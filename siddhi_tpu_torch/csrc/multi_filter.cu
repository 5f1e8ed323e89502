// multi_filter: P filter programs over S staged batches in one launch
// sequence, for sm_90a (kernel K29).
//
// Replaces, in the JAX package's fused and merged dispatches:
//   siddhi_tpu/core/fusion.py    _dispatch_plain / _dispatch_join: the
//                                pre-window filters of K stacked batches
//                                inside one lax.scan
//   siddhi_tpu/optimizer/mqo.py  MergedGroupRuntime._build_body: each
//                                unit's pre-window filters inside the one
//                                merged step
// Program p is one unit's (or one query's) filters as the typed postfix
// bytecode of kernels/filter_bytecode.py; batch s is one staged batch of a
// stack (inputs [S, B], row i of batch s at s * B + i).  Each (program,
// batch) pair compacts its own rows as kernel K1 does: a STABLE partition,
// kept rows (valid, CURRENT, or EXPIRED with the program's keep_expired
// bit, passing the filters) first in input order, then the others, marked
// invalid.  A program with a seq counter numbers its kept rows from it,
// batch after batch (batch s starts where batch s - 1 ended), and the
// counter advances by the program's kept rows over the stack; without a
// counter each row's seq is its input index.  The [P, S] kept counts stay
// on the card.
//
// Launch sequence: flags (one thread per (program, batch, row), block
// counts), a scan of each (program, batch)'s block counts, the scatter,
// then the counters.  Bound: every input row is read once per program and
// written once per program, so the launch is bound by bytes.
#include "bytecode.cuh"
#include "rows.cuh"

using namespace siddhi;

namespace {

constexpr int MAX_COLS = 16;
constexpr int MAX_CODE = 256;
constexpr int MAX_P = 8;
constexpr int BLOCK = 256;

}  // namespace

// Mirrored field for field by kernels/multi_filter.py (ctypes.Structure).
// `codes` is [P, MAX_CODE] on the card (the programs' bytecode, uploaded
// once per program set); the outputs are [P, S, B] per leaf.
struct MultiPlan {
  int P, S, B, ncols, write_seq_mask, keep_expired_mask;
  int col_ty[MAX_COLS];
  int code_len[MAX_P];
  const int* codes;
  const long long* ts;
  const int* kind;
  const unsigned char* valid;
  const void* col[MAX_COLS];
  const int* gslot[MAX_P];
  long long* seq[MAX_P];
  long long* out_ts;
  int* out_kind;
  unsigned char* out_valid;
  long long* out_seq;
  int* out_gslot;
  void* out_col[MAX_COLS];
  long long* counts;
  unsigned char* flags;
  long long* block_sums;    // [P * S, nb + 1]
  InSet in_sets[MAX_P][MAX_IN];
};

static_assert(sizeof(MultiPlan) <= 4000, "MultiPlan must fit the kernel parameter space");

namespace {

__device__ __forceinline__ int col_bytes(int ty) {
  return ty == T_I64 ? 8 : 4;   // bool columns arrive as int32
}

__global__ void mf_flags(const __grid_constant__ MultiPlan pl, long long nb) {
  __shared__ long long sh[2 * BLOCK];
  const int ps = blockIdx.y, p = ps / pl.S, s = ps % pl.S;
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  long long r = (long long)s * pl.B + i;
  int keep = 0;
  if (i < pl.B) {
    const int kexp = (pl.keep_expired_mask >> p) & 1;
    keep = pl.valid[r] && (pl.kind[r] == K_CURRENT || (kexp && pl.kind[r] == K_EXPIRED));
    if (keep && pl.code_len[p] > 0)
      keep = eval_bytecode_in(
          pl.codes + (long long)p * MAX_CODE, pl.code_len[p],
          [&](int c) { return load_slot(pl.col[c], r, pl.col_ty[c]); },
          [&](int, int) { return 0LL; }, pl.in_sets[p]);
    pl.flags[(long long)ps * pl.B + i] = (unsigned char)keep;
  }
  long long tot;
  block_excl_scan<BLOCK>((long long)keep, sh, &tot);
  if (threadIdx.x == 0) pl.block_sums[(long long)ps * (nb + 1) + blockIdx.x] = tot;
}

// In-place exclusive scan of one (program, batch)'s block counts (one
// block each); the total goes to the row's last word and to counts.
__global__ void mf_scan(const __grid_constant__ MultiPlan pl, long long nb) {
  __shared__ long long sh[2 * SCAN_BLOCK];
  long long* sums = pl.block_sums + (long long)blockIdx.x * (nb + 1);
  long long per = (nb + SCAN_BLOCK - 1) / SCAN_BLOCK;
  long long lo = threadIdx.x * per;
  long long hi = lo + per < nb ? lo + per : nb;
  long long v = 0;
  for (long long j = lo; j < hi; ++j) v += sums[j];
  long long tot;
  long long off = block_excl_scan<SCAN_BLOCK>(v, sh, &tot);
  for (long long j = lo; j < hi; ++j) {
    long long x = sums[j];
    sums[j] = off;
    off += x;
  }
  if (threadIdx.x == 0) {
    sums[nb] = tot;
    pl.counts[blockIdx.x] = tot;
  }
}

__global__ void mf_scatter(const __grid_constant__ MultiPlan pl, long long nb) {
  __shared__ long long sh[2 * BLOCK];
  const int ps = blockIdx.y, p = ps / pl.S, s = ps % pl.S;
  const long long* sums = pl.block_sums + (long long)ps * (nb + 1);
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  int keep = i < pl.B ? pl.flags[(long long)ps * pl.B + i] : 0;
  long long tot;
  long long r = block_excl_scan<BLOCK>((long long)keep, sh, &tot) + sums[blockIdx.x];
  if (i >= pl.B) return;
  const long long total = sums[nb];
  const long long src = (long long)s * pl.B + i;
  const long long dst = (long long)ps * pl.B + (keep ? r : total + (i - r));
  pl.out_ts[dst] = pl.ts[src];
  pl.out_kind[dst] = pl.kind[src];
  pl.out_valid[dst] = (unsigned char)keep;
  pl.out_gslot[dst] = pl.gslot[p][src];
  long long sq = i;
  if ((pl.write_seq_mask >> p) & 1) {
    // this batch's rows follow the program's kept rows of earlier batches
    long long base = pl.seq[p][0];
    for (int t = 0; t < s; ++t) base += pl.counts[(long long)p * pl.S + t];
    sq = keep ? base + r : BIG_SEQ;
  }
  pl.out_seq[dst] = sq;
  for (int c = 0; c < pl.ncols; ++c)
    copy_elem(pl.out_col[c], dst, pl.col[c], src, col_bytes(pl.col_ty[c]));
}

__global__ void mf_finish(const __grid_constant__ MultiPlan pl) {
  int p = threadIdx.x;
  if (p >= pl.P || !((pl.write_seq_mask >> p) & 1)) return;
  long long add = 0;
  for (int s = 0; s < pl.S; ++s) add += pl.counts[(long long)p * pl.S + s];
  pl.seq[p][0] += add;
}

}  // namespace

extern "C" int siddhi_multi_plan_size() { return (int)sizeof(MultiPlan); }

// Launches on `stream`; returns the launches' cudaError_t (0 = launched).
extern "C" int siddhi_multi_filter(const MultiPlan* plan, void* stream) {
  const MultiPlan& pl = *plan;
  if (pl.B <= 0 || pl.P <= 0 || pl.S <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  long long nb = (pl.B + BLOCK - 1) / BLOCK;
  dim3 grid((unsigned)nb, (unsigned)(pl.P * pl.S));
  mf_flags<<<grid, BLOCK, 0, st>>>(pl, nb);
  mf_scan<<<(unsigned)(pl.P * pl.S), SCAN_BLOCK, 0, st>>>(pl, nb);
  mf_scatter<<<grid, BLOCK, 0, st>>>(pl, nb);
  if (pl.write_seq_mask) mf_finish<<<1, 32, 0, st>>>(pl);
  return (int)cudaGetLastError();
}
