// filter_compact: the pre-window filter chain and the pass-through window
// of a single-stream query, for sm_90a.
//
// Replaces, in the JAX package's jitted query step:
//   siddhi_tpu/core/planner.py  _apply_chain (filters) in stage_body
//   siddhi_tpu/core/window.py   NoWindow.process + sort_rows
// Each row is kept when it is valid, CURRENT (or, for a query reading a
// named window, EXPIRED: `keep_expired`) and passes the filters (typed
// postfix bytecode, kernels/filter_bytecode.py, one thread per row; an
// `x in Table` probe is a lookup in the hash sets of csrc/in_probe.cu).  The
// output is a STABLE partition: kept rows first in input order, numbered
// seq0 + rank when a seq counter is given, then the others in input order,
// marked invalid.  Without a counter each row's seq is its input index (a
// caller that keys host data by input row finds it there).  The kept count
// goes to a device scalar and the counter advances by it.  In the
// row-aligned mode (`aligned`; a windowless group-by on a mesh, whose
// shards' rows merge row by row: siddhi_tpu/core/window.py NoWindow with
// `compact` off) every row stays at its input position, kept or not.
//
// Bound: every input row is read once (its columns, ts, kind, valid, group
// slot) and written once to its place; the filter is a few dozen integer
// or float operations per row, so the step is bound by bytes.  Design:
// flags and per-block counts in one pass, a one-block scan of the block
// counts, then each block rescans its flags and scatters its rows; a block
// writes its kept rows to one contiguous run, so stores coalesce.
#include "bytecode.cuh"
#include "rows.cuh"

using namespace siddhi;

namespace {

constexpr int MAX_COLS = 16;
constexpr int MAX_CODE = 256;
constexpr int BLOCK = 256;

}  // namespace

// Mirrored field for field by kernels/filter_compact.py (ctypes.Structure).
struct FilterPlan {
  int B, ncols, code_len, write_seq, keep_expired, aligned;
  int col_ty[MAX_COLS];
  int code[MAX_CODE];
  const long long* ts;
  const int* kind;
  const unsigned char* valid;
  const int* gslot;
  const void* col[MAX_COLS];
  long long* out_ts;
  int* out_kind;
  unsigned char* out_valid;
  long long* out_seq;
  int* out_gslot;
  void* out_col[MAX_COLS];
  long long* count;
  long long* seq;
  unsigned char* flags;
  long long* block_sums;
  InSet in_sets[MAX_IN];
};

namespace {

__device__ __forceinline__ int col_bytes(int ty) {
  return ty == T_I64 ? 8 : 4;   // bool columns arrive as int32
}

__global__ void fc_flags(const FilterPlan pl) {
  __shared__ long long sh[2 * BLOCK];
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  int keep = 0;
  if (i < pl.B) {
    keep = pl.valid[i] && (pl.kind[i] == K_CURRENT ||
                           (pl.keep_expired && pl.kind[i] == K_EXPIRED));
    if (keep && pl.code_len > 0)
      keep = eval_bytecode_in(
          pl.code, pl.code_len,
          [&](int c) { return load_slot(pl.col[c], i, pl.col_ty[c]); },
          [&](int, int) { return 0LL; }, pl.in_sets);
    pl.flags[i] = (unsigned char)keep;
  }
  long long tot;
  block_excl_scan<BLOCK>((long long)keep, sh, &tot);
  if (threadIdx.x == 0) pl.block_sums[blockIdx.x] = tot;
}

__global__ void fc_scatter(const FilterPlan pl) {
  __shared__ long long sh[2 * BLOCK];
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  int keep = i < pl.B ? pl.flags[i] : 0;
  long long tot;
  long long r = block_excl_scan<BLOCK>((long long)keep, sh, &tot) + pl.block_sums[blockIdx.x];
  if (i >= pl.B) return;
  long long total = pl.block_sums[gridDim.x];
  long long dst = pl.aligned ? i : (keep ? r : total + (i - r));
  pl.out_ts[dst] = pl.ts[i];
  pl.out_kind[dst] = pl.kind[i];
  pl.out_valid[dst] = (unsigned char)keep;
  pl.out_gslot[dst] = pl.gslot[i];
  pl.out_seq[dst] = pl.write_seq ? (keep ? pl.seq[0] + r : BIG_SEQ) : i;
  for (int c = 0; c < pl.ncols; ++c)
    copy_elem(pl.out_col[c], dst, pl.col[c], i, col_bytes(pl.col_ty[c]));
}

__global__ void fc_finish(const FilterPlan pl, long long nb) {
  long long total = pl.block_sums[nb];
  pl.count[0] = total;
  if (pl.write_seq) pl.seq[0] += total;
}

}  // namespace

extern "C" int siddhi_filter_plan_size() { return (int)sizeof(FilterPlan); }

// Launches on `stream`; returns the launches' cudaError_t (0 = launched).
extern "C" int siddhi_filter_compact(const FilterPlan* plan, void* stream) {
  const FilterPlan& pl = *plan;
  if (pl.B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  long long nb = (pl.B + BLOCK - 1) / BLOCK;
  fc_flags<<<(unsigned)nb, BLOCK, 0, s>>>(pl);
  scan_sums_kernel<<<1, SCAN_BLOCK, 0, s>>>(pl.block_sums, nb);
  fc_scatter<<<(unsigned)nb, BLOCK, 0, s>>>(pl);
  fc_finish<<<1, 1, 0, s>>>(pl, nb);
  return (int)cudaGetLastError();
}
