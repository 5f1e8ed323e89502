// hop_window: one step of a hopping (sliding-batch) time window (kernel
// K18), for sm_90a.
//
// Replaces the JAX package's HoppingWindow.process
// (siddhi_tpu/core/window_ext.py:1166, with its sort_rows / concat_rows
// and the scatter that rebuilds its buffer), hopping(window.time,
// hop.time).  kernels/hop_window.py states the rows, their order and the
// state.  The candidates are the buffer's alive rows [0, n) and the
// arrivals (compacted to the front by filter_compact), in that order; each
// candidate has three flags, all from its ts: CURRENT (in [emit - win,
// emit)), EXPIRED (in [emit - hop - win, emit - hop)) and kept (ts >=
// next' - win - hop).  Every output row's place and every kept row's place
// is its flag's rank, so there is no sort.
//
// Two launches with one host fetch between them, as K16's:
//   prepare: hp_first (one block: the least arrival ts, the boundary, the
//     flush), hp_flags (a thread per candidate: the three flags, their
//     per-block counts), three one-block scans of the block counts,
//     hp_totals (the output row count, which the host reads to size the
//     output);
//   write: hp_write (a thread per candidate: rescans its block's flags and
//     writes its EXPIRED row, its CURRENT row and its kept copy at their
//     ranks; thread 0 writes the RESET row), hp_finish (the counters, the
//     parity flip, the wake).
// The kept rows go into the other of two buffers and the parity flips, so
// a step allocates no buffer and no candidate is overwritten before it is
// read.  Kept rows past C drop, as in the reference, and are counted in
// `missed` (the runtime raises).
//
// Bound: each alive row and each arrival is read once; each output row and
// each kept row written once.  No arithmetic to speak of: bound by bytes.
// A design that kept the rows as a ring in ts order would read only the
// rows it emits and write only the arrivals it keeps; this one rewrites the
// whole kept buffer a step.
#include "rows.cuh"

using namespace siddhi;

namespace {

constexpr int MAX_COLS = 16;
constexpr int BLOCK = 256;
constexpr int MIN_BLOCK = 1024;
constexpr long long NO_WAKEUP = BIG_SEQ;
enum : int { F_CUR = 1, F_PREV = 2, F_KEEP = 4 };

}  // namespace

// Mirrored field for field by kernels/hop_window.py (ctypes.Structure).
struct HopPlan {
  long long C, A, now, win, hop, cap;   // A: the batch's capacity
  int ncols, pad;
  int col_bytes[MAX_COLS];
  long long reset_val[MAX_COLS];
  long long* b_ts[2];
  int* b_gslot[2];
  void* b_col[2][MAX_COLS];
  long long* meta;   // [n, next (-1 unset), seq, parity, missed]
  const long long* a_ts;
  const int* a_gslot;
  const void* a_col[MAX_COLS];
  const long long* n_arr;
  long long* sums[3];  // per-block counts of the CURRENT / EXPIRED / kept flags
  long long* scal;     // [rows out, flush, emit, next', n, rows of C + A]
  long long* out_ts;
  int* out_kind;
  long long* out_seq;
  int* out_gslot;
  void* out_col[MAX_COLS];
  long long* wake;     // [next' or NO_WAKEUP, rows missed]
};

namespace {

// The step's boundary: next (the first arrival's ts + hop while unset),
// whether `now` has reached it, the collapsed emit time and next'.
__global__ void hp_first(const HopPlan pl) {
  __shared__ long long sh[MIN_BLOCK];
  const long long na = pl.n_arr[0];
  long long m = BIG_SEQ;
  for (long long i = threadIdx.x; i < na; i += MIN_BLOCK) m = min(m, pl.a_ts[i]);
  sh[threadIdx.x] = m;
  __syncthreads();
  for (int s = MIN_BLOCK / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] = min(sh[threadIdx.x], sh[threadIdx.x + s]);
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  const long long next0 = pl.meta[1];
  const long long nxt = next0 >= 0 ? next0 : (na > 0 ? sh[0] + pl.hop : -1);
  const bool flush = nxt >= 0 && pl.now >= nxt;
  const long long emit = flush ? nxt + ((pl.now - nxt) / pl.hop) * pl.hop : nxt;
  pl.scal[1] = flush;
  pl.scal[2] = emit;
  pl.scal[3] = flush ? emit + pl.hop : nxt;
  pl.scal[4] = pl.meta[0];
  pl.scal[5] = pl.meta[0] + na;
}

// Candidate i: buffer row i (i < n) or arrival i - n.
__device__ __forceinline__ long long cand_ts(const HopPlan& pl, int par, long long n, long long i) {
  return i < n ? pl.b_ts[par][i] : pl.a_ts[i - n];
}

__device__ __forceinline__ int cand_flags(const HopPlan& pl, long long i) {
  const long long n = pl.scal[4];
  if (i >= pl.scal[5]) return 0;
  const int par = (int)pl.meta[3];
  const long long ts = cand_ts(pl, par, n, i);
  const long long emit = pl.scal[2], nn = pl.scal[3], prev = emit - pl.hop;
  int f = 0;
  if (pl.scal[1]) {
    if (ts >= emit - pl.win && ts < emit) f |= F_CUR;
    if (ts >= prev - pl.win && ts < prev) f |= F_PREV;
  }
  if (nn < 0 || ts >= nn - pl.win - pl.hop) f |= F_KEEP;
  return f;
}

__global__ void hp_flags(const HopPlan pl) {
  __shared__ long long sh[2 * BLOCK];
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const int f = cand_flags(pl, i);
  for (int j = 0; j < 3; ++j) {
    long long tot;
    block_excl_scan<BLOCK>((long long)((f >> j) & 1), sh, &tot);
    if (threadIdx.x == 0) pl.sums[j][blockIdx.x] = tot;
  }
}

__global__ void hp_totals(const HopPlan pl, long long nb) {
  const long long n_cur = pl.sums[0][nb], n_prev = pl.sums[1][nb];
  pl.scal[0] = pl.scal[1] ? n_prev + 1 + n_cur : 0;
}

__device__ __forceinline__ void put_row(const HopPlan& pl, long long o, int kind, long long seq,
                                        long long ts, int gslot) {
  pl.out_ts[o] = ts;
  pl.out_kind[o] = kind;
  pl.out_seq[o] = seq;
  pl.out_gslot[o] = gslot;
}

// Each candidate's EXPIRED row, CURRENT row and kept copy at its ranks
// (rows past the output's `cap` rows are not written: never so when the
// host sized it by the prepare launch's count).
__global__ void hp_write(const HopPlan pl, long long nb) {
  __shared__ long long sh[2 * BLOCK];
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const int f = cand_flags(pl, i);
  long long r[3];
  for (int j = 0; j < 3; ++j) {
    long long tot;
    r[j] = block_excl_scan<BLOCK>((long long)((f >> j) & 1), sh, &tot) + pl.sums[j][blockIdx.x];
  }
  const long long seq0 = pl.meta[2], n = pl.scal[4], CB = pl.C + pl.A;
  const long long n_prev = pl.sums[1][nb];
  const int par = (int)pl.meta[3], q = 1 - par;
  if (i == 0 && pl.scal[1] && n_prev < pl.cap) {
    put_row(pl, n_prev, K_RESET, seq0 + CB, pl.now, -1);
    for (int c = 0; c < pl.ncols; ++c) store_bits(pl.out_col[c], n_prev, pl.reset_val[c], pl.col_bytes[c]);
  }
  if (!f) return;
  const bool buf = i < n;
  const long long src = buf ? i : i - n;
  const long long ts = buf ? pl.b_ts[par][src] : pl.a_ts[src];
  const int gs = buf ? pl.b_gslot[par][src] : pl.a_gslot[src];
  const void* const* scol = buf ? (const void* const*)pl.b_col[par] : pl.a_col;
  if ((f & F_PREV) && r[1] < pl.cap) {
    put_row(pl, r[1], K_EXPIRED, seq0 + r[1], ts, gs);
    for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.out_col[c], r[1], scol[c], src, pl.col_bytes[c]);
  }
  const long long o = n_prev + 1 + r[0];
  if ((f & F_CUR) && o < pl.cap) {
    put_row(pl, o, K_CURRENT, seq0 + CB + 1 + r[0], ts, gs);
    for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.out_col[c], o, scol[c], src, pl.col_bytes[c]);
  }
  if ((f & F_KEEP) && r[2] < pl.C) {
    pl.b_ts[q][r[2]] = ts;
    pl.b_gslot[q][r[2]] = gs;
    for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.b_col[q][c], r[2], scol[c], src, pl.col_bytes[c]);
  }
}

__global__ void hp_finish(const HopPlan pl, long long nb) {
  long long* m = pl.meta;
  const long long kept = pl.sums[2][nb], nn = pl.scal[3];
  const long long missed = kept > pl.C ? kept - pl.C : 0;
  m[0] = kept - missed;
  m[1] = nn;
  if (pl.scal[1]) m[2] += 2 * (pl.C + pl.A) + 2;
  m[3] = 1 - m[3];
  m[4] += missed;
  pl.wake[0] = nn >= 0 ? nn : NO_WAKEUP;
  pl.wake[1] = missed;
}

inline long long n_blocks(const HopPlan& pl) { return (pl.C + pl.A + BLOCK - 1) / BLOCK; }

}  // namespace

extern "C" int siddhi_hop_plan_size() { return (int)sizeof(HopPlan); }

// Prepare launch on `stream`; returns the launches' cudaError_t (0 = launched).
extern "C" int siddhi_hop_prepare(const HopPlan* plan, void* stream) {
  const HopPlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  const long long nb = n_blocks(pl);
  hp_first<<<1, MIN_BLOCK, 0, s>>>(pl);
  hp_flags<<<(unsigned)nb, BLOCK, 0, s>>>(pl);
  for (int j = 0; j < 3; ++j) scan_sums_kernel<<<1, SCAN_BLOCK, 0, s>>>(pl.sums[j], nb);
  hp_totals<<<1, 1, 0, s>>>(pl, nb);
  return (int)cudaGetLastError();
}

// Write launch on `stream` (after the prepare launch, with the outputs set).
extern "C" int siddhi_hop_write(const HopPlan* plan, void* stream) {
  const HopPlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  const long long nb = n_blocks(pl);
  hp_write<<<(unsigned)nb, BLOCK, 0, s>>>(pl, nb);
  hp_finish<<<1, 1, 0, s>>>(pl, nb);
  return (int)cudaGetLastError();
}
