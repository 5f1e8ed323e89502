// time_batch: one step of a tumbling time-batch window (kernel K12), for
// sm_90a.
//
// Replaces the JAX package's TimeBatchWindow.process
// (siddhi_tpu/core/window.py:602, with its sort_rows / concat_rows and the
// scatters that rebuild its two buffers).  Time is cut into slices
// [start + k*t, start + (k+1)*t); the arrivals come compacted to the front
// by filter_compact.  When `now` has passed at least one boundary the step
// flushes: the previous slice as EXPIRED rows (seq seq0 + rank), one RESET
// row (seq seq0 + C, ts now), then the pending slice and the arrivals with
// ts < boundary as CURRENT rows (seq seq0 + C + 1 + rank); several
// boundaries passed in one gap collapse into one flush, as in the
// reference.  Arrivals at or past the boundary start the new pending
// slice; in a step that does not flush they are dropped, as in the
// reference.  The seq counter advances by 2C + B + 2 on a flush.
//
// Every output row's place follows from its slice and its rank, so there
// is no sort: one scan of the arrivals' `ts < boundary` predicate, then
// writes at offsets.  The pending and previous slices are two buffers kept
// in place: a flush appends to the pending one, which becomes the previous
// slice, and the new pending slice is written over the old previous one
// (meta[4] says which buffer is pending), so no slice is copied.  A slice
// that would overflow C keeps the rows that fit, as the reference's
// dropping scatter does, and counts the rest in `missed` (the runtime
// raises).
//
// External mode (`ext`) replaces ExternalTimeBatchWindow.process
// (siddhi_tpu/core/window_ext.py:178), externalTimeBatch(attr, t): the
// slices are cut by the arrivals' event times (`a_ets`), not by `now`.
// The start is the first arrival's event time; the step flushes when its
// latest event time has passed a boundary (a step without arrivals never
// does), arrivals with event time < boundary join the flushed slice, the
// RESET row still carries `now`, and there is no timer (the wake is
// NO_WAKEUP).
//
// Chunk mode replaces ChunkBatchWindow.process
// (siddhi_tpu/core/window_ext.py:427), batch(): a step with an arrival
// flushes the previous chunk (EXPIRED, seq seq0 + rank), a RESET row (seq
// seq0 + qf) and every arrival (CURRENT, seq seq0 + qf + 1 + rank); the
// arrivals become the previous chunk.  Cron mode replaces
// CronWindow.process (:579): a step flushes when the host says its batch
// holds a TIMER row (`flush`); the flush is timeBatch's without the
// step's arrivals, which start the new pending batch.  Both keep the two
// buffers and the parity word; neither has a start or a timer.  In the
// flags below, chunk mode flags every arrival as in the flushed slice and
// cron mode flags none on a flush and all otherwise, so the scan, the
// writes and the buffer moves are timeBatch's.
//
// Bound: a flush reads the two slices and the arrivals once and writes
// each output row once; a step that does not flush moves only its
// arrivals.  No arithmetic to speak of: bound by bytes.
#include "rows.cuh"

using namespace siddhi;

namespace {

constexpr int MAX_COLS = 16;
constexpr int BLOCK = 256;
constexpr int MIN_BLOCK = 1024;
enum : int { M_TIME = 0, M_EXT = 1, M_CHUNK = 2, M_CRON = 3 };

}  // namespace

// Mirrored field for field by kernels/time_batch.py (ctypes.Structure).
struct TimeBatchPlan {
  long long C, t, now, B, cap_out;
  int ncols, mode;   // M_EXT: slices by a_ets (externalTimeBatch)
  int flush, pad;    // M_CRON: the batch holds a TIMER row
  int col_bytes[MAX_COLS];
  long long reset_val[MAX_COLS];
  long long* b_ts[2];
  int* b_gslot[2];
  void* b_col[2][MAX_COLS];
  long long* meta;  // [start, seq, pending fill, previous fill, parity, missed]
  const long long* a_ts;
  const long long* a_ets;   // ext: the arrivals' event times
  const int* a_gslot;
  const void* a_col[MAX_COLS];
  const long long* n_arr;
  unsigned char* flags;
  long long* block_sums;
  long long* step;   // [start, nflush, boundary] of this step
  long long* out_ts;
  int* out_kind;
  unsigned char* out_valid;
  long long* out_seq;
  int* out_gslot;
  void* out_col[MAX_COLS];
  long long* wake;   // [earliest flush time, rows missed]
};

namespace {

__device__ __forceinline__ long long imax(long long a, long long b) { return a > b ? a : b; }

// What slices the time: the arrivals' ts, or their event times.
__device__ __forceinline__ const long long* slice_key(const TimeBatchPlan& pl) {
  return pl.mode == M_EXT ? pl.a_ets : pl.a_ts;
}

// The step's slice facts, from the state and the earliest (and, in
// external mode, the latest) arrival.
__global__ void tb_first(const TimeBatchPlan pl) {
  __shared__ long long sh[MIN_BLOCK];
  __shared__ long long sx[MIN_BLOCK];
  const long long na = pl.n_arr[0];
  const long long* key = slice_key(pl);
  long long m = BIG_SEQ, x = -BIG_SEQ;
  for (long long i = threadIdx.x; i < na; i += MIN_BLOCK) {
    m = min(m, key[i]);
    x = max(x, key[i]);
  }
  sh[threadIdx.x] = m;
  sx[threadIdx.x] = x;
  __syncthreads();
  for (int s = MIN_BLOCK / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      sh[threadIdx.x] = min(sh[threadIdx.x], sh[threadIdx.x + s]);
      sx[threadIdx.x] = max(sx[threadIdx.x], sx[threadIdx.x + s]);
    }
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  if (pl.mode == M_CHUNK || pl.mode == M_CRON) {
    // the flags: chunk, every arrival in the flushed chunk; cron, none in
    // the flushed batch on a flush, all in the pending one otherwise
    const bool flush = pl.mode == M_CHUNK ? na > 0 : pl.flush != 0;
    pl.step[0] = -1;
    pl.step[1] = flush ? 1 : 0;
    pl.step[2] = (pl.mode == M_CRON && flush) ? -BIG_SEQ : BIG_SEQ;
    return;
  }
  const long long start0 = pl.meta[0], first = sh[0];
  const bool any_cur = na > 0;
  const long long start = start0 >= 0 ? start0 : first;
  long long nflush;
  if (pl.mode == M_EXT) nflush = any_cur ? imax(sx[0] - start, 0) / pl.t : 0;
  else nflush = start0 >= 0 ? imax(pl.now - start0, 0) / pl.t
                            : (any_cur ? imax(pl.now - first, 0) / pl.t : 0);
  pl.step[0] = start;
  pl.step[1] = nflush;
  pl.step[2] = start + (nflush > 0 ? nflush : 1) * pl.t;
}

// Flags of the arrivals that belong to the slice ending at the boundary,
// and their per-block counts.
__global__ void tb_flags(const TimeBatchPlan pl) {
  __shared__ long long sh[2 * BLOCK];
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  int f = i < pl.n_arr[0] && slice_key(pl)[i] < pl.step[2];
  if (i < pl.B) pl.flags[i] = (unsigned char)f;
  long long tot;
  block_excl_scan<BLOCK>((long long)f, sh, &tot);
  if (threadIdx.x == 0) pl.block_sums[blockIdx.x] = tot;
}

// The RESET row's seq offset; the CURRENT rows follow it.
__device__ __forceinline__ long long reset_seq(const TimeBatchPlan& pl, long long qf) {
  return pl.mode == M_CHUNK ? qf : pl.C;
}

__device__ void put_row(const TimeBatchPlan& pl, long long p, int kind, long long seq, long long ts,
                        int gslot) {
  pl.out_valid[p] = 1;
  pl.out_kind[p] = kind;
  pl.out_seq[p] = seq;
  pl.out_ts[p] = ts;
  pl.out_gslot[p] = gslot;
}

// The output rows that come from the state: the previous slice (EXPIRED),
// the RESET row and the pending slice (CURRENT); and the invalid tail.
__global__ void tb_out(const TimeBatchPlan pl, long long nb) {
  long long p = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (p >= pl.cap_out) return;
  const long long seq0 = pl.meta[1], pf = pl.meta[2], qf = pl.meta[3];
  const int par = (int)pl.meta[4];
  const bool flush = pl.step[1] > 0;
  const long long n_in = pl.block_sums[nb];
  const long long n_out = flush ? qf + 1 + pf + n_in : 0;
  if (p >= n_out) {
    pl.out_valid[p] = 0;
    pl.out_kind[p] = 0;
    pl.out_seq[p] = 0;
    pl.out_ts[p] = 0;
    pl.out_gslot[p] = 0;
    for (int c = 0; c < pl.ncols; ++c) store_bits(pl.out_col[c], p, 0, pl.col_bytes[c]);
    return;
  }
  const int P = par, Q = 1 - par;
  const long long rs = reset_seq(pl, qf);
  if (p < qf) {
    put_row(pl, p, K_EXPIRED, seq0 + p, pl.b_ts[Q][p], pl.b_gslot[Q][p]);
    for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.out_col[c], p, pl.b_col[Q][c], p, pl.col_bytes[c]);
  } else if (p == qf) {
    put_row(pl, p, K_RESET, seq0 + rs, pl.now, -1);
    for (int c = 0; c < pl.ncols; ++c) store_bits(pl.out_col[c], p, pl.reset_val[c], pl.col_bytes[c]);
  } else if (p <= qf + pf) {
    long long r = p - qf - 1;
    put_row(pl, p, K_CURRENT, seq0 + rs + 1 + r, pl.b_ts[P][r], pl.b_gslot[P][r]);
    for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.out_col[c], p, pl.b_col[P][c], r, pl.col_bytes[c]);
  }
  // rows past qf + pf are the arrivals: tb_arr writes them
}

// Each arrival to its place: the flushed slice's CURRENT rows and the
// pending buffer's tail (ts < boundary), or the new pending slice.
__global__ void tb_arr(const TimeBatchPlan pl) {
  __shared__ long long sh[2 * BLOCK];
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  int f = i < pl.B ? pl.flags[i] : 0;
  long long tot;
  long long r = block_excl_scan<BLOCK>((long long)f, sh, &tot) + pl.block_sums[blockIdx.x];
  if (i >= pl.n_arr[0]) return;
  const long long seq0 = pl.meta[1], pf = pl.meta[2], qf = pl.meta[3];
  const int P = (int)pl.meta[4], Q = 1 - P;
  const bool flush = pl.step[1] > 0;
  if (f) {
    if (flush && qf + 1 + pf + r < pl.cap_out) {
      long long p = qf + 1 + pf + r;
      put_row(pl, p, K_CURRENT, seq0 + reset_seq(pl, qf) + 1 + pf + r, pl.a_ts[i], pl.a_gslot[i]);
      for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.out_col[c], p, pl.a_col[c], i, pl.col_bytes[c]);
    }
    long long d = pf + r;
    if (d < pl.C) {
      pl.b_ts[P][d] = pl.a_ts[i];
      pl.b_gslot[P][d] = pl.a_gslot[i];
      for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.b_col[P][c], d, pl.a_col[c], i, pl.col_bytes[c]);
    }
  } else if (flush) {
    long long d = i - r;
    if (d < pl.C) {
      pl.b_ts[Q][d] = pl.a_ts[i];
      pl.b_gslot[Q][d] = pl.a_gslot[i];
      for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.b_col[Q][c], d, pl.a_col[c], i, pl.col_bytes[c]);
    }
  }
}

__global__ void tb_finish(const TimeBatchPlan pl, long long nb) {
  long long* m = pl.meta;
  const long long na = pl.n_arr[0], n_in = pl.block_sums[nb], n_next = na - n_in;
  const long long start0 = m[0], pf = m[2], nflush = pl.step[1];
  const long long fill = pf + n_in;
  long long missed = imax(fill - pl.C, 0);
  long long nstart;
  if (nflush > 0) {
    missed += imax(n_next - pl.C, 0);
    m[1] += pl.mode == M_CHUNK ? m[3] + 1 + na : pl.mode == M_CRON ? 2 * pl.C + 1 : 2 * pl.C + pl.B + 2;
    m[3] = fill < pl.C ? fill : pl.C;
    m[2] = n_next < pl.C ? n_next : pl.C;
    m[4] = 1 - m[4];
    nstart = pl.step[0] + nflush * pl.t;
  } else {
    m[2] = fill < pl.C ? fill : pl.C;
    nstart = (start0 >= 0 || na > 0) ? pl.step[0] : -1;
  }
  if (pl.mode == M_CHUNK || pl.mode == M_CRON) nstart = -1;
  m[0] = nstart;
  m[5] += missed;
  pl.wake[0] = nstart >= 0 && pl.mode == M_TIME ? nstart + pl.t : BIG_SEQ;
  pl.wake[1] = missed;
}

}  // namespace

extern "C" int siddhi_time_batch_plan_size() { return (int)sizeof(TimeBatchPlan); }

// Launches on `stream`; returns the launches' cudaError_t (0 = launched).
extern "C" int siddhi_time_batch(const TimeBatchPlan* plan, void* stream) {
  const TimeBatchPlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  long long nb = (pl.B + BLOCK - 1) / BLOCK;
  tb_first<<<1, MIN_BLOCK, 0, s>>>(pl);
  if (nb > 0) tb_flags<<<(unsigned)nb, BLOCK, 0, s>>>(pl);
  scan_sums_kernel<<<1, SCAN_BLOCK, 0, s>>>(pl.block_sums, nb);
  if (pl.cap_out > 0) tb_out<<<(unsigned)((pl.cap_out + BLOCK - 1) / BLOCK), BLOCK, 0, s>>>(pl, nb);
  if (nb > 0) tb_arr<<<(unsigned)nb, BLOCK, 0, s>>>(pl);
  tb_finish<<<1, 1, 0, s>>>(pl, nb);
  return (int)cudaGetLastError();
}
