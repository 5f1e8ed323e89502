// length_batch: one step of a tumbling length-batch window, for sm_90a.
//
// Replaces the JAX package's LengthBatchWindow.process
// (siddhi_tpu/core/window.py:447, with its sort_rows / concat_rows).  The
// arrivals come compacted to the front by filter_compact.  With fill0
// pending rows, na arrivals and batches of n, the step completes
// nflush = (fill0 + na) / n batches; flush f emits the previous batch as
// EXPIRED rows, one RESET row and the completed batch as CURRENT rows,
// numbered seq0 + f*(2n+2) + offset.  A row's place in the output follows
// from its flush and offset alone, so each output row is written by one
// thread: no sort and no scan.  Then the last flushed batch becomes the
// previous batch and the rest of the arrivals the pending one.
//
// Bound: each emitted row is read once and written once (a CURRENT row is
// read again when it later expires, in a later flush or step), and the
// pending and previous batches are rewritten; no arithmetic to speak of,
// so the step is bound by bytes.  Four launches: emit, previous batch,
// pending batch, counters; the state is read by the first three and
// written only after every read of it (stream order).
#include "rows.cuh"

using namespace siddhi;

namespace {

constexpr int MAX_COLS = 16;
constexpr int BLOCK = 256;

}  // namespace

// Mirrored field for field by kernels/length_batch.py (ctypes.Structure).
struct BatchPlan {
  long long n, now, cap_out;
  int ncols;
  int col_bytes[MAX_COLS];
  long long reset_val[MAX_COLS];
  long long* p_ts;
  int* p_gslot;
  void* p_col[MAX_COLS];
  long long* q_ts;
  int* q_gslot;
  void* q_col[MAX_COLS];
  long long* meta;   // [fill, prev_count, seq]
  const long long* a_ts;
  const int* a_gslot;
  const void* a_col[MAX_COLS];
  const long long* n_arr;
  long long* out_ts;
  int* out_kind;
  unsigned char* out_valid;
  long long* out_seq;
  int* out_gslot;
  void* out_col[MAX_COLS];
};

namespace {

struct Step {
  long long fill0, pc, seq0, na, G, nflush;
};

__device__ __forceinline__ Step read_step(const BatchPlan& pl) {
  Step s;
  s.fill0 = pl.meta[0];
  s.pc = pl.meta[1];
  s.seq0 = pl.meta[2];
  s.na = pl.n_arr[0];
  s.G = s.fill0 + s.na;
  s.nflush = s.G / pl.n;
  return s;
}

// Row g of the step (pending rows first, then arrivals) into dst[di].
__device__ void copy_step_row(const BatchPlan& pl, const Step& s, long long g,
                              long long* dts, int* dgslot, void* const* dcol, long long di) {
  if (g < s.fill0) {
    dts[di] = pl.p_ts[g];
    dgslot[di] = pl.p_gslot[g];
    for (int c = 0; c < pl.ncols; ++c) copy_elem(dcol[c], di, pl.p_col[c], g, pl.col_bytes[c]);
  } else {
    long long a = g - s.fill0;
    dts[di] = pl.a_ts[a];
    dgslot[di] = pl.a_gslot[a];
    for (int c = 0; c < pl.ncols; ++c) copy_elem(dcol[c], di, pl.a_col[c], a, pl.col_bytes[c]);
  }
}

__global__ void lb_emit(const BatchPlan pl) {
  long long p = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (p >= pl.cap_out) return;
  const Step s = read_step(pl);
  const long long n = pl.n, per = 2 * n + 1;
  long long shift = (s.pc == 0 && s.nflush > 0) ? n : 0;
  long long n_out = s.nflush > 0 ? s.nflush * per - shift : 0;
  if (p >= n_out) {
    pl.out_ts[p] = 0;
    pl.out_kind[p] = 0;
    pl.out_valid[p] = 0;
    pl.out_seq[p] = 0;
    pl.out_gslot[p] = 0;
    for (int c = 0; c < pl.ncols; ++c) store_bits(pl.out_col[c], p, 0, pl.col_bytes[c]);
    return;
  }
  long long q = p + shift, f = q / per, loc = q % per;
  pl.out_valid[p] = 1;
  pl.out_seq[p] = s.seq0 + f * (2 * n + 2) + loc;
  if (loc == n) {
    pl.out_kind[p] = K_RESET;
    pl.out_ts[p] = pl.now;
    pl.out_gslot[p] = -1;
    for (int c = 0; c < pl.ncols; ++c)
      store_bits(pl.out_col[c], p, pl.reset_val[c], pl.col_bytes[c]);
    return;
  }
  if (loc < n && f == 0) {               // the batch kept from earlier sends
    pl.out_kind[p] = K_EXPIRED;
    pl.out_ts[p] = pl.q_ts[loc];
    pl.out_gslot[p] = pl.q_gslot[loc];
    for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.out_col[c], p, pl.q_col[c], loc, pl.col_bytes[c]);
    return;
  }
  long long g = loc < n ? (f - 1) * n + loc : f * n + loc - n - 1;
  pl.out_kind[p] = loc < n ? K_EXPIRED : K_CURRENT;
  copy_step_row(pl, s, g, pl.out_ts, pl.out_gslot, pl.out_col, p);
}

__global__ void lb_prev(const BatchPlan pl) {
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const Step s = read_step(pl);
  if (i >= pl.n || s.nflush == 0) return;
  copy_step_row(pl, s, (s.nflush - 1) * pl.n + i, pl.q_ts, pl.q_gslot, pl.q_col, i);
}

__global__ void lb_pend(const BatchPlan pl) {
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const Step s = read_step(pl);
  long long g = s.nflush * pl.n + i;
  // a pending row that stays (no flush) is already in place
  if (g >= s.G || g < s.fill0) return;
  copy_step_row(pl, s, g, pl.p_ts, pl.p_gslot, pl.p_col, i);
}

__global__ void lb_finish(const BatchPlan pl) {
  const Step s = read_step(pl);
  pl.meta[0] = s.G - s.nflush * pl.n;
  pl.meta[1] = s.nflush > 0 ? pl.n : s.pc;
  pl.meta[2] = s.seq0 + s.nflush * (2 * pl.n + 2);
}

}  // namespace

extern "C" int siddhi_batch_plan_size() { return (int)sizeof(BatchPlan); }

// Launches on `stream`; returns the launches' cudaError_t (0 = launched).
extern "C" int siddhi_length_batch(const BatchPlan* plan, void* stream) {
  const BatchPlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  if (pl.cap_out > 0)
    lb_emit<<<(unsigned)((pl.cap_out + BLOCK - 1) / BLOCK), BLOCK, 0, s>>>(pl);
  unsigned nb = (unsigned)((pl.n + BLOCK - 1) / BLOCK);
  lb_prev<<<nb, BLOCK, 0, s>>>(pl);
  lb_pend<<<nb, BLOCK, 0, s>>>(pl);
  lb_finish<<<1, 1, 0, s>>>(pl);
  return (int)cudaGetLastError();
}
