// length_window: the sliding length window of a single-stream query or of
// a join side, for sm_90a.
//
// Replaces, in the JAX package's jitted step:
//   siddhi_tpu/core/window.py  LengthWindow.process (:249-316) with its
//   sort_rows / concat_rows
// The reference argsorts and gathers the whole buffer every step.  Here
// the window is a ring in add_seq order with alive rows at logical
// [head, tail), and a step is closed-form in the arrival index k (see
// kernels/length_window.py): arrival k evicts virtual entry
// count0 + k - C (an old ring row, or, when the batch is longer than the
// window, an earlier arrival of the same batch), EXPIRED k lands at
// k0 + 2(k - k0) and CURRENT k right after it (k0 = max(0, C - count0)
// arrivals evict nothing and land at k), seq = seq0 + 2k (+1).
//
// Bound: each arrival is read once and written once as a CURRENT row (and
// once into the ring if it is among the last C); each evicted row is read
// once and written once as an EXPIRED row; no sort, no pass over the ring.
// The step is bound by those bytes.  Design: one thread per arrival in
// three launches, because an arrival of a batch longer than the window
// overwrites the ring slot that an earlier arrival's EXPIRED row reads:
// emit every output row first, then store the last C arrivals, then move
// the counters.
#include "rows.cuh"

using namespace siddhi;

namespace {

constexpr int MAX_COLS = 16;
constexpr int BLOCK = 256;

}  // namespace

// Mirrored field for field by kernels/length_window.py (ctypes.Structure).
struct LengthPlan {
  long long C, B;
  int ncols;
  int col_bytes[MAX_COLS];
  long long* ts;
  int* gslot;
  void* col[MAX_COLS];
  long long* meta;                 // [head, tail, seq, 0]
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

__global__ void lw_emit(const LengthPlan pl) {
  long long k = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (k >= pl.B) return;
  const long long C = pl.C;
  const long long head = pl.meta[0], tail = pl.meta[1], seq0 = pl.meta[2];
  const long long n = pl.n_arr[0];
  const long long count0 = tail - head;
  const long long k0 = C - count0 > 0 ? C - count0 : 0;
  const long long nvalid = n + (n > k0 ? n - k0 : 0);
  for (int q = 0; q < 2; ++q)
    if (2 * k + q >= nvalid) pl.out_valid[2 * k + q] = 0;
  if (k >= n) return;
  long long cpos = k;
  if (k >= k0) {
    const long long epos = k0 + 2 * (k - k0);
    cpos = epos + 1;
    const long long v = count0 + k - C;      // the virtual entry evicted
    if (v < count0) {
      const long long r = (head + v) % C;
      pl.out_ts[epos] = pl.ts[r];
      pl.out_gslot[epos] = pl.gslot[r];
      for (int c = 0; c < pl.ncols; ++c)
        copy_elem(pl.out_col[c], epos, pl.col[c], r, pl.col_bytes[c]);
    } else {
      const long long a = v - count0;
      pl.out_ts[epos] = pl.a_ts[a];
      pl.out_gslot[epos] = pl.a_gslot[a];
      for (int c = 0; c < pl.ncols; ++c)
        copy_elem(pl.out_col[c], epos, pl.a_col[c], a, pl.col_bytes[c]);
    }
    pl.out_kind[epos] = K_EXPIRED;
    pl.out_valid[epos] = 1;
    pl.out_seq[epos] = seq0 + 2 * k;
  }
  pl.out_ts[cpos] = pl.a_ts[k];
  pl.out_kind[cpos] = K_CURRENT;
  pl.out_valid[cpos] = 1;
  pl.out_seq[cpos] = seq0 + 2 * k + 1;
  pl.out_gslot[cpos] = pl.a_gslot[k];
  for (int c = 0; c < pl.ncols; ++c)
    copy_elem(pl.out_col[c], cpos, pl.a_col[c], k, pl.col_bytes[c]);
}

__global__ void lw_store(const LengthPlan pl) {
  long long k = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const long long n = pl.n_arr[0];
  if (k >= n || k < n - pl.C) return;
  const long long tail = pl.meta[1];
  const long long d = (tail + k) % pl.C;
  pl.ts[d] = pl.a_ts[k];
  pl.gslot[d] = pl.a_gslot[k];
  for (int c = 0; c < pl.ncols; ++c)
    copy_elem(pl.col[c], d, pl.a_col[c], k, pl.col_bytes[c]);
}

__global__ void lw_finish(const LengthPlan pl) {
  const long long n = pl.n_arr[0];
  const long long head = pl.meta[0], tail = pl.meta[1];
  const long long total = tail - head + n;
  const long long tail2 = tail + n;
  pl.meta[0] = tail2 - (total < pl.C ? total : pl.C);
  pl.meta[1] = tail2;
  pl.meta[2] += 2 * n;
}

}  // namespace

extern "C" int siddhi_length_plan_size() { return (int)sizeof(LengthPlan); }

// Launches on `stream`; returns the launches' cudaError_t (0 = launched).
extern "C" int siddhi_length_window(const LengthPlan* plan, void* stream) {
  const LengthPlan& pl = *plan;
  if (pl.B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned nb = (unsigned)((pl.B + BLOCK - 1) / BLOCK);
  lw_emit<<<nb, BLOCK, 0, s>>>(pl);
  lw_store<<<nb, BLOCK, 0, s>>>(pl);
  lw_finish<<<1, 1, 0, s>>>(pl);
  return (int)cudaGetLastError();
}
