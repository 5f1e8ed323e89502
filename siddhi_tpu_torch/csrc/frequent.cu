// frequent: one step of the Misra-Gries frequent window (kernel K19), for
// sm_90a.
//
// Replaces the JAX package's FrequentWindow.process
// (siddhi_tpu/core/window_ext.py:1023: a lax.scan over the batch that
// writes a [B, n + 1] grid of rows, then a sort of the grid by seq), under
// frequent(n, ...) and lossyFrequent(support, ...).  kernels/frequent.py
// states the cases, the rows and their numbering.
//
// Design: the window is sequential by nature (each arrival's case depends
// on every earlier one), so one warp walks the arrivals in batch order.
// The counters' counts and keys lie striped across the lanes (counter j
// on lane j % 32), in shared memory when they fit (else the kernel works
// on them in device memory, so every n the reference accepts runs).  Per
// arrival the warp scans the counters 32 at a time: __ballot_sync of the
// lanes whose counter holds the key (a hit) and of the free ones, __ffs for
// the lowest index; a full miss decrements all counters and writes the
// evicted ones' rows, a lane each, at the running offset plus the
// __popc of the lower lanes' evictions.  Rows go out in seq order at that
// running offset, so nothing is sorted afterwards, and the output is sized
// by the bound 3A + n (not the reference's A * (n + 1) grid).
//
// Bound: the arrivals are read once and each output row written once; the
// counters stay on chip.  What bounds it in fact is the serial scan: a warp
// compares an arrival's key against up to n counters (n / 32 steps) and a
// full miss touches all n; no other SM works.  That is the reference's
// algorithm; a hash of the keys would find a hit without the scan.
#include "rows.cuh"

using namespace siddhi;

namespace {

constexpr int MAX_COLS = 16;
constexpr unsigned FULL = 0xffffffffu;
enum : int { T_I32 = 0, T_I64 = 1, T_F32 = 2, T_F64 = 3, T_BOOL = 4 };

}  // namespace

// Mirrored field for field by kernels/frequent.py (ctypes.Structure).
struct FreqPlan {
  long long n, B, cap;   // B: the batch's capacity; cap: the output's rows
  int ncols, nkeys, shared, pad;   // shared: bytes of counters in shared memory (0: none)
  int col_bytes[MAX_COLS];
  int key_col[MAX_COLS];
  int key_ty[MAX_COLS];
  long long* counts;   // [n]
  long long* keys;     // [n, nkeys]
  long long* s_ts;     // the stored events
  int* s_gslot;
  void* s_col[MAX_COLS];
  long long* meta;     // [seq]
  const long long* a_ts;
  const int* a_gslot;
  const void* a_col[MAX_COLS];
  const long long* a_row;   // each arrival's input row
  const long long* n_arr;
  long long* out_ts;
  int* out_kind;
  long long* out_seq;
  int* out_gslot;
  void* out_col[MAX_COLS];
  long long* n_out;
};

namespace {

__device__ __forceinline__ long long key_word(const FreqPlan& pl, int w, long long i) {
  const void* c = pl.a_col[pl.key_col[w]];
  switch (pl.key_ty[w]) {
    case T_I32: return ((const int*)c)[i];
    case T_I64:
    case T_F64: return ((const long long*)c)[i];
    case T_F32: return f32_key(((const unsigned*)c)[i]);
    default: return ((const unsigned char*)c)[i] != 0;
  }
}

__device__ __forceinline__ void row_from_state(const FreqPlan& pl, long long o, long long ts,
                                               long long seq, long long j) {
  if (o >= pl.cap) return;
  pl.out_ts[o] = ts;
  pl.out_kind[o] = K_EXPIRED;
  pl.out_seq[o] = seq;
  pl.out_gslot[o] = pl.s_gslot[j];
  for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.out_col[c], o, pl.s_col[c], j, pl.col_bytes[c]);
}

__global__ void __launch_bounds__(32) fq_walk(const FreqPlan pl) {
  extern __shared__ long long smem[];
  const int lane = threadIdx.x;
  const long long n = pl.n;
  const int K = pl.nkeys;
  long long* cnt = pl.counts;
  long long* key = pl.keys;
  if (pl.shared) {
    cnt = smem;
    key = smem + n;
    for (long long j = lane; j < n; j += 32) cnt[j] = pl.counts[j];
    for (long long j = lane; j < n * K; j += 32) key[j] = pl.keys[j];
    __syncwarp();
  }
  const long long na = pl.n_arr[0], seq0 = pl.meta[0];
  long long o = 0;
  long long kv[MAX_COLS];
  for (long long q = 0; q < na; ++q) {
    for (int w = 0; w < K; ++w) kv[w] = key_word(pl, w, q);
    const long long base = seq0 + pl.a_row[q] * (n + 1), ts = pl.a_ts[q];
    long long midx = -1, fidx = -1;
    for (long long c0 = 0; c0 < n; c0 += 32) {
      const long long j = c0 + lane;
      bool hit = false, fr = false;
      if (j < n) {
        const long long cj = cnt[j];
        fr = cj == 0;
        if (cj > 0) {
          hit = true;
          for (int w = 0; w < K; ++w)
            if (key[j * K + w] != kv[w]) { hit = false; break; }
        }
      }
      const unsigned bh = __ballot_sync(FULL, hit);
      if (bh) { midx = c0 + __ffs(bh) - 1; break; }
      const unsigned bf = __ballot_sync(FULL, fr);
      if (fidx < 0 && bf) fidx = c0 + __ffs(bf) - 1;
    }
    if (midx >= 0 || fidx >= 0) {
      const long long j = midx >= 0 ? midx : fidx;
      if (midx >= 0) {
        // a hit: the stored event leaves, the arrival replaces it
        if (lane == 0) row_from_state(pl, o, ts, base + j, j);
        ++o;
      }
      __syncwarp();
      if (lane == 0) {
        cnt[j] = midx >= 0 ? cnt[j] + 1 : 1;
        if (midx < 0)
          for (int w = 0; w < K; ++w) key[j * K + w] = kv[w];
        pl.s_ts[j] = ts;
        pl.s_gslot[j] = pl.a_gslot[q];
        for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.s_col[c], j, pl.a_col[c], q, pl.col_bytes[c]);
        if (o < pl.cap) {
          pl.out_ts[o] = ts;
          pl.out_kind[o] = K_CURRENT;
          pl.out_seq[o] = base + n;
          pl.out_gslot[o] = pl.a_gslot[q];
          for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.out_col[c], o, pl.a_col[c], q, pl.col_bytes[c]);
        }
      }
      ++o;
    } else {
      // a full miss: every count - 1, the counters reaching 0 evicted in
      // counter order
      for (long long c0 = 0; c0 < n; c0 += 32) {
        const long long j = c0 + lane;
        bool ev = false;
        if (j < n) {
          const long long cj = cnt[j] - 1;
          cnt[j] = cj;
          ev = cj == 0;
        }
        const unsigned b = __ballot_sync(FULL, ev);
        if (ev) row_from_state(pl, o + __popc(b & ((1u << lane) - 1u)), ts, base + j, j);
        o += __popc(b);
      }
    }
    __syncwarp();
  }
  if (pl.shared) {
    for (long long j = lane; j < n; j += 32) pl.counts[j] = cnt[j];
    for (long long j = lane; j < n * K; j += 32) pl.keys[j] = key[j];
  }
  if (lane == 0) {
    *pl.n_out = o;
    pl.meta[0] = seq0 + pl.B * (n + 1);
  }
}

}  // namespace

extern "C" int siddhi_freq_plan_size() { return (int)sizeof(FreqPlan); }

// Launches on `stream`; returns the launch's cudaError_t (0 = launched).
extern "C" int siddhi_frequent(const FreqPlan* plan, void* stream) {
  const FreqPlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  if (pl.shared > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fq_walk, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.shared);
    if (e != cudaSuccess) return (int)e;
  }
  fq_walk<<<1, 32, pl.shared, s>>>(pl);
  return (int)cudaGetLastError();
}
