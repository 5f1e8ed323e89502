// join_lanes: the per-bucket candidate lane table of an equi-join side,
// for sm_90a.
//
// Replaces, in the JAX package's jitted join step:
//   siddhi_tpu/core/join.py  _bucket_lanes (:775-792)
// which argsorts the side's whole buffer by bucket every step.  Every row
// alive in the ring (logical offset j from the head) goes to bucket
// jslot % nbl; lane b holds its rows' offsets ascending, C where empty.
// Rows past lane width k are counted into the header's lane-overflow
// word instead of being dropped silently.
//
// Bound: the key-slot column of the live rows is read (4 B a row) and the
// [nbl, k] table written (4 B an entry); at 2^20 live rows, 2^17 buckets
// and k = 32 the table's 16 MB dominate, so the build is bound by bytes.
// Design: no sort.  A counting pass (one atomic add a row), a device-wide
// exclusive scan of the bucket counts, a placement pass that drops each
// row into its bucket's segment at an atomic (unordered) position, then a
// ranking pass: each row's rank is the number of smaller offsets in its
// segment (buckets hold about 8 rows under a uniform key spread), which
// orders every lane whatever order the atomics gave, and so makes the
// table, overflow included, the same on every run.  Atomics are integer
// adds, so no result depends on their order.
#include "rows.cuh"

using namespace siddhi;

namespace {

constexpr int BLOCK = 256;

}  // namespace

// Mirrored field for field by kernels/join_lanes.py (ctypes.Structure).
struct LanePlan {
  long long C, nbl, k;
  const int* jslot;          // the ring's key-slot column [C]
  const long long* meta;     // [head, tail, ...]
  int* lanes;                // [nbl * k]
  long long* cnt;            // [nbl + 1] counts, then exclusive offsets
  int* fill;                 // [nbl]
  int* tmp;                  // [C] rows grouped by bucket
  long long* sums;           // block sums of the scan
  long long* overflow;       // one header word
};

namespace {

__device__ __forceinline__ long long bucket_of(const LanePlan& pl, long long j, long long head) {
  long long s = pl.jslot[(head + j) % pl.C];
  long long b = s % pl.nbl;
  return b < 0 ? b + pl.nbl : b;
}

__global__ void ln_init(const LanePlan pl) {
  long long t = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (t < pl.nbl * pl.k) pl.lanes[t] = (int)pl.C;
  if (t <= pl.nbl) pl.cnt[t] = 0;
  if (t < pl.nbl) pl.fill[t] = 0;
  if (t == 0) pl.overflow[0] = 0;
}

__global__ void ln_count(const LanePlan pl) {
  long long j = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const long long head = pl.meta[0];
  if (j >= pl.meta[1] - head) return;
  atomicAdd((unsigned long long*)&pl.cnt[bucket_of(pl, j, head)], 1ull);
}

__global__ void ln_place(const LanePlan pl) {
  long long j = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const long long head = pl.meta[0];
  if (j >= pl.meta[1] - head) return;
  long long b = bucket_of(pl, j, head);
  long long pos = pl.cnt[b] + atomicAdd(&pl.fill[b], 1);
  pl.tmp[pos] = (int)j;
}

__global__ void ln_rank(const LanePlan pl) {
  long long j = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const long long head = pl.meta[0];
  if (j >= pl.meta[1] - head) return;
  long long b = bucket_of(pl, j, head);
  long long lo = pl.cnt[b], hi = pl.cnt[b + 1];
  long long rank = 0;
  for (long long e = lo; e < hi; ++e) rank += pl.tmp[e] < j;
  if (rank < pl.k) pl.lanes[b * pl.k + rank] = (int)j;
  else atomicAdd((unsigned long long*)pl.overflow, 1ull);
}

}  // namespace

extern "C" int siddhi_lane_plan_size() { return (int)sizeof(LanePlan); }

// Launches on `stream`; returns the launches' cudaError_t (0 = launched).
extern "C" int siddhi_join_lanes(const LanePlan* plan, void* stream) {
  const LanePlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  long long init_n = pl.nbl * pl.k > pl.nbl + 1 ? pl.nbl * pl.k : pl.nbl + 1;
  ln_init<<<(unsigned)((init_n + BLOCK - 1) / BLOCK), BLOCK, 0, s>>>(pl);
  unsigned nb = (unsigned)((pl.C + BLOCK - 1) / BLOCK);
  ln_count<<<nb, BLOCK, 0, s>>>(pl);
  exclusive_scan(pl.cnt, pl.nbl + 1, pl.sums, s);
  ln_place<<<nb, BLOCK, 0, s>>>(pl);
  ln_rank<<<nb, BLOCK, 0, s>>>(pl);
  return (int)cudaGetLastError();
}
