// agg_merge: one send's base values merged into every duration's bucket
// slab of an incremental aggregation (kernel K28), for sm_90a.
//
// Replaces the JAX package's aggregation `merge`
// (siddhi_tpu/core/aggregation.py:510-525), run there once per duration:
// vals f64 [n_base, B] merge into slab f64 [D, n_base, cap] at slots i32
// [D, B], a slot of -1 dropping the row; each base merges by its kind
// (add, min or max as XLA computes them: NaN wins, -0.0 is below +0.0).
//
// The trap is the sum order: XLA's CPU scatter applies a slot's updates in
// row order, ((s + v0) + v1) + ..., and f64 addition is not associative,
// so atomics cannot reproduce it.  Design: the (duration, row) pairs that
// have a slot are compacted in (duration, row) order (a flag scan), sorted
// by the key duration * cap + slot with radix.cuh's stable LSD radix sort,
// so each slot's rows keep their row order, and one thread per
// (duration, slot) segment walks its rows in that order for every base,
// reading the slab word once and writing it once.
//
// Bound: the slots and values are read once and each touched slab word is
// read and written once; the sort's passes move the pairs a few times
// more.  Bound by bytes.
#include "radix.cuh"

using namespace siddhi;

namespace {

constexpr int MAX_BASE = 16;
constexpr int BLOCK = 256;

}  // namespace

// Mirrored field for field by kernels/agg_merge.py (ctypes.Structure).
struct MergePlan {
  long long B, cap;
  int D, nbase, bits, pad;
  int kind[MAX_BASE];
  const int* slots;       // [D, B]
  const double* vals;     // [nbase, B]
  double* slab;           // [D, nbase, cap]
  long long* flags;       // [D * B]: has a slot, then its exclusive scan
  long long* sums;        // the scan's block sums, the total last
  unsigned long long* key[2];
  int* idx[2];
  long long* hist;
  long long* hist_sums;
};

namespace {

__device__ __forceinline__ double xla_min(double a, double b) {
  bool take_b = (b < a) || (b == a && signbit(b)) || isnan(b);
  return (take_b && !isnan(a)) ? b : a;
}

__device__ __forceinline__ double xla_max(double a, double b) {
  bool take_b = (b > a) || (b == a && signbit(a)) || isnan(b);
  return (take_b && !isnan(a)) ? b : a;
}

__global__ void am_flags(const MergePlan pl, long long n) {
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i < n) pl.flags[i] = pl.slots[i] >= 0 ? 1 : 0;
}

// Pair i = d * B + row with a slot goes to its scanned place, keyed by
// d * cap + slot.
__global__ void am_compact(const MergePlan pl, long long n) {
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  int s = pl.slots[i];
  if (s < 0) return;
  long long d = i / pl.B;
  long long p = pl.flags[i];
  pl.key[0][p] = (unsigned long long)(d * pl.cap + s);
  pl.idx[0][p] = (int)i;
}

// One thread per segment head walks the segment's rows in order.
__global__ void am_walk(const MergePlan pl, const long long* n_p, int cur, long long cap_pairs) {
  long long j = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const long long n = *n_p;
  if (j >= n || j >= cap_pairs) return;
  const unsigned long long* key = pl.key[cur];
  const int* idx = pl.idx[cur];
  unsigned long long k = key[j];
  if (j > 0 && key[j - 1] == k) return;
  long long end = j + 1;
  while (end < n && key[end] == k) ++end;
  long long d = (long long)(k / (unsigned long long)pl.cap);
  long long slot = (long long)(k % (unsigned long long)pl.cap);
  for (int b = 0; b < pl.nbase; ++b) {
    double* w = pl.slab + (d * pl.nbase + b) * pl.cap + slot;
    const double* v = pl.vals + (long long)b * pl.B;
    double acc = *w;
    int kd = pl.kind[b];
    for (long long m = j; m < end; ++m) {
      double x = v[idx[m] % pl.B];
      acc = kd == 0 ? __dadd_rn(acc, x) : kd == 1 ? xla_min(acc, x) : xla_max(acc, x);
    }
    *w = acc;
  }
}

}  // namespace

extern "C" int siddhi_agg_merge_plan_size() { return (int)sizeof(MergePlan); }

// Launch on `stream`; returns the last launch's cudaError_t (0 = launched).
extern "C" int siddhi_agg_merge(const MergePlan* plan, void* stream) {
  const MergePlan& pl = *plan;
  long long n = (long long)pl.D * pl.B;
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned nb = (unsigned)((n + BLOCK - 1) / BLOCK);
  am_flags<<<nb, BLOCK, 0, s>>>(pl, n);
  exclusive_scan(pl.flags, n, pl.sums, s);
  am_compact<<<nb, BLOCK, 0, s>>>(pl, n);
  const long long* n_p = pl.sums + (n + SCAN_BLOCK - 1) / SCAN_BLOCK;
  int cur = radix_sort(pl.key, pl.idx, 0, n_p, n, pl.bits, pl.hist, pl.hist_sums, s);
  am_walk<<<nb, BLOCK, 0, s>>>(pl, n_p, cur, n);
  return (int)cudaGetLastError();
}
