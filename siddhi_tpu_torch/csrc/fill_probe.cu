// fill_probe: the state observatory's window-fill probe, for sm_90a
// (kernel K33).
//
// Replaces the JAX package's sampled fill reduction
// (siddhi_tpu/observability/stateobs.py _probe, built by _probe_fn: one
// jitted sum of each window Buffer's `alive` mask, stacked into int32[n]).
//
// The port's window states hold their fill in one of three forms, one
// descriptor a JAX leaf (kernels/fill_probe.py FillSource):
//   MASK   count the nonzero elements of a 1- or 8-byte array (a mask, or a
//          frequent window's counters: alive where the count is > 0);
//   COUNT  one 4- or 8-byte counter (a batch's fill in its `meta`);
//   DIFF   the difference of two counters (a ring's tail - head).
// One launch takes the whole descriptor table by value (a
// __grid_constant__ plan, as K30's ring_append takes its leaf pointers), so
// the probe adds no host-to-device copy.  The output int64[n] is zeroed
// with a memset on the same stream; a grid (chunks, leaves) then counts: a
// MASK leaf's blocks read 16 bytes a thread a step, reduce in the warp and
// in the block, and add one integer per block (integer sums: the same
// result in any order); a counter leaf's block (0, l) stores its value.
//
// Bound: a MASK leaf reads its bytes once; counter leaves read a few bytes
// and are launch-bound.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_SOURCES = 16;
constexpr int BLOCK = 256;
constexpr int KIND_MASK = 0, KIND_COUNT = 1, KIND_DIFF = 2;

}  // namespace

// Mirrored by kernels/fill_probe.py (ctypes.Structure).
struct FillPlan {
  int n;
  int kind[MAX_SOURCES];
  int esize[MAX_SOURCES];         // element bytes: 1 or 8 (MASK), 4 or 8
  long long nelem[MAX_SOURCES];   // MASK: elements to count
  const void* a[MAX_SOURCES];     // MASK: the array; COUNT / DIFF: counter
  const void* b[MAX_SOURCES];     // DIFF: the counter subtracted
  long long* out;                 // int64[n]
};

static_assert(sizeof(FillPlan) <= 4000, "FillPlan must fit the kernel parameter space");

namespace {

__device__ __forceinline__ long long load_counter(const void* p, int esize) {
  return esize == 4 ? (long long)*(const int*)p : *(const long long*)p;
}

__device__ __forceinline__ int nz_bytes(unsigned w) {
  return __popc(__vcmpne4(w, 0u)) >> 3;
}

__global__ void fill_probe_kernel(const __grid_constant__ FillPlan pl) {
  __shared__ long long warp_sums[BLOCK / 32];
  const int l = blockIdx.y;
  const int kind = pl.kind[l];
  if (kind != KIND_MASK) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      long long v = load_counter(pl.a[l], pl.esize[l]);
      if (kind == KIND_DIFF) v -= load_counter(pl.b[l], pl.esize[l]);
      pl.out[l] = v;
    }
    return;
  }
  const int es = pl.esize[l];
  const long long nbytes = pl.nelem[l] * es;
  const unsigned char* base = (const unsigned char*)pl.a[l];
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long cnt = 0;
  const bool v16 = ((unsigned long long)base % 16 == 0);
  const long long body = v16 ? nbytes / 16 : 0;
  const uint4* p4 = (const uint4*)base;
  for (long long i = t0; i < body; i += stride) {
    const uint4 v = p4[i];
    if (es == 1) {
      cnt += nz_bytes(v.x) + nz_bytes(v.y) + nz_bytes(v.z) + nz_bytes(v.w);
    } else {
      cnt += ((v.x | v.y) != 0u) + ((v.z | v.w) != 0u);
    }
  }
  // the tail past the last whole 16 bytes (or everything, unaligned)
  for (long long e = body * 16 / es + t0; e < pl.nelem[l]; e += stride) {
    if (es == 1) cnt += base[e] != 0;
    else cnt += ((const long long*)base)[e] != 0;
  }
  int c32 = (int)cnt;
  c32 = __reduce_add_sync(0xffffffffu, c32);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = c32;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long s = 0;
    for (int w = 0; w < BLOCK / 32; ++w) s += warp_sums[w];
    if (s) atomicAdd((unsigned long long*)&pl.out[l], (unsigned long long)s);
  }
}

}  // namespace

extern "C" int siddhi_fill_probe_plan_size() { return (int)sizeof(FillPlan); }

// Launches on `stream`; returns the launch's cudaError_t (0 = launched).
extern "C" int siddhi_fill_probe(const FillPlan* plan, void* stream) {
  const FillPlan& pl = *plan;
  if (pl.n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(pl.out, 0, sizeof(long long) * pl.n, s);
  if (err != cudaSuccess) return (int)err;
  long long most = 1;
  for (int l = 0; l < pl.n; ++l)
    if (pl.kind[l] == KIND_MASK) {
      long long units = (pl.nelem[l] * pl.esize[l] + 15) / 16;
      most = units > most ? units : most;
    }
  long long blocks = (most + BLOCK - 1) / BLOCK;
  blocks = blocks < 1 ? 1 : (blocks > 1056 ? 1056 : blocks);
  dim3 grid((unsigned)blocks, (unsigned)pl.n);
  fill_probe_kernel<<<grid, BLOCK, 0, s>>>(pl);
  return (int)cudaGetLastError();
}
