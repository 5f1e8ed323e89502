// Row-moving helpers shared by the single-stream kernels: event kinds, a
// block-wide exclusive scan, element copies of columns by width, a
// device-wide exclusive scan and a bitonic sort of (key, index) pairs.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace siddhi {

enum : int { K_CURRENT = 0, K_EXPIRED = 1, K_TIMER = 2, K_RESET = 3 };

// Exclusive scan of one value per thread across a block of exactly BS
// threads (Hillis-Steele over shared memory; `sh` holds 2*BS values).
// Every thread of the block must call it.  Returns the exclusive prefix
// and sets *total to the block's sum.
template <int BS, class T>
__device__ T block_excl_scan(T v, T* sh, T* total) {
  int t = threadIdx.x;
  T* a = sh;
  T* b = sh + BS;
  a[t] = v;
  __syncthreads();
  for (int off = 1; off < BS; off <<= 1) {
    T x = a[t];
    if (t >= off) x += a[t - off];
    b[t] = x;
    __syncthreads();
    T* tmp = a; a = b; b = tmp;
  }
  T incl = a[t];
  *total = a[BS - 1];
  __syncthreads();
  return incl - v;
}

// One element of a column whose elements are `bytes` wide (1, 4 or 8).
__device__ __forceinline__ void copy_elem(void* dst, long long di, const void* src,
                                          long long si, int bytes) {
  if (bytes == 8) ((long long*)dst)[di] = ((const long long*)src)[si];
  else if (bytes == 4) ((int*)dst)[di] = ((const int*)src)[si];
  else ((unsigned char*)dst)[di] = ((const unsigned char*)src)[si];
}

// Element si of a column whose elements are `bytes` wide, as 64 bits (an
// int32 or a float's bits sign-extended, a bool as 0 / 1).
__device__ __forceinline__ long long load_raw(const void* src, long long si, int bytes) {
  if (bytes == 8) return ((const long long*)src)[si];
  if (bytes == 4) return (long long)((const int*)src)[si];
  return (long long)((const unsigned char*)src)[si];
}

// A float32's bits as those of the float64 it converts to; a NaN keeps its
// payload and comes out quiet, as an x86 conversion gives it (the key word
// of a float column in the frequent windows).
__device__ __forceinline__ long long f32_key(unsigned u) {
  if (((u >> 23) & 0xffu) == 0xffu) {
    unsigned long long m = u & 0x7fffffu;
    if (m) m |= 0x400000u;
    return (long long)(((unsigned long long)(u >> 31) << 63) | (0x7ffULL << 52) | (m << 29));
  }
  return __double_as_longlong((double)__uint_as_float(u));
}

__device__ __forceinline__ void store_bits(void* dst, long long di, long long v, int bytes) {
  if (bytes == 8) ((long long*)dst)[di] = v;
  else if (bytes == 4) ((int*)dst)[di] = (int)v;
  else ((unsigned char*)dst)[di] = (unsigned char)(v != 0);
}



constexpr long long BIG_SEQ = 0x1fffffffffffffffLL;   // (2^63 - 1) / 4
constexpr int SCAN_BLOCK = 1024;

// In-place exclusive scan of sums[0, nb) by one block of SCAN_BLOCK
// threads (each thread takes a contiguous run); the total goes to sums[nb].
__global__ void scan_sums_kernel(long long* sums, long long nb) {
  __shared__ long long sh[2 * SCAN_BLOCK];
  long long per = (nb + SCAN_BLOCK - 1) / SCAN_BLOCK;
  long long lo = threadIdx.x * per;
  long long hi = lo + per < nb ? lo + per : nb;
  long long s = 0;
  for (long long j = lo; j < hi; ++j) s += sums[j];
  long long tot;
  long long off = block_excl_scan<SCAN_BLOCK>(s, sh, &tot);
  for (long long j = lo; j < hi; ++j) {
    long long v = sums[j];
    sums[j] = off;
    off += v;
  }
  if (threadIdx.x == 0) sums[nb] = tot;
}

// Block totals of data[0, n) in SCAN_BLOCK-element blocks.
__global__ void block_totals_kernel(const long long* data, long long n, long long* sums) {
  __shared__ long long sh[2 * SCAN_BLOCK];
  long long i = (long long)blockIdx.x * SCAN_BLOCK + threadIdx.x;
  long long tot;
  block_excl_scan<SCAN_BLOCK>(i < n ? data[i] : 0LL, sh, &tot);
  if (threadIdx.x == 0) sums[blockIdx.x] = tot;
}

__global__ void apply_offsets_kernel(long long* data, long long n, const long long* sums) {
  __shared__ long long sh[2 * SCAN_BLOCK];
  long long i = (long long)blockIdx.x * SCAN_BLOCK + threadIdx.x;
  long long tot;
  long long ex = block_excl_scan<SCAN_BLOCK>(i < n ? data[i] : 0LL, sh, &tot);
  if (i < n) data[i] = ex + sums[blockIdx.x];
}

// Device-wide exclusive scan of data[0, n) in place; `sums` holds
// ceil(n / SCAN_BLOCK) + 1 values and ends with the total.
inline void exclusive_scan(long long* data, long long n, long long* sums, cudaStream_t s) {
  long long nb = (n + SCAN_BLOCK - 1) / SCAN_BLOCK;
  if (nb == 0) return;
  block_totals_kernel<<<(unsigned)nb, SCAN_BLOCK, 0, s>>>(data, n, sums);
  scan_sums_kernel<<<1, SCAN_BLOCK, 0, s>>>(sums, nb);
  apply_offsets_kernel<<<(unsigned)nb, SCAN_BLOCK, 0, s>>>(data, n, sums);
}

// One compare-exchange step of a bitonic sort of (key, val) pairs, ordered
// by key then val (so equal keys keep their val order: a stable sort when
// val is the original index).  n is a power of two.
__global__ void bitonic_step_kernel(long long* keys, int* vals, long long n, long long j,
                                    long long k) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long ixj = i ^ j;
  if (ixj <= i) return;
  long long ki = keys[i], kj = keys[ixj];
  int vi = vals[i], vj = vals[ixj];
  bool gt = (ki > kj) || (ki == kj && vi > vj);
  bool up = (i & k) == 0;
  if (gt == up) {
    keys[i] = kj; keys[ixj] = ki;
    vals[i] = vj; vals[ixj] = vi;
  }
}

inline void bitonic_sort(long long* keys, int* vals, long long n, cudaStream_t s) {
  unsigned blocks = (unsigned)((n + 255) / 256);
  for (long long k = 2; k <= n; k <<= 1)
    for (long long j = k >> 1; j > 0; j >>= 1)
      bitonic_step_kernel<<<blocks, 256, 0, s>>>(keys, vals, n, j, k);
}

}  // namespace siddhi
