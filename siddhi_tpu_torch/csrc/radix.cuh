// A stable LSD radix sort of (key, index) pairs over 8-bit digits, shared
// by group_agg (K4: the group slots beyond MAX_SLOTS), ext_window (K16),
// sort_window (K17) and agg_merge (K28).
//
// Each pass: a digit histogram per tile of RADIX_TILE pairs, one scan of
// the (digit, tile) counts in digit-major order, and a stable scatter in
// which each warp ranks its pairs with __match_any_sync and the tile's
// warps and rounds are counted in order, so equal digits keep their input
// order.  The pair count lives on the device (`n_p`); the launches are
// sized by its upper bound `cap`.
#pragma once

#include "rows.cuh"

namespace siddhi {

constexpr int RADIX_BLOCK = 256;
constexpr int RADIX_ROUNDS = 8;
constexpr int RADIX_TILE = RADIX_BLOCK * RADIX_ROUNDS;
constexpr int RADIX_WARPS = RADIX_BLOCK / 32;
constexpr int RADIX = 256;

// Digit counts of each tile, digit-major: hist[d * tiles + tile].
__global__ void radix_hist_kernel(const unsigned long long* key, const long long* n_p, int shift,
                                  long long* hist, long long tiles) {
  __shared__ int h[RADIX];
  h[threadIdx.x] = 0;
  __syncthreads();
  const long long n = *n_p;
  const long long base = (long long)blockIdx.x * RADIX_TILE;
  for (int k = 0; k < RADIX_ROUNDS; ++k) {
    long long j = base + k * RADIX_BLOCK + threadIdx.x;
    if (j < n) atomicAdd(&h[(key[j] >> shift) & 0xff], 1);
  }
  __syncthreads();
  hist[(long long)threadIdx.x * tiles + blockIdx.x] = h[threadIdx.x];
}

// Stable scatter of (key, index) pairs by one digit, at the offsets of
// the scanned histogram.
__global__ void radix_scatter_kernel(const unsigned long long* key_in, const int* idx_in,
                                     unsigned long long* key_out, int* idx_out,
                                     const long long* n_p, int shift, const long long* hist,
                                     long long tiles) {
  __shared__ int wc[RADIX_WARPS][RADIX];
  __shared__ int run[RADIX];
  __shared__ long long off[RADIX];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  run[t] = 0;
  const long long n = *n_p;
  const long long base = (long long)blockIdx.x * RADIX_TILE;
  off[t] = hist[(long long)t * tiles + blockIdx.x];
  for (int k = 0; k < RADIX_ROUNDS; ++k) {
    for (int w = 0; w < RADIX_WARPS; ++w) wc[w][t] = 0;
    __syncthreads();
    long long j = base + k * RADIX_BLOCK + t;
    bool live = j < n;
    unsigned long long kv = live ? key_in[j] : 0;
    int d = live ? (int)((kv >> shift) & 0xff) : RADIX;
    unsigned peers = __match_any_sync(0xffffffffu, d);
    int rank = __popc(peers & ((1u << lane) - 1u));
    if (live && rank == 0) wc[warp][d] = __popc(peers);
    __syncthreads();
    // per digit t: the warps' exclusive offsets, after the earlier rounds
    int acc = run[t];
    for (int w = 0; w < RADIX_WARPS; ++w) {
      int c = wc[w][t];
      wc[w][t] = acc;
      acc += c;
    }
    run[t] = acc;
    __syncthreads();
    if (live) {
      long long dst = off[d] + wc[warp][d] + rank;
      key_out[dst] = kv;
      idx_out[dst] = idx_in[j];
    }
    __syncthreads();
  }
}

// The tiles of `cap` pairs; `hist` holds RADIX * tiles values and
// `hist_sums` ceil(RADIX * tiles / SCAN_BLOCK) + 1.
inline long long radix_tiles(long long cap) { return (cap + RADIX_TILE - 1) / RADIX_TILE; }

// Sorts the *n_p pairs (at most cap) in buffer `cur` by the low `bits`
// bits of their keys, stably, one pass per 8 bits, ping-ponging between
// the two buffers; returns the buffer that holds the result.
inline int radix_sort(unsigned long long* const* key, int* const* idx, int cur,
                      const long long* n_p, long long cap, int bits, long long* hist,
                      long long* hist_sums, cudaStream_t s) {
  long long tiles = radix_tiles(cap);
  if (tiles == 0) return cur;
  for (int shift = 0; shift < bits; shift += 8) {
    radix_hist_kernel<<<(unsigned)tiles, RADIX_BLOCK, 0, s>>>(key[cur], n_p, shift, hist, tiles);
    exclusive_scan(hist, RADIX * tiles, hist_sums, s);
    radix_scatter_kernel<<<(unsigned)tiles, RADIX_BLOCK, 0, s>>>(
        key[cur], idx[cur], key[1 - cur], idx[1 - cur], n_p, shift, hist, tiles);
    cur = 1 - cur;
  }
  return cur;
}

}  // namespace siddhi
