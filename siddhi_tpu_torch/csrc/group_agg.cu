// group_agg: the selector's aggregation scans, for sm_90a.
//
// Replaces the JAX package's AggregatorBank.process
// (siddhi_tpu/core/selector.py:320, with _segmented_scan at :61): for each
// accumulator spec, the inclusive scan of its op (add on i64/f32, min and
// max on i32/i64/f32) over the contributing rows (sign != 0) of each
// (group slot, reset epoch) segment in seq order, with the carry state of
// the slot folded into the head of its epoch-0 segment; and the new state
// per slot (the value after its last row of the final epoch, else the
// identity if a RESET occurred, else the old value).  Rows that contribute
// nothing get the identity.
//
// Design: a stable counting sort by slot instead of the reference's
// argsort of slot*(B+2)+epoch.  Each 1024-row tile counts its rows per
// slot (shared-memory atomics; only counts, so order does not matter); a
// device-wide scan of the (slot, tile) counts in slot-major order gives
// each tile's first place per slot; each tile then sorts its (slot, row)
// keys in shared memory (bitonic: keys are distinct, so the order within
// a slot is the row order) and scatters.  Epochs in seq order come from
// a scan of the tiles' RESET counts.  One thread per segment then walks
// its segment left to right, so float sums add in seq order, exactly as
// the plain version does.
//
// Run mode (siddhi_group_agg_runs) takes rows whose (slot, epoch)
// segments are each one run of consecutive contributing rows, as a keyed
// window's key-major rows grouped by the partition key are: the
// contributing rows are compacted in row order (a tile count, a scan, a
// scatter) instead of sorted, so no [K] histogram limits the slots.
//
// Radix mode (siddhi_group_agg_radix) takes more than MAX_SLOTS slots in
// any row order: the contributing rows are compacted in row order as in
// run mode, then sorted by slot with the stable LSD radix sort of
// radix.cuh (one 8-bit pass per byte of K - 1), so each slot's rows stay
// in seq order and its epochs ascend; the same walk follows.  The slot
// bits the passes take are those of an int32 slot, so K has no limit
// below the allocator's.
//
// Bound: each row's sign, kind, valid flag, slot and contributions are
// read once and its results written once, plus the [K] states; the
// counting sort adds its permutation and a K x tiles count matrix.
// Bound by bytes; segments walk serially, so a step whose rows fall in
// few segments (one slot, no RESET) is latency-bound instead.
#include <cassert>

#include "bytecode.cuh"
#include "radix.cuh"
#include "rows.cuh"

using namespace siddhi;

namespace {

constexpr int MAX_SPECS = 16;
constexpr int TILE = 1024;
constexpr int BLOCK = 256;
constexpr unsigned NO_KEY = 0xffffffffu;

enum : int { OP_ADD = 0, OP_MIN = 1, OP_MAX = 2 };
enum : int { D_I32 = 0, D_I64 = 1, D_F32 = 2 };

}  // namespace

// Mirrored field for field by kernels/group_agg.py (ctypes.Structure).
struct AggPlan {
  long long B, K;
  int nspec, ntiles;
  int op[MAX_SPECS];
  int dt[MAX_SPECS];
  long long init[MAX_SPECS];
  const int* sign;
  const int* kind;
  const unsigned char* valid;
  const int* gslot;
  const void* vals[MAX_SPECS];
  const void* state[MAX_SPECS];
  void* new_state[MAX_SPECS];
  void* res[MAX_SPECS];
  long long* hist;         // [K * ntiles] counts, then their exclusive scan
  long long* hist_sums;
  long long* tile_resets;  // [ntiles + 1]
  int* perm;               // sorted place -> row
  int* s_slot;
  int* s_epoch;
  // radix mode: the compacted rows in row order, the (slot, place) pairs
  // and the radix histogram
  int* r_perm;
  int* r_slot;
  int* r_epoch;
  unsigned long long* r_key[2];
  int* r_idx[2];
  long long* r_hist;
  long long* r_hist_sums;
};

namespace {

__device__ __forceinline__ int width(int dt) { return dt == D_I64 ? 8 : 4; }

__device__ __forceinline__ long long load_v(const void* p, long long i, int dt) {
  return dt == D_I64 ? ((const long long*)p)[i] : (long long)((const int*)p)[i];
}

__device__ long long combine(int op, int dt, long long a, long long b) {
  if (dt == D_F32) {
    float x = as_f(a), y = as_f(b), r;
    if (op == OP_ADD) r = __fadd_rn(x, y);
    else if (x != x || y != y) r = __int_as_float(0x7fc00000);   // NaN propagates
    else r = op == OP_MIN ? fminf(x, y) : fmaxf(x, y);
    return from_f(r);
  }
  if (dt == D_I64) {
    if (op == OP_ADD) return (long long)((unsigned long long)a + (unsigned long long)b);
    return op == OP_MIN ? (a < b ? a : b) : (a > b ? a : b);
  }
  int x = (int)a, y = (int)b;
  if (op == OP_ADD) return (long long)(int)((unsigned)x + (unsigned)y);
  return (long long)(op == OP_MIN ? (x < y ? x : y) : (x > y ? x : y));
}

__device__ __forceinline__ bool active(const AggPlan& pl, long long i, int* slot) {
  if (i >= pl.B || pl.sign[i] == 0) return false;
  int g = pl.gslot[i];
  // slots come from an allocator of K slots; a larger one is a fault that
  // stops the kernel, as torch's own index check stops the plain version
  assert(g < pl.K);
  *slot = g < 0 ? 0 : g;
  return true;
}

__device__ __forceinline__ long long is_reset(const AggPlan& pl, long long i) {
  return i < pl.B && pl.valid[i] && pl.kind[i] == K_RESET;
}

__global__ void ag_tile(const AggPlan pl) {
  extern __shared__ int cnt[];       // [K]
  __shared__ long long sh[2 * TILE];
  int t = threadIdx.x, tile = blockIdx.x;
  for (long long s = t; s < pl.K; s += TILE) cnt[s] = 0;
  __syncthreads();
  long long i = (long long)tile * TILE + t;
  int slot = 0;
  if (active(pl, i, &slot)) {
    atomicAdd(&cnt[slot], 1);
  } else if (i < pl.B) {
    for (int j = 0; j < pl.nspec; ++j) store_bits(pl.res[j], i, pl.init[j], width(pl.dt[j]));
  }
  long long tot;
  block_excl_scan<TILE>(is_reset(pl, i), sh, &tot);
  if (t == 0) pl.tile_resets[tile] = tot;
  for (long long s = t; s < pl.K; s += TILE) pl.hist[s * pl.ntiles + tile] = cnt[s];
}

__global__ void ag_scatter(const AggPlan pl) {
  extern __shared__ int start[];     // [K]
  __shared__ unsigned keys[TILE];
  __shared__ int ep[TILE];
  __shared__ long long sh[2 * TILE];
  int t = threadIdx.x, tile = blockIdx.x;
  long long i = (long long)tile * TILE + t;
  long long tot;
  ep[t] = (int)(pl.tile_resets[tile] + block_excl_scan<TILE>(is_reset(pl, i), sh, &tot));
  int slot = 0;
  keys[t] = active(pl, i, &slot) ? ((unsigned)slot << 10) | (unsigned)t : NO_KEY;
  __syncthreads();
  for (int k = 2; k <= TILE; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      int ixj = t ^ j;
      if (ixj > t) {
        unsigned a = keys[t], b = keys[ixj];
        bool up = (t & k) == 0;
        if ((a > b) == up) { keys[t] = b; keys[ixj] = a; }
      }
      __syncthreads();
    }
  }
  unsigned key = keys[t];
  if (key != NO_KEY && (t == 0 || (keys[t - 1] >> 10) != (key >> 10))) start[key >> 10] = t;
  __syncthreads();
  if (key == NO_KEY) return;
  int s = (int)(key >> 10), li = (int)(key & 1023u);
  long long dst = pl.hist[(long long)s * pl.ntiles + tile] + (t - start[s]);
  pl.perm[dst] = tile * TILE + li;
  pl.s_slot[dst] = s;
  pl.s_epoch[dst] = ep[li];
}

__global__ void ag_state_init(const AggPlan pl) {
  long long s = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (s >= pl.K) return;
  bool reset = pl.tile_resets[pl.ntiles] > 0;
  for (int j = 0; j < pl.nspec; ++j) {
    int w = width(pl.dt[j]);
    if (reset) store_bits(pl.new_state[j], s, pl.init[j], w);
    else copy_elem(pl.new_state[j], s, pl.state[j], s, w);
  }
}

// Run mode: each tile's contributing rows and RESET rows counted (and the
// identity written for the others) ...
__global__ void ag_runs_count(const AggPlan pl) {
  __shared__ long long sh[2 * TILE];
  int t = threadIdx.x, tile = blockIdx.x;
  long long i = (long long)tile * TILE + t;
  int slot = 0;
  long long act = active(pl, i, &slot) ? 1 : 0;
  if (!act && i < pl.B)
    for (int j = 0; j < pl.nspec; ++j) store_bits(pl.res[j], i, pl.init[j], width(pl.dt[j]));
  long long tot;
  block_excl_scan<TILE>(act, sh, &tot);
  if (t == 0) pl.hist[tile] = tot;
  block_excl_scan<TILE>(is_reset(pl, i), sh, &tot);
  if (t == 0) pl.tile_resets[tile] = tot;
}

// ... then, after both scans, placed in row order with their epochs.
__global__ void ag_runs_scatter(const AggPlan pl) {
  __shared__ long long sh[2 * TILE];
  int t = threadIdx.x, tile = blockIdx.x;
  long long i = (long long)tile * TILE + t;
  int slot = 0;
  long long act = active(pl, i, &slot) ? 1 : 0;
  long long tot;
  long long dst = pl.hist[tile] + block_excl_scan<TILE>(act, sh, &tot);
  long long ep = pl.tile_resets[tile] + block_excl_scan<TILE>(is_reset(pl, i), sh, &tot);
  if (!act) return;
  pl.perm[dst] = (int)i;
  pl.s_slot[dst] = slot;
  pl.s_epoch[dst] = (int)ep;
}

// Radix mode: the (slot, place) pairs of the compacted rows ...
__global__ void ag_radix_keys(const AggPlan pl) {
  long long j = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (j >= pl.hist[pl.ntiles]) return;
  pl.r_key[0][j] = (unsigned long long)(unsigned)pl.r_slot[j];
  pl.r_idx[0][j] = (int)j;
}

// ... and, once sorted by slot, the rows, slots and epochs in that order.
__global__ void ag_radix_gather(const AggPlan pl, int cur) {
  long long p = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (p >= pl.hist[pl.ntiles]) return;
  int j = pl.r_idx[cur][p];
  pl.perm[p] = pl.r_perm[j];
  pl.s_slot[p] = pl.r_slot[j];
  pl.s_epoch[p] = pl.r_epoch[j];
}

// One thread per (slot, epoch) segment head; n_act points at the number of
// contributing rows.
__global__ void ag_walk(const AggPlan pl, const long long* n_act_p) {
  long long p = (long long)blockIdx.x * BLOCK + threadIdx.x;
  long long n_act = *n_act_p;
  if (p >= n_act) return;
  int s = pl.s_slot[p], e = pl.s_epoch[p];
  if (p > 0 && pl.s_slot[p - 1] == s && pl.s_epoch[p - 1] == e) return;
  long long end = p + 1;
  while (end < n_act && pl.s_slot[end] == s && pl.s_epoch[end] == e) ++end;
  bool final_epoch = e == pl.tile_resets[pl.ntiles];
  for (int j = 0; j < pl.nspec; ++j) {
    int op = pl.op[j], dt = pl.dt[j], w = width(dt);
    long long acc = load_v(pl.vals[j], pl.perm[p], dt);
    if (e == 0) acc = combine(op, dt, load_v(pl.state[j], s, dt), acc);
    store_bits(pl.res[j], pl.perm[p], acc, w);
    for (long long q = p + 1; q < end; ++q) {
      int row = pl.perm[q];
      acc = combine(op, dt, acc, load_v(pl.vals[j], row, dt));
      store_bits(pl.res[j], row, acc, w);
    }
    if (final_epoch) store_bits(pl.new_state[j], s, acc, w);
  }
}

inline unsigned blocks(long long n) { return (unsigned)((n + BLOCK - 1) / BLOCK); }

}  // namespace

extern "C" int siddhi_agg_plan_size() { return (int)sizeof(AggPlan); }

// Launches on `stream`; returns the launches' cudaError_t (0 = launched).
extern "C" int siddhi_group_agg(const AggPlan* plan, void* stream) {
  const AggPlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  size_t shared = (size_t)pl.K * sizeof(int);
  long long nh = pl.K * pl.ntiles;
  ag_tile<<<pl.ntiles, TILE, shared, s>>>(pl);
  exclusive_scan(pl.hist, nh, pl.hist_sums, s);
  scan_sums_kernel<<<1, SCAN_BLOCK, 0, s>>>(pl.tile_resets, pl.ntiles);
  ag_scatter<<<pl.ntiles, TILE, shared, s>>>(pl);
  ag_state_init<<<blocks(pl.K), BLOCK, 0, s>>>(pl);
  ag_walk<<<blocks(pl.B > 0 ? pl.B : 1), BLOCK, 0, s>>>(
      pl, pl.hist_sums + (nh + SCAN_BLOCK - 1) / SCAN_BLOCK);
  return (int)cudaGetLastError();
}

// Run mode; `hist` holds ntiles + 1 values.
extern "C" int siddhi_group_agg_runs(const AggPlan* plan, void* stream) {
  const AggPlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  ag_runs_count<<<pl.ntiles, TILE, 0, s>>>(pl);
  scan_sums_kernel<<<1, SCAN_BLOCK, 0, s>>>(pl.hist, pl.ntiles);
  scan_sums_kernel<<<1, SCAN_BLOCK, 0, s>>>(pl.tile_resets, pl.ntiles);
  ag_runs_scatter<<<pl.ntiles, TILE, 0, s>>>(pl);
  ag_state_init<<<blocks(pl.K), BLOCK, 0, s>>>(pl);
  ag_walk<<<blocks(pl.B > 0 ? pl.B : 1), BLOCK, 0, s>>>(pl, pl.hist + pl.ntiles);
  return (int)cudaGetLastError();
}

// Radix mode; `hist` holds ntiles + 1 values.
extern "C" int siddhi_group_agg_radix(const AggPlan* plan, void* stream) {
  const AggPlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  AggPlan rp = pl;                    // run mode's compaction, into r_*
  rp.perm = pl.r_perm;
  rp.s_slot = pl.r_slot;
  rp.s_epoch = pl.r_epoch;
  unsigned nb = blocks(pl.B > 0 ? pl.B : 1);
  ag_runs_count<<<pl.ntiles, TILE, 0, s>>>(pl);
  scan_sums_kernel<<<1, SCAN_BLOCK, 0, s>>>(pl.hist, pl.ntiles);
  scan_sums_kernel<<<1, SCAN_BLOCK, 0, s>>>(pl.tile_resets, pl.ntiles);
  ag_runs_scatter<<<pl.ntiles, TILE, 0, s>>>(rp);
  ag_radix_keys<<<nb, BLOCK, 0, s>>>(pl);
  int bits = 0;
  while (bits < 31 && (1LL << bits) < pl.K) ++bits;
  int cur = radix_sort(pl.r_key, pl.r_idx, 0, pl.hist + pl.ntiles, pl.B, bits, pl.r_hist,
                       pl.r_hist_sums, s);
  ag_radix_gather<<<nb, BLOCK, 0, s>>>(pl, cur);
  ag_state_init<<<blocks(pl.K), BLOCK, 0, s>>>(pl);
  ag_walk<<<nb, BLOCK, 0, s>>>(pl, pl.hist + pl.ntiles);
  return (int)cudaGetLastError();
}
