// ring: the serving loop's on-device emission ring, for sm_90a (kernel
// K30).
//
// Replaces the JAX package's ring programs (siddhi_tpu/serving/ring.py
// _Generation._set: one dynamic_update_index_in_dim per leaf of a step's
// output block, and _Generation._read: one dynamic_index_in_dim per leaf of
// the oldest slot, each fetched by the drainer).
//
// ring_append: one launch copies every leaf of a step's output block (its
// header words and its row columns) into slot `slot` of the [S, ...] ring,
// through a table of leaf pointers: grid (chunks, leaves).
//
// ring_pack: the drainer's edge.  For the m oldest slots (slot (tail + j)
// mod S), a launch per (slot, chunk of rows) counts the valid rows and
// copies each slot's header words to `meta` ([m, H + 1]), a scan of the
// counts places each chunk, and a second launch per (slot, chunk) packs
// the valid rows of the m slots, in slot order and row order, into one
// contiguous staging buffer of fixed-stride packed rows (each row leaf's
// element at its byte offset) and writes each slot's valid-row count.
// The drainer then fetches `meta`, and the first sum(counts) packed rows:
// two device-to-host transfers a drain round, whatever m is.
//
// Bound: an append moves the block's bytes once in and once out; a pack
// reads the slots' valid flags and the valid rows once and writes them
// once, so both are bound by bytes.
#include <cuda_runtime.h>
#include "rows.cuh"

using namespace siddhi;

namespace {

constexpr int MAX_LEAVES = 40;
constexpr int APPEND_BLOCK = 256;
constexpr int PACK_BLOCK = 1024;

}  // namespace

// Mirrored by kernels/ring.py (ctypes.Structure).
struct AppendPlan {
  int n, slot;
  long long bytes[MAX_LEAVES];   // bytes of one slot of each leaf
  const void* src[MAX_LEAVES];
  void* dst[MAX_LEAVES];         // the leaf's [S, ...] ring
};

struct PackPlan {
  int n_leaves, m, S, tail, R, H, row_stride, nch;
  int esize[MAX_LEAVES];         // element bytes of each row leaf
  int off[MAX_LEAVES];           // its byte offset in a packed row
  const void* leaf[MAX_LEAVES];  // [S, R] rings of the row leaves
  const unsigned char* valid;    // [S, R] ring of the valid flags
  const long long* header;       // [S, H] ring of the header words
  long long* counts;             // scratch [m * nch + 1]: chunk counts
  long long* meta;               // out [m, H + 1]
  unsigned char* packed;         // out [m * R, row_stride] (a prefix used)
};

static_assert(sizeof(AppendPlan) <= 4000, "AppendPlan must fit the kernel parameter space");
static_assert(sizeof(PackPlan) <= 4000, "PackPlan must fit the kernel parameter space");

namespace {

__global__ void ring_append_kernel(const __grid_constant__ AppendPlan pl) {
  const int l = blockIdx.y;
  const long long nbytes = pl.bytes[l];
  const unsigned char* src = (const unsigned char*)pl.src[l];
  unsigned char* dst = (unsigned char*)pl.dst[l] + (long long)pl.slot * nbytes;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool v16 = (nbytes % 16 == 0) && (((unsigned long long)src | (unsigned long long)dst) % 16 == 0);
  if (v16) {
    const uint4* s4 = (const uint4*)src;
    uint4* d4 = (uint4*)dst;
    for (long long i = t0; i < nbytes / 16; i += stride) d4[i] = s4[i];
  } else {
    for (long long i = t0; i < nbytes; i += stride) dst[i] = src[i];
  }
}

// Valid rows of each (slot, chunk of PACK_BLOCK rows); block (0, j) also
// copies slot j's header words to meta.
__global__ void ring_count_kernel(const __grid_constant__ PackPlan pl) {
  __shared__ long long sh[2 * PACK_BLOCK];
  const int j = blockIdx.y, c = blockIdx.x;
  const long long slot = (pl.tail + j) % pl.S;
  const long long r = (long long)c * PACK_BLOCK + threadIdx.x;
  long long keep = (r < pl.R && pl.valid[slot * pl.R + r]) ? 1 : 0;
  long long tot;
  block_excl_scan<PACK_BLOCK>(keep, sh, &tot);
  if (threadIdx.x == 0) pl.counts[(long long)j * pl.nch + c] = tot;
  if (c == 0 && threadIdx.x < pl.H)
    pl.meta[(long long)j * (pl.H + 1) + threadIdx.x] = pl.header[slot * pl.H + threadIdx.x];
}

// After the scan of the chunk counts (slot-major, so a slot's rows follow
// the earlier slots'): each chunk writes its valid rows at its offset;
// block (0, j) writes slot j's valid-row count.
__global__ void ring_pack_kernel(const __grid_constant__ PackPlan pl) {
  __shared__ long long sh[2 * PACK_BLOCK];
  const int j = blockIdx.y, c = blockIdx.x;
  const long long slot = (pl.tail + j) % pl.S;
  const long long at = (long long)j * pl.nch + c;
  if (c == 0 && threadIdx.x == 0)
    pl.meta[(long long)j * (pl.H + 1) + pl.H] =
        pl.counts[(long long)(j + 1) * pl.nch] - pl.counts[(long long)j * pl.nch];
  const long long r = (long long)c * PACK_BLOCK + threadIdx.x;
  long long keep = (r < pl.R && pl.valid[slot * pl.R + r]) ? 1 : 0;
  long long tot;
  long long ex = block_excl_scan<PACK_BLOCK>(keep, sh, &tot);
  if (!keep) return;
  unsigned char* dst = pl.packed + (pl.counts[at] + ex) * pl.row_stride;
  const long long src_row = slot * pl.R + r;
  for (int l = 0; l < pl.n_leaves; ++l) {
    const int es = pl.esize[l];
    const unsigned char* src = (const unsigned char*)pl.leaf[l] + src_row * es;
    for (int b = 0; b < es; ++b) dst[pl.off[l] + b] = src[b];
  }
}

}  // namespace

extern "C" int siddhi_ring_append_plan_size() { return (int)sizeof(AppendPlan); }
extern "C" int siddhi_ring_pack_plan_size() { return (int)sizeof(PackPlan); }

// Launches on `stream`; returns the launch's cudaError_t (0 = launched).
extern "C" int siddhi_ring_append(const AppendPlan* plan, void* stream) {
  const AppendPlan& pl = *plan;
  if (pl.n <= 0) return 0;
  long long most = 0;
  for (int l = 0; l < pl.n; ++l) most = pl.bytes[l] > most ? pl.bytes[l] : most;
  long long blocks = (most / 16 + APPEND_BLOCK - 1) / APPEND_BLOCK;
  blocks = blocks < 1 ? 1 : (blocks > 1024 ? 1024 : blocks);
  dim3 grid((unsigned)blocks, (unsigned)pl.n);
  ring_append_kernel<<<grid, APPEND_BLOCK, 0, (cudaStream_t)stream>>>(pl);
  return (int)cudaGetLastError();
}

extern "C" int siddhi_ring_pack(const PackPlan* plan, void* stream) {
  const PackPlan& pl = *plan;
  if (pl.m <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)pl.nch, (unsigned)pl.m);
  ring_count_kernel<<<grid, PACK_BLOCK, 0, s>>>(pl);
  scan_sums_kernel<<<1, SCAN_BLOCK, 0, s>>>(pl.counts, (long long)pl.m * pl.nch);
  ring_pack_kernel<<<grid, PACK_BLOCK, 0, s>>>(pl);
  return (int)cudaGetLastError();
}
