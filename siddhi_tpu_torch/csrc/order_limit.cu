// order_limit: a selector's `order by` / `limit` / `offset` (kernel K13),
// for sm_90a.
//
// Replaces the JAX package's SelectorExec._order_limit
// (siddhi_tpu/core/selector.py:545): stable argsorts of the step's output
// rows by each order-by key, the last key first (DESC by negation in the
// key's own type, or logical not for a bool; invalid rows last), then a
// rank of the valid rows that keeps [offset, offset + limit).  Only valid
// rows are delivered and the reference sorts invalid rows last, so the
// kernel compacts the valid rows first and sorts those alone: the same
// rows come out in the same order.
//
// Each key becomes order-preserving unsigned bits: the sign bit flipped
// for an int (a DESC int null wraps to itself, so null ints sort first
// under DESC, as in the reference); for a float, -0.0 and +0.0 are one
// value, every NaN one value above +inf, and the IEEE flip; a bool is 0 or
// 1.  Then one stable LSD radix sort per key over 8-bit digits
// (radix.cuh, shared with group_agg).  Last, the kept rows are gathered to
// the front of the output.
//
// Bound: each valid row's keys are read once and each kept row written
// once; the radix passes re-read and re-write (key, index) pairs, 4 passes
// a 32-bit key and 8 a 64-bit one, which is the design's cost above the
// bound.  Bound by bytes.
#include "radix.cuh"
#include "rows.cuh"

using namespace siddhi;

namespace {

constexpr int MAX_COLS = 16;
constexpr int BLOCK = 256;

}  // namespace

// Mirrored field for field by kernels/order_limit.py (ctypes.Structure).
struct OrderPlan {
  long long N, cap, lo, limit;   // limit < 0: none
  int ncols, pad;
  int col_bytes[MAX_COLS];
  const long long* ts;
  const int* kind;
  const unsigned char* valid;
  const void* col[MAX_COLS];
  unsigned char* flags;
  long long* block_sums;   // [N/BLOCK + 1]; the valid count at the end
  int* idx[2];
  unsigned long long* key[2];
  long long* hist;         // [RADIX * tiles]
  long long* hist_sums;
  long long* out_ts;
  int* out_kind;
  unsigned char* out_valid;
  void* out_col[MAX_COLS];
};

namespace {

__global__ void ol_flags(const OrderPlan pl) {
  __shared__ long long sh[2 * BLOCK];
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  int f = i < pl.N && pl.valid[i];
  if (i < pl.N) pl.flags[i] = (unsigned char)f;
  long long tot;
  block_excl_scan<BLOCK>((long long)f, sh, &tot);
  if (threadIdx.x == 0) pl.block_sums[blockIdx.x] = tot;
}

__global__ void ol_compact(const OrderPlan pl) {
  __shared__ long long sh[2 * BLOCK];
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  int f = i < pl.N ? pl.flags[i] : 0;
  long long tot;
  long long r = block_excl_scan<BLOCK>((long long)f, sh, &tot) + pl.block_sums[blockIdx.x];
  if (f) pl.idx[0][r] = (int)i;
}

// The order-preserving bits of key column `col` (type ty) at the rows of
// the current order; `desc` negates first.
__global__ void ol_keys(const OrderPlan pl, long long nb, const void* col, int ty, int desc,
                        int cur) {
  long long j = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (j >= pl.block_sums[nb]) return;
  long long r = pl.idx[cur][j];
  unsigned long long u;
  if (ty == 1) {                                   // int64
    long long v = ((const long long*)col)[r];
    if (desc) v = (long long)(0ULL - (unsigned long long)v);
    u = (unsigned long long)v ^ 0x8000000000000000ULL;
  } else if (ty == 2) {                            // float32
    float f = ((const float*)col)[r];
    if (desc) f = -f;
    unsigned int b = f != f ? 0x7fc00000u : (f == 0.0f ? 0u : (unsigned int)__float_as_int(f));
    u = (b & 0x80000000u) ? (unsigned long long)(~b) : (unsigned long long)(b | 0x80000000u);
  } else if (ty == 3) {                            // bool
    unsigned char v = ((const unsigned char*)col)[r] != 0;
    u = desc ? !v : v;
  } else {                                         // int32
    int v = ((const int*)col)[r];
    if (desc) v = (int)(0u - (unsigned int)v);
    u = (unsigned long long)((unsigned int)v ^ 0x80000000u);
  }
  pl.key[cur][j] = u;
}

// The kept rows [lo, lo + limit) of the order to the output's front; the
// rest of the output invalid.
__global__ void ol_emit(const OrderPlan pl, long long nb, int cur) {
  long long p = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (p >= pl.cap) return;
  const long long n = pl.block_sums[nb];
  long long kept = n - pl.lo;
  if (kept < 0) kept = 0;
  if (pl.limit >= 0 && kept > pl.limit) kept = pl.limit;
  if (p >= kept) {
    pl.out_ts[p] = 0;
    pl.out_kind[p] = 0;
    pl.out_valid[p] = 0;
    for (int c = 0; c < pl.ncols; ++c) store_bits(pl.out_col[c], p, 0, pl.col_bytes[c]);
    return;
  }
  long long r = pl.idx[cur][pl.lo + p];
  pl.out_ts[p] = pl.ts[r];
  pl.out_kind[p] = pl.kind[r];
  pl.out_valid[p] = 1;
  for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.out_col[c], p, pl.col[c], r, pl.col_bytes[c]);
}

}  // namespace

extern "C" int siddhi_order_plan_size() { return (int)sizeof(OrderPlan); }

// Launches on `stream`: the compaction, then for each key (`key_col`,
// `key_ty`: 0 int32, 1 int64, 2 float32, 3 bool; `key_desc`), in the order
// given (the last order-by key first), its bits and its radix passes, then
// the output.  Returns the launches' cudaError_t (0 = launched).
extern "C" int siddhi_order_limit(const OrderPlan* plan, int nkeys, const void* const* key_col,
                                  const int* key_ty, const int* key_desc, void* stream) {
  const OrderPlan& pl = *plan;
  if (pl.N <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  long long nb = (pl.N + BLOCK - 1) / BLOCK;
  ol_flags<<<(unsigned)nb, BLOCK, 0, s>>>(pl);
  scan_sums_kernel<<<1, SCAN_BLOCK, 0, s>>>(pl.block_sums, nb);
  ol_compact<<<(unsigned)nb, BLOCK, 0, s>>>(pl);
  int cur = 0;
  for (int k = 0; k < nkeys; ++k) {
    ol_keys<<<(unsigned)nb, BLOCK, 0, s>>>(pl, nb, key_col[k], key_ty[k], key_desc[k], cur);
    int bits = key_ty[k] == 1 ? 64 : key_ty[k] == 3 ? 8 : 32;
    cur = radix_sort(pl.key, pl.idx, cur, pl.block_sums + nb, pl.N, bits, pl.hist, pl.hist_sums,
                     s);
  }
  if (pl.cap > 0) ol_emit<<<(unsigned)((pl.cap + BLOCK - 1) / BLOCK), BLOCK, 0, s>>>(pl, nb, cur);
  return (int)cudaGetLastError();
}
