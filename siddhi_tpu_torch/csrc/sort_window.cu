// sort_window: one step of a sort(n, attr[, order]) window (kernel K17),
// for sm_90a.
//
// Replaces the JAX package's SortWindow.process
// (siddhi_tpu/core/window_ext.py:496): an argsort of the [C + B]
// candidates' keys (dead ones keyed +inf or BIG_SEQ), a rank scatter, the
// keep / evict split, sort_rows and a rebuilt buffer.
// kernels/sort_window.py states the keys, the rows and their order.
//
// Design.  Only the alive candidates are sorted: the buffer's n rows and
// the compacted arrivals, listed in candidate order, with their keys as
// 64-bit unsigned sort keys (a stable LSD radix sort, radix.cuh, keeps
// equal keys in candidate order).  An alive candidate's rank among all
// C + B candidates is its sorted place plus the dead candidates before it,
// which follows from the key alone: none below the dead key, all of them
// above it, and at the dead key those at a lower position (the arrival's
// input position, which the filter's index mode hands over).  One scan of
// packed (evicted, kept) counts then places every output row and every
// kept row.  Two launches with one host fetch of the output row count
// between them (it sizes the output); the kept rows go to a second set of
// columns, then replace the buffer.
//
// Bound: each candidate is read once, each output and kept row written
// once, plus the sort's eight passes over the alive candidates (12 bytes
// read and written per pass).  Bound by bytes.
#include "radix.cuh"
#include "rows.cuh"

using namespace siddhi;

namespace {

constexpr int MAX_COLS = 16;
constexpr int BLOCK = 256;
constexpr unsigned long long SIGN = 0x8000000000000000ULL;
constexpr long long FLIP = 0x7fffffffffffffffLL;
constexpr unsigned long long CANON_NAN = 0x7ff8000000000000ULL;

enum : int { KT_I32 = 0, KT_I64 = 1, KT_F32 = 2, KT_BOOL = 3 };
// scal words: the output row count first (the host reads it)
enum : int { S_NOUT = 0, S_NA, S_N, S_TOTAL, S_NEV, S_NKEEP };

}  // namespace

// Mirrored field for field by kernels/sort_window.py (ctypes.Structure).
struct SortPlan {
  long long C, A, B, length, cap, dead;
  int ncols, key_col, key_type, desc;
  int col_bytes[MAX_COLS];
  const long long* b_ts;
  const int* b_gslot;
  const void* b_col[MAX_COLS];
  long long* n_ts;
  int* n_gslot;
  void* n_col[MAX_COLS];
  long long* meta;          // [alive rows, seq]
  const long long* a_ts;
  const int* a_gslot;
  const void* a_col[MAX_COLS];
  const long long* a_pos;   // each arrival's input position
  const long long* n_arr;
  long long* out_ts;
  int* out_kind;
  long long* out_seq;
  int* out_gslot;
  void* out_col[MAX_COLS];
  long long* scal;
  unsigned char* keep;      // per candidate
  long long* block_sums;
  unsigned long long* r_key[2];
  int* r_idx[2];
  long long* r_hist;
  long long* r_hist_sums;
};

namespace {

__device__ __forceinline__ long long gid() { return (long long)blockIdx.x * BLOCK + threadIdx.x; }

// Candidate m's key, as an int64 in the reference's order.
__device__ long long cand_key(const SortPlan& pl, long long m, long long n) {
  const void* col = m < n ? pl.b_col[pl.key_col] : pl.a_col[pl.key_col];
  long long i = m < n ? m : m - n;
  if (pl.key_type == KT_F32) {
    float f = ((const float*)col)[i];
    if (pl.desc) f = -f;
    double d = (double)f;
    unsigned long long bits;
    if (d != d) bits = CANON_NAN;
    else if (d == 0.0) bits = 0ULL;
    else bits = (unsigned long long)__double_as_longlong(d);
    long long b = (long long)bits;
    return b < 0 ? b ^ FLIP : b;
  }
  if (pl.key_type == KT_I32) {
    int v = ((const int*)col)[i];
    if (pl.desc) v = (int)(0u - (unsigned)v);
    return (long long)v;
  }
  long long v = pl.key_type == KT_I64 ? ((const long long*)col)[i]
                                      : (long long)((const unsigned char*)col)[i];
  return pl.desc ? (long long)(0ULL - (unsigned long long)v) : v;
}

__global__ void so_scal(const SortPlan pl) {
  long long* s = pl.scal;
  s[S_NA] = pl.n_arr[0];
  s[S_N] = pl.meta[0];
  s[S_TOTAL] = s[S_N] + s[S_NA];
}

__global__ void so_keys(const SortPlan pl) {
  long long m = gid();
  if (m >= pl.scal[S_TOTAL]) return;
  pl.r_key[0][m] = (unsigned long long)cand_key(pl, m, pl.scal[S_N]) ^ SIGN;
  pl.r_idx[0][m] = (int)m;
}

// Each alive candidate's rank among all C + B candidates: kept or not.
__global__ void so_rank(const SortPlan pl) {
  long long r = gid();
  const long long* s = pl.scal;
  long long total = s[S_TOTAL], n = s[S_N];
  if (r >= total) return;
  long long m = pl.r_idx[0][r];
  unsigned long long kb = pl.r_key[0][r], dead = (unsigned long long)pl.dead ^ SIGN;
  long long before = 0;
  if (kb > dead) {
    before = pl.C + pl.B - total;
  } else if (kb == dead && m >= n) {
    long long k = m - n;
    before = (pl.C - n) + (pl.a_pos[k] - k);
  }
  long long keep_n = total < pl.length ? total : pl.length;
  pl.keep[m] = (unsigned char)(r + before < keep_n);
}

// Packed counts: evicted candidates in the low 32 bits, kept ones above.
__device__ __forceinline__ long long so_flag(const SortPlan& pl, long long m) {
  if (m >= pl.scal[S_TOTAL]) return 0;
  return pl.keep[m] ? (1LL << 32) : 1LL;
}

__global__ void so_flags(const SortPlan pl) {
  __shared__ long long sh[2 * BLOCK];
  long long m = gid(), tot;
  block_excl_scan<BLOCK>(so_flag(pl, m), sh, &tot);
  if (threadIdx.x == 0) pl.block_sums[blockIdx.x] = tot;
}

__global__ void so_count(const SortPlan pl, long long nb) {
  long long tot = pl.block_sums[nb];
  long long* s = pl.scal;
  s[S_NEV] = tot & 0xffffffffLL;
  s[S_NKEEP] = tot >> 32;
  s[S_NOUT] = s[S_NA] + s[S_NEV];
}

__device__ void put_out(const SortPlan& pl, long long o, int kind, long long seq, bool buf,
                        long long i) {
  if (o >= pl.cap) return;
  pl.out_ts[o] = buf ? pl.b_ts[i] : pl.a_ts[i];
  pl.out_kind[o] = kind;
  pl.out_seq[o] = seq;
  pl.out_gslot[o] = buf ? pl.b_gslot[i] : pl.a_gslot[i];
  for (int c = 0; c < pl.ncols; ++c)
    copy_elem(pl.out_col[c], o, buf ? pl.b_col[c] : pl.a_col[c], i, pl.col_bytes[c]);
}

__global__ void so_write(const SortPlan pl) {
  __shared__ long long sh[2 * BLOCK];
  long long m = gid(), tot;
  long long f = so_flag(pl, m);
  long long x = block_excl_scan<BLOCK>(f, sh, &tot) + pl.block_sums[blockIdx.x];
  if (f == 0) return;
  const long long* s = pl.scal;
  long long n = s[S_N], na = s[S_NA], seq0 = pl.meta[1];
  bool buf = m < n;
  long long i = buf ? m : m - n;
  if (!buf) put_out(pl, i, K_CURRENT, seq0 + i, false, i);
  if (f == 1) {
    long long e = na + (x & 0xffffffffLL);
    put_out(pl, e, K_EXPIRED, seq0 + e, buf, i);
  } else {
    long long d = x >> 32;
    pl.n_ts[d] = buf ? pl.b_ts[i] : pl.a_ts[i];
    pl.n_gslot[d] = buf ? pl.b_gslot[i] : pl.a_gslot[i];
    for (int c = 0; c < pl.ncols; ++c)
      copy_elem(pl.n_col[c], d, buf ? pl.b_col[c] : pl.a_col[c], i, pl.col_bytes[c]);
  }
}

__global__ void so_finish(const SortPlan pl) {
  const long long* s = pl.scal;
  pl.meta[0] = s[S_NKEEP];
  pl.meta[1] += s[S_NOUT];
}

inline unsigned blocks(long long n) { return (unsigned)(n > 0 ? (n + BLOCK - 1) / BLOCK : 1); }

}  // namespace

extern "C" int siddhi_sort_plan_size() { return (int)sizeof(SortPlan); }

// The prepare launch on `stream`: scal[S_NOUT] then holds the output rows.
// Returns the launches' cudaError_t (0 = launched).
extern "C" int siddhi_sort_prepare(const SortPlan* plan, void* stream) {
  const SortPlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  long long cap = pl.C + pl.A;
  unsigned nb = blocks(cap);
  so_scal<<<1, 1, 0, s>>>(pl);
  so_keys<<<nb, BLOCK, 0, s>>>(pl);
  radix_sort(pl.r_key, pl.r_idx, 0, pl.scal + S_TOTAL, cap, 64, pl.r_hist, pl.r_hist_sums, s);
  so_rank<<<nb, BLOCK, 0, s>>>(pl);
  so_flags<<<nb, BLOCK, 0, s>>>(pl);
  scan_sums_kernel<<<1, SCAN_BLOCK, 0, s>>>(pl.block_sums, (long long)nb);
  so_count<<<1, 1, 0, s>>>(pl, (long long)nb);
  return (int)cudaGetLastError();
}

// The write launch on `stream` (after the prepare launch, with the output
// pointers set): the output rows, the kept rows, the counters.
extern "C" int siddhi_sort_write(const SortPlan* plan, void* stream) {
  const SortPlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  so_write<<<blocks(pl.C + pl.A), BLOCK, 0, s>>>(pl);
  so_finish<<<1, 1, 0, s>>>(pl);
  return (int)cudaGetLastError();
}
