// ext_window: one step of an externalTime, timeLength or delay window
// (kernel K16), for sm_90a.
//
// Replaces the JAX package's ExternalTimeWindow.process, TimeLengthWindow
// .process and DelayWindow.process (siddhi_tpu/core/window_ext.py:83, :279,
// :375), each an argsort of the [C + B] candidates' emission keys, a rank
// scatter, sort_rows and a rebuilt buffer.  kernels/ext_window.py states the
// rows, their order and the buffer layout (n alive rows at [0, n), each with
// a 64-bit key: the event time, the expiry time or the release time).
//
// Design.  A step is two launches with one host fetch between them: the
// prepare launch finds what leaves and how many rows come out (the host
// reads that count to size the output), the write launch writes every
// output row at its rank and the new buffer, which goes to a second set of
// columns (a merge cannot run in place).  All 64-bit key arithmetic is
// unsigned, so a wrap is defined; sort keys are the keys' bits with the
// sign flipped, so an unsigned order is the signed one.
//  * externalTime: the arrivals are sorted by event time (a stable LSD
//    radix sort, radix.cuh); the buffer is kept in (ets, position) order,
//    so the rows that expire are a prefix of the buffer and of the sorted
//    arrivals.  Each output row's rank, and each survivor's place in the
//    merged buffer, is a sum of binary-search counts in those two sorted
//    runs: one thread per row, no sort of the output.  The reference's
//    `ets * (C + 2B) + pos` key, which overflows at epoch-millisecond
//    event times, is not copied: the pair is compared.
//  * timeLength: one scan compacts the survivors (add_seq order) and the
//    rows that time out; the emitted items (time expiries, evictions,
//    arrivals) are sorted stably by their keys 4*expire_ts, 4*ts + 1 and
//    4*ts + 2 by the radix sort, in the reference's candidate order; a
//    second scan places the arrivals the window keeps in their CURRENT
//    rows' order.
//  * delay: one scan of packed (released, kept) counts compacts the kept
//    rows and lists the released ones, which the radix sort orders by
//    release time.  Kept rows past C drop, as in the reference, and are
//    counted in `missed`.
//
// Bound: each candidate row is read once and each output and kept row
// written once, plus the sort's passes over the emitted items (8 passes
// of 12 bytes read and written per item).  Bound by bytes.
#include "radix.cuh"
#include "rows.cuh"

using namespace siddhi;

namespace {

constexpr int MAX_COLS = 16;
constexpr int BLOCK = 256;
constexpr long long NO_WAKEUP = BIG_SEQ;
constexpr unsigned long long SIGN = 0x8000000000000000ULL;

enum : int { M_EXT = 0, M_TLEN = 1, M_DELAY = 2 };
enum : int { N_ALIVE = 0, SEQ = 1, MISSED = 2 };
// scal words: the output row count first (the host reads it)
enum : int { S_NOUT = 0, S_NA, S_N, S_A, S_B, S_C, S_D, S_E, S_F, S_ITEMS };

}  // namespace

// Mirrored field for field by kernels/ext_window.py (ctypes.Structure).
struct ExtPlan {
  long long C, A, t, now, length, cap;
  int mode, ncols;
  int col_bytes[MAX_COLS];
  const long long* b_ts;
  const long long* b_key;
  const int* b_gslot;
  const void* b_col[MAX_COLS];
  long long* n_ts;
  long long* n_key;
  int* n_gslot;
  void* n_col[MAX_COLS];
  long long* meta;          // [alive rows, seq, rows dropped, 0]
  const long long* a_ts;
  const long long* a_ets;   // externalTime: the arrivals' event times
  const int* a_gslot;
  const void* a_col[MAX_COLS];
  const long long* n_arr;
  long long* out_ts;
  int* out_kind;
  long long* out_seq;
  int* out_gslot;
  void* out_col[MAX_COLS];
  long long* wake;          // [wake, rows dropped]
  long long* scal;
  long long* block_sums;
  int* list;
  long long* s_key;         // externalTime: the arrivals' sorted event times
  unsigned long long* r_key[2];
  int* r_idx[2];
  long long* r_hist;
  long long* r_hist_sums;
};

namespace {

__device__ __forceinline__ unsigned long long ord(unsigned long long bits) { return bits ^ SIGN; }

__device__ __forceinline__ long long add_w(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

// Rows of a[0, n) (ascending) below x, and at or below x.
__device__ long long lower_bound(const long long* a, long long n, long long x) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ long long upper_bound(const long long* a, long long n, long long x) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ long long lmin(long long a, long long b) { return a < b ? a : b; }
__device__ __forceinline__ long long lmax(long long a, long long b) { return a > b ? a : b; }

// Output row o: its head, then its group slot and columns from a buffer
// row (from_buf) or an arrival.
__device__ void out_row(const ExtPlan& pl, long long o, int kind, long long ts, long long seq,
                        bool from_buf, long long i) {
  if (o >= pl.cap) return;
  pl.out_ts[o] = ts;
  pl.out_kind[o] = kind;
  pl.out_seq[o] = seq;
  if (from_buf) {
    pl.out_gslot[o] = pl.b_gslot[i];
    for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.out_col[c], o, pl.b_col[c], i, pl.col_bytes[c]);
  } else {
    pl.out_gslot[o] = pl.a_gslot[i];
    for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.out_col[c], o, pl.a_col[c], i, pl.col_bytes[c]);
  }
}

// New buffer row d from a buffer row or an arrival, with its key.
__device__ void new_row(const ExtPlan& pl, long long d, bool from_buf, long long i, long long key) {
  pl.n_key[d] = key;
  if (from_buf) {
    pl.n_ts[d] = pl.b_ts[i];
    pl.n_gslot[d] = pl.b_gslot[i];
    for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.n_col[c], d, pl.b_col[c], i, pl.col_bytes[c]);
  } else {
    pl.n_ts[d] = pl.a_ts[i];
    pl.n_gslot[d] = pl.a_gslot[i];
    for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.n_col[c], d, pl.a_col[c], i, pl.col_bytes[c]);
  }
}

__device__ __forceinline__ long long gid() { return (long long)blockIdx.x * BLOCK + threadIdx.x; }

// ---- externalTime ---------------------------------------------------------

__global__ void ex_keys(const ExtPlan pl) {
  long long i = gid();
  if (i >= pl.n_arr[0]) return;
  pl.r_key[0][i] = ord((unsigned long long)pl.a_ets[i]);
  pl.r_idx[0][i] = (int)i;
}

__global__ void ex_sorted(const ExtPlan pl) {
  long long j = gid();
  if (j >= pl.n_arr[0]) return;
  pl.s_key[j] = pl.a_ets[pl.r_idx[0][j]];
}

__global__ void ex_scal(const ExtPlan pl) {
  long long na = pl.n_arr[0], n = pl.meta[N_ALIVE], ndb = 0, nda = 0;
  if (na > 0) {
    long long thr = add_w(pl.s_key[na - 1], -pl.t);   // ext_now - t
    ndb = upper_bound(pl.b_key, n, thr);
    nda = upper_bound(pl.s_key, na, thr);
  }
  long long total = (n - ndb) + (na - nda);
  long long* s = pl.scal;
  s[S_NA] = na;
  s[S_N] = n;
  s[S_A] = ndb;
  s[S_B] = nda;
  s[S_C] = lmax(total - pl.C, 0);   // the oldest survivors that drop
  s[S_D] = total;
  s[S_NOUT] = ndb + nda + na;
}

// Each buffer row: EXPIRED at its rank (a due prefix), or its place in the
// merged buffer.
__global__ void ex_buf(const ExtPlan pl) {
  long long i = gid();
  const long long* s = pl.scal;
  long long n = s[S_N], na = s[S_NA], ndb = s[S_A], nda = s[S_B], drop = s[S_C];
  if (i >= n) return;
  long long e = pl.b_key[i], seq0 = pl.meta[SEQ];
  if (i < ndb) {
    long long et = add_w(e, pl.t);
    long long r = i + lmin(lower_bound(pl.s_key, na, e), nda) + lower_bound(pl.s_key, na, et);
    out_row(pl, r, K_EXPIRED, et, seq0 + r, true, i);
  } else {
    long long p = (i - ndb) + (lower_bound(pl.s_key, na, e) - nda) - drop;
    if (p >= 0) new_row(pl, p, true, i, e);
  }
}

// Each arrival (in event-time order): CURRENT at its rank, EXPIRED too if
// due, else its place in the merged buffer.
__global__ void ex_arr(const ExtPlan pl) {
  long long j = gid();
  const long long* s = pl.scal;
  long long n = s[S_N], na = s[S_NA], ndb = s[S_A], nda = s[S_B], drop = s[S_C];
  if (j >= na) return;
  long long a = pl.s_key[j], src = pl.r_idx[0][j], seq0 = pl.meta[SEQ];
  long long lo = add_w(a, -pl.t);
  long long r = lmin(upper_bound(pl.b_key, n, lo), ndb) + lmin(upper_bound(pl.s_key, na, lo), nda) + j;
  out_row(pl, r, K_CURRENT, pl.a_ts[src], seq0 + r, false, src);
  if (j < nda) {
    long long et = add_w(a, pl.t);
    long long r2 = lmin(upper_bound(pl.b_key, n, a), ndb) + j + lower_bound(pl.s_key, na, et);
    out_row(pl, r2, K_EXPIRED, et, seq0 + r2, false, src);
  } else {
    long long p = (j - nda) + (upper_bound(pl.b_key, n, a) - ndb) - drop;
    if (p >= 0) new_row(pl, p, false, src, a);
  }
}

__global__ void ex_finish(const ExtPlan pl) {
  const long long* s = pl.scal;
  pl.meta[N_ALIVE] = s[S_D] - s[S_C];
  pl.meta[SEQ] += s[S_NOUT];
  pl.meta[MISSED] += s[S_C];
  pl.wake[0] = NO_WAKEUP;
  pl.wake[1] = s[S_C];
}

// ---- timeLength -----------------------------------------------------------

__device__ __forceinline__ bool tl_surv(const ExtPlan& pl, long long i) {
  return i < pl.meta[N_ALIVE] && pl.b_key[i] > pl.now;
}

__global__ void tl_flags(const ExtPlan pl) {
  __shared__ long long sh[2 * BLOCK];
  long long i = gid(), tot;
  block_excl_scan<BLOCK>((long long)(i < pl.C && tl_surv(pl, i)), sh, &tot);
  if (threadIdx.x == 0) pl.block_sums[blockIdx.x] = tot;
}

// list[0, count0): the survivors in order; list[count0, n): the rows that
// time out, in order.
__global__ void tl_lists(const ExtPlan pl, long long nb) {
  __shared__ long long sh[2 * BLOCK];
  long long i = gid(), tot;
  bool sv = i < pl.C && tl_surv(pl, i);
  long long r = block_excl_scan<BLOCK>((long long)sv, sh, &tot) + pl.block_sums[blockIdx.x];
  if (i >= pl.meta[N_ALIVE]) return;
  long long count0 = pl.block_sums[nb];
  if (sv) pl.list[r] = (int)i;
  else pl.list[count0 + (i - r)] = (int)i;
}

__global__ void tl_scal(const ExtPlan pl, long long nb) {
  long long count0 = pl.block_sums[nb], n = pl.meta[N_ALIVE], na = pl.n_arr[0], L = pl.length;
  long long ndue = n - count0;
  long long kev0 = lmin(lmax(L - count0, 0), na);   // the first arrival that evicts
  long long nev = na - kev0;
  long long total = count0 + na, start = lmax(total - L, 0);
  long long* s = pl.scal;
  s[S_NA] = na;
  s[S_N] = count0;
  s[S_A] = ndue;
  s[S_B] = kev0;
  s[S_C] = nev;
  s[S_D] = total;
  s[S_E] = lmax(start - count0, 0);   // the first arrival the window keeps
  s[S_F] = lmin(start, count0);       // the first survivor it keeps
  s[S_ITEMS] = ndue + nev + na;
  s[S_NOUT] = ndue + nev + na;
  pl.wake[0] = NO_WAKEUP;
  pl.wake[1] = 0;
}

// Emitted item m: a time expiry (list order), an eviction or an arrival
// (batch order), keyed as the reference keys it.
__global__ void tl_items(const ExtPlan pl) {
  long long m = gid();
  const long long* s = pl.scal;
  long long count0 = s[S_N], ndue = s[S_A], kev0 = s[S_B], nev = s[S_C];
  if (m >= s[S_ITEMS]) return;
  unsigned long long key;
  if (m < ndue) {
    key = (unsigned long long)pl.b_key[pl.list[count0 + m]] * 4ULL;
  } else if (m < ndue + nev) {
    key = (unsigned long long)pl.a_ts[kev0 + m - ndue] * 4ULL + 1ULL;
  } else {
    key = (unsigned long long)pl.a_ts[m - ndue - nev] * 4ULL + 2ULL;
  }
  pl.r_key[0][m] = ord(key);
  pl.r_idx[0][m] = (int)m;
}

// Which arrival a sorted item is, if it is one the window keeps.
__device__ __forceinline__ long long tl_kept_arrival(const ExtPlan& pl, long long r) {
  const long long* s = pl.scal;
  if (r >= s[S_ITEMS]) return -1;
  long long m = pl.r_idx[0][r], first = s[S_A] + s[S_C];
  if (m < first) return -1;
  long long k = m - first;
  return k >= s[S_E] ? k : -1;
}

__global__ void tl_write(const ExtPlan pl) {
  __shared__ long long sh[2 * BLOCK];
  long long r = gid(), tot;
  const long long* s = pl.scal;
  if (r < s[S_ITEMS]) {
    long long count0 = s[S_N], ndue = s[S_A], kev0 = s[S_B], nev = s[S_C];
    long long m = pl.r_idx[0][r], seq = pl.meta[SEQ] + r;
    if (m < ndue) {
      long long i = pl.list[count0 + m];
      out_row(pl, r, K_EXPIRED, pl.b_key[i], seq, true, i);
    } else if (m < ndue + nev) {
      long long k = kev0 + m - ndue, v = count0 + k - pl.length;
      if (v < count0) out_row(pl, r, K_EXPIRED, pl.a_ts[k], seq, true, pl.list[v]);
      else out_row(pl, r, K_EXPIRED, pl.a_ts[k], seq, false, v - count0);
    } else {
      long long k = m - ndue - nev;
      out_row(pl, r, K_CURRENT, pl.a_ts[k], seq, false, k);
    }
  }
  block_excl_scan<BLOCK>((long long)(tl_kept_arrival(pl, r) >= 0), sh, &tot);
  if (threadIdx.x == 0) pl.block_sums[blockIdx.x] = tot;
}

// The kept arrivals, in their CURRENT rows' order, after the kept
// survivors.
__global__ void tl_place(const ExtPlan pl) {
  __shared__ long long sh[2 * BLOCK];
  long long r = gid(), tot;
  long long k = tl_kept_arrival(pl, r);
  long long q = block_excl_scan<BLOCK>((long long)(k >= 0), sh, &tot) + pl.block_sums[blockIdx.x];
  if (k < 0) return;
  const long long* s = pl.scal;
  long long key = add_w(pl.a_ts[k], pl.t);
  new_row(pl, (s[S_N] - s[S_F]) + q, false, k, key);
  atomicMin(pl.wake, key);
}

__global__ void tl_keep(const ExtPlan pl) {
  long long q = gid();
  const long long* s = pl.scal;
  if (q >= s[S_N] || q < s[S_F]) return;
  long long i = pl.list[q];
  new_row(pl, q - s[S_F], true, i, pl.b_key[i]);
  atomicMin(pl.wake, pl.b_key[i]);
}

__global__ void tl_finish(const ExtPlan pl) {
  const long long* s = pl.scal;
  pl.meta[N_ALIVE] = lmin(s[S_D], pl.length);
  pl.meta[SEQ] += s[S_ITEMS];
}

// ---- delay ----------------------------------------------------------------

// Candidate c: buffer row c (c < C) or arrival c - C; its release time.
__device__ __forceinline__ bool dl_cand(const ExtPlan& pl, long long c, long long* rel) {
  if (c < pl.C) {
    if (c >= pl.meta[N_ALIVE]) return false;
    *rel = pl.b_key[c];
    return true;
  }
  long long k = c - pl.C;
  if (k >= pl.n_arr[0]) return false;
  *rel = add_w(pl.a_ts[k], pl.t);
  return true;
}

// Packed counts: released rows in the low 32 bits, kept rows above.
__device__ __forceinline__ long long dl_flag(const ExtPlan& pl, long long c, long long* rel) {
  if (c >= pl.C + pl.A || !dl_cand(pl, c, rel)) return 0;
  return *rel <= pl.now ? 1LL : (1LL << 32);
}

__global__ void dl_flags(const ExtPlan pl) {
  __shared__ long long sh[2 * BLOCK];
  long long c = gid(), rel, tot;
  block_excl_scan<BLOCK>(dl_flag(pl, c, &rel), sh, &tot);
  if (threadIdx.x == 0) pl.block_sums[blockIdx.x] = tot;
}

__global__ void dl_scal(const ExtPlan pl, long long nb) {
  long long tot = pl.block_sums[nb];
  long long* s = pl.scal;
  s[S_ITEMS] = tot & 0xffffffffLL;
  s[S_NOUT] = tot & 0xffffffffLL;
  s[S_A] = tot >> 32;
  s[S_C] = lmax(s[S_A] - pl.C, 0);   // kept rows past C drop
  pl.wake[0] = NO_WAKEUP;
  pl.wake[1] = s[S_C];
}

__global__ void dl_items(const ExtPlan pl) {
  __shared__ long long sh[2 * BLOCK];
  long long c = gid(), rel = 0, tot;
  long long f = dl_flag(pl, c, &rel);
  long long x = block_excl_scan<BLOCK>(f, sh, &tot) + pl.block_sums[blockIdx.x];
  if (f == 1) {
    long long q = x & 0xffffffffLL;
    pl.r_key[0][q] = ord((unsigned long long)rel);
    pl.r_idx[0][q] = (int)c;
  } else if (f != 0 && (x >> 32) < pl.C) {
    bool buf = c < pl.C;
    new_row(pl, x >> 32, buf, buf ? c : c - pl.C, rel);
    atomicMin(pl.wake, rel);
  }
}

__global__ void dl_write(const ExtPlan pl) {
  long long r = gid();
  if (r >= pl.scal[S_ITEMS]) return;
  long long c = pl.r_idx[0][r];
  bool buf = c < pl.C;
  long long i = buf ? c : c - pl.C;
  out_row(pl, r, K_CURRENT, buf ? pl.b_ts[i] : pl.a_ts[i], pl.meta[SEQ] + r, buf, i);
}

__global__ void dl_finish(const ExtPlan pl) {
  pl.meta[N_ALIVE] = lmin(pl.scal[S_A], pl.C);
  pl.meta[SEQ] += pl.scal[S_ITEMS];
  pl.meta[MISSED] += pl.scal[S_C];
}

inline unsigned blocks(long long n) { return (unsigned)(n > 0 ? (n + BLOCK - 1) / BLOCK : 1); }

// The stable sort of the n_p (at most cap) items in r_key[0] / r_idx[0] by
// all 64 key bits: eight passes, so the result is back in buffer 0.
inline void sort_items(const ExtPlan& pl, const long long* n_p, long long cap, cudaStream_t s) {
  radix_sort(pl.r_key, pl.r_idx, 0, n_p, cap, 64, pl.r_hist, pl.r_hist_sums, s);
}

}  // namespace

extern "C" int siddhi_ext_plan_size() { return (int)sizeof(ExtPlan); }

// The prepare launch on `stream`: scal[S_NOUT] then holds the output rows.
// Returns the launches' cudaError_t (0 = launched).
extern "C" int siddhi_ext_prepare(const ExtPlan* plan, void* stream) {
  const ExtPlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  if (pl.mode == M_EXT) {
    ex_keys<<<blocks(pl.A), BLOCK, 0, s>>>(pl);
    sort_items(pl, pl.n_arr, pl.A, s);
    ex_sorted<<<blocks(pl.A), BLOCK, 0, s>>>(pl);
    ex_scal<<<1, 1, 0, s>>>(pl);
  } else if (pl.mode == M_TLEN) {
    unsigned nb = blocks(pl.C);
    tl_flags<<<nb, BLOCK, 0, s>>>(pl);
    scan_sums_kernel<<<1, SCAN_BLOCK, 0, s>>>(pl.block_sums, (long long)nb);
    tl_lists<<<nb, BLOCK, 0, s>>>(pl, (long long)nb);
    tl_scal<<<1, 1, 0, s>>>(pl, (long long)nb);
    long long cap = pl.C + 2 * pl.A;
    tl_items<<<blocks(cap), BLOCK, 0, s>>>(pl);
    sort_items(pl, pl.scal + S_ITEMS, cap, s);
  } else {
    long long cap = pl.C + pl.A;
    unsigned nb = blocks(cap);
    dl_flags<<<nb, BLOCK, 0, s>>>(pl);
    scan_sums_kernel<<<1, SCAN_BLOCK, 0, s>>>(pl.block_sums, (long long)nb);
    dl_scal<<<1, 1, 0, s>>>(pl, (long long)nb);
    dl_items<<<nb, BLOCK, 0, s>>>(pl);
    sort_items(pl, pl.scal + S_ITEMS, cap, s);
  }
  return (int)cudaGetLastError();
}

// The write launch on `stream` (after the prepare launch, with the output
// pointers set): the output rows, the new buffer, the counters.
extern "C" int siddhi_ext_write(const ExtPlan* plan, void* stream) {
  const ExtPlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  if (pl.mode == M_EXT) {
    ex_buf<<<blocks(pl.C), BLOCK, 0, s>>>(pl);
    ex_arr<<<blocks(pl.A), BLOCK, 0, s>>>(pl);
    ex_finish<<<1, 1, 0, s>>>(pl);
  } else if (pl.mode == M_TLEN) {
    long long cap = pl.C + 2 * pl.A;
    unsigned nb = blocks(cap);
    tl_write<<<nb, BLOCK, 0, s>>>(pl);
    scan_sums_kernel<<<1, SCAN_BLOCK, 0, s>>>(pl.block_sums, (long long)nb);
    tl_place<<<nb, BLOCK, 0, s>>>(pl);
    tl_keep<<<blocks(pl.C), BLOCK, 0, s>>>(pl);
    tl_finish<<<1, 1, 0, s>>>(pl);
  } else {
    dl_write<<<blocks(pl.C + pl.A), BLOCK, 0, s>>>(pl);
    dl_finish<<<1, 1, 0, s>>>(pl);
  }
  return (int)cudaGetLastError();
}
