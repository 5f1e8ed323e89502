// time_window: one step of a sliding time window, for sm_90a.
//
// Replaces the JAX package's TimeWindow.process
// (siddhi_tpu/core/window.py:346, with sort_rows / concat_rows).  The
// buffer is a ring of capacity C in add_seq order: alive rows at logical
// positions [head, tail), physical position = logical mod C.  One step:
//   1. find the rows that expire (expire_ts <= now).  While expire_ts
//      rises along the ring (the host knows it from the timestamps it
//      sent) they are a prefix, found by binary search; otherwise a pass
//      over the ring splits the alive rows into expiring and surviving
//      ones (stable compaction) and the expiring ones are sorted by
//      (expire_ts, ring order);
//   2. order the arrivals by ts (stable): already in order when the
//      batch's timestamps do not fall, else sorted;
//   3. emit: an expiring row's place is its rank among the expiring rows
//      plus the number of arrivals with ts < its expire_ts; an arrival's
//      its rank plus the number of expiring rows with expire_ts <= its ts
//      (binary searches into the other sorted run).  That is the
//      reference's stable sort by expire_ts*2 / ts*2+1;
//   4. survivors keep their order at the tail end of the old range
//      (in place when the expiring rows were a prefix), arrivals are
//      appended with add_seq = their seq and expire_ts = ts + t, the
//      oldest rows beyond C drop unemitted;
//   5. counters: head, tail, seq (+ C + B when anything was emitted) and
//      the wake (the least expire_ts alive).
// The host sizes the step from a bound on the rows that can expire
// (e_bound).  When more rows expire than that, the step changes nothing,
// emits only invalid rows and writes how many rows the bound missed beside
// the wake, which the host reads in the same fetch and raises on; rows are
// never dropped unreported.
// Sorting is a bitonic sort of (key, index) pairs, stable by the index.
//
// Bound: a step must read the rows that expire and the arrivals and write
// the emitted rows and the arrivals' ring rows; the rest of the buffer is
// not touched while event time is in order.  Out of order, the pass over
// the ring and the sorts are extra.  Little arithmetic: bound by bytes.
#include "rows.cuh"

using namespace siddhi;

namespace {

constexpr int MAX_COLS = 16;
constexpr int BLOCK = 256;
constexpr long long NO_WAKEUP = BIG_SEQ;
constexpr long long KEY_PAD = 0x7fffffffffffffffLL;

// work words
enum : int { W_E = 0, W_HEAD, W_TAIL, W_SEQ, W_NA, W_WAKE };

}  // namespace

// Mirrored field for field by kernels/time_window.py (ctypes.Structure).
struct TimePlan {
  long long C, B, now, t, cap_out, e_bound, arr_cap, e_sort_n, a_sort_n;
  int ncols, e_prefix, a_sorted;
  int col_bytes[MAX_COLS];
  long long* ts;
  long long* add_seq;
  long long* expire_ts;
  int* gslot;
  void* col[MAX_COLS];
  long long* meta;   // [head, tail, seq, 0]
  const long long* a_ts;
  const int* a_gslot;
  const void* a_col[MAX_COLS];
  const long long* n_arr;
  long long* out_ts;
  int* out_kind;
  unsigned char* out_valid;
  long long* out_seq;
  int* out_gslot;
  void* out_col[MAX_COLS];
  long long* wake;   // [least expire_ts alive, rows the bound missed]
  long long* work;
  // the general step: due flags' block sums, expiring and surviving ring
  // positions, the survivors while they move
  long long* block_sums;
  long long* e_list;
  long long* k_list;
  long long* s_ts;
  long long* s_add;
  long long* s_exp;
  int* s_gslot;
  void* s_col[MAX_COLS];
  // sort keys and values of the expiring rows and of the arrivals
  long long* e_keys;
  int* e_vals;
  long long* a_keys;
  int* a_vals;
  long long* a_seq;   // each arrival's seq (its add_seq)
};

namespace {

__device__ __forceinline__ long long phys(const TimePlan& pl, long long logical) {
  return logical % pl.C;
}

// more rows expire than the host's bound: the step is not applied
__device__ __forceinline__ bool short_bound(const TimePlan& pl) {
  return pl.work[W_E] > pl.e_bound;
}

// ring position of the j-th expiring row in emission order
__device__ __forceinline__ long long e_pos(const TimePlan& pl, long long j) {
  if (pl.e_prefix) return phys(pl, pl.work[W_HEAD] + j);
  return pl.e_list[pl.e_vals[j]];
}

// arrival row of the k-th arrival in ts order
__device__ __forceinline__ long long a_row(const TimePlan& pl, long long k) {
  return pl.a_sorted ? k : pl.a_vals[k];
}

__global__ void tw_begin(const TimePlan pl) {
  long long head = pl.meta[0], tail = pl.meta[1];
  pl.work[W_HEAD] = head;
  pl.work[W_TAIL] = tail;
  pl.work[W_SEQ] = pl.meta[2];
  pl.work[W_NA] = pl.n_arr[0];
  pl.work[W_WAKE] = NO_WAKEUP;
  if (pl.e_prefix) {
    // first logical position whose expire_ts > now
    long long lo = head, hi = tail;
    while (lo < hi) {
      long long mid = lo + (hi - lo) / 2;
      if (pl.expire_ts[phys(pl, mid)] <= pl.now) lo = mid + 1; else hi = mid;
    }
    pl.work[W_E] = lo - head;
  }
}

// general step, pass 1: per-block counts of the alive rows that expire
__global__ void tw_mark(const TimePlan pl) {
  __shared__ long long sh[2 * BLOCK];
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  long long L = pl.work[W_TAIL] - pl.work[W_HEAD];
  long long due = 0;
  if (i < L) due = pl.expire_ts[phys(pl, pl.work[W_HEAD] + i)] <= pl.now;
  long long tot;
  block_excl_scan<BLOCK>(due, sh, &tot);
  if (threadIdx.x == 0) pl.block_sums[blockIdx.x] = tot;
}

// general step, pass 2: expiring and surviving ring positions, ring order;
// sort keys of the expiring ones
__global__ void tw_split(const TimePlan pl) {
  __shared__ long long sh[2 * BLOCK];
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  long long L = pl.work[W_TAIL] - pl.work[W_HEAD];
  long long p = phys(pl, pl.work[W_HEAD] + (i < L ? i : 0));
  long long due = i < L && pl.expire_ts[p] <= pl.now;
  long long tot;
  long long r = block_excl_scan<BLOCK>(due, sh, &tot) + pl.block_sums[blockIdx.x];
  if (i >= L) return;
  if (due) {
    pl.e_list[r] = p;
    if (r < pl.e_sort_n) pl.e_keys[r] = pl.expire_ts[p];
  } else {
    pl.k_list[i - r] = p;
  }
}

__global__ void tw_e_count(const TimePlan pl, long long nb) {
  pl.work[W_E] = pl.block_sums[nb];
}

__global__ void tw_e_keys_pad(const TimePlan pl) {
  long long j = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (j >= pl.e_sort_n) return;
  if (j >= pl.work[W_E]) pl.e_keys[j] = KEY_PAD;
  pl.e_vals[j] = (int)j;
}

__global__ void tw_a_keys(const TimePlan pl) {
  long long j = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (j >= pl.a_sort_n) return;
  pl.a_keys[j] = j < pl.work[W_NA] ? pl.a_ts[j] : KEY_PAD;
  pl.a_vals[j] = (int)j;
}

// number of arrivals (in ts order) with ts < x (strict) or <= x
__device__ long long count_arrivals(const TimePlan& pl, long long x, bool strict) {
  long long lo = 0, hi = pl.work[W_NA];
  while (lo < hi) {
    long long mid = lo + (hi - lo) / 2;
    long long v = pl.a_ts[a_row(pl, mid)];
    if (strict ? v < x : v <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// number of expiring rows with expire_ts <= x
__device__ long long count_expiring(const TimePlan& pl, long long x) {
  long long lo = 0, hi = pl.work[W_E];
  while (lo < hi) {
    long long mid = lo + (hi - lo) / 2;
    if (pl.expire_ts[e_pos(pl, mid)] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// threads [0, e_bound): expiring rows; [e_bound, +arr_cap): arrivals;
// then [.., +cap_out): invalid padding past the emitted rows
__global__ void tw_emit(const TimePlan pl) {
  long long r = (long long)blockIdx.x * BLOCK + threadIdx.x;
  long long e = pl.work[W_E], na = pl.work[W_NA], seq0 = pl.work[W_SEQ];
  bool skip = short_bound(pl);
  if (r < pl.e_bound) {
    if (skip || r >= e) return;
    long long p = e_pos(pl, r);
    long long x = pl.expire_ts[p];
    long long o = r + count_arrivals(pl, x, true);
    if (o >= pl.cap_out) return;
    pl.out_ts[o] = x;
    pl.out_kind[o] = K_EXPIRED;
    pl.out_valid[o] = 1;
    pl.out_seq[o] = seq0 + o;
    pl.out_gslot[o] = pl.gslot[p];
    for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.out_col[c], o, pl.col[c], p, pl.col_bytes[c]);
    return;
  }
  r -= pl.e_bound;
  if (r < pl.arr_cap) {
    if (skip || r >= na) return;
    long long a = a_row(pl, r);
    long long x = pl.a_ts[a];
    long long o = r + count_expiring(pl, x);
    pl.a_seq[r] = seq0 + o;
    if (o >= pl.cap_out) return;
    pl.out_ts[o] = x;
    pl.out_kind[o] = K_CURRENT;
    pl.out_valid[o] = 1;
    pl.out_seq[o] = seq0 + o;
    pl.out_gslot[o] = pl.a_gslot[a];
    for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.out_col[c], o, pl.a_col[c], a, pl.col_bytes[c]);
    return;
  }
  r -= pl.arr_cap;
  if (r < pl.cap_out && (skip || r >= e + na)) {
    pl.out_ts[r] = 0;
    pl.out_kind[r] = 0;
    pl.out_valid[r] = 0;
    pl.out_seq[r] = 0;
    pl.out_gslot[r] = 0;
    for (int c = 0; c < pl.ncols; ++c) store_bits(pl.out_col[c], r, 0, pl.col_bytes[c]);
  }
}

// survivors after the step and the new head (overflow drops the oldest)
__device__ __forceinline__ long long survivors(const TimePlan& pl) {
  return pl.work[W_TAIL] - pl.work[W_HEAD] - pl.work[W_E];
}

__device__ __forceinline__ long long new_head(const TimePlan& pl) {
  long long nk = survivors(pl), na = pl.work[W_NA];
  long long drop = nk + na - pl.C;
  return pl.work[W_TAIL] - nk + (drop > 0 ? drop : 0);
}

// general step: survivors to the stash, then back to the tail end
__global__ void tw_stash(const TimePlan pl) {
  long long j = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (short_bound(pl) || j >= survivors(pl)) return;
  long long p = pl.k_list[j];
  pl.s_ts[j] = pl.ts[p];
  pl.s_add[j] = pl.add_seq[p];
  pl.s_exp[j] = pl.expire_ts[p];
  pl.s_gslot[j] = pl.gslot[p];
  for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.s_col[c], j, pl.col[c], p, pl.col_bytes[c]);
}

__global__ void tw_unstash(const TimePlan pl) {
  long long j = (long long)blockIdx.x * BLOCK + threadIdx.x;
  long long nk = survivors(pl);
  if (short_bound(pl) || j >= nk) return;
  long long logical = pl.work[W_TAIL] - nk + j;
  long long p = phys(pl, logical);
  pl.ts[p] = pl.s_ts[j];
  pl.add_seq[p] = pl.s_add[j];
  pl.expire_ts[p] = pl.s_exp[j];
  pl.gslot[p] = pl.s_gslot[j];
  for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.col[c], p, pl.s_col[c], j, pl.col_bytes[c]);
  if (logical >= new_head(pl))
    atomicMin((long long*)&pl.work[W_WAKE], pl.s_exp[j]);
}

__global__ void tw_append(const TimePlan pl) {
  long long k = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (short_bound(pl) || k >= pl.work[W_NA]) return;
  long long logical = pl.work[W_TAIL] + k;
  if (logical < new_head(pl)) return;
  long long p = phys(pl, logical), a = a_row(pl, k);
  pl.ts[p] = pl.a_ts[a];
  pl.add_seq[p] = pl.a_seq[k];
  pl.expire_ts[p] = pl.a_ts[a] + pl.t;
  pl.gslot[p] = pl.a_gslot[a];
  for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.col[c], p, pl.a_col[c], a, pl.col_bytes[c]);
}

__global__ void tw_finish(const TimePlan pl) {
  long long tail = pl.work[W_TAIL], na = pl.work[W_NA], e = pl.work[W_E];
  if (short_bound(pl)) {
    pl.wake[0] = NO_WAKEUP;
    pl.wake[1] = e - pl.e_bound;
    return;
  }
  long long head2 = new_head(pl), tail2 = tail + na;
  long long wake = pl.work[W_WAKE];
  // survivors and arrivals each rise in expire_ts (in the general step the
  // survivors' least came from tw_unstash): the least alive is the first
  // kept survivor or the first kept arrival
  if (pl.e_prefix && head2 < tail) {
    long long x = pl.expire_ts[phys(pl, head2)];
    wake = x < wake ? x : wake;
  }
  long long fa = head2 > tail ? head2 : tail;
  if (fa < tail2) {
    long long x = pl.expire_ts[phys(pl, fa)];
    wake = x < wake ? x : wake;
  }
  pl.meta[0] = head2;
  pl.meta[1] = tail2;
  pl.meta[2] = (e + na > 0) ? pl.work[W_SEQ] + pl.C + pl.B : pl.work[W_SEQ];
  pl.wake[0] = head2 < tail2 ? wake : NO_WAKEUP;
  pl.wake[1] = 0;
}

inline unsigned blocks(long long n) { return (unsigned)((n + BLOCK - 1) / BLOCK); }

}  // namespace

extern "C" int siddhi_time_plan_size() { return (int)sizeof(TimePlan); }

// Launches on `stream`; returns the launches' cudaError_t (0 = launched).
extern "C" int siddhi_time_window(const TimePlan* plan, void* stream) {
  const TimePlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  tw_begin<<<1, 1, 0, s>>>(pl);
  if (!pl.e_prefix) {
    long long nb = (pl.C + BLOCK - 1) / BLOCK;
    tw_mark<<<(unsigned)nb, BLOCK, 0, s>>>(pl);
    scan_sums_kernel<<<1, SCAN_BLOCK, 0, s>>>(pl.block_sums, nb);
    tw_split<<<(unsigned)nb, BLOCK, 0, s>>>(pl);
    tw_e_count<<<1, 1, 0, s>>>(pl, nb);
    tw_e_keys_pad<<<blocks(pl.e_sort_n), BLOCK, 0, s>>>(pl);
    bitonic_sort(pl.e_keys, pl.e_vals, pl.e_sort_n, s);
  }
  if (!pl.a_sorted) {
    tw_a_keys<<<blocks(pl.a_sort_n), BLOCK, 0, s>>>(pl);
    bitonic_sort(pl.a_keys, pl.a_vals, pl.a_sort_n, s);
  }
  long long n_emit = pl.e_bound + pl.arr_cap + pl.cap_out;
  if (n_emit > 0) tw_emit<<<blocks(n_emit), BLOCK, 0, s>>>(pl);
  if (!pl.e_prefix) {
    tw_stash<<<blocks(pl.C), BLOCK, 0, s>>>(pl);
    tw_unstash<<<blocks(pl.C), BLOCK, 0, s>>>(pl);
  }
  if (pl.arr_cap > 0) tw_append<<<blocks(pl.arr_cap), BLOCK, 0, s>>>(pl);
  tw_finish<<<1, 1, 0, s>>>(pl);
  return (int)cudaGetLastError();
}
