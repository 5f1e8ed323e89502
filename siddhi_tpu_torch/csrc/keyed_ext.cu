// keyed_ext: the keyed window kernels K20-K23, for sm_90a: eight windows
// of a partitioned single-stream query kept once per partition key.
//
// Replace, in the JAX package's keyed query step `kstep`
// (siddhi_tpu/core/planner.py:539-584): the pre-window filters, the gather
// of each key's events to [Kb, E], `window.process` under vmap over the
// [K, ...] slab, the scatter back that drops padding keys, the flattening
// of the rows and the least wake, for
//   K20 keyed_ext:   ExternalTimeWindow, TimeLengthWindow, DelayWindow
//                    (siddhi_tpu/core/window_ext.py:83, :279, :375);
//   K21 keyed_batch: ExternalTimeBatchWindow, ChunkBatchWindow, CronWindow
//                    (:178, :427, :579);
//   K22 keyed_sort:  SortWindow (:496);
//   K23 keyed_hop:   HoppingWindow (:1166).
// kernels/keyed_ext.py states each mode's rows, their order and the slab.
//
// K20, K21 and K23: one block of BLOCK threads owns one key row of key_idx
// at a time (a grid-stride loop over the rows; a padding row, key_idx == K,
// touches nothing).  Output: "count, scan, write at offsets".  kx_count
// gathers the row's kept arrivals (its sel entries that are valid CURRENT
// rows and pass the filters, run as the typed postfix bytecode, one event a
// thread, compacted in batch order by a block scan) into `arr` / `apos`,
// notes a valid TIMER row (cron), and counts the key's output rows; a
// device-wide scan of the counts gives each row's offset and the total (the
// host reads it to size the output).  kx_write runs the key's step: its
// candidates (the slab rows of the key, then its arrivals) are staged in a
// workspace (dynamic shared memory, or a slice of a global buffer when
// C + 2E is large, the grid then smaller), each row's place in the output
// found by a block scan of flags (batch windows, hopping, compactions) or by
// counting, for each candidate, the candidates that order before it (the
// sorted emissions of externalTime, timeLength and delay, the survivors of
// externalTime): O((C + 2E)^2 / BLOCK) comparisons a key, spread over the
// block.  The rows are written at the row's offset; then the key's slab row
// is rewritten one column at a time through a [C] staging array (each kept
// candidate to its new place, synchronise, copy back), so a candidate is
// never overwritten before it is read.  Rows beyond C are counted in the
// wake's second word.
//
// K22 (sort) has a design of its own, with the same protocol (the count
// launch, the scan, one fetch of the total, the write launch).  A key row's
// candidates are its n = cnt + na alive places: the slab rows at [0, cnt) and
// the kept arrivals at C + their sel column.  Its dead places (the other
// C + E - n) are counted, not ranked: a dead place is keyed `dead`, so it
// ranks before an alive key above `dead` (a NaN, a long above BIG_SEQ) and,
// at an equal key, before an alive place behind it.  Two modes, chosen per
// key row on the device from n:
//   * warp mode, n <= SW_LIMIT = 32 * SW_R places (SW_R = 8 places a lane):
//     a warp owns the row.  ks_count gathers the kept arrivals with
//     __ballot_sync / __popc (no block scan, no __syncthreads), stages the
//     candidates' sort keys in the warp's shared slice, then each lane holds
//     up to SW_R keys in registers and ranks them against every candidate
//     by __shfl_sync (ties by place); a candidate is kept when its rank is
//     below min(n, length).  The kept mask (a word per 32 candidates) goes
//     to `kmask` beside `ocnt`; a row stores only its ceil(n / 32) words,
//     since its span of ceil((C + E) / 32) words may be narrower than the
//     lanes' SW_R bucket.  ks_write reads the mask and does not rank
//     again: in rounds of 32 candidates each lane loads its candidate's ts,
//     gslot and columns into registers, __syncwarp, then writes the arrival
//     CURRENT (seq0 + k), an evicted candidate EXPIRED at its ballot prefix
//     (seq0 + na + rank) and a kept one at its compacted slab place (a
//     place is never below an unread candidate's: compaction only moves
//     rows down).
//   * block mode, n > SW_LIMIT (a hot key, or a window longer than the
//     limit): ks_count queues the row in `hot`; ks_count_block (a block of
//     SB_BLOCK threads a queued row) stores the candidates' keys in its
//     slice of the global workspace and finds the place of rank
//     min(n, length) - 1 by an MSD radix select over the keys' 8-bit digits
//     (the dead places counted into their digit): 8 passes of O(n) where a
//     counting rank is O(n^2).  The candidates below it are kept, and of
//     those equal to it the first by place (a block scan).  ks_write_block
//     moves the row as ks_write does, in chunks of SB_BLOCK candidates with
//     a block scan for the ranks.
// The host enables block mode only where C + E > SW_LIMIT, and sizes its
// workspace (C + E keys for each of hot_grid blocks) from (C, E).
//
// Bound: each arrival is read once (its columns, ts, gslot, kind, valid,
// the sel entry) and each output row written once; of the slab, the rows of
// the keys in the batch are read and the rows kept written, plus the per-key
// counters.  Bound by bytes.  K20, K21 and K23 keep the block-per-row
// design: the counting rank is quadratic in a key's rows and the
// column-at-a-time rewrite moves every kept row of a stepped key.
#include <climits>

#include "bytecode.cuh"
#include "rows.cuh"

using namespace siddhi;

namespace {

constexpr int MAX_COLS = 16;
constexpr int MAX_CODE = 256;
constexpr int BLOCK = 128;
constexpr long long NO_WAKEUP = BIG_SEQ;
constexpr long long INV = LLONG_MAX;       // the key of a place that is not ranked
constexpr long long FLIP = 0x7fffffffffffffffLL;
constexpr unsigned long long CANON_NAN = 0x7ff8000000000000ULL;

enum : int {
  M_EXT = 6, M_TLEN = 7, M_DELAY = 8, M_XBATCH = 9, M_CHUNK = 10, M_CRON = 11, M_SORT = 12,
  M_HOP = 13
};
enum : int { KT_I32 = 0, KT_I64 = 1, KT_F32 = 2 };   // sort key types (bool is int32)

}  // namespace

// Mirrored field for field by kernels/keyed_ext.py (ctypes.Structure).
struct ExtPlan {
  long long Kb, E, K, C, now, t, length, win, hop, cap, dead, ws_words;
  int mode, ncols, code_len, ts_pos, key_pos, key_type, desc, ws_global;
  int col_ty[MAX_COLS];
  int col_w[MAX_COLS];
  long long col_def[MAX_COLS];
  int code[MAX_CODE];
  const long long* ts;
  const int* kind;
  const unsigned char* valid;
  const int* gslot;
  const void* col[MAX_COLS];
  const int* key_idx;
  const int* sel;
  long long* s_ts;
  int* s_gslot;
  void* s_col[MAX_COLS];
  int* count;
  long long* seq;
  long long* p_ts;          // externalTimeBatch / cron: the previous block
  int* p_gslot;
  void* p_col[MAX_COLS];
  int* p_count;
  long long* kstate;        // externalTimeBatch's start, hopping's next
  int* arr;                 // [Kb, E] each row's kept arrivals (batch rows)
  int* apos;                // [Kb, E] their sel columns
  int* n_arr;               // [Kb]
  int* timer;               // [Kb] a valid TIMER row in the key row
  long long* ocnt;          // [Kb] output rows, then their offsets
  long long* sums;          // the scan's block sums, the total last
  long long* ws;            // the global workspace (ws_global)
  long long* out_ts;
  int* out_kind;
  long long* out_seq;
  int* out_gslot;
  void* out_col[MAX_COLS];
  long long* wake;          // [least wake, rows that did not fit]
  unsigned* kmask;          // sort: [Kb, mwords] each row's kept candidates
  int* hot;                 // sort: the block-mode rows' count, then the rows
  long long mwords, hot_grid;   // hot_grid: block mode's blocks (0: off)
  InSet in_sets[MAX_IN];
};

namespace {

// The key a key row steps, or -1 for a padding row.
__device__ __forceinline__ long long key_of(const ExtPlan& pl, long long r) {
  long long k = pl.key_idx[r];
  return (k >= 0 && k < pl.K) ? k : -1;
}

// A column element as int64 (the event-time attribute's astype(int64)).
__device__ __forceinline__ long long load_i64(const void* p, long long i, int ty) {
  if (ty == T_I64) return ((const long long*)p)[i];
  if (ty == T_F32) return (long long)((const float*)p)[i];
  return (long long)((const int*)p)[i];
}

// Block reductions (every thread calls them; `sh` holds 2 * BLOCK values).
__device__ long long block_sum(long long v, long long* sh) {
  long long tot;
  block_excl_scan<BLOCK>(v, sh, &tot);
  return tot;
}

template <bool MAX>
__device__ long long block_ext(long long v, long long* sh) {
  int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int s = BLOCK / 2; s > 0; s >>= 1) {
    if (t < s) {
      long long o = sh[t + s];
      if (MAX ? o > sh[t] : o < sh[t]) sh[t] = o;
    }
    __syncthreads();
  }
  long long r = sh[0];
  __syncthreads();
  return r;
}

// The candidates of a key: its slab rows [0, cnt) of a block, then its
// arrivals [cnt, cnt + na).
struct Cands {
  const long long* ts;
  const int* gs;
  void* const* col;
  long long base, cnt;
  const int* arr;
  long long na;
};

__device__ __forceinline__ long long cand_ts(const ExtPlan& pl, const Cands& c, long long i) {
  return i < c.cnt ? c.ts[c.base + i] : pl.ts[c.arr[i - c.cnt]];
}

// Candidate i's column q as raw bits (q = -2: ts, -1: gslot).
__device__ __forceinline__ long long cand_raw(const ExtPlan& pl, const Cands& c, long long i, int q) {
  bool s = i < c.cnt;
  long long j = s ? c.base + i : (long long)c.arr[i - c.cnt];
  if (q == -2) return s ? c.ts[j] : pl.ts[j];
  if (q == -1) return s ? c.gs[j] : pl.gslot[j];
  return load_raw(s ? (const void*)c.col[q] : pl.col[q], j, pl.col_w[q]);
}

__device__ __forceinline__ long long cand_i64(const ExtPlan& pl, const Cands& c, long long i, int q) {
  bool s = i < c.cnt;
  long long j = s ? c.base + i : (long long)c.arr[i - c.cnt];
  return load_i64(s ? (const void*)c.col[q] : pl.col[q], j, pl.col_ty[q]);
}

// Output row o: candidate i's gslot and columns with `kind`, ts and seq.
__device__ void emit(const ExtPlan& pl, const Cands& c, long long o, long long i, int kind,
                     long long ts, long long seq) {
  if (o >= pl.cap) return;
  pl.out_ts[o] = ts;
  pl.out_kind[o] = kind;
  pl.out_seq[o] = seq;
  pl.out_gslot[o] = (int)cand_raw(pl, c, i, -1);
  for (int q = 0; q < pl.ncols; ++q) store_bits(pl.out_col[q], o, cand_raw(pl, c, i, q), pl.col_w[q]);
}

__device__ void emit_reset(const ExtPlan& pl, long long o, long long seq) {
  if (o >= pl.cap) return;
  pl.out_ts[o] = pl.now;
  pl.out_kind[o] = K_RESET;
  pl.out_seq[o] = seq;
  pl.out_gslot[o] = -1;
  for (int q = 0; q < pl.ncols; ++q) store_bits(pl.out_col[q], o, pl.col_def[q], pl.col_w[q]);
}

// A block scan of flags over [0, n): fn(i, rank) for each flagged i, in
// order; returns their number.
template <class Flag, class Fn>
__device__ long long scan_flags(long long n, Flag flag, Fn fn, long long* sh) {
  long long base = 0;
  for (long long i0 = 0; i0 < n; i0 += BLOCK) {
    long long i = i0 + threadIdx.x;
    bool f = i < n && flag(i);
    long long tot;
    long long ex = block_excl_scan<BLOCK>((long long)f, sh, &tot);
    if (f) fn(i, base + ex);
    base += tot;
  }
  return base;
}

// rk[i] = the place of i in the stable order of key[0, n) (ties by index),
// for every i whose key is not INV.
__device__ void count_rank(const long long* key, long long* rk, long long n) {
  for (long long i = threadIdx.x; i < n; i += BLOCK) {
    long long ki = key[i];
    if (ki == INV) continue;
    long long r = 0;
    for (long long j = 0; j < n; ++j) {
      long long kj = key[j];
      r += kj < ki || (kj == ki && j < i);
    }
    rk[i] = r;
  }
  __syncthreads();
}

// Rewrite a key's block (main or previous) at `base`: candidate i goes to
// place dst[i] (< 0: dropped, >= C: beyond the block), n rows after.
__device__ void rewrite(const ExtPlan& pl, const Cands& c, long long ncand, const long long* dst,
                        long long* d_ts, int* d_gs, void* const* d_col, long long base, long long n,
                        long long* tmp) {
  for (int q = -2; q < pl.ncols; ++q) {
    for (long long i = threadIdx.x; i < ncand; i += BLOCK) {
      long long d = dst[i];
      if (d >= 0 && d < pl.C) tmp[d] = cand_raw(pl, c, i, q);
    }
    __syncthreads();
    for (long long p = threadIdx.x; p < n; p += BLOCK) {
      if (q == -2) d_ts[base + p] = tmp[p];
      else if (q == -1) d_gs[base + p] = (int)tmp[p];
      else store_bits(d_col[q], base + p, tmp[p], pl.col_w[q]);
    }
    __syncthreads();
  }
}

// Copy candidate i into a block's place p (the batch family: no overlap).
__device__ void put(const ExtPlan& pl, const Cands& c, long long i, long long* d_ts, int* d_gs,
                    void* const* d_col, long long p) {
  d_ts[p] = cand_raw(pl, c, i, -2);
  d_gs[p] = (int)cand_raw(pl, c, i, -1);
  for (int q = 0; q < pl.ncols; ++q) store_bits(d_col[q], p, cand_raw(pl, c, i, q), pl.col_w[q]);
}

__device__ __forceinline__ void add_missed(const ExtPlan& pl, long long m) {
  if (m > 0 && threadIdx.x == 0) atomicAdd((unsigned long long*)(pl.wake + 1), (unsigned long long)m);
}

__device__ __forceinline__ void min_wake(const ExtPlan& pl, long long w) {
  if (w < NO_WAKEUP && threadIdx.x == 0) atomicMin(pl.wake, w);
}

// sort's key of a key column element (its raw bits), as an int64 in the
// reference's order.
__device__ long long sort_key(const ExtPlan& pl, long long raw) {
  if (pl.key_type == KT_F32) {
    float f = __int_as_float((int)raw);
    if (pl.desc) f = -f;
    double d = (double)f;
    unsigned long long bits;
    if (d != d) bits = CANON_NAN;
    else if (d == 0.0) bits = 0ULL;
    else bits = (unsigned long long)__double_as_longlong(d);
    long long b = (long long)bits;
    return b < 0 ? b ^ FLIP : b;
  }
  if (pl.key_type == KT_I64) return pl.desc ? (long long)(0ULL - (unsigned long long)raw) : raw;
  int v = (int)raw;
  if (pl.desc) v = (int)(0u - (unsigned)v);
  return (long long)v;
}

// The state a step reads, per key row.
struct Key {
  long long r, k, cnt, pc, seq0, na, o;
  bool timer;
  const int* arr;
  const int* apos;
};

__device__ Cands main_cands(const ExtPlan& pl, const Key& y) {
  return Cands{pl.s_ts, pl.s_gslot, pl.s_col, y.k * pl.C, y.cnt, y.arr, y.na};
}

// ---- K20: externalTime ------------------------------------------------------
template <bool W>
__device__ long long step_ext(const ExtPlan& pl, const Key& y, long long* ws, long long* sh) {
  const Cands c = main_cands(pl, y);
  const long long n = y.cnt + y.na, t = pl.t;
  long long m = -BIG_SEQ;
  for (long long a = threadIdx.x; a < y.na; a += BLOCK) {
    long long e = cand_i64(pl, c, y.cnt + a, pl.ts_pos);
    if (e > m) m = e;
  }
  const long long ext_now = block_ext<true>(m, sh);
  long long* key = ws;
  long long* rk = ws + 2 * n + 2;
  long long* dst = rk + 2 * n + 2;
  long long* tmp = dst + n + 1;
  // emission places: the candidates expiring, then the arrivals CURRENT
  long long nd = 0;
  for (long long i = threadIdx.x; i < n; i += BLOCK) {
    long long e = cand_i64(pl, c, i, pl.ts_pos);
    bool due = e + t <= ext_now;
    nd += due;
    key[i] = due ? 2 * (e + t) : INV;
    if (i >= y.cnt) key[n + i - y.cnt] = 2 * e + 1;
  }
  const long long n_due = block_sum(nd, sh);
  if (!W) return n_due + y.na;
  count_rank(key, rk, n + y.na);
  for (long long i = threadIdx.x; i < n + y.na; i += BLOCK) {
    if (key[i] == INV) continue;
    long long r = rk[i];
    if (i < n)
      emit(pl, c, y.o + r, i, K_EXPIRED, cand_i64(pl, c, i, pl.ts_pos) + t, y.seq0 + r);
    else
      emit(pl, c, y.o + r, y.cnt + i - n, K_CURRENT, cand_ts(pl, c, y.cnt + i - n), y.seq0 + r);
  }
  __syncthreads();
  // survivors by (event time, candidate place); the oldest beyond C drop
  for (long long i = threadIdx.x; i < n; i += BLOCK) {
    long long e = cand_i64(pl, c, i, pl.ts_pos);
    key[i] = e + t <= ext_now ? INV : e;
  }
  __syncthreads();
  count_rank(key, rk, n);
  long long nk = 0;
  for (long long i = threadIdx.x; i < n; i += BLOCK) nk += key[i] != INV;
  const long long total = block_sum(nk, sh);
  const long long drop = total > pl.C ? total - pl.C : 0;
  for (long long i = threadIdx.x; i < n; i += BLOCK) dst[i] = key[i] == INV ? -1 : rk[i] - drop;
  __syncthreads();
  rewrite(pl, c, n, dst, pl.s_ts, pl.s_gslot, pl.s_col, y.k * pl.C, total - drop, tmp);
  if (threadIdx.x == 0) {
    pl.count[y.k] = (int)(total - drop);
    pl.seq[y.k] = y.seq0 + n_due + y.na;
  }
  add_missed(pl, drop);
  return 0;
}

// ---- K20: timeLength --------------------------------------------------------
template <bool W>
__device__ long long step_tlen(const ExtPlan& pl, const Key& y, long long* ws, long long* sh) {
  const Cands c = main_cands(pl, y);
  const long long n = y.cnt + y.na, t = pl.t, len = pl.length, now = pl.now;
  long long* key = ws;
  long long* rk = ws + 2 * n + 2;
  long long* inv = rk + 2 * n + 2;          // survivor v -> its candidate
  long long* dst = inv + n + 1;
  long long* tmp = dst + n + 1;
  long long nd = 0;
  for (long long i = threadIdx.x; i < y.cnt; i += BLOCK) nd += cand_ts(pl, c, i) + t <= now;
  const long long n_due = block_sum(nd, sh);
  const long long count0 = y.cnt - n_due;
  long long nev = count0 + y.na - len;
  nev = nev < 0 ? 0 : (nev > y.na ? y.na : nev);
  if (!W) return n_due + nev + y.na;
  scan_flags(
      y.cnt, [&](long long i) { return cand_ts(pl, c, i) + t > now; },
      [&](long long i, long long s) { inv[s] = i; }, sh);
  __syncthreads();
  // virtual index v: survivor v, else arrival v - count0
  auto virt = [&](long long v) { return v < count0 ? inv[v] : y.cnt + v - count0; };
  // places: the expiring rows, the evictions, the arrivals
  for (long long i = threadIdx.x; i < y.cnt; i += BLOCK) {
    long long ts = cand_ts(pl, c, i);
    key[i] = ts + t <= now ? 4 * (ts + t) : INV;
  }
  for (long long a = threadIdx.x; a < y.na; a += BLOCK) {
    long long ts = cand_ts(pl, c, y.cnt + a);
    key[y.cnt + a] = count0 + a - len >= 0 ? 4 * ts + 1 : INV;
    key[n + a] = 4 * ts + 2;
  }
  __syncthreads();
  count_rank(key, rk, n + y.na);
  for (long long i = threadIdx.x; i < n + y.na; i += BLOCK) {
    if (key[i] == INV) continue;
    long long r = rk[i], o = y.o + r, sq = y.seq0 + r;
    if (i < y.cnt) {
      emit(pl, c, o, i, K_EXPIRED, cand_ts(pl, c, i) + t, sq);
    } else if (i < n) {
      long long a = i - y.cnt;
      emit(pl, c, o, virt(count0 + a - len), K_EXPIRED, cand_ts(pl, c, y.cnt + a), sq);
    } else {
      long long a = i - n;
      emit(pl, c, o, y.cnt + a, K_CURRENT, cand_ts(pl, c, y.cnt + a), sq);
    }
  }
  __syncthreads();
  // the last `len` of the survivors and arrivals: the survivors in order,
  // then the kept arrivals by (ts, k)
  const long long total = count0 + y.na;
  const long long start = total > len ? total - len : 0;
  const long long ks = count0 > start ? count0 - start : 0;
  const long long a0 = start > count0 ? start - count0 : 0;
  for (long long i = threadIdx.x; i < n; i += BLOCK) dst[i] = -1;
  for (long long a = threadIdx.x; a < y.na; a += BLOCK)
    key[a] = a >= a0 ? cand_ts(pl, c, y.cnt + a) : INV;
  __syncthreads();
  count_rank(key, rk, y.na);
  long long mw = NO_WAKEUP;
  for (long long v = start + threadIdx.x; v < count0; v += BLOCK) {
    dst[inv[v]] = v - start;
    long long w = cand_ts(pl, c, inv[v]) + t;
    if (w < mw) mw = w;
  }
  for (long long a = a0 + threadIdx.x; a < y.na; a += BLOCK) {
    dst[y.cnt + a] = ks + rk[a];
    long long w = cand_ts(pl, c, y.cnt + a) + t;
    if (w < mw) mw = w;
  }
  __syncthreads();
  const long long wk = block_ext<false>(mw, sh);
  rewrite(pl, c, n, dst, pl.s_ts, pl.s_gslot, pl.s_col, y.k * pl.C, total - start, tmp);
  if (threadIdx.x == 0) {
    pl.count[y.k] = (int)(total - start);
    pl.seq[y.k] = y.seq0 + n_due + nev + y.na;
  }
  min_wake(pl, wk);
  return 0;
}

// ---- K20: delay -------------------------------------------------------------
template <bool W>
__device__ long long step_delay(const ExtPlan& pl, const Key& y, long long* ws, long long* sh) {
  const Cands c = main_cands(pl, y);
  const long long n = y.cnt + y.na, t = pl.t, now = pl.now;
  long long* key = ws;
  long long* rk = ws + n + 1;
  long long* dst = rk + n + 1;
  long long* tmp = dst + n + 1;
  long long nr = 0;
  for (long long i = threadIdx.x; i < n; i += BLOCK) {
    long long rel = cand_ts(pl, c, i) + t;
    nr += rel <= now;
    key[i] = rel <= now ? rel : INV;
  }
  const long long n_rel = block_sum(nr, sh);
  if (!W) return n_rel;
  count_rank(key, rk, n);
  for (long long i = threadIdx.x; i < n; i += BLOCK)
    if (key[i] != INV) emit(pl, c, y.o + rk[i], i, K_CURRENT, cand_ts(pl, c, i), y.seq0 + rk[i]);
  for (long long i = threadIdx.x; i < n; i += BLOCK) dst[i] = -1;
  __syncthreads();
  long long mw = NO_WAKEUP;
  const long long nk = scan_flags(
      n, [&](long long i) { return key[i] == INV; },
      [&](long long i, long long d) {
        dst[i] = d;
        long long w = cand_ts(pl, c, i) + t;
        if (d < pl.C && w < mw) mw = w;
      },
      sh);
  __syncthreads();
  const long long wk = block_ext<false>(mw, sh);
  const long long kept = nk < pl.C ? nk : pl.C;
  rewrite(pl, c, n, dst, pl.s_ts, pl.s_gslot, pl.s_col, y.k * pl.C, kept, tmp);
  if (threadIdx.x == 0) {
    pl.count[y.k] = (int)kept;
    pl.seq[y.k] = y.seq0 + n_rel;
  }
  add_missed(pl, nk - kept);
  min_wake(pl, wk);
  return 0;
}

// ---- K21: the batch family --------------------------------------------------
// A flush's rows: the previous block EXPIRED (seq0 + p), a RESET row at
// seq0 + s_reset, then the pending rows [0, cnt) and `extra` more (arrivals
// whose flag holds) CURRENT at seq0 + s_reset + 1 + rank.
template <class Flag>
__device__ void flush_rows(const ExtPlan& pl, const Key& y, const Cands& c, long long s_reset,
                           long long npend, Flag flag, long long* sh) {
  const long long C = pl.C, base = y.k * C;
  const Cands q{pl.p_ts, pl.p_gslot, pl.p_col, base, y.pc, y.arr, 0};
  for (long long p = threadIdx.x; p < y.pc; p += BLOCK)
    emit(pl, q, y.o + p, p, K_EXPIRED, pl.p_ts[base + p], y.seq0 + p);
  if (threadIdx.x == 0) emit_reset(pl, y.o + y.pc, y.seq0 + s_reset);
  const long long o1 = y.o + y.pc + 1, s1 = y.seq0 + s_reset + 1;
  for (long long i = threadIdx.x; i < npend; i += BLOCK)
    emit(pl, c, o1 + i, i, K_CURRENT, cand_ts(pl, c, i), s1 + i);
  scan_flags(
      y.na, flag,
      [&](long long a, long long r) {
        emit(pl, c, o1 + npend + r, c.cnt + a, K_CURRENT, cand_ts(pl, c, c.cnt + a),
             s1 + npend + r);
      },
      sh);
  __syncthreads();
}

template <bool W>
__device__ long long step_xbatch(const ExtPlan& pl, const Key& y, long long* sh) {
  const Cands c = main_cands(pl, y);
  const long long C = pl.C, base = y.k * C, t = pl.t;
  long long lo = BIG_SEQ, hi = -BIG_SEQ;
  for (long long a = threadIdx.x; a < y.na; a += BLOCK) {
    long long e = cand_i64(pl, c, y.cnt + a, pl.ts_pos);
    if (e < lo) lo = e;
    if (e > hi) hi = e;
  }
  const long long first = block_ext<false>(lo, sh), last = block_ext<true>(hi, sh);
  const long long start0 = pl.kstate[y.k];
  const long long start = start0 >= 0 ? start0 : first;
  const long long nflush = y.na > 0 ? (last - start > 0 ? last - start : 0) / t : 0;
  const bool flush = nflush > 0;
  const long long boundary = start + (flush ? nflush : 1) * t;
  auto early = [&](long long a) { return cand_i64(pl, c, y.cnt + a, pl.ts_pos) < boundary; };
  long long ne = 0;
  for (long long a = threadIdx.x; a < y.na; a += BLOCK) ne += early(a);
  const long long n_in = block_sum(ne, sh);
  if (!W) return flush ? y.pc + 1 + y.cnt + n_in : 0;
  long long missed = 0;
  if (flush) {
    flush_rows(pl, y, c, C, y.cnt, early, sh);
    // the pending rows and the early arrivals become the previous block
    for (long long i = threadIdx.x; i < y.cnt && i < C; i += BLOCK)
      put(pl, c, i, pl.p_ts, pl.p_gslot, pl.p_col, base + i);
    scan_flags(
        y.na, early,
        [&](long long a, long long r) {
          if (y.cnt + r < C) put(pl, c, y.cnt + a, pl.p_ts, pl.p_gslot, pl.p_col, base + y.cnt + r);
        },
        sh);
    __syncthreads();
    // the later arrivals become the pending block
    const long long nn = scan_flags(
        y.na, [&](long long a) { return !early(a); },
        [&](long long a, long long r) {
          if (r < C) put(pl, c, y.cnt + a, pl.s_ts, pl.s_gslot, pl.s_col, base + r);
        },
        sh);
    long long fill = y.cnt + n_in;
    missed = (fill > C ? fill - C : 0) + (nn > C ? nn - C : 0);
    if (threadIdx.x == 0) {
      pl.p_count[y.k] = (int)(fill < C ? fill : C);
      pl.count[y.k] = (int)(nn < C ? nn : C);
    }
  } else {
    scan_flags(
        y.na, early,
        [&](long long a, long long r) {
          if (y.cnt + r < C) put(pl, c, y.cnt + a, pl.s_ts, pl.s_gslot, pl.s_col, base + y.cnt + r);
        },
        sh);
    long long fill = y.cnt + n_in;
    missed = fill > C ? fill - C : 0;
    if (threadIdx.x == 0) pl.count[y.k] = (int)(fill < C ? fill : C);
  }
  if (threadIdx.x == 0) {
    pl.kstate[y.k] = (start0 >= 0 || y.na > 0) ? (flush ? start + nflush * t : start) : -1;
    pl.seq[y.k] = flush ? y.seq0 + 2 * C + pl.E + 2 : y.seq0;
  }
  add_missed(pl, missed);
  return 0;
}

template <bool W>
__device__ long long step_chunk(const ExtPlan& pl, const Key& y, long long* sh) {
  const Cands c = main_cands(pl, y);
  const long long C = pl.C, base = y.k * C;
  const bool flush = y.na > 0;
  if (!W) return flush ? y.cnt + 1 + y.na : 0;
  if (!flush) return 0;
  // the previous chunk is the slab's main block: it comes out EXPIRED
  const Cands q{pl.s_ts, pl.s_gslot, pl.s_col, base, y.cnt, y.arr, y.na};
  for (long long p = threadIdx.x; p < y.cnt; p += BLOCK)
    emit(pl, q, y.o + p, p, K_EXPIRED, pl.s_ts[base + p], y.seq0 + p);
  if (threadIdx.x == 0) emit_reset(pl, y.o + y.cnt, y.seq0 + y.cnt);
  for (long long a = threadIdx.x; a < y.na; a += BLOCK)
    emit(pl, c, y.o + y.cnt + 1 + a, y.cnt + a, K_CURRENT, cand_ts(pl, c, y.cnt + a),
         y.seq0 + y.cnt + 1 + a);
  __syncthreads();
  for (long long a = threadIdx.x; a < y.na && a < C; a += BLOCK)
    put(pl, c, y.cnt + a, pl.s_ts, pl.s_gslot, pl.s_col, base + a);
  if (threadIdx.x == 0) {
    pl.count[y.k] = (int)(y.na < C ? y.na : C);
    pl.seq[y.k] = y.seq0 + y.cnt + 1 + y.na;
  }
  add_missed(pl, y.na - C);
  return 0;
}

template <bool W>
__device__ long long step_cron(const ExtPlan& pl, const Key& y, long long* sh) {
  const Cands c = main_cands(pl, y);
  const long long C = pl.C, base = y.k * C;
  const bool flush = y.timer;
  if (!W) return flush ? y.pc + 1 + y.cnt : 0;
  long long fill;
  if (flush) {
    flush_rows(pl, y, c, C, y.cnt, [](long long) { return false; }, sh);
    for (long long i = threadIdx.x; i < y.cnt; i += BLOCK)
      put(pl, c, i, pl.p_ts, pl.p_gslot, pl.p_col, base + i);
    __syncthreads();
    for (long long a = threadIdx.x; a < y.na && a < C; a += BLOCK)
      put(pl, c, y.cnt + a, pl.s_ts, pl.s_gslot, pl.s_col, base + a);
    fill = y.na;
    if (threadIdx.x == 0) {
      pl.p_count[y.k] = (int)y.cnt;
      pl.seq[y.k] = y.seq0 + 2 * C + 1;
    }
  } else {
    for (long long a = threadIdx.x; a < y.na && y.cnt + a < C; a += BLOCK)
      put(pl, c, y.cnt + a, pl.s_ts, pl.s_gslot, pl.s_col, base + y.cnt + a);
    fill = y.cnt + y.na;
  }
  if (threadIdx.x == 0) pl.count[y.k] = (int)(fill < C ? fill : C);
  add_missed(pl, fill - C);
  return 0;
}

// ---- K23: hopping -----------------------------------------------------------
template <bool W>
__device__ long long step_hop(const ExtPlan& pl, const Key& y, long long* ws, long long* sh) {
  const Cands c = main_cands(pl, y);
  const long long C = pl.C, n = y.cnt + y.na, win = pl.win, hop = pl.hop, now = pl.now;
  long long lo = BIG_SEQ;
  for (long long a = threadIdx.x; a < y.na; a += BLOCK) {
    long long ts = cand_ts(pl, c, y.cnt + a);
    if (ts < lo) lo = ts;
  }
  const long long first = block_ext<false>(lo, sh);
  const long long next0 = pl.kstate[y.k];
  const long long nxt = next0 >= 0 ? next0 : (y.na > 0 ? first + hop : -1);
  const bool flush = nxt >= 0 && now >= nxt;
  const long long emit_ts = flush ? nxt + ((now - nxt) / hop) * hop : nxt;
  const long long pts = emit_ts - hop;
  auto in_prev = [&](long long i) {
    long long ts = cand_ts(pl, c, i);
    return ts >= pts - win && ts < pts;
  };
  auto in_cur = [&](long long i) {
    long long ts = cand_ts(pl, c, i);
    return ts >= emit_ts - win && ts < emit_ts;
  };
  long long np = 0, nc = 0;
  if (flush)
    for (long long i = threadIdx.x; i < n; i += BLOCK) {
      np += in_prev(i);
      nc += in_cur(i);
    }
  const long long n_prev = block_sum(np, sh), n_cur = block_sum(nc, sh);
  if (!W) return flush ? n_prev + 1 + n_cur : 0;
  const long long CB = C + pl.E;
  if (flush) {
    scan_flags(
        n, in_prev,
        [&](long long i, long long r) {
          emit(pl, c, y.o + r, i, K_EXPIRED, cand_ts(pl, c, i), y.seq0 + r);
        },
        sh);
    if (threadIdx.x == 0) emit_reset(pl, y.o + n_prev, y.seq0 + CB);
    scan_flags(
        n, in_cur,
        [&](long long i, long long r) {
          emit(pl, c, y.o + n_prev + 1 + r, i, K_CURRENT, cand_ts(pl, c, i), y.seq0 + CB + 1 + r);
        },
        sh);
  }
  long long* dst = ws;
  long long* tmp = ws + n + 1;
  const long long new_next = flush ? emit_ts + hop : nxt;
  for (long long i = threadIdx.x; i < n; i += BLOCK) dst[i] = -1;
  __syncthreads();
  const long long nk = scan_flags(
      n, [&](long long i) { return new_next < 0 || cand_ts(pl, c, i) >= new_next - win - hop; },
      [&](long long i, long long d) { dst[i] = d; }, sh);
  __syncthreads();
  const long long kept = nk < C ? nk : C;
  rewrite(pl, c, n, dst, pl.s_ts, pl.s_gslot, pl.s_col, y.k * C, kept, tmp);
  if (threadIdx.x == 0) {
    pl.count[y.k] = (int)kept;
    pl.kstate[y.k] = new_next;
    pl.seq[y.k] = flush ? y.seq0 + 2 * CB + 2 : y.seq0;
  }
  add_missed(pl, nk - kept);
  if (new_next >= 0) min_wake(pl, new_next);
  return 0;
}

// The modes of the block-per-row kernels: K20 (F_EXT), K21 (F_BATCH), K23.
enum : int { F_EXT = 0, F_BATCH = 1, F_HOP = 3 };

template <bool W, int F>
__device__ long long step(const ExtPlan& pl, const Key& y, long long* ws, long long* sh) {
  if (F == F_EXT) {
    if (pl.mode == M_EXT) return step_ext<W>(pl, y, ws, sh);
    if (pl.mode == M_TLEN) return step_tlen<W>(pl, y, ws, sh);
    return step_delay<W>(pl, y, ws, sh);
  }
  if (F == F_BATCH) {
    if (pl.mode == M_XBATCH) return step_xbatch<W>(pl, y, sh);
    if (pl.mode == M_CHUNK) return step_chunk<W>(pl, y, sh);
    return step_cron<W>(pl, y, sh);
  }
  return step_hop<W>(pl, y, ws, sh);
}

__device__ Key key_row(const ExtPlan& pl, long long r, long long k) {
  Key y;
  y.r = r;
  y.k = k;
  y.cnt = pl.count[k];
  y.pc = pl.p_count ? pl.p_count[k] : 0;
  y.seq0 = pl.seq[k];
  y.arr = pl.arr + r * pl.E;
  y.apos = pl.apos + r * pl.E;
  y.na = pl.n_arr[r];
  y.timer = pl.timer[r] != 0;
  y.o = 0;
  return y;
}

__device__ long long* workspace(const ExtPlan& pl) {
  extern __shared__ long long dyn[];
  return pl.ws_global ? pl.ws + (long long)blockIdx.x * pl.ws_words : dyn;
}

// Batch row i (-1: none) of a key row: `keep` a kept arrival (a valid
// CURRENT row that passes the filters), `timer` a valid TIMER row.
__device__ __forceinline__ void arrival_test(const ExtPlan& pl, long long i, bool& keep,
                                             bool& timer) {
  keep = timer = false;
  if (i < 0) return;
  timer = pl.valid[i] && pl.kind[i] == K_TIMER;
  keep = pl.valid[i] && pl.kind[i] == K_CURRENT;
  if (keep && pl.code_len > 0)
    keep = eval_bytecode_in(
        pl.code, pl.code_len, [&](int q) { return load_slot(pl.col[q], i, pl.col_ty[q]); },
        [&](int, int) { return 0LL; }, pl.in_sets);
}

__global__ void kx_init(const ExtPlan pl) {
  pl.wake[0] = NO_WAKEUP;
  pl.wake[1] = 0;
  if (pl.hot) pl.hot[0] = 0;
}

template <int F>
__global__ void __launch_bounds__(BLOCK) kx_count(const ExtPlan pl) {
  __shared__ long long sh[2 * BLOCK];
  long long* ws = workspace(pl);
  for (long long r = blockIdx.x; r < pl.Kb; r += gridDim.x) {
    long long k = key_of(pl, r);
    if (k < 0) {
      if (threadIdx.x == 0) pl.ocnt[r] = pl.n_arr[r] = pl.timer[r] = 0;
      continue;
    }
    // the key row's kept arrivals, compacted in batch order
    int* arr = pl.arr + r * pl.E;
    int* apos = pl.apos + r * pl.E;
    long long na = 0;
    int tick = 0;
    for (long long e0 = 0; e0 < pl.E; e0 += BLOCK) {
      long long e = e0 + threadIdx.x;
      long long i = e < pl.E ? pl.sel[r * pl.E + e] : -1;
      bool keep, timer;
      arrival_test(pl, i, keep, timer);
      tick |= __syncthreads_or(timer);
      long long tot;
      long long ex = block_excl_scan<BLOCK>((long long)keep, sh, &tot);
      if (keep) {
        arr[na + ex] = (int)i;
        apos[na + ex] = (int)e;
      }
      na += tot;
    }
    if (threadIdx.x == 0) {
      pl.n_arr[r] = (int)na;
      pl.timer[r] = tick;
    }
    __syncthreads();
    Key y = key_row(pl, r, k);
    y.na = na;
    y.timer = tick != 0;
    long long rows = step<false, F>(pl, y, ws, sh);
    if (threadIdx.x == 0) pl.ocnt[r] = rows;
    __syncthreads();
  }
}

template <int F>
__global__ void __launch_bounds__(BLOCK) kx_write(const ExtPlan pl) {
  __shared__ long long sh[2 * BLOCK];
  long long* ws = workspace(pl);
  for (long long r = blockIdx.x; r < pl.Kb; r += gridDim.x) {
    long long k = key_of(pl, r);
    if (k < 0) continue;
    Key y = key_row(pl, r, k);
    y.o = pl.ocnt[r];
    // every thread has read the key's counters before any moves them
    __syncthreads();
    step<true, F>(pl, y, ws, sh);
    __syncthreads();
  }
}

// The grid: a block per key row, or as many blocks as the global
// workspace holds (each then loops over key rows).
inline unsigned grid(const ExtPlan& pl) {
  long long g = pl.Kb < (pl.ws_global ? 1024 : (1LL << 20)) ? pl.Kb
                                                             : (pl.ws_global ? 1024 : (1LL << 20));
  return (unsigned)(g > 0 ? g : 1);
}

inline size_t smem(const ExtPlan& pl) {
  return pl.ws_global ? 0 : (size_t)pl.ws_words * sizeof(long long);
}

template <int F>
int count_launch(const ExtPlan* plan, void* stream) {
  const ExtPlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  size_t b = smem(pl);
  if (b > 48 * 1024) {
    int e = (int)cudaFuncSetAttribute(kx_count<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)b);
    if (!e)
      e = (int)cudaFuncSetAttribute(kx_write<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b);
    if (e) return e;
  }
  kx_init<<<1, 1, 0, s>>>(pl);
  kx_count<F><<<grid(pl), BLOCK, b, s>>>(pl);
  if (pl.Kb > 0) exclusive_scan(pl.ocnt, pl.Kb, pl.sums, s);
  return (int)cudaGetLastError();
}

template <int F>
int write_launch(const ExtPlan* plan, void* stream) {
  const ExtPlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  kx_write<F><<<grid(pl), BLOCK, smem(pl), s>>>(pl);
  return (int)cudaGetLastError();
}


// ---- K22: sort, warp mode and block mode ------------------------------------
constexpr int SW_WARPS = 8;                 // warps a block (warp mode)
constexpr int SW_R = 8;                     // candidates a lane (warp mode)
constexpr int SW_LIMIT = 32 * SW_R;         // a warp-mode row's candidates
constexpr int SB_BLOCK = 256;               // threads a block-mode row (= the radix)
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long SIGN = 0x8000000000000000ULL;

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

__device__ __forceinline__ long long slab_key(const ExtPlan& pl, long long k, long long i) {
  return sort_key(pl, load_raw(pl.s_col[pl.key_pos], k * pl.C + i, pl.col_w[pl.key_pos]));
}

__device__ __forceinline__ long long batch_key(const ExtPlan& pl, long long i) {
  return sort_key(pl, load_raw(pl.col[pl.key_pos], i, pl.col_w[pl.key_pos]));
}

// The dead places before candidate j's place: none before a slab row (the
// alive rows are the slab's prefix); before arrival a = j - cnt, the slab's
// C - cnt and the sel columns below its own that hold no kept arrival.
__device__ __forceinline__ long long dead_before(const ExtPlan& pl, long long cnt, const int* apos,
                                                 long long j) {
  return j < cnt ? 0 : pl.C - cnt + apos[j - cnt] - (j - cnt);
}

// A candidate's ts, gslot and (at most NC) columns, held in registers.
template <int NC>
struct Row {
  long long ts;
  int gs;
  long long v[NC];
};

// Candidate j of key k's row: slab row j below cnt, else arrival j - cnt.
template <int NC>
__device__ __forceinline__ void load_cand(const ExtPlan& pl, long long k, long long cnt,
                                          const int* arr, long long j, Row<NC>& x) {
  const bool s = j < cnt;
  const long long src = s ? k * pl.C + j : (long long)arr[j - cnt];
  x.ts = s ? pl.s_ts[src] : pl.ts[src];
  x.gs = s ? pl.s_gslot[src] : pl.gslot[src];
#pragma unroll
  for (int q = 0; q < NC; ++q)
    if (q < pl.ncols) x.v[q] = load_raw(s ? (const void*)pl.s_col[q] : pl.col[q], src, pl.col_w[q]);
}

template <int NC>
__device__ __forceinline__ void emit_row(const ExtPlan& pl, long long o, int kind, long long seq,
                                         const Row<NC>& x) {
  if (o >= pl.cap) return;
  pl.out_ts[o] = x.ts;
  pl.out_kind[o] = kind;
  pl.out_seq[o] = seq;
  pl.out_gslot[o] = x.gs;
#pragma unroll
  for (int q = 0; q < NC; ++q)
    if (q < pl.ncols) store_bits(pl.out_col[q], o, x.v[q], pl.col_w[q]);
}

template <int NC>
__device__ __forceinline__ void put_row(const ExtPlan& pl, long long p, const Row<NC>& x) {
  pl.s_ts[p] = x.ts;
  pl.s_gslot[p] = x.gs;
#pragma unroll
  for (int q = 0; q < NC; ++q)
    if (q < pl.ncols) store_bits(pl.s_col[q], p, x.v[q], pl.col_w[q]);
}

// A warp-mode row's m staged candidates: lane l holds candidates
// j = 32 s + l (s < R) in registers and ranks each against every
// candidate by __shfl_sync (ties by place), the dead places before it
// counted in; a candidate is kept when its rank is below lim.  Stores the
// kept mask; returns the kept count.
template <int R>
__device__ __forceinline__ long long warp_rank(const ExtPlan& pl, long long r, const long long* skey,
                                               const int* sdead, int m, long long lim, int ndead) {
  const int lane = threadIdx.x & 31;
  long long key[R];
  int rk[R];
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int j = s * 32 + lane;
    key[s] = j < m ? skey[j] : 0;
    rk[s] = j >= m ? 0 : key[s] > pl.dead ? ndead : key[s] == pl.dead ? sdead[j] : 0;
  }
#pragma unroll
  for (int s2 = 0; s2 < R; ++s2) {
    const int top = m - s2 * 32 < 32 ? m - s2 * 32 : 32;
    for (int l = 0; l < top; ++l) {
      const long long kq = __shfl_sync(FULL, key[s2], l);
      const int q = s2 * 32 + l;
#pragma unroll
      for (int s = 0; s < R; ++s) rk[s] += kq < key[s] || (kq == key[s] && q < s * 32 + lane);
    }
  }
  long long kept = 0;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const unsigned b = __ballot_sync(FULL, s * 32 + lane < m && rk[s] < lim);
    // only the row's own words: R may pass its mwords = ceil((C + E) / 32)
    if (lane == 0 && s * 32 < m) pl.kmask[r * pl.mwords + s] = b;
    kept += __popc(b);
  }
  return kept;
}

// Count launch, warp mode: a warp a key row.  Gathers the row's kept
// arrivals, ranks a row of at most SW_LIMIT candidates and stores its kept
// mask and output rows; queues a larger row for ks_count_block.
__global__ void __launch_bounds__(SW_WARPS * 32) ks_count(const ExtPlan pl) {
  __shared__ long long s_key[SW_WARPS][SW_LIMIT];
  __shared__ int s_dead[SW_WARPS][SW_LIMIT];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  long long* skey = s_key[w];
  int* sdead = s_dead[w];
  const long long C = pl.C, E = pl.E;
  const long long warps = (long long)gridDim.x * SW_WARPS;
  for (long long r = (long long)blockIdx.x * SW_WARPS + w; r < pl.Kb; r += warps) {
    __syncwarp();                         // the last row's staged keys are read
    const long long k = key_of(pl, r);
    if (k < 0) {
      if (lane == 0) pl.ocnt[r] = pl.n_arr[r] = pl.timer[r] = 0;
      continue;
    }
    const long long cnt = pl.count[k];
    for (long long i = lane; i < cnt && i < SW_LIMIT; i += 32) {
      skey[i] = slab_key(pl, k, i);
      sdead[i] = 0;
    }
    // the kept arrivals, compacted in batch order by ballot
    int* arr = pl.arr + r * E;
    int* apos = pl.apos + r * E;
    long long na = 0;
    unsigned tick = 0;
    for (long long e0 = 0; e0 < E; e0 += 4 * 32) {
      int sv[4];                          // four loads in flight
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long e = e0 + u * 32 + lane;
        sv[u] = e < E ? pl.sel[r * E + e] : -1;
      }
      // the AND of four ints is >= 0 when any of them is
      if (!__any_sync(FULL, (sv[0] & sv[1] & sv[2] & sv[3]) >= 0)) continue;   // no event here
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long e = e0 + u * 32 + lane, i = sv[u];
        bool keep, timer;
        arrival_test(pl, i, keep, timer);
        tick |= __ballot_sync(FULL, timer);
        const unsigned b = __ballot_sync(FULL, keep);
        if (keep) {
          const long long a = na + __popc(b & lanes_below(lane));
          arr[a] = (int)i;
          apos[a] = (int)e;
          if (cnt + a < SW_LIMIT) {
            skey[cnt + a] = batch_key(pl, i);
            sdead[cnt + a] = (int)(C - cnt + e - a);
          }
        }
        na += __popc(b);
      }
    }
    if (lane == 0) {
      pl.n_arr[r] = (int)na;
      pl.timer[r] = tick != 0;
    }
    const long long n = cnt + na;
    if (n > SW_LIMIT) {
      if (lane == 0) pl.hot[1 + atomicAdd(pl.hot, 1)] = (int)r;
      continue;
    }
    __syncwarp();
    const long long lim = n < pl.length ? n : pl.length;
    const int m = (int)n, ndead = (int)(C + E - n);
    long long kept;
    if (m <= 32) kept = warp_rank<1>(pl, r, skey, sdead, m, lim, ndead);
    else if (m <= 64) kept = warp_rank<2>(pl, r, skey, sdead, m, lim, ndead);
    else if (m <= 128) kept = warp_rank<4>(pl, r, skey, sdead, m, lim, ndead);
    else kept = warp_rank<SW_R>(pl, r, skey, sdead, m, lim, ndead);
    if (lane == 0) pl.ocnt[r] = na + n - kept;
  }
}

// Count launch, block mode: a block a queued row.  The candidates' keys as
// order-preserving unsigned bits in the block's workspace slice; an MSD
// radix select of the place of rank lim - 1 among all C + E places (the
// dead ones counted into their digit); the kept mask and output rows.
__global__ void __launch_bounds__(SB_BLOCK) ks_count_block(const ExtPlan pl) {
  __shared__ long long sh[2 * SB_BLOCK];
  __shared__ unsigned hist[SB_BLOCK];
  __shared__ long long pick[2];
  const int t = threadIdx.x;
  unsigned long long* u = (unsigned long long*)pl.ws + (long long)blockIdx.x * pl.ws_words;
  const unsigned long long udead = (unsigned long long)pl.dead ^ SIGN;
  const int nhot = pl.hot[0];
  for (int h = blockIdx.x; h < nhot; h += gridDim.x) {
    const long long r = pl.hot[1 + h], k = key_of(pl, r);
    const long long cnt = pl.count[k], na = pl.n_arr[r], n = cnt + na;
    const int* arr = pl.arr + r * pl.E;
    const int* apos = pl.apos + r * pl.E;
    for (long long j = t; j < n; j += SB_BLOCK)
      u[j] = (unsigned long long)(j < cnt ? slab_key(pl, k, j) : batch_key(pl, arr[j - cnt])) ^ SIGN;
    const long long ndead = pl.C + pl.E - n;
    const long long lim = n < pl.length ? n : pl.length;
    unsigned long long pre = 0, msk = 0;
    long long target = lim - 1;
    __syncthreads();
    for (int shift = 56; shift >= 0 && lim > 0; shift -= 8) {
      hist[t] = 0;
      __syncthreads();
      for (long long j = t; j < n; j += SB_BLOCK) {
        const unsigned long long x = u[j];
        if ((x & msk) == pre) atomicAdd(&hist[(x >> shift) & 0xff], 1u);
      }
      if (t == 0 && ndead > 0 && (udead & msk) == pre)
        atomicAdd(&hist[(udead >> shift) & 0xff], (unsigned)ndead);
      __syncthreads();
      if (t < 32) {                       // the digit that holds rank `target`
        unsigned c[8];
        long long sum = 0;
#pragma unroll
        for (int d = 0; d < 8; ++d) sum += c[d] = hist[8 * t + d];
        long long inc = sum;
        for (int off = 1; off < 32; off <<= 1) {
          const long long y = __shfl_up_sync(FULL, inc, off);
          if (t >= off) inc += y;
        }
        const int f = __ffs(__ballot_sync(FULL, inc > target)) - 1;
        if (t == f) {
          long long below = inc - sum;
          int d = 0;
#pragma unroll
          for (int q = 0; q < 7; ++q)
            if (d == q && below + c[q] <= target) {
              below += c[q];
              d = q + 1;
            }
          pick[0] = 8 * t + d;
          pick[1] = target - below;
        }
      }
      __syncthreads();
      pre |= (unsigned long long)pick[0] << shift;
      msk |= 0xffULL << shift;
      target = pick[1];
    }
    // kept: below the picked key, and of those equal to it the first by place
    const long long cless = lim - 1 - target;
    long long tie0 = 0, nkeep = 0;
    for (long long j0 = 0; j0 < n; j0 += SB_BLOCK) {
      const long long j = j0 + t;
      const bool live = j < n && lim > 0;
      const unsigned long long x = live ? u[j] : 0;
      const bool tie = live && x == pre;
      long long tot;
      const long long tr = tie0 + block_excl_scan<SB_BLOCK>((long long)tie, sh, &tot);
      const bool kept =
          live && (x < pre || (tie && cless + tr + (pre == udead ? dead_before(pl, cnt, apos, j) : 0) < lim));
      const unsigned b = __ballot_sync(FULL, kept);
      if ((t & 31) == 0 && j < n) pl.kmask[r * pl.mwords + (j >> 5)] = b;
      nkeep += kept;
      tie0 += tot;
    }
    long long tot;
    block_excl_scan<SB_BLOCK>(nkeep, sh, &tot);
    if (t == 0) pl.ocnt[r] = na + n - tot;
  }
}

// Write launch, warp mode: in rounds of 32 candidates, each lane loads its
// candidate, the warp synchronises, then the arrivals go out CURRENT, the
// evicted EXPIRED at their ballot prefix, the kept to their compacted place
// (a row of at most NC columns).
template <int NC>
__global__ void __launch_bounds__(SW_WARPS * 32) ks_write(const ExtPlan pl) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * SW_WARPS;
  for (long long r = (long long)blockIdx.x * SW_WARPS + (threadIdx.x >> 5); r < pl.Kb; r += warps) {
    const long long k = key_of(pl, r);
    if (k < 0) continue;
    const long long cnt = pl.count[k], na = pl.n_arr[r], n = cnt + na;
    if (n > SW_LIMIT) continue;           // block mode: ks_write_block
    const long long seq0 = pl.seq[k], o = pl.ocnt[r];
    const int* arr = pl.arr + r * pl.E;
    const unsigned* mk = pl.kmask + r * pl.mwords;
    long long ev = 0, kp = 0;
    for (long long j0 = 0; j0 < n; j0 += 32) {
      const long long j = j0 + lane;
      const bool live = j < n;
      const unsigned m = mk[j0 >> 5];
      const unsigned lv = __ballot_sync(FULL, live);
      Row<NC> x;
      if (live) load_cand(pl, k, cnt, arr, j, x);
      __syncwarp();                       // the round's rows are read before any moves
      if (live) {
        if (j >= cnt) emit_row(pl, o + j - cnt, K_CURRENT, seq0 + j - cnt, x);
        if ((m >> lane) & 1u) {
          const long long d = kp + __popc(m & lanes_below(lane));
          if (d != j || j >= cnt) put_row(pl, k * pl.C + d, x);   // else already there
        } else {
          const long long e = ev + __popc(~m & lv & lanes_below(lane));
          emit_row(pl, o + na + e, K_EXPIRED, seq0 + na + e, x);
        }
      }
      ev += __popc(~m & lv);
      kp += __popc(m);
    }
    __syncwarp();                         // every lane has read the key's counters
    if (lane == 0) {
      pl.count[k] = (int)kp;
      pl.seq[k] = seq0 + na + ev;
    }
  }
}

// Write launch, block mode: ks_write for a queued row, in chunks of
// SB_BLOCK candidates ranked by one block scan (kept in the high word).
__global__ void __launch_bounds__(SB_BLOCK) ks_write_block(const ExtPlan pl) {
  __shared__ long long sh[2 * SB_BLOCK];
  const int t = threadIdx.x;
  const int nhot = pl.hot[0];
  for (int h = blockIdx.x; h < nhot; h += gridDim.x) {
    const long long r = pl.hot[1 + h], k = key_of(pl, r);
    const long long cnt = pl.count[k], na = pl.n_arr[r], n = cnt + na;
    const long long seq0 = pl.seq[k], o = pl.ocnt[r];
    const int* arr = pl.arr + r * pl.E;
    const unsigned* mk = pl.kmask + r * pl.mwords;
    long long ev = 0, kp = 0;
    for (long long j0 = 0; j0 < n; j0 += SB_BLOCK) {
      const long long j = j0 + t;
      const bool live = j < n;
      const bool kept = live && ((mk[j >> 5] >> (j & 31)) & 1u);
      Row<MAX_COLS> x;
      if (live) load_cand(pl, k, cnt, arr, j, x);
      long long tot;
      // the scan's barriers: the chunk's rows are read before any moves
      const long long ex = block_excl_scan<SB_BLOCK>(live ? (kept ? (1LL << 32) : 1LL) : 0LL, sh, &tot);
      if (live) {
        if (j >= cnt) emit_row(pl, o + j - cnt, K_CURRENT, seq0 + j - cnt, x);
        if (kept) {
          const long long d = kp + (ex >> 32);
          if (d != j || j >= cnt) put_row(pl, k * pl.C + d, x);   // else already there
        } else {
          const long long e = ev + (ex & 0xffffffffLL);
          emit_row(pl, o + na + e, K_EXPIRED, seq0 + na + e, x);
        }
      }
      ev += tot & 0xffffffffLL;
      kp += tot >> 32;
    }
    __syncthreads();                      // every thread has read the key's counters
    if (t == 0) {
      pl.count[k] = (int)kp;
      pl.seq[k] = seq0 + na + ev;
    }
  }
}

inline unsigned warp_grid(const ExtPlan& pl) {
  long long g = (pl.Kb + SW_WARPS - 1) / SW_WARPS;
  return (unsigned)(g < 1 ? 1 : g);
}

int sort_count(const ExtPlan* plan, void* stream) {
  const ExtPlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  kx_init<<<1, 1, 0, s>>>(pl);
  ks_count<<<warp_grid(pl), SW_WARPS * 32, 0, s>>>(pl);
  if (pl.hot_grid > 0) ks_count_block<<<(unsigned)pl.hot_grid, SB_BLOCK, 0, s>>>(pl);
  if (pl.Kb > 0) exclusive_scan(pl.ocnt, pl.Kb, pl.sums, s);
  return (int)cudaGetLastError();
}

int sort_write(const ExtPlan* plan, void* stream) {
  const ExtPlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  if (pl.ncols <= 4) ks_write<4><<<warp_grid(pl), SW_WARPS * 32, 0, s>>>(pl);
  else if (pl.ncols <= 8) ks_write<8><<<warp_grid(pl), SW_WARPS * 32, 0, s>>>(pl);
  else ks_write<MAX_COLS><<<warp_grid(pl), SW_WARPS * 32, 0, s>>>(pl);
  if (pl.hot_grid > 0) ks_write_block<<<(unsigned)pl.hot_grid, SB_BLOCK, 0, s>>>(pl);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int siddhi_keyed_ext_plan_size() { return (int)sizeof(ExtPlan); }

// Each kernel's entry points: the count launch (with the scan of the
// counts; the total lands in sums[last]) and the write launch, on
// `stream`; each returns the launches' cudaError_t (0 = launched).
extern "C" int siddhi_keyed_ext_count(const ExtPlan* p, void* s) { return count_launch<F_EXT>(p, s); }
extern "C" int siddhi_keyed_ext_write(const ExtPlan* p, void* s) { return write_launch<F_EXT>(p, s); }
extern "C" int siddhi_keyed_batch_count(const ExtPlan* p, void* s) {
  return count_launch<F_BATCH>(p, s);
}
extern "C" int siddhi_keyed_batch_write(const ExtPlan* p, void* s) {
  return write_launch<F_BATCH>(p, s);
}
extern "C" int siddhi_keyed_sort_count(const ExtPlan* p, void* s) { return sort_count(p, s); }
extern "C" int siddhi_keyed_sort_write(const ExtPlan* p, void* s) { return sort_write(p, s); }
extern "C" int siddhi_keyed_hop_count(const ExtPlan* p, void* s) { return count_launch<F_HOP>(p, s); }
extern "C" int siddhi_keyed_hop_write(const ExtPlan* p, void* s) { return write_launch<F_HOP>(p, s); }
