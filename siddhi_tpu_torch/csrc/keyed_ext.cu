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
// Design: one block of BLOCK threads owns one key row of key_idx at a time
// (a grid-stride loop over the rows; a padding row, key_idx == K, touches
// nothing).  Output: "count, scan, write at offsets".  kx_count gathers the
// row's kept arrivals (its sel entries that are valid CURRENT rows and pass
// the filters, run as the typed postfix bytecode, one event a thread,
// compacted in batch order by a block scan) into `arr` / `apos`, notes a
// valid TIMER row (cron), and counts the key's output rows; a device-wide
// scan of the counts gives each row's offset and the total (the host reads
// it to size the output).  kx_write runs the key's step: its candidates
// (the slab rows of the key, then its arrivals) are staged in a workspace
// (dynamic shared memory, or a slice of a global buffer when C + 2E is
// large, the grid then smaller), each row's place in the output found by a
// block scan of flags (batch windows, hopping, compactions) or by counting,
// for each candidate, the candidates that order before it (the sorted
// emissions of externalTime, timeLength and delay, the survivors of
// externalTime, sort's ranks over its C + E places): O((C + 2E)^2 / BLOCK)
// comparisons a key, spread over the block.  The rows are written at the
// row's offset; then the key's slab row is rewritten one column at a time
// through a [C] staging array (each kept candidate to its new place,
// synchronise, copy back), so a candidate is never overwritten before it
// is read.  Rows beyond C are counted in the wake's second word.
//
// Bound: each arrival is read once (its columns, ts, gslot, kind, valid,
// the sel entry) and each output row written once; of the slab, the rows of
// the keys in the batch are read and the rows kept written, plus the per-key
// counters.  Bound by bytes; the counting rank is quadratic in a key's rows
// and the column-at-a-time rewrite moves every kept row of a stepped key.
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
// for every i whose key is not INV (ALL: for every i).
template <bool ALL = false>
__device__ void count_rank(const long long* key, long long* rk, long long n) {
  for (long long i = threadIdx.x; i < n; i += BLOCK) {
    long long ki = key[i];
    if (!ALL && ki == INV) continue;
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

// sort's key of candidate i, as an int64 in the reference's order.
__device__ long long sort_key(const ExtPlan& pl, const Cands& c, long long i) {
  long long raw = cand_raw(pl, c, i, pl.key_pos);
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

// ---- K22: sort --------------------------------------------------------------
template <bool W>
__device__ long long step_sort(const ExtPlan& pl, const Key& y, long long* ws, long long* sh) {
  const Cands c = main_cands(pl, y);
  const long long C = pl.C, P = C + pl.E, n = y.cnt + y.na;
  long long* key = ws;                      // by place
  long long* rk = ws + P;                   // by place
  long long* dst = rk + P;                  // by candidate
  long long* tmp = dst + n + 1;
  // candidate i's place: slab row i at i, arrival a at C + its sel column
  auto place = [&](long long i) { return i < y.cnt ? i : C + y.apos[i - y.cnt]; };
  for (long long p = threadIdx.x; p < P; p += BLOCK) key[p] = pl.dead;
  __syncthreads();
  for (long long i = threadIdx.x; i < n; i += BLOCK) key[place(i)] = sort_key(pl, c, i);
  __syncthreads();
  count_rank<true>(key, rk, P);
  const long long lim = n < pl.length ? n : pl.length;
  auto kept = [&](long long i) { return rk[place(i)] < lim; };
  long long nk = 0;
  for (long long i = threadIdx.x; i < n; i += BLOCK) nk += kept(i);
  const long long n_keep = block_sum(nk, sh), n_ev = n - n_keep;
  if (!W) return y.na + n_ev;
  for (long long a = threadIdx.x; a < y.na; a += BLOCK)
    emit(pl, c, y.o + a, y.cnt + a, K_CURRENT, cand_ts(pl, c, y.cnt + a), y.seq0 + a);
  scan_flags(
      n, [&](long long i) { return !kept(i); },
      [&](long long i, long long r) {
        emit(pl, c, y.o + y.na + r, i, K_EXPIRED, cand_ts(pl, c, i), y.seq0 + y.na + r);
      },
      sh);
  for (long long i = threadIdx.x; i < n; i += BLOCK) dst[i] = -1;
  __syncthreads();
  scan_flags(n, kept, [&](long long i, long long d) { dst[i] = d; }, sh);
  __syncthreads();
  rewrite(pl, c, n, dst, pl.s_ts, pl.s_gslot, pl.s_col, y.k * C, n_keep, tmp);
  if (threadIdx.x == 0) {
    pl.count[y.k] = (int)n_keep;
    pl.seq[y.k] = y.seq0 + y.na + n_ev;
  }
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

// The modes of each kernel: K20 (F_EXT), K21 (F_BATCH), K22, K23.
enum : int { F_EXT = 0, F_BATCH = 1, F_SORT = 2, F_HOP = 3 };

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
  if (F == F_SORT) return step_sort<W>(pl, y, ws, sh);
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

__global__ void kx_init(const ExtPlan pl) {
  pl.wake[0] = NO_WAKEUP;
  pl.wake[1] = 0;
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
      bool keep = false, timer = false;
      if (i >= 0) {
        timer = pl.valid[i] && pl.kind[i] == K_TIMER;
        keep = pl.valid[i] && pl.kind[i] == K_CURRENT;
        if (keep && pl.code_len > 0)
          keep = eval_bytecode_in(
              pl.code, pl.code_len, [&](int q) { return load_slot(pl.col[q], i, pl.col_ty[q]); },
              [&](int, int) { return 0LL; }, pl.in_sets);
      }
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
extern "C" int siddhi_keyed_sort_count(const ExtPlan* p, void* s) { return count_launch<F_SORT>(p, s); }
extern "C" int siddhi_keyed_sort_write(const ExtPlan* p, void* s) { return write_launch<F_SORT>(p, s); }
extern "C" int siddhi_keyed_hop_count(const ExtPlan* p, void* s) { return count_launch<F_HOP>(p, s); }
extern "C" int siddhi_keyed_hop_write(const ExtPlan* p, void* s) { return write_launch<F_HOP>(p, s); }
