// keyed_window: the per-key window step of a partitioned single-stream
// query, for sm_90a.
//
// Replaces, in the JAX package's keyed query step `kstep`
// (siddhi_tpu/core/planner.py:539-584): the pre-window filters, the
// gather of each key's events to [Kb, E], `window.process` under vmap over
// the [K, ...] slab for LengthWindow, TimeWindow, LengthBatchWindow and
// TimeBatchWindow (siddhi_tpu/core/window.py:249, :346, :447, :573), the
// scatter back that drops padding keys, the flattening of the [Kb, E_out]
// rows and the least wake.
// kernels/keyed_window.py states the rows, their order and the slab layout.
//
// Design: one thread owns one key row of key_idx and walks that key's E
// events in batch order, with the key's slab row addressed directly (no
// gathered copy of the state, no scatter back; a padding row, key_idx ==
// K, touches nothing).  The filters run as the typed postfix bytecode on
// each event the thread reads, so the batch's row indices in sel stay
// valid.  Output: "count, scan, write at offsets".  kw_count stores each
// key's kept arrivals and its number of output rows and scans them per
// block; a one-block scan of the block sums gives the total (the host reads
// it to size the output); kw_write rescans the counts, writes each key's
// rows at its offset in the key's own order, and moves its slab row in
// place.  length: a ring (evict the head when full, push the arrival).
// time: expiring rows and arrivals merge in (ts + t)*2 / ts*2+1 order
// (a two-pointer merge when both runs are sorted, else each row's rank
// counted), survivors compact toward the head, arrivals follow, the oldest
// beyond C drop.  A key whose ring is in timestamp order (the slab's
// `ordered` flag) and whose arrivals are too, none older than its last
// survivor, expires a prefix: its thread
// reads only the expiring rows and the arrivals, the survivors stay where
// they are and the head moves, so a step costs O(expiring + arrivals), not
// O(alive rows).  lengthBatch: batches are read where they lie (pending
// rows, then arrivals) and only the new pending and previous batches are
// written.  timeBatch: each key follows its own slice boundaries from its
// `start`; a flush emits the previous slice, a RESET row and the pending
// rows with the arrivals before the boundary, then moves them into the
// previous slice; rows beyond C are counted in the wake's second word.
// session (SessionWindow.process, siddhi_tpu/core/window_ext.py:668): a
// key whose gap has passed since its last arrival emits its session in ts
// order, then its arrivals that are not too late pass as CURRENT rows and
// join the session at its tail; `start` and `last` follow, and the wake is
// last + gap.  A session of at most 256 rows in slab order (no late join)
// is emitted by its key's thread as it lies; kw_count lists the others,
// and a rank launch before kw_write writes their rows, a block per 256
// rows: a block finds whether the key's rows are in ts order (then a row's
// rank is its position), else counts each row's stable ts rank against the
// key's rows staged through shared memory (O(rows^2) comparisons per late
// session, spread over the card, not one thread).  A session without a key
// is this mode on one key row: one thread walks the batch's arrivals.
// session with allowed latency (SessionLatencyWindow.process,
// siddhi_tpu/core/window_ext.py:850): a key's thread walks its arrivals
// through the reference's scan with the current session in the slab and
// the previous one in the p_ block, in the reference's slab order (appends
// and merged rows at the tail, so both stay prefix-compact).  kw_count runs
// the same walk on the counts and scalars alone to count the key's rows.
// An expiring session in ts order along the slab is written by the thread
// as it lies; one out of order is copied to scratch rows at its output
// offset and listed, and kw_latency_rank (after kw_write) ranks each listed
// session's rows, a block per 256 rows, against the session's rows staged
// through shared memory, and writes them from the scratch at offset +
// rank.  The kept arrivals follow the key's expiries as CURRENT rows.
//
// Bound: each arrival is read once (its columns, ts, gslot, kind, valid,
// the sel entry) and each output row written once; of the slab, the rows
// that leave (evicted, expiring, flushed) are read and the rows that enter
// written, plus the per-key counters.  Bound by bytes; a hot key serialises
// its events on one thread, and so does a flushing key its 2C + 1 rows.
#include <climits>

#include "bytecode.cuh"
#include "rows.cuh"

using namespace siddhi;

namespace {

constexpr int MAX_COLS = 16;
constexpr int MAX_CODE = 256;
constexpr int BLOCK = 128;
constexpr int RANK_BLOCK = 256, RANK_GRID = 528;
constexpr long long NO_WAKEUP = BIG_SEQ;

enum : int { M_LENGTH = 0, M_TIME = 1, M_BATCH = 2, M_TBATCH = 3, M_SESSION = 4, M_LATENCY = 5 };

}  // namespace

// Mirrored field for field by kernels/keyed_window.py (ctypes.Structure).
struct KeyedPlan {
  long long Kb, E, K, C, now, t, lat, cap;   // lat: the session's allowed latency
  int mode, ncols, code_len, pad;
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
  int* head;
  int* count;
  long long* seq;
  long long* p_ts;
  int* p_gslot;
  void* p_col[MAX_COLS];
  int* p_count;
  long long* start;        // timeBatch: each key's slice start, -1 unset;
                           // session: the session's start, -1 for none
  int* ordered;            // time: 1 where a key's ring is in ts order
  long long* last;         // session: the latest arrival, -1 for none
  long long* p_start;      // latency: the previous session's start, last
  long long* p_last;       // and alive time (end + gap + latency), -1 for
  long long* p_alive;      // none
  int* late;               // session: key rows whose expiring session is
  int* n_late;             // out of ts order, and their number
  long long* seg;          // latency: (offset, rows, seq) of each session
  int* n_seg;              // written out of ts order, and their number
  long long* x_ts;         // latency: those sessions' rows, at their
  int* x_gslot;            // output offsets
  void* x_col[MAX_COLS];
  int* arr;
  int* n_arr;
  long long* ocnt;
  long long* block_sums;
  long long* out_ts;
  int* out_kind;
  long long* out_seq;
  int* out_gslot;
  void* out_col[MAX_COLS];
  long long* wake;         // [least wake, rows a slice could not hold]
  InSet in_sets[MAX_IN];
};

namespace {

// The key this thread owns, or -1 for a padding row / a thread past Kb.
__device__ __forceinline__ long long key_of(const KeyedPlan& pl, long long r) {
  if (r >= pl.Kb) return -1;
  long long k = pl.key_idx[r];
  return (k >= 0 && k < pl.K) ? k : -1;
}

// Output row helpers: a row from the batch, from a slab block, or a RESET.
__device__ __forceinline__ void emit_batch(const KeyedPlan& pl, long long o, long long i, int kind,
                                           long long ts, long long seq) {
  if (o >= pl.cap) return;
  pl.out_ts[o] = ts;
  pl.out_kind[o] = kind;
  pl.out_seq[o] = seq;
  pl.out_gslot[o] = pl.gslot[i];
  for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.out_col[c], o, pl.col[c], i, pl.col_w[c]);
}

__device__ __forceinline__ void emit_slab(const KeyedPlan& pl, long long o, const long long* s_ts,
                                          const int* s_gs, void* const* s_col, long long p, int kind,
                                          long long ts, long long seq) {
  if (o >= pl.cap) return;
  pl.out_ts[o] = ts;
  pl.out_kind[o] = kind;
  pl.out_seq[o] = seq;
  pl.out_gslot[o] = s_gs[p];
  for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.out_col[c], o, s_col[c], p, pl.col_w[c]);
}

__device__ __forceinline__ void emit_reset(const KeyedPlan& pl, long long o, long long seq) {
  if (o >= pl.cap) return;
  pl.out_ts[o] = pl.now;
  pl.out_kind[o] = K_RESET;
  pl.out_seq[o] = seq;
  pl.out_gslot[o] = -1;
  for (int c = 0; c < pl.ncols; ++c) store_bits(pl.out_col[c], o, pl.col_def[c], pl.col_w[c]);
}

// Slab writes: a batch row into slab position p, a slab row moved.
__device__ __forceinline__ void put_batch(const KeyedPlan& pl, long long* s_ts, int* s_gs,
                                          void* const* s_col, long long p, long long i) {
  s_ts[p] = pl.ts[i];
  s_gs[p] = pl.gslot[i];
  for (int c = 0; c < pl.ncols; ++c) copy_elem(s_col[c], p, pl.col[c], i, pl.col_w[c]);
}

__device__ __forceinline__ void move_slab(const KeyedPlan& pl, long long* d_ts, int* d_gs,
                                          void* const* d_col, long long dp, const long long* s_ts,
                                          const int* s_gs, void* const* s_col, long long sp) {
  d_ts[dp] = s_ts[sp];
  d_gs[dp] = s_gs[sp];
  for (int c = 0; c < pl.ncols; ++c) copy_elem(d_col[c], dp, s_col[c], sp, pl.col_w[c]);
}

// A timeBatch key's flush: (number of slices passed, their boundary), from
// its start and the timestamps of its arrivals.
struct TBatchFlush {
  long long nflush, start, boundary;
};

__device__ TBatchFlush tbatch_flush(const KeyedPlan& pl, long long k, const int* arr, int na) {
  long long start0 = pl.start[k], first = BIG_SEQ;
  for (int q = 0; q < na; ++q) {
    long long a = pl.ts[arr[q]];
    if (a < first) first = a;
  }
  TBatchFlush f;
  f.start = start0 >= 0 ? start0 : first;
  f.nflush = 0;
  if (start0 >= 0 || na > 0) {
    long long el = pl.now - f.start;
    f.nflush = el > 0 ? el / pl.t : 0;
  }
  f.boundary = f.start + (f.nflush > 0 ? f.nflush : 1) * pl.t;
  return f;
}

// Expiring rows of a time key whose ring is in timestamp order: a prefix.
__device__ long long expiring_prefix(const KeyedPlan& pl, long long k) {
  long long C = pl.C, base = k * C, head = pl.head[k], cnt = pl.count[k], ne = 0;
  while (ne < cnt && pl.s_ts[base + (head + ne) % C] + pl.t <= pl.now) ++ne;
  return ne;
}

// A session key's facts before its step: does its session expire now,
// and below which ts is an arrival too late to join it.
struct SessionFacts {
  bool expire;
  long long late_below;
};

__device__ SessionFacts session_facts(const KeyedPlan& pl, long long k) {
  long long last0 = pl.last[k];
  SessionFacts f;
  f.expire = last0 >= 0 && last0 + pl.t <= pl.now;
  bool live = last0 >= 0 && !f.expire;
  f.late_below = live ? pl.start[k] - pl.t : LLONG_MIN;
  return f;
}

// Does a session key's own thread emit its expiring session: at most
// RANK_BLOCK rows, in ts order along the slab (no late join)?  Else the
// rank launch does.
__device__ bool session_own(const KeyedPlan& pl, long long k) {
  long long base = k * pl.C, cnt = pl.count[k];
  if (cnt > RANK_BLOCK) return false;
  for (long long i = 1; i < cnt; ++i)
    if (pl.s_ts[base + i - 1] > pl.s_ts[base + i]) return false;
  return true;
}

// ---- session with allowed latency ----------------------------------------
// The previous session (pc rows at base) comes out EXPIRED in a stable ts
// order at o, numbered from seq: as it lies when it is in ts order, else
// copied to the scratch rows at o and listed for kw_latency_rank.
__device__ void latency_emit(const KeyedPlan& pl, long long base, long long pc, long long o,
                             long long seq) {
  bool sorted = true;
  for (long long i = 1; i < pc && sorted; ++i) sorted = pl.p_ts[base + i - 1] <= pl.p_ts[base + i];
  if (sorted) {
    for (long long i = 0; i < pc; ++i)
      emit_slab(pl, o + i, pl.p_ts, pl.p_gslot, pl.p_col, base + i, K_EXPIRED, pl.p_ts[base + i],
                seq + i);
    return;
  }
  // rows past the output are not written (never so when the output was
  // sized by the count launch); the list holds sessions inside it only
  if (o + pc > pl.cap) return;
  for (long long i = 0; i < pc; ++i)
    move_slab(pl, pl.x_ts, pl.x_gslot, pl.x_col, o + i, pl.p_ts, pl.p_gslot, pl.p_col, base + i);
  long long s = atomicAdd(pl.n_seg, 1);
  pl.seg[3 * s] = o;
  pl.seg[3 * s + 1] = pc;
  pl.seg[3 * s + 2] = seq;
}

// One key's latency step; W: write the rows and the state (kw_write), else
// only count the rows (kw_count).  Returns the key's output rows.  A
// dropped arrival is marked in arr (-1 - row) for the CURRENT pass.
template <bool W>
__device__ long long step_latency(const KeyedPlan& pl, long long k, int* arr, int na, long long o) {
  const long long C = pl.C, base = k * C, gap = pl.t, lat = pl.lat, now = pl.now;
  long long cc = pl.count[k], pc = pl.p_count[k];
  long long cs = pl.start[k], cl = pl.last[k];
  long long ps = pl.p_start[k], pll = pl.p_last[k], pa = pl.p_alive[k];
  long long seq = pl.seq[k], missed = 0;
  const long long o0 = o;
  auto emit_prev = [&]() {
    if (W) latency_emit(pl, base, pc, o, seq);
    o += pc;
    seq += pc;
  };
  auto rotate = [&]() {   // the current session becomes the previous one
    if (W)
      for (long long i = 0; i < cc; ++i)
        move_slab(pl, pl.p_ts, pl.p_gslot, pl.p_col, base + i, pl.s_ts, pl.s_gslot, pl.s_col, base + i);
    pc = cc;
    ps = cs;
    pll = cl;
    pa = cl + gap + lat;
    cc = 0;
  };
  bool prev_has = pll >= 0;
  if (prev_has && pa <= now) {
    emit_prev();
    pc = 0;
    ps = pll = pa = -1;
    prev_has = false;
  }
  if (cl >= 0 && cl + gap <= now) {
    if (prev_has) emit_prev();
    rotate();
    cs = cl = -1;
  }
  long long nk = 0;
  for (int q = 0; q < na; ++q) {
    const long long i = arr[q], t = pl.ts[i];
    const bool cur_has = cl >= 0;
    bool ph = pll >= 0;
    const bool in_cur = cur_has && t >= cs && t <= cl + gap;
    const bool new_sess = cur_has && t >= cs && t > cl + gap;
    const bool late_cur = cur_has && t < cs && t >= cs - gap;
    const bool late_prev = cur_has && t < cs - gap && ph && t >= ps - gap;
    const bool fresh = !cur_has;
    const bool kept = fresh || in_cur || new_sess || late_cur || late_prev;
    if (new_sess) {
      if (ph) emit_prev();
      rotate();
      ph = true;
    }
    bool p_fwd = false;
    if (kept && !late_prev) {
      if (cc < C) {
        if (W) put_batch(pl, pl.s_ts, pl.s_gslot, pl.s_col, base + cc, i);
        ++cc;
      } else {
        ++missed;
      }
      cs = (fresh || new_sess) ? t : (cs < t ? cs : t);
      cl = cl > t ? cl : t;
    } else if (late_prev) {
      if (pc < C) {
        if (W) put_batch(pl, pl.p_ts, pl.p_gslot, pl.p_col, base + pc, i);
        ++pc;
      } else {
        ++missed;
      }
      if (t < ps) ps = t;
      if (t > pll) {
        pll = t;
        pa = t + gap + lat;
        p_fwd = true;
      }
    }
    if ((late_cur || p_fwd) && ph && cl >= 0 && pll + gap >= cs - gap) {
      // the previous session merges into the current one, after its rows
      for (long long j = 0; j < pc; ++j) {
        if (cc < C) {
          if (W) move_slab(pl, pl.s_ts, pl.s_gslot, pl.s_col, base + cc, pl.p_ts, pl.p_gslot, pl.p_col, base + j);
          ++cc;
        } else {
          ++missed;
        }
      }
      pc = 0;
      cs = cs < ps ? cs : ps;
      cl = cl > pll ? cl : pll;
      ps = pll = pa = -1;
    }
    if (W && !kept) arr[q] = -1 - (int)i;
    nk += kept;
  }
  if (W) {
    long long kq = 0;
    for (int q = 0; q < na; ++q) {
      if (arr[q] < 0) continue;
      const long long i = arr[q];
      emit_batch(pl, o + kq, i, K_CURRENT, pl.ts[i], seq + kq);
      ++kq;
    }
    pl.count[k] = (int)cc;
    pl.p_count[k] = (int)pc;
    pl.start[k] = cs;
    pl.last[k] = cl;
    pl.p_start[k] = ps;
    pl.p_last[k] = pll;
    pl.p_alive[k] = pa;
    pl.seq[k] = seq + nk;
    long long wk = cl >= 0 ? cl + gap : NO_WAKEUP;
    if (pll >= 0 && pa < wk) wk = pa;
    if (wk < NO_WAKEUP) atomicMin(pl.wake, wk);
    if (missed) atomicAdd((unsigned long long*)(pl.wake + 1), (unsigned long long)missed);
  }
  return o + nk - o0;
}

// Output rows of one key (kernels/keyed_window.py states the counts).
__device__ long long out_rows(const KeyedPlan& pl, long long k, const int* arr, int na) {
  long long C = pl.C;
  long long cnt = pl.count[k];
  if (pl.mode == M_LATENCY) return step_latency<false>(pl, k, const_cast<int*>(arr), na, 0);
  if (pl.mode == M_SESSION) {
    SessionFacts f = session_facts(pl, k);
    long long rows = f.expire ? cnt : 0;
    for (int q = 0; q < na; ++q) rows += pl.ts[arr[q]] >= f.late_below;
    return rows;
  }
  if (pl.mode == M_LENGTH) {
    long long ev = cnt + na - C;
    ev = ev < 0 ? 0 : (ev > na ? na : ev);
    return na + ev;
  }
  if (pl.mode == M_TIME) {
    if (pl.ordered[k]) return expiring_prefix(pl, k) + na;
    long long head = pl.head[k], ne = 0;
    for (long long i = 0; i < cnt; ++i)
      if (pl.s_ts[k * C + (head + i) % C] + pl.t <= pl.now) ++ne;
    return ne + na;
  }
  if (pl.mode == M_TBATCH) {
    TBatchFlush f = tbatch_flush(pl, k, arr, na);
    if (f.nflush == 0) return 0;
    long long n_in = 0;
    for (int q = 0; q < na; ++q) n_in += pl.ts[arr[q]] < f.boundary;
    return pl.p_count[k] + 1 + cnt + n_in;
  }
  long long nflush = (cnt + na) / C;
  if (nflush == 0) return 0;
  return pl.p_count[k] + nflush * (C + 1) + (nflush - 1) * C;
}

__global__ void kw_count(const KeyedPlan pl) {
  __shared__ long long sh[2 * BLOCK];
  long long r = (long long)blockIdx.x * BLOCK + threadIdx.x;
  long long k = key_of(pl, r);
  long long rows = 0;
  if (k >= 0) {
    int na = 0;
    int* arr = pl.arr + r * pl.E;
    for (long long e = 0; e < pl.E; ++e) {
      long long i = pl.sel[r * pl.E + e];
      if (i < 0) continue;
      bool keep = pl.valid[i] && pl.kind[i] == K_CURRENT;
      if (keep && pl.code_len > 0)
        keep = eval_bytecode_in(
            pl.code, pl.code_len,
            [&](int c) { return load_slot(pl.col[c], i, pl.col_ty[c]); },
            [&](int, int) { return 0LL; }, pl.in_sets);
      if (keep) arr[na++] = (int)i;
    }
    pl.n_arr[r] = na;
    rows = out_rows(pl, k, arr, na);
    if (pl.mode == M_SESSION && session_facts(pl, k).expire && !session_own(pl, k))
      pl.late[atomicAdd(pl.n_late, 1)] = (int)r;
  }
  if (r < pl.Kb) pl.ocnt[r] = rows;
  long long tot;
  block_excl_scan<BLOCK>(rows, sh, &tot);
  if (threadIdx.x == 0) pl.block_sums[blockIdx.x] = tot;
}

__global__ void kw_init(const KeyedPlan pl) {
  pl.wake[0] = NO_WAKEUP;
  pl.wake[1] = 0;
  if (pl.mode == M_SESSION) *pl.n_late = 0;
  if (pl.mode == M_LATENCY) *pl.n_seg = 0;
}

// ---- length ---------------------------------------------------------------
__device__ void step_length(const KeyedPlan& pl, long long k, const int* arr, int na, long long o) {
  long long C = pl.C, base = k * C;
  long long head = pl.head[k], cnt = pl.count[k], seq0 = pl.seq[k];
  long long* s_ts = pl.s_ts + 0;
  for (int q = 0; q < na; ++q) {
    long long i = arr[q];
    if (cnt == C) {
      long long p = base + head;
      emit_slab(pl, o++, pl.s_ts, pl.s_gslot, pl.s_col, p, K_EXPIRED, s_ts[p], seq0 + 2LL * q);
      head = head + 1 == C ? 0 : head + 1;
      --cnt;
    }
    put_batch(pl, pl.s_ts, pl.s_gslot, pl.s_col, base + (head + cnt) % C, i);
    ++cnt;
    emit_batch(pl, o++, i, K_CURRENT, pl.ts[i], seq0 + 2LL * q + 1);
  }
  pl.head[k] = (int)head;
  pl.count[k] = (int)cnt;
  pl.seq[k] = seq0 + 2LL * na;
}

// ---- time -----------------------------------------------------------------
// A ring in timestamp order, arrivals in timestamp order and none older than
// the last survivor (step_time checks all three): the expiring rows are a
// prefix, merged with the arrivals; the survivors stay in place, and the
// ring stays in order, so its head is its least ts.
__device__ void step_time_ordered(const KeyedPlan& pl, long long k, const int* arr, int na,
                                  long long o, long long ne) {
  long long C = pl.C, base = k * C, t = pl.t;
  long long head = pl.head[k], cnt = pl.count[k], seq0 = pl.seq[k];
  const long long* s_ts = pl.s_ts;
  long long i = 0, rank = 0;
  int q = 0;
  while (i < ne || q < na) {
    long long p = base + (head + i) % C;
    if (i < ne && (q >= na || s_ts[p] + t <= pl.ts[arr[q]])) {
      emit_slab(pl, o + rank, s_ts, pl.s_gslot, pl.s_col, p, K_EXPIRED, s_ts[p] + t, seq0 + rank);
      ++i;
    } else {
      long long ai = arr[q];
      emit_batch(pl, o + rank, ai, K_CURRENT, pl.ts[ai], seq0 + rank);
      ++q;
    }
    ++rank;
  }
  long long w = cnt - ne, total = w + na;
  long long drop = total > C ? total - C : 0;
  for (int a = 0; a < na; ++a)
    if (w + a >= drop) put_batch(pl, pl.s_ts, pl.s_gslot, pl.s_col, base + (head + ne + w + a) % C, arr[a]);
  long long head2 = (head + ne + drop) % C, cnt2 = total < C ? total : C;
  if (cnt2 > 0) atomicMin(pl.wake, pl.s_ts[base + head2] + t);
  pl.head[k] = (int)head2;
  pl.count[k] = (int)cnt2;
  if (ne + na > 0) pl.seq[k] = seq0 + C + pl.E;
}

__device__ void step_time(const KeyedPlan& pl, long long k, const int* arr, int na, long long o) {
  long long C = pl.C, base = k * C, t = pl.t, now = pl.now;
  long long head = pl.head[k], cnt = pl.count[k], seq0 = pl.seq[k];
  const long long* s_ts = pl.s_ts;
  // are the arrivals (in batch order) and the expiring rows (along the
  // ring) each in timestamp order?
  bool sorted = true;
  long long last = LLONG_MIN, ne = 0;
  for (int q = 0; q < na; ++q) {
    long long a = pl.ts[arr[q]];
    if (a < last) sorted = false;
    last = a;
  }
  if (sorted && pl.ordered[k]) {
    long long ne0 = expiring_prefix(pl, k);
    if (ne0 == cnt || na == 0 || s_ts[base + (head + cnt - 1) % C] <= pl.ts[arr[0]]) {
      step_time_ordered(pl, k, arr, na, o, ne0);
      return;
    }
  }
  last = LLONG_MIN;
  for (long long i = 0; i < cnt; ++i) {
    long long e = s_ts[base + (head + i) % C] + t;
    if (e <= now) {
      if (e < last) sorted = false;
      last = e;
      ++ne;
    }
  }
  if (sorted) {
    // two-pointer merge; an expiring row e precedes an arrival a iff
    // 2e < 2a + 1, i.e. e <= a
    long long i = 0, rank = 0;
    int q = 0;
    while (true) {
      while (i < cnt && s_ts[base + (head + i) % C] + t > now) ++i;
      bool have_e = i < cnt, have_a = q < na;
      if (!have_e && !have_a) break;
      long long e = have_e ? s_ts[base + (head + i) % C] + t : 0;
      if (have_e && (!have_a || e <= pl.ts[arr[q]])) {
        emit_slab(pl, o + rank, s_ts, pl.s_gslot, pl.s_col, base + (head + i) % C, K_EXPIRED, e,
                  seq0 + rank);
        ++i;
      } else {
        long long ai = arr[q];
        emit_batch(pl, o + rank, ai, K_CURRENT, pl.ts[ai], seq0 + rank);
        ++q;
      }
      ++rank;
    }
  } else {
    for (long long i = 0; i < cnt; ++i) {
      long long p = base + (head + i) % C;
      long long e = s_ts[p] + t;
      if (e > now) continue;
      long long rank = 0;
      for (long long j = 0; j < cnt; ++j) {
        long long ej = s_ts[base + (head + j) % C] + t;
        if (ej <= now && (ej < e || (ej == e && j < i))) ++rank;
      }
      for (int q = 0; q < na; ++q)
        if (pl.ts[arr[q]] < e) ++rank;
      emit_slab(pl, o + rank, s_ts, pl.s_gslot, pl.s_col, p, K_EXPIRED, e, seq0 + rank);
    }
    for (int q = 0; q < na; ++q) {
      long long ai = arr[q], a = pl.ts[ai], rank = 0;
      for (int b = 0; b < na; ++b) {
        long long tb = pl.ts[arr[b]];
        if (tb < a || (tb == a && b < q)) ++rank;
      }
      for (long long j = 0; j < cnt; ++j) {
        long long ej = s_ts[base + (head + j) % C] + t;
        if (ej <= now && ej <= a) ++rank;
      }
      emit_batch(pl, o + rank, ai, K_CURRENT, a, seq0 + rank);
    }
  }
  // survivors compact toward the head in their order; arrivals follow in
  // emission order; the oldest beyond C drop
  long long w = 0;
  for (long long i = 0; i < cnt; ++i) {
    long long p = base + (head + i) % C;
    if (pl.s_ts[p] + t <= now) continue;
    if (w != i)
      move_slab(pl, pl.s_ts, pl.s_gslot, pl.s_col, base + (head + w) % C, pl.s_ts, pl.s_gslot,
                pl.s_col, p);
    ++w;
  }
  long long total = w + na;
  long long drop = total > C ? total - C : 0;
  for (int q = 0; q < na; ++q) {
    long long r = q;
    if (!sorted) {
      long long a = pl.ts[arr[q]];
      r = 0;
      for (int b = 0; b < na; ++b) {
        long long tb = pl.ts[arr[b]];
        if (tb < a || (tb == a && b < q)) ++r;
      }
    }
    if (w + r >= drop) put_batch(pl, pl.s_ts, pl.s_gslot, pl.s_col, base + (head + w + r) % C, arr[q]);
  }
  long long head2 = (head + drop) % C, cnt2 = total < C ? total : C;
  long long wk = NO_WAKEUP, prev = LLONG_MIN;
  int ord = 1;
  for (long long j = 0; j < cnt2; ++j) {
    long long ts = pl.s_ts[base + (head2 + j) % C];
    if (ts < prev) ord = 0;
    prev = ts;
    if (ts + t < wk) wk = ts + t;
  }
  if (wk < NO_WAKEUP) atomicMin(pl.wake, wk);
  pl.head[k] = (int)head2;
  pl.count[k] = (int)cnt2;
  pl.ordered[k] = ord;
  if (ne + na > 0) pl.seq[k] = seq0 + C + pl.E;
}

// ---- lengthBatch ----------------------------------------------------------
// Element i of batch b of this step: a pending row while g = b*n + i is
// below the pending count, else arrival g - fill0.
__device__ __forceinline__ void emit_member(const KeyedPlan& pl, long long o, long long base,
                                            long long fill0, const int* arr, long long g, int kind,
                                            long long seq) {
  if (g < fill0) {
    emit_slab(pl, o, pl.s_ts, pl.s_gslot, pl.s_col, base + g, kind, pl.s_ts[base + g], seq);
  } else {
    long long ai = arr[g - fill0];
    emit_batch(pl, o, ai, kind, pl.ts[ai], seq);
  }
}

__device__ void step_batch(const KeyedPlan& pl, long long k, const int* arr, int na, long long o) {
  long long n = pl.C, base = k * n;
  long long fill0 = pl.count[k], pc = pl.p_count[k], seq0 = pl.seq[k];
  long long nflush = (fill0 + na) / n, span = 2 * n + 2;
  for (long long f = 0; f < nflush; ++f) {
    long long sb = seq0 + f * span;
    if (f == 0) {
      for (long long i = 0; i < pc; ++i)
        emit_slab(pl, o++, pl.p_ts, pl.p_gslot, pl.p_col, base + i, K_EXPIRED, pl.p_ts[base + i],
                  sb + i);
    } else {
      for (long long i = 0; i < n; ++i)
        emit_member(pl, o++, base, fill0, arr, (f - 1) * n + i, K_EXPIRED, sb + i);
    }
    emit_reset(pl, o++, sb + n);
    for (long long i = 0; i < n; ++i)
      emit_member(pl, o++, base, fill0, arr, f * n + i, K_CURRENT, sb + n + 1 + i);
  }
  if (nflush > 0) {
    // the previous batch becomes batch nflush - 1 (it may read pending rows,
    // so it moves before the pending batch does)
    for (long long i = 0; i < n; ++i) {
      long long g = (nflush - 1) * n + i;
      if (g < fill0)
        move_slab(pl, pl.p_ts, pl.p_gslot, pl.p_col, base + i, pl.s_ts, pl.s_gslot, pl.s_col,
                  base + g);
      else
        put_batch(pl, pl.p_ts, pl.p_gslot, pl.p_col, base + i, arr[g - fill0]);
    }
    pl.p_count[k] = (int)n;
  }
  long long first = nflush * n;      // the first element of the new pending batch
  for (long long g = first > fill0 ? first : fill0; g < fill0 + na; ++g)
    put_batch(pl, pl.s_ts, pl.s_gslot, pl.s_col, base + (g - first), arr[g - fill0]);
  pl.count[k] = (int)(fill0 + na - first);
  pl.seq[k] = seq0 + nflush * span;
}

// ---- timeBatch ------------------------------------------------------------
// Rows past C are counted in wake[1], the runtime raises on them; what the
// step emits is the reference's rows all the same.
__device__ void step_tbatch(const KeyedPlan& pl, long long k, const int* arr, int na, long long o) {
  long long C = pl.C, base = k * C, t = pl.t;
  long long cnt = pl.count[k], pc = pl.p_count[k], seq0 = pl.seq[k];
  TBatchFlush f = tbatch_flush(pl, k, arr, na);
  bool flush = f.nflush > 0;
  long long missed = 0, w = cnt, n_next = 0;
  if (flush) {
    for (long long i = 0; i < pc; ++i)
      emit_slab(pl, o++, pl.p_ts, pl.p_gslot, pl.p_col, base + i, K_EXPIRED, pl.p_ts[base + i],
                seq0 + i);
    emit_reset(pl, o++, seq0 + C);
    for (long long i = 0; i < cnt; ++i)
      emit_slab(pl, o++, pl.s_ts, pl.s_gslot, pl.s_col, base + i, K_CURRENT, pl.s_ts[base + i],
                seq0 + C + 1 + i);
    for (int q = 0; q < na; ++q) {
      long long ai = arr[q];
      if (pl.ts[ai] < f.boundary) {
        emit_batch(pl, o++, ai, K_CURRENT, pl.ts[ai], seq0 + C + 1 + w);
        ++w;
      }
    }
    // the flushed slice becomes the previous one (the pending rows first,
    // read before the arrivals past the boundary replace them) ...
    for (long long i = 0; i < cnt; ++i)
      move_slab(pl, pl.p_ts, pl.p_gslot, pl.p_col, base + i, pl.s_ts, pl.s_gslot, pl.s_col, base + i);
    w = cnt;
    for (int q = 0; q < na; ++q) {
      long long ai = arr[q];
      if (pl.ts[ai] < f.boundary) {
        if (w < C) put_batch(pl, pl.p_ts, pl.p_gslot, pl.p_col, base + w, ai);
        ++w;
      }
    }
    // ... and the arrivals past it start the new pending slice
    for (int q = 0; q < na; ++q) {
      long long ai = arr[q];
      if (pl.ts[ai] >= f.boundary) {
        if (n_next < C) put_batch(pl, pl.s_ts, pl.s_gslot, pl.s_col, base + n_next, ai);
        ++n_next;
      }
    }
    pl.p_count[k] = (int)(w < C ? w : C);
    pl.count[k] = (int)(n_next < C ? n_next : C);
    missed = (w > C ? w - C : 0) + (n_next > C ? n_next - C : 0);
    pl.seq[k] = seq0 + 2 * C + pl.E + 2;
  } else {
    // arrivals before the boundary join the pending slice, the others drop
    for (int q = 0; q < na; ++q) {
      long long ai = arr[q];
      if (pl.ts[ai] < f.boundary) {
        if (w < C) put_batch(pl, pl.s_ts, pl.s_gslot, pl.s_col, base + w, ai);
        ++w;
      }
    }
    pl.count[k] = (int)(w < C ? w : C);
    missed = w > C ? w - C : 0;
  }
  long long nstart = -1;
  if (pl.start[k] >= 0 || na > 0) nstart = flush ? f.start + f.nflush * t : f.start;
  pl.start[k] = nstart;
  if (nstart >= 0) atomicMin(pl.wake, nstart + t);
  if (missed) atomicAdd((unsigned long long*)(pl.wake + 1), (unsigned long long)missed);
}

// ---- session --------------------------------------------------------------
__device__ void step_session(const KeyedPlan& pl, long long k, const int* arr, int na, long long o) {
  long long C = pl.C, base = k * C, gap = pl.t;
  long long cnt = pl.count[k], seq0 = pl.seq[k], start0 = pl.start[k], last0 = pl.last[k];
  SessionFacts f = session_facts(pl, k);
  long long nexp = 0;
  if (f.expire) {
    // the session in ts order: as it lies, or kw_session_rank has written it
    if (session_own(pl, k))
      for (long long i = 0; i < cnt; ++i)
        emit_slab(pl, o + i, pl.s_ts, pl.s_gslot, pl.s_col, base + i, K_EXPIRED, pl.s_ts[base + i],
                  seq0 + i);
    nexp = cnt;
    o += cnt;
  }
  long long w = f.expire ? 0 : cnt, ncur = 0, mn = LLONG_MAX, mx = -1;
  for (int q = 0; q < na; ++q) {
    long long ai = arr[q], a = pl.ts[ai];
    if (a < f.late_below) continue;
    emit_batch(pl, o++, ai, K_CURRENT, a, seq0 + nexp + ncur);
    if (w < C) put_batch(pl, pl.s_ts, pl.s_gslot, pl.s_col, base + w, ai);
    ++w;
    ++ncur;
    mn = a < mn ? a : mn;
    mx = a > mx ? a : mx;
  }
  long long nlast, nstart;
  if (ncur > 0) {
    nlast = mx > 0 ? mx : 0;
    nstart = (f.expire || last0 < 0) ? mn : (start0 < mn ? start0 : mn);
  } else {
    nlast = f.expire ? -1 : last0;
    nstart = f.expire ? -1 : start0;
  }
  pl.count[k] = (int)(w < C ? w : C);
  pl.seq[k] = seq0 + nexp + ncur;
  pl.start[k] = nstart;
  pl.last[k] = nlast;
  if (nlast >= 0) atomicMin(pl.wake, nlast + gap);
  if (w > C) atomicAdd((unsigned long long*)(pl.wake + 1), (unsigned long long)(w - C));
}

// The expiring sessions kw_count listed (above RANK_BLOCK rows, or out of
// ts order): a block per RANK_BLOCK rows of such a key ranks each row,
// stably by (ts, slab position), against all the key's rows, and writes it
// at its key's offset + rank.  Before kw_write, which then overwrites the
// rows.
__global__ void kw_session_rank(const KeyedPlan pl) {
  __shared__ long long sh_ts[RANK_BLOCK];
  __shared__ long long sh_o;
  long long tiles = (pl.C + RANK_BLOCK - 1) / RANK_BLOCK;
  long long items = (long long)*pl.n_late * tiles;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    long long r = pl.late[it / tiles], tile = it % tiles;
    long long k = pl.key_idx[r], base = k * pl.C, cnt = pl.count[k];
    if (tile * RANK_BLOCK >= cnt) continue;  // the same for the whole block
    if (threadIdx.x == 0) {
      // the key row's offset, as kw_write finds it
      long long b = r / BLOCK, o = pl.block_sums[b];
      for (long long q = b * BLOCK; q < r; ++q) o += pl.ocnt[q];
      sh_o = o;
    }
    long long i = tile * RANK_BLOCK + threadIdx.x;
    long long ti = i < cnt ? pl.s_ts[base + i] : 0;
    int unsorted = 0;
    for (long long j = threadIdx.x + 1; j < cnt && !unsorted; j += RANK_BLOCK)
      unsorted = pl.s_ts[base + j - 1] > pl.s_ts[base + j];
    bool sorted = !__syncthreads_or(unsorted);  // the same for the block
    long long rank = sorted ? i : 0;  // in ts order: a row's rank is its place
    for (long long j0 = 0; !sorted && j0 < cnt; j0 += RANK_BLOCK) {
      __syncthreads();
      if (j0 + threadIdx.x < cnt) sh_ts[threadIdx.x] = pl.s_ts[base + j0 + threadIdx.x];
      __syncthreads();
      int m = cnt - j0 < RANK_BLOCK ? (int)(cnt - j0) : RANK_BLOCK;
      long long before = i - j0;  // rows jj < before precede row i
      for (int jj = 0; jj < m; ++jj) {
        long long tj = sh_ts[jj];
        rank += tj < ti || (tj == ti && jj < before);
      }
    }
    if (i < cnt)
      emit_slab(pl, sh_o + rank, pl.s_ts, pl.s_gslot, pl.s_col, base + i, K_EXPIRED, ti,
                pl.seq[k] + rank);
    __syncthreads();
  }
}

// The latency sessions kw_write listed (written to the scratch rows out of
// ts order): a block per RANK_BLOCK rows of such a session ranks each row,
// stably by (ts, position), against the session's rows and writes it at
// the session's offset + rank.  After kw_write.
__global__ void kw_latency_rank(const KeyedPlan pl) {
  __shared__ long long sh_ts[RANK_BLOCK];
  long long tiles = (pl.C + RANK_BLOCK - 1) / RANK_BLOCK;
  long long items = (long long)*pl.n_seg * tiles;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const long long* sg = pl.seg + 3 * (it / tiles);
    long long tile = it % tiles, o = sg[0], cnt = sg[1], sq = sg[2];
    if (tile * RANK_BLOCK >= cnt) continue;  // the same for the whole block
    long long i = tile * RANK_BLOCK + threadIdx.x;
    long long ti = i < cnt ? pl.x_ts[o + i] : 0, rank = 0;
    for (long long j0 = 0; j0 < cnt; j0 += RANK_BLOCK) {
      __syncthreads();
      if (j0 + threadIdx.x < cnt) sh_ts[threadIdx.x] = pl.x_ts[o + j0 + threadIdx.x];
      __syncthreads();
      int m = cnt - j0 < RANK_BLOCK ? (int)(cnt - j0) : RANK_BLOCK;
      long long before = i - j0;  // rows jj < before precede row i
      for (int jj = 0; jj < m; ++jj) {
        long long tj = sh_ts[jj];
        rank += tj < ti || (tj == ti && jj < before);
      }
    }
    if (i < cnt)
      emit_slab(pl, o + rank, pl.x_ts, pl.x_gslot, pl.x_col, o + i, K_EXPIRED, ti, sq + rank);
    __syncthreads();
  }
}

__global__ void kw_write(const KeyedPlan pl) {
  __shared__ long long sh[2 * BLOCK];
  long long r = (long long)blockIdx.x * BLOCK + threadIdx.x;
  long long k = key_of(pl, r);
  long long rows = r < pl.Kb ? pl.ocnt[r] : 0;
  long long tot;
  long long o = block_excl_scan<BLOCK>(rows, sh, &tot) + pl.block_sums[blockIdx.x];
  if (k < 0) return;
  int* arr = pl.arr + r * pl.E;
  int na = pl.n_arr[r];
  if (pl.mode == M_LENGTH) step_length(pl, k, arr, na, o);
  else if (pl.mode == M_LATENCY) step_latency<true>(pl, k, arr, na, o);
  else if (pl.mode == M_TIME) step_time(pl, k, arr, na, o);
  else if (pl.mode == M_TBATCH) step_tbatch(pl, k, arr, na, o);
  else if (pl.mode == M_SESSION) step_session(pl, k, arr, na, o);
  else step_batch(pl, k, arr, na, o);
}

inline unsigned blocks(long long n) { return (unsigned)(n > 0 ? (n + BLOCK - 1) / BLOCK : 1); }

}  // namespace

extern "C" int siddhi_keyed_plan_size() { return (int)sizeof(KeyedPlan); }

// Count launch on `stream`; returns the launches' cudaError_t (0 = launched).
extern "C" int siddhi_keyed_count(const KeyedPlan* plan, void* stream) {
  const KeyedPlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned nb = blocks(pl.Kb);
  kw_init<<<1, 1, 0, s>>>(pl);
  kw_count<<<nb, BLOCK, 0, s>>>(pl);
  scan_sums_kernel<<<1, SCAN_BLOCK, 0, s>>>(pl.block_sums, (long long)nb);
  return (int)cudaGetLastError();
}

// Write launch on `stream` (after the count launch, with the outputs set).
extern "C" int siddhi_keyed_write(const KeyedPlan* plan, void* stream) {
  const KeyedPlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  if (pl.mode == M_SESSION) kw_session_rank<<<RANK_GRID, RANK_BLOCK, 0, s>>>(pl);
  kw_write<<<blocks(pl.Kb), BLOCK, 0, s>>>(pl);
  if (pl.mode == M_LATENCY) kw_latency_rank<<<RANK_GRID, RANK_BLOCK, 0, s>>>(pl);
  return (int)cudaGetLastError();
}
