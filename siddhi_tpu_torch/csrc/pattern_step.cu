// pattern_step: one partitioned-pattern NFA step per launch, for sm_90a.
//
// Replaces the jitted XLA step of the JAX package's flagship path:
//   siddhi_tpu/core/pattern_planner.py  make_step (dense and gather) + wire_ts
//   siddhi_tpu/core/pattern.py          PatternExec.tick + _spawn
//   siddhi_tpu/core/pattern_planner.py  _emit_matches (compaction) and
//                                       StatePacker.pack/unpack (the kernel
//                                       reads and writes the packed blobs)
// The selector's projection stays outside, as plain torch ops on the
// compacted rows.
//
// Absent atoms (`not X for t` after the first atom) and the timer step
//   siddhi_tpu/core/pattern.py          tick phase 2 (absent deadlines) and
//                                       the absent kill of phase 3
//   siddhi_tpu/core/pattern_planner.py  tstep and the wake of _emit_matches
// A slot waiting at an absent atom advances (or completes, at the last
// atom) once entry_ts + waiting_time <= now_k, and dies when a matching
// event of the absent stream arrives first.  Each launch also reduces the
// earliest pending absent deadline of its keys into header[2] (warp
// shuffles, then one atomicMin per block), so the wake rides the step's
// one header fetch.  In timer mode (`timer` = 1) a launch runs one invalid
// event at ts = now over every key of the slab (dense, key_lo = 0) and
// reads no events: phase 1 and phase 2 are all it does.
//
// General mode (a second kernel from this source, `pattern_general_kernel`,
// chosen by kernels/pattern_step.py's KernelPlan for every plan outside the
// flagship's subset): count atoms (`<m:n>`, `+`, `*`, `?`, capture depth
// up to the plan's count cap) with the zero-minimum epsilon closure,
// logical `and` / `or` pairs with instant and timed absent sides,
// SEQUENCE's strict continuity, a leading absent atom, and every seed and
// fork form of the reference's tick and _spawn, in the reference's phase
// order per key: within expiry, standalone absent deadlines, the timed
// logical-absent deadline pass (lmask bit 2), match evaluation on the
// pre-capture state, SEQUENCE kills, the seed, capture at depth
// clip(count, 0, D - 1), the emission rows, the spawn (fork candidates in
// slot order, then the seed, then the second seed, into the free slots in
// slot order; overflow counts in `dropped`), the skip revert, then advance
// / kill / deactivate.  Captures live in [P, D] rows per column (row
// off + p * D + d); filters read them with the bytecode's LOAD_CAPD.  A
// fork's inherited float captures and every `e[last]` read turn -0.0 into
// +0.0, as the reference's one-hot takes do.  One thread walks one key's
// events, so a top-level plan (one key) is one thread: that is the
// reference's semantics, and its cost is recorded, not hidden.  The bound
// is the flagship mode's (the bytes the events reach), with the touched
// slots' words at the depths written and the fork copies added.
//
// Design: one thread per key.  The state is the reference's packed layout,
// b32 int32[W32, K] and b64 int64[W64, K] with the key axis minor, so
// neighbouring threads touch neighbouring addresses.  A thread walks its E
// events in order, applying tick's phases to its P slots (within-expiry,
// filter evaluation on the pre-capture state, capture, emission, seed spawn
// into the first free slot, advance / deactivate), then compacts its
// emissions to at most R rows in (event, slot) order.  Filters arrive as a
// typed postfix bytecode (kernels/filter_bytecode.py), so the kernel builds
// once for every query.  The blobs are updated in place (the JAX step
// donated them).  Header counts reduce per warp, then one atomicAdd.
//
// Bound: the step updates the state in place and reads only the events its
// selection names, so the bytes it must move depend on the traffic: the
// selection; the selected events' columns and ts deltas; each key's control
// words (P active flags, seed_on, done); the pos word and the capture words
// the filter loads of every slot live when the key's events arrive; every
// state word the step assigns; the R x Kb output rows and the header.  A
// key's whole slab (520 B at W32 = 50, W64 = 40) is not part of it: a step
// touches only the slots and atoms its events reach.  On the flagship's own
// traffic (K = 2^20, Kb = 131072 keys x E = 4 events per send, P = 4,
// S = 4, R = 2) that is about 298 B a key, 39 MB a send, about 12 us at
// 3.35 TB/s; chip_smoke.py counts it from each run's inputs.  The work per
// byte is a handful of integer compares, so the step is memory-bound: the
// kernel touches each state word of a key from one thread (key-minor
// layout, so a warp's accesses coalesce), reads and writes a slot's words
// only when an event reaches that slot, and the repeated touches of one
// key's words in the E loop hit L1/L2, not device memory.  It still writes
// the control words of every key, and control flow diverges across keys in
// different NFA positions; that costs issue slots and some bytes over the
// bound.  Spilling to local memory is accepted in this first version.

#include <cstdint>
#include <cuda_runtime.h>

#include "bytecode.cuh"

using namespace siddhi;

namespace {

constexpr int MAX_ATOMS = 8;
constexpr int MAX_COLS = 8;
constexpr int MAX_EMIT = 24;
constexpr int MAX_CODE = 192;
constexpr long long NO_WAKE = 0x1FFFFFFFFFFFFFFFLL;  // core/window.py NO_WAKEUP

}  // namespace

// Mirrored field for field by kernels/pattern_step.py (ctypes.Structure).
struct StepPlan {
  // shapes and flags
  int K, Kb, E, B, P, S, R, compact, dense, ts_wire;
  int has_within, every, seed_cap_atom, stream_atom_mask;
  int absent_mask, timer;
  long long within, now, ts_base, key_lo;
  long long wait[MAX_ATOMS];
  // state layout: first blob row of each leaf (slot p adds p)
  int off_active, off_pos, off_count, off_lmask, off_seed_on, off_done;
  int off_start, off_entry;
  int cap_ts[MAX_ATOMS];
  int n_cols[MAX_ATOMS];
  int cap_off[MAX_ATOMS][MAX_COLS];
  int cap_ty[MAX_ATOMS][MAX_COLS];
  long long cap_null[MAX_ATOMS][MAX_COLS];
  // this step's stream
  int ev_ncols;
  int ev_ty[MAX_COLS];
  // filters
  int code_start[MAX_ATOMS];
  int code_len[MAX_ATOMS];
  int code[MAX_CODE];
  // emission: captured (atom, column) pairs the selector reads
  int n_emit;
  int emit_atom[MAX_EMIT];
  int emit_col[MAX_EMIT];
  // buffers
  int* b32;
  long long* b64;
  unsigned long long* dropped;
  const void* ev_col[MAX_COLS];
  const long long* raw_ts;
  const int* ts_delta;
  const int* sel_idx;
  const int* key_idx;
  long long* out_ts;
  int* out_kind;
  unsigned char* out_valid;
  void* out_col[MAX_EMIT];
  unsigned long long* header;
  InSet in_sets[MAX_IN];
};

namespace {

struct Key {
  const StepPlan& pl;
  long long col;
  __device__ int& w32(int row) const { return pl.b32[(long long)row * pl.K + col]; }
  __device__ long long& w64(int row) const { return pl.b64[(long long)row * pl.K + col]; }
  // a capture column of atom a at slot p, as a 64-bit stack slot
  __device__ long long cap(int a, int c, int p) const {
    int row = pl.cap_off[a][c] + p;
    return pl.cap_ty[a][c] == T_I64 ? w64(row) : (long long)w32(row);
  }
  __device__ void set_cap(int a, int c, int p, long long v) const {
    int row = pl.cap_off[a][c] + p;
    if (pl.cap_ty[a][c] == T_I64) w64(row) = v; else w32(row) = (int)v;
  }
};

// One atom's filter for the slot `p`: the incoming event under the atom's
// own ref, every other ref from slot p's (pre-capture) captures.
__device__ bool eval_filter(const Key& key, int atom, int p, const long long* ev) {
  const StepPlan& pl = key.pl;
  return eval_bytecode_in(
      pl.code + pl.code_start[atom], pl.code_len[atom],
      [&](int c) { return ev[c]; },
      [&](int a, int c) { return key.cap(a, c, p); }, pl.in_sets);
}

__device__ void store_row(const StepPlan& pl, long long row, bool valid, long long ts,
                          const Key* key, int slot, const long long* ev) {
  // (the emitted atoms are presence atoms: absent atoms hold no captures)
  pl.out_ts[row] = valid ? ts : 0;
  pl.out_kind[row] = 0;  // CURRENT
  pl.out_valid[row] = valid ? 1 : 0;
  for (int i = 0; i < pl.n_emit; ++i) {
    int a = pl.emit_atom[i], c = pl.emit_col[i];
    int ty = pl.cap_ty[a][c];
    long long v = 0;
    if (valid) {
      if (slot < pl.P) v = key->cap(a, c, slot);
      else v = (a == pl.seed_cap_atom) ? ev[c] : pl.cap_null[a][c];
    }
    void* dst = pl.out_col[i];
    if (ty == T_I64) ((long long*)dst)[row] = v;
    else if (ty == T_BOOL) ((unsigned char*)dst)[row] = (unsigned char)(v != 0);
    else ((int*)dst)[row] = (int)v;
  }
}

// One key's E events.  Returns its emitted-row and dropped-row counts, its
// slab-overflow count and its earliest pending absent deadline through the
// out parameters.
__device__ void step_key(const StepPlan& pl, long long col, int k,
                         unsigned& n_valid, unsigned& n_drop, unsigned& n_fork_drop,
                         long long& wake) {
  const Key key{pl, col};
  const int P = pl.P, S = pl.S;
  unsigned active = 0;
  for (int p = 0; p < P; ++p) active |= (key.w32(pl.off_active + p) != 0 ? 1u : 0u) << p;
  bool seed_on = key.w32(pl.off_seed_on) != 0;
  bool done = key.w32(pl.off_done) != 0;
  int rank = 0;
  long long ev[MAX_COLS];
  for (int e = 0; e < pl.E; ++e) {
    bool valid = false;
    long long ts = pl.now;
    if (!pl.timer) {
      int si = pl.sel_idx[(long long)k * pl.E + e];
      valid = si >= 0;
      int ci = si < 0 ? 0 : (si > pl.B - 1 ? pl.B - 1 : si);
      ts = pl.ts_wire ? pl.ts_base + (long long)pl.ts_delta[ci] : pl.raw_ts[ci];
      for (int c = 0; c < pl.ev_ncols; ++c) {
        int ty = pl.ev_ty[c];
        const void* src = pl.ev_col[c];
        ev[c] = ty == T_I64 ? ((const long long*)src)[ci] : (long long)((const int*)src)[ci];
      }
    }
    long long now_k = valid ? ts : pl.now;
    // phase 1: within expiry
    if (pl.has_within) {
      for (int p = 0; p < P; ++p)
        if ((active >> p & 1u) && now_k - key.w64(pl.off_start + p) > pl.within)
          active &= ~(1u << p);
    }
    // phase 2: absent deadlines, atoms in chain order (a slot that passes
    // one absent atom meets the next one's deadline in the same tick)
    unsigned acomp = 0;
    if (pl.absent_mask) {
      for (int p = 0; p < P; ++p) {
        if (!(active >> p & 1u)) continue;
        int a = key.w32(pl.off_pos + p);
        while (a >= 0 && a < S && (pl.absent_mask >> a & 1)) {
          long long entry = key.w64(pl.off_entry + p);
          if (entry + pl.wait[a] > now_k) break;
          if (a == S - 1) {
            acomp |= 1u << p;          // emits at entry + wait (phase 5)
            active &= ~(1u << p);
            break;
          }
          key.w32(pl.off_pos + p) = a + 1;
          key.w32(pl.off_count + p) = 0;
          key.w32(pl.off_lmask + p) = 0;
          key.w64(pl.off_entry + p) = entry + pl.wait[a];
          ++a;
        }
      }
    }
    // phase 3: match evaluation on the pre-capture state; an absent atom's
    // match kills its slot
    bool ev_ok = valid && !done;
    unsigned m = 0, complete = 0, kill = 0;
    if (ev_ok) {
      for (int p = 0; p < P; ++p) {
        if (!(active >> p & 1u)) continue;
        int a = key.w32(pl.off_pos + p);
        if (a < 0 || a >= S || !(pl.stream_atom_mask >> a & 1)) continue;
        if (eval_filter(key, a, p, ev)) {
          if (pl.absent_mask >> a & 1) {
            if ((key.w32(pl.off_lmask + p) & 1) == 0) kill |= 1u << p;
            continue;
          }
          m |= 1u << p;
          if (a == S - 1) complete |= 1u << p;
        }
      }
    }
    bool seed_match = ev_ok && seed_on && (pl.stream_atom_mask & 1) &&
                      eval_filter(key, 0, 0, ev);
    bool seed_complete = seed_match && S == 1;
    if (!pl.every) {
      if (seed_match) seed_on = false;
      if (complete || acomp || seed_complete) done = true;
    }
    // phase 4: capture into the matched atom of each matched slot
    for (int p = 0; p < P; ++p) {
      if (!(m >> p & 1u)) continue;
      int a = key.w32(pl.off_pos + p);
      key.w64(pl.cap_ts[a] + p) = ts;
      for (int c = 0; c < pl.n_cols[a]; ++c) key.set_cap(a, c, p, ev[c]);
    }
    // phase 5: emission rows in (slot, seed) order, compacted per key
    for (int slot = 0; slot <= P; ++slot) {
      bool v = slot < P ? ((complete | acomp) >> slot & 1u) != 0 : seed_complete;
      // an absent completion carries its deadline, entry_ts + waiting time
      long long row_ts = (slot < P && (acomp >> slot & 1u))
                             ? key.w64(pl.off_entry + slot) + pl.wait[S - 1] : ts;
      if (pl.compact) {
        if (!v) continue;
        if (rank < pl.R) {
          store_row(pl, (long long)rank * pl.Kb + k, true, row_ts, &key, slot, ev);
          ++n_valid;
        } else {
          ++n_drop;
        }
        ++rank;
      } else {
        long long row = ((long long)e * (P + 1) + slot) * pl.Kb + k;
        store_row(pl, row, v, row_ts, &key, slot, ev);
        n_valid += v ? 1u : 0u;
      }
    }
    // phase 6: the seed takes the first free slot (slots completing in this
    // tick are still active here)
    if (seed_match && S > 1) {
      int j = -1;
      for (int p = 0; p < P; ++p)
        if (!(active >> p & 1u)) { j = p; break; }
      if (j < 0) {
        ++n_fork_drop;
      } else {
        active |= 1u << j;
        key.w32(pl.off_pos + j) = 1;
        key.w32(pl.off_count + j) = 0;
        key.w32(pl.off_lmask + j) = 0;
        key.w64(pl.off_start + j) = ts;
        key.w64(pl.off_entry + j) = ts;
        for (int a = 0; a < S; ++a) {
          if (pl.absent_mask >> a & 1) continue;  // no captures
          bool seed_has = (a == 0);  // atom 0 is on this stream: it matched
          key.w64(pl.cap_ts[a] + j) = seed_has ? ts : -1;
          for (int c = 0; c < pl.n_cols[a]; ++c)
            key.set_cap(a, c, j, seed_has ? ev[c] : pl.cap_null[a][c]);
        }
      }
    }
    // phase 7: kill, then advance or deactivate the matched slots.  An
    // absent completion deactivates its slot again here, as the reference's
    // `deactivate` mask does, even when this tick's seed took it in phase 6
    active &= ~(kill | acomp);
    for (int p = 0; p < P; ++p) {
      if (!(m >> p & 1u)) continue;
      key.w32(pl.off_count + p) = 0;
      if (complete >> p & 1u) {
        active &= ~(1u << p);
      } else {
        key.w32(pl.off_pos + p) += 1;
        key.w32(pl.off_lmask + p) = 0;
        key.w64(pl.off_entry + p) = ts;
      }
    }
  }
  if (pl.compact) {
    for (int r = rank < pl.R ? rank : pl.R; r < pl.R; ++r)
      store_row(pl, (long long)r * pl.Kb + k, false, 0, &key, 0, ev);
  }
  for (int p = 0; p < P; ++p) key.w32(pl.off_active + p) = (active >> p) & 1u;
  key.w32(pl.off_seed_on) = seed_on ? 1 : 0;
  key.w32(pl.off_done) = done ? 1 : 0;
  if (pl.absent_mask) {
    for (int p = 0; p < P; ++p) {
      if (!(active >> p & 1u)) continue;
      int a = key.w32(pl.off_pos + p);
      if (a >= 0 && a < S && (pl.absent_mask >> a & 1)) {
        long long w = key.w64(pl.off_entry + p) + pl.wait[a];
        if (w < wake) wake = w;
      }
    }
  }
}

// A gather-mode padding row (key index past the capacity): it writes no
// state and emits nothing.
__device__ void empty_rows(const StepPlan& pl, int k) {
  long long nrows = pl.compact ? pl.R : (long long)pl.E * (pl.P + 1);
  long long ev[MAX_COLS] = {0};
  for (long long r = 0; r < nrows; ++r)
    store_row(pl, r * pl.Kb + k, false, 0, nullptr, 0, ev);
}

__global__ void __launch_bounds__(256)
pattern_step_kernel(const __grid_constant__ StepPlan pl) {
  __shared__ long long warp_wake[8];
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned n_valid = 0, n_drop = 0, n_fork_drop = 0;
  long long wake = NO_WAKE;
  if (k < pl.Kb) {
    long long col = pl.dense ? pl.key_lo + k : (long long)pl.key_idx[k];
    if (col >= 0 && col < pl.K) step_key(pl, col, k, n_valid, n_drop, n_fork_drop, wake);
    else empty_rows(pl, k);
  }
  // every lane of the warp reaches here: reduce, then one atomic per warp
  n_valid = __reduce_add_sync(0xffffffffu, n_valid);
  n_drop = __reduce_add_sync(0xffffffffu, n_drop);
  n_fork_drop = __reduce_add_sync(0xffffffffu, n_fork_drop);
  if ((threadIdx.x & 31) == 0) {
    if (n_valid) atomicAdd(pl.header, (unsigned long long)n_valid);
    if (n_drop) atomicAdd(pl.header + 1, (unsigned long long)n_drop);
    if (n_fork_drop) atomicAdd(pl.dropped, (unsigned long long)n_fork_drop);
  }
  if (pl.absent_mask) {
    // the block's earliest deadline: warp shuffles, then one atomic
    for (int off = 16; off > 0; off >>= 1) {
      long long o = __shfl_down_sync(0xffffffffu, wake, off);
      if (o < wake) wake = o;
    }
    if ((threadIdx.x & 31) == 0) warp_wake[threadIdx.x >> 5] = wake;
    __syncthreads();
    if (threadIdx.x == 0) {
      long long w = warp_wake[0];
      for (int i = 1; i < (int)(blockDim.x >> 5); ++i)
        if (warp_wake[i] < w) w = warp_wake[i];
      if (w < NO_WAKE) atomicMin((long long*)(pl.header + 2), w);
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// General mode
// ---------------------------------------------------------------------------

namespace {

constexpr int G_ATOMS = 8;
constexpr int G_SIDES = 16;   // an atom and its logical partner
constexpr int G_COLS = 8;
constexpr int G_EMIT = 24;
constexpr int G_CODE = 256;
constexpr int G_STACK = 16;   // batches one stacked launch walks
constexpr int G_P = 32;

// atom flags
enum : int { A_COUNT = 1, A_ABSENT = 2, A_AND = 4, A_OR = 8, A_PABSENT = 16, A_PTIMED = 32 };
// side flags: on this step's stream, holds captures, absent, the seed slot
// captures the event at depth 0, the seed emission row carries the event
enum : int { S_HERE = 1, S_CAP = 2, S_ABSENT = 4, S_SEEDHAS = 8, S_SEEDROW = 16 };

}  // namespace

// Mirrored field for field by kernels/pattern_step.py (ctypes.Structure).
struct GenPlan {
  // shapes and flags (as StepPlan's)
  int K, Kb, E, B, P, S, R, compact, dense, ts_wire;
  int has_within, timer, sequence, every, has_timers;
  // the seed (reference tick's seed_immediate / seed_keeps derived values)
  int seed_spawn, seed_complete, seed_pos, seed_count, seed_fork_also;
  int seed_lmask, seed_skip, seed_disarm, last_side;
  long long within, now, ts_base, key_lo;
  // state layout: first blob row of each [P] leaf
  int off_active, off_pos, off_count, off_lmask, off_seed_on, off_done;
  int off_start, off_entry;
  // atoms by position
  int a_flags[G_ATOMS], a_min[G_ATOMS], a_max[G_ATOMS];
  int a_side[G_ATOMS], a_pside[G_ATOMS];
  int skip_to[G_ATOMS];   // atoms a slot parked at this position reaches by skips
  long long a_wait[G_ATOMS], a_pwait[G_ATOMS];
  // sides (every atom of the pattern, partners included)
  int s_flags[G_SIDES], s_depth[G_SIDES], s_ts[G_SIDES], s_ncols[G_SIDES];
  int s_code[G_SIDES], s_code_len[G_SIDES];
  int s_col[G_SIDES][G_COLS];
  signed char s_ty[G_SIDES][G_COLS], s_nk[G_SIDES][G_COLS];
  // this step's stream
  int ev_ncols;
  int ev_ty[G_COLS];
  int code[G_CODE];
  // emission: (side, column, depth; -1 = last) triples the selector reads
  int n_emit;
  signed char emit_side[G_EMIT], emit_col[G_EMIT], emit_depth[G_EMIT];
  // buffers
  int* b32;
  long long* b64;
  unsigned long long* dropped;
  const void* ev_col[G_COLS];
  const long long* raw_ts;
  const int* ts_delta;
  const int* sel_idx;
  const int* key_idx;
  long long* out_ts;
  int* out_kind;
  unsigned char* out_valid;
  void* out_col[G_EMIT];
  unsigned long long* header;
  InSet in_sets[MAX_IN];
  // stacked mode (`n_stack` > 0): batch s reads its events at s * in_stride
  // of ev_col / raw_ts, its selection at s * sel_stride of sel_idx, writes
  // its rows at s * out_stride of the outputs and its header at
  // header + 3 * s, with now = s_now[s]
  int n_stack, stack_pad;
  long long in_stride, sel_stride, out_stride;
  long long s_now[G_STACK];
};

// One batch of a launch: the offsets of its inputs and outputs
struct GenBatch {
  long long now, in_off, sel_off, out_off;
  unsigned long long* header;
};

static_assert(sizeof(GenPlan) <= 4000, "GenPlan must fit the kernel parameter space");

namespace {

__device__ __forceinline__ long long null_bits(int nk) { return nk == N_NONE ? 0 : null_slot(nk); }

// -0.0f as +0.0f (the reference's one-hot takes add the value to zeros)
__device__ __forceinline__ long long canon(long long v, int ty) {
  return (ty == T_F32 && (int)v == INT32_MIN) ? 0 : v;
}

struct GKey {
  const GenPlan& pl;
  long long col;
  __device__ int& w32(int row) const { return pl.b32[(long long)row * pl.K + col]; }
  __device__ long long& w64(int row) const { return pl.b64[(long long)row * pl.K + col]; }
  __device__ int crow(int s, int c, int p, int d) const { return pl.s_col[s][c] + p * pl.s_depth[s] + d; }
  __device__ long long& cts(int s, int p, int d) const { return w64(pl.s_ts[s] + p * pl.s_depth[s] + d); }
  __device__ long long cap(int s, int c, int p, int d) const {
    int row = crow(s, c, p, d);
    return pl.s_ty[s][c] == T_I64 ? w64(row) : (long long)w32(row);
  }
  __device__ void set_cap(int s, int c, int p, int d, long long v) const {
    int row = crow(s, c, p, d);
    if (pl.s_ty[s][c] == T_I64) w64(row) = v; else w32(row) = (int)v;
  }
  // e[last]: the filled depths (capture ts >= 0) counted, less one
  __device__ int last_depth(int s, int p) const {
    int D = pl.s_depth[s], n = 0;
    for (int d = 0; d < D; ++d) n += cts(s, p, d) >= 0 ? 1 : 0;
    return n > 0 ? n - 1 : 0;
  }
  // a capture of slot p at depth d (-1: last)
  __device__ long long cap_at(int s, int c, int p, int d) const {
    if (d >= 0) return cap(s, c, p, d);
    return canon(cap(s, c, p, last_depth(s, p)), pl.s_ty[s][c]);
  }
};

// Side s's filter for slot p: the incoming event under the side's own ref,
// other refs from slot p's (pre-capture) captures; with null_except >= 0,
// the seed skip's zero-occurrence reading: every capture null except the
// indexed loads of side null_except.
__device__ bool gen_filter(const GKey& key, int s, int p, const long long* ev, int null_except) {
  const GenPlan& pl = key.pl;
  if (pl.s_code_len[s] == 0) return true;
  return eval_bytecode(
      pl.code + pl.s_code[s], pl.s_code_len[s], [&](int c) { return ev[c]; },
      [](int, int) { return 0LL; }, [](int) { return 0LL; }, pl.in_sets,
      [&](int t, int c, int d) {
        if (null_except >= 0 && t != null_except) return null_bits(pl.s_nk[t][c]);
        return key.cap_at(t, c, p, d);
      });
}

__device__ void gen_store_row(const GenPlan& pl, long long row, bool valid, long long ts,
                              const GKey* key, int slot, const long long* ev) {
  pl.out_ts[row] = valid ? ts : 0;
  pl.out_kind[row] = 0;  // CURRENT
  pl.out_valid[row] = valid ? 1 : 0;
  for (int i = 0; i < pl.n_emit; ++i) {
    int s = pl.emit_side[i], c = pl.emit_col[i], d = pl.emit_depth[i];
    int ty = pl.s_ty[s][c];
    long long v = 0;
    if (valid) {
      if (slot < pl.P) v = key->cap_at(s, c, slot, d);
      else v = (pl.s_flags[s] & S_SEEDROW) ? ev[c] : null_bits(pl.s_nk[s][c]);
      if (slot == pl.P && d < 0) v = canon(v, ty);
    }
    void* dst = pl.out_col[i];
    if (ty == T_I64) ((long long*)dst)[row] = v;
    else if (ty == T_BOOL) ((unsigned char*)dst)[row] = (unsigned char)(v != 0);
    else ((int*)dst)[row] = (int)v;
  }
}

// A spawned slot's captures: a fork copies its source slot's, a seed holds
// the event at depth 0 of the sides that seed from this stream, nulls
// elsewhere.
__device__ void gen_spawn_caps(const GKey& key, int j, int src, long long ts, const long long* ev) {
  const GenPlan& pl = key.pl;
  for (int s = 0; s < 2 * pl.S && s < G_SIDES; ++s) {
    if (!(pl.s_flags[s] & S_CAP)) continue;
    int D = pl.s_depth[s];
    for (int d = 0; d < D; ++d) {
      bool seeded = src < 0 && d == 0 && (pl.s_flags[s] & S_SEEDHAS);
      key.cts(s, j, d) = src >= 0 ? key.cts(s, src, d) : (seeded ? ts : -1);
      for (int c = 0; c < pl.s_ncols[s]; ++c) {
        long long v = src >= 0 ? canon(key.cap(s, c, src, d), pl.s_ty[s][c])
                               : (seeded ? ev[c] : null_bits(pl.s_nk[s][c]));
        key.set_cap(s, c, j, d, v);
      }
    }
  }
}

// One key's E events in general mode.
__device__ void gen_key(const GenPlan& pl, const GenBatch& b, long long col, int k, unsigned& n_valid,
                        unsigned& n_drop,
                        unsigned& n_fork_drop, long long& wake) {
  const GKey key{pl, col};
  const int P = pl.P, S = pl.S;
  const int nsides = 2 * S < G_SIDES ? 2 * S : G_SIDES;
  unsigned active = 0;
  for (int p = 0; p < P; ++p) active |= (key.w32(pl.off_active + p) != 0 ? 1u : 0u) << p;
  bool seed_on = key.w32(pl.off_seed_on) != 0;
  bool done = key.w32(pl.off_done) != 0;
  int rank = 0;
  long long ev[G_COLS];
  long long absent_ts[G_P];
  signed char ftgt[G_P], fcnt[G_P];
  unsigned cap[G_SIDES], skipm[G_SIDES];
  for (int e = 0; e < pl.E; ++e) {
    bool valid = false;
    long long ts = b.now;
    if (!pl.timer) {
      int si = pl.sel_idx[b.sel_off + (long long)k * pl.E + e];
      valid = si >= 0;
      long long ci = b.in_off + (si < 0 ? 0 : (si > pl.B - 1 ? pl.B - 1 : si));
      ts = pl.ts_wire ? pl.ts_base + (long long)pl.ts_delta[ci] : pl.raw_ts[ci];
      for (int c = 0; c < pl.ev_ncols; ++c) ev[c] = load_slot(pl.ev_col[c], ci, pl.ev_ty[c]);
    } else {
      for (int c = 0; c < pl.ev_ncols; ++c) ev[c] = 0;
    }
    long long now_k = valid ? ts : b.now;
    // phase 1: within expiry
    if (pl.has_within) {
      for (int p = 0; p < P; ++p)
        if ((active >> p & 1u) && now_k - key.w64(pl.off_start + p) > pl.within) active &= ~(1u << p);
    }
    // phase 2: standalone absent deadlines (consecutive absent atoms in one
    // tick), then the timed logical-absent pass: its deadline sets lmask
    // bit 2, and the state fires once the presence side (bit 1) is there
    unsigned acomp = 0;
    if (pl.has_timers) {
      for (int p = 0; p < P; ++p) {
        if (!(active >> p & 1u)) continue;
        int a = key.w32(pl.off_pos + p);
        while (a >= 0 && a < S && (pl.a_flags[a] & A_ABSENT)) {
          long long entry = key.w64(pl.off_entry + p);
          if (entry + pl.a_wait[a] > now_k) break;
          if (a == S - 1) {
            acomp |= 1u << p;
            absent_ts[p] = entry + pl.a_wait[a];
            active &= ~(1u << p);
            break;
          }
          key.w32(pl.off_pos + p) = a + 1;
          key.w32(pl.off_count + p) = 0;
          key.w32(pl.off_lmask + p) = 0;
          key.w64(pl.off_entry + p) = entry + pl.a_wait[a];
          ++a;
        }
        if (!(active >> p & 1u)) continue;
        while (a >= 0 && a < S && (pl.a_flags[a] & A_PTIMED)) {
          int lm = key.w32(pl.off_lmask + p);
          if (lm & 2) break;
          long long entry = key.w64(pl.off_entry + p);
          if (entry + pl.a_pwait[a] > now_k) break;
          key.w32(pl.off_lmask + p) = lm | 2;
          if (!(lm & 1)) break;
          if (a == S - 1) {
            acomp |= 1u << p;
            absent_ts[p] = entry + pl.a_pwait[a];
            active &= ~(1u << p);
            break;
          }
          key.w32(pl.off_pos + p) = a + 1;
          key.w32(pl.off_count + p) = 0;
          key.w32(pl.off_lmask + p) = 0;
          key.w64(pl.off_entry + p) = entry + pl.a_pwait[a];
          ++a;
        }
      }
    }
    // phase 3: match evaluation on the pre-capture state, slot by slot: the
    // atom at the slot's position, and (a slot that collected nothing
    // there) the later atoms its zero-minimum count atoms let it skip to
    bool ev_ok = valid && !done;
    unsigned complete = acomp, deact = acomp, adv = 0, fork = 0, kill = 0, matched = 0, caphere = 0;
    for (int s = 0; s < nsides; ++s) cap[s] = skipm[s] = 0;
    if (ev_ok) {
      for (int p = 0; p < P; ++p) {
        unsigned bit = 1u << p;
        if (!(active & bit)) continue;
        int q = key.w32(pl.off_pos + p);
        if (q < 0 || q >= S) continue;
        int cnt = key.w32(pl.off_count + p);
        int lm = key.w32(pl.off_lmask + p), lmn = lm;
        int tgt = q + 1, fc = 0;
        unsigned cands = (1u << q) | (cnt == 0 ? (unsigned)pl.skip_to[q] : 0u);
        while (cands) {
          int b = __ffs(cands) - 1;
          cands &= cands - 1;
          const int fl = pl.a_flags[b];
          const bool last = b == S - 1, here = b == q;
          for (int si = 0; si < 2; ++si) {
            int s = si == 0 ? pl.a_side[b] : pl.a_pside[b];
            if (s < 0 || !(pl.s_flags[s] & S_HERE)) continue;
            if (!here && si != 0) continue;     // skips reach primary sides only
            bool cond = gen_filter(key, s, p, ev, -1);
            bool m_here = here && cond, m_skip = !here && cond, m = cond;
            if (m_skip) skipm[s] |= bit;
            if (pl.s_flags[s] & S_ABSENT) {
              if (m && !(lm >> si & 1)) kill |= bit;
              continue;
            }
            if (m) matched |= bit;
            if (fl & (A_AND | A_OR)) {
              int sb = 1 << si;
              bool have_other = (lmn & (3 ^ sb)) != 0;
              bool instant = (fl & A_PABSENT) && !(fl & A_PTIMED);
              bool go = ((fl & A_OR) || instant) ? m : (m && have_other);
              if (m) {
                lmn |= sb;
                cap[s] |= bit;
                caphere |= bit;
              }
              if (go) {
                if (last) { complete |= bit; deact |= bit; }
                else adv |= bit;
              }
            } else if (!(fl & A_COUNT)) {
              if (m) cap[s] |= bit;
              if (m_here) caphere |= bit;
              if (last) {
                if (m) complete |= bit;
                if (m_here) deact |= bit;
              } else {
                if (m_here) adv |= bit;
                if (m_skip) { fork |= bit; tgt = b + 1; fc = 0; }
              }
            } else {
              bool can_stay = m_here && cnt + 1 < pl.a_max[b];
              bool can_adv = m_here && cnt + 1 >= pl.a_min[b];
              if (m) cap[s] |= bit;
              if (m_here) caphere |= bit;
              if (last) {
                if (can_adv || (m_skip && pl.a_min[b] <= 1)) complete |= bit;
                if (can_adv && !can_stay) deact |= bit;
              } else {
                if (can_adv && can_stay) { fork |= bit; tgt = b + 1; }
                if (can_adv && !can_stay) adv |= bit;
              }
              // a skip-collect forks a collector that already holds the event
              if (m_skip) { fork |= bit; tgt = b; fc = 1; }
            }
          }
        }
        key.w32(pl.off_lmask + p) = lmn;
        ftgt[p] = (signed char)tgt;
        fcnt[p] = (signed char)fc;
      }
      if (pl.sequence) kill |= active & ~matched;
    }
    // the seed (a virtual slot at position 0), read against slot 0's
    // captures as the reference's seed filters are
    bool seed_match = false;
    int seed_side = 0;
    if (ev_ok && seed_on && pl.seed_disarm && gen_filter(key, pl.a_pside[0], 0, ev, -1))
      seed_on = false;
    if (ev_ok && seed_on && !(pl.a_flags[0] & A_ABSENT)) {
      for (int si = 0; si < 2; ++si) {
        int s = si == 0 ? pl.a_side[0] : pl.a_pside[0];
        if (s < 0 || (pl.s_flags[s] & (S_HERE | S_ABSENT)) != S_HERE) continue;
        if (gen_filter(key, s, 0, ev, -1)) {
          if (!seed_match) seed_side = si;
          seed_match = true;
        }
      }
    }
    bool seed_complete = seed_match && pl.seed_complete;
    if (pl.seed_skip && ev_ok && seed_on && gen_filter(key, pl.last_side, 0, ev, pl.last_side))
      seed_complete = true;
    bool seed_spawn = seed_match && pl.seed_spawn;
    if (!pl.every) {
      if (seed_match) seed_on = false;
      if (complete || seed_complete) done = true;
    }
    // phase 4: capture at depth clip(count, 0, D - 1)
    for (int s = 0; s < nsides; ++s) {
      for (unsigned m = cap[s]; m; m &= m - 1) {
        int p = __ffs(m) - 1, D = pl.s_depth[s];
        int d = key.w32(pl.off_count + p);
        d = d < 0 ? 0 : (d > D - 1 ? D - 1 : d);
        key.cts(s, p, d) = ts;
        for (int c = 0; c < pl.s_ncols[s]; ++c) key.set_cap(s, c, p, d, ev[c]);
      }
    }
    // phase 5: emission rows in (slot, seed) order, compacted per key
    for (int slot = 0; slot <= P; ++slot) {
      bool v = slot < P ? (complete >> slot & 1u) != 0 : seed_complete;
      long long row_ts = (slot < P && (acomp >> slot & 1u)) ? absent_ts[slot] : ts;
      if (pl.compact) {
        if (!v) continue;
        if (rank < pl.R) {
          gen_store_row(pl, b.out_off + (long long)rank * pl.Kb + k, true, row_ts, &key, slot, ev);
          ++n_valid;
        } else {
          ++n_drop;
        }
        ++rank;
      } else {
        long long row = ((long long)e * (P + 1) + slot) * pl.Kb + k;
        gen_store_row(pl, b.out_off + row, v, row_ts, &key, slot, ev);
        n_valid += v ? 1u : 0u;
      }
    }
    // phase 6: the spawn.  Candidates in rank order (the forks by source
    // slot, the seed, the second seed) take the free slots in slot order
    {
      unsigned freem = ~active & (P == 32 ? 0xffffffffu : (1u << P) - 1u);
      int nseed = seed_spawn ? (pl.seed_fork_also ? 2 : 1) : 0;
      int ncand = __popc(fork) + nseed, nfree = __popc(freem);
      if (ncand > nfree) n_fork_drop += (unsigned)(ncand - nfree);
      unsigned fk = fork;
      int taken_seeds = 0;
      for (; freem && (fk || taken_seeds < nseed); freem &= freem - 1) {
        int j = __ffs(freem) - 1;
        active |= 1u << j;
        key.w64(pl.off_entry + j) = ts;
        key.w32(pl.off_lmask + j) = 0;
        if (fk) {
          int src = __ffs(fk) - 1;
          fk &= fk - 1;
          key.w32(pl.off_pos + j) = ftgt[src];
          key.w32(pl.off_count + j) = fcnt[src];
          key.w64(pl.off_start + j) = key.w64(pl.off_start + src);
          gen_spawn_caps(key, j, src, ts, ev);
        } else {
          bool second = taken_seeds == 1;
          ++taken_seeds;
          key.w32(pl.off_pos + j) = pl.seed_fork_also ? (second ? 0 : 1) : pl.seed_pos;
          key.w32(pl.off_count + j) = pl.seed_fork_also ? (second ? 1 : 0) : pl.seed_count;
          if (pl.seed_lmask) key.w32(pl.off_lmask + j) = 1 << seed_side;
          key.w64(pl.off_start + j) = ts;
          gen_spawn_caps(key, j, -1, ts, ev);
        }
      }
    }
    // the skip revert: a surviving zero-collect origin's skip-written
    // captures go back to null (after the emission and the forks read them)
    for (int s = 0; s < nsides; ++s) {
      for (unsigned m = skipm[s]; m; m &= m - 1) {
        int p = __ffs(m) - 1, D = pl.s_depth[s];
        int d = key.w32(pl.off_count + p);
        d = d < 0 ? 0 : (d > D - 1 ? D - 1 : d);
        key.cts(s, p, d) = -1;
        for (int c = 0; c < pl.s_ncols[s]; ++c) key.set_cap(s, c, p, d, null_bits(pl.s_nk[s][c]));
      }
    }
    // phase 7: advance / kill / deactivate (an absent completion also
    // deactivates a slot this tick's spawn just took, as the reference does)
    active &= ~(kill | deact);
    for (int p = 0; p < P; ++p) {
      unsigned bit = 1u << p;
      if ((adv | deact) & bit) key.w32(pl.off_count + p) = 0;
      else if (caphere & bit) key.w32(pl.off_count + p) += 1;
      if (adv & bit) {
        key.w32(pl.off_pos + p) += 1;
        key.w32(pl.off_lmask + p) = 0;
        key.w64(pl.off_entry + p) = ts;
      }
    }
  }
  if (pl.compact) {
    for (int r = rank < pl.R ? rank : pl.R; r < pl.R; ++r)
      gen_store_row(pl, b.out_off + (long long)r * pl.Kb + k, false, 0, &key, 0, ev);
  }
  for (int p = 0; p < P; ++p) key.w32(pl.off_active + p) = (active >> p) & 1u;
  key.w32(pl.off_seed_on) = seed_on ? 1 : 0;
  key.w32(pl.off_done) = done ? 1 : 0;
  if (pl.has_timers) {
    for (int p = 0; p < P; ++p) {
      if (!(active >> p & 1u)) continue;
      int a = key.w32(pl.off_pos + p);
      if (a < 0 || a >= S) continue;
      long long w = NO_WAKE;
      if (pl.a_flags[a] & A_ABSENT) w = key.w64(pl.off_entry + p) + pl.a_wait[a];
      else if ((pl.a_flags[a] & A_PTIMED) && !(key.w32(pl.off_lmask + p) & 2))
        w = key.w64(pl.off_entry + p) + pl.a_pwait[a];
      if (w < wake) wake = w;
    }
  }
}

__global__ void __launch_bounds__(128)
pattern_general_kernel(const __grid_constant__ GenPlan pl) {
  __shared__ long long warp_wake[4];
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  // a stacked launch walks its batches in order; each key's slab rows stay
  // with one thread from batch to batch
  const int ns = pl.n_stack > 0 ? pl.n_stack : 1;
  for (int s = 0; s < ns; ++s) {
    GenBatch b;
    b.now = pl.n_stack > 0 ? pl.s_now[s] : pl.now;
    b.in_off = (long long)s * pl.in_stride;
    b.sel_off = (long long)s * pl.sel_stride;
    b.out_off = (long long)s * pl.out_stride;
    b.header = pl.header + 3 * s;
    unsigned n_valid = 0, n_drop = 0, n_fork_drop = 0;
    long long wake = NO_WAKE;
    if (k < pl.Kb) {
      long long col = pl.dense ? pl.key_lo + k : (long long)pl.key_idx[k];
      if (col >= 0 && col < pl.K) {
        gen_key(pl, b, col, k, n_valid, n_drop, n_fork_drop, wake);
      } else {
        // a gather-mode padding row: no state, no rows
        long long nrows = pl.compact ? pl.R : (long long)pl.E * (pl.P + 1);
        long long ev[G_COLS] = {0};
        for (long long r = 0; r < nrows; ++r)
          gen_store_row(pl, b.out_off + r * pl.Kb + k, false, 0, nullptr, 0, ev);
      }
    }
    n_valid = __reduce_add_sync(0xffffffffu, n_valid);
    n_drop = __reduce_add_sync(0xffffffffu, n_drop);
    n_fork_drop = __reduce_add_sync(0xffffffffu, n_fork_drop);
    if ((threadIdx.x & 31) == 0) {
      if (n_valid) atomicAdd(b.header, (unsigned long long)n_valid);
      if (n_drop) atomicAdd(b.header + 1, (unsigned long long)n_drop);
      if (n_fork_drop) atomicAdd(pl.dropped, (unsigned long long)n_fork_drop);
    }
    if (pl.has_timers) {
      for (int off = 16; off > 0; off >>= 1) {
        long long o = __shfl_down_sync(0xffffffffu, wake, off);
        if (o < wake) wake = o;
      }
      if ((threadIdx.x & 31) == 0) warp_wake[threadIdx.x >> 5] = wake;
      __syncthreads();
      if (threadIdx.x == 0) {
        long long w = warp_wake[0];
        for (int i = 1; i < (int)(blockDim.x >> 5); ++i)
          if (warp_wake[i] < w) w = warp_wake[i];
        if (w < NO_WAKE) atomicMin((long long*)(b.header + 2), w);
      }
      __syncthreads();   // warp_wake is written again by the next batch
    }
  }
}

}  // namespace

extern "C" int siddhi_pattern_step_plan_size() { return (int)sizeof(StepPlan); }

// Launches on `stream`; returns the launch's cudaError_t (0 = launched).
extern "C" int siddhi_pattern_step(const StepPlan* plan, void* stream) {
  if (plan->Kb <= 0) return 0;
  int threads = 256;
  int blocks = (plan->Kb + threads - 1) / threads;
  pattern_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*plan);
  return (int)cudaGetLastError();
}

extern "C" int siddhi_pattern_general_plan_size() { return (int)sizeof(GenPlan); }

// Launches the general mode on `stream`; returns the launch's cudaError_t.
extern "C" int siddhi_pattern_general(const GenPlan* plan, void* stream) {
  if (plan->Kb <= 0) return 0;
  int threads = 128;
  int blocks = (plan->Kb + threads - 1) / threads;
  pattern_general_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*plan);
  return (int)cudaGetLastError();
}
