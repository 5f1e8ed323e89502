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

namespace {

constexpr int MAX_ATOMS = 8;
constexpr int MAX_COLS = 8;
constexpr int MAX_EMIT = 24;
constexpr int MAX_CODE = 192;
constexpr int MAX_STACK = 16;

enum : int { T_I32 = 0, T_I64 = 1, T_F32 = 2, T_BOOL = 3 };
enum : int { N_NONE = 0, N_INT = 1, N_LONG = 2, N_NAN = 3, N_ID = 4 };
enum : int {
  OP_LOAD_EV = 1, OP_LOAD_CAP, OP_CONST, OP_ARITH, OP_CMP, OP_AND, OP_OR,
  OP_NOT, OP_ISNULL
};

}  // namespace

// Mirrored field for field by kernels/pattern_step.py (ctypes.Structure).
struct StepPlan {
  // shapes and flags
  int K, Kb, E, B, P, S, R, compact, dense, ts_wire;
  int has_within, every, seed_cap_atom, stream_atom_mask;
  long long within, now, ts_base, key_lo;
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

__device__ __forceinline__ float as_f(long long v) { return __int_as_float((int)v); }
__device__ __forceinline__ long long from_f(float f) { return (long long)__float_as_int(f); }

__device__ bool is_null(long long v, int nk) {
  switch (nk) {
    case N_INT: return (int)v == INT32_MIN;
    case N_LONG: return v == INT64_MIN;
    case N_NAN: { float f = as_f(v); return f != f; }
    case N_ID: return (int)v == -1;
    default: return false;
  }
}

// plain astype between the stack's value types (no null mapping)
__device__ long long cast(long long v, int from, int to) {
  if (from == to) return v;
  if (to == T_F32) {
    if (from == T_I64) return from_f(__ll2float_rn(v));
    return from_f(__int2float_rn((int)v));  // int32 and bool
  }
  if (to == T_I64) return v;                // int32 and bool are sign-extended
  return (long long)(int)v;                 // to int32
}

// floor division of b != 0 (Python // on integers)
__device__ long long floordiv64(long long a, long long b) {
  long long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}

// Java integer division as the reference computes it:
// sign(a) * sign(b) * (|a| // |b|), wrapping, with a zero divisor giving 0
__device__ long long int_div(long long a, long long b, bool is32) {
  if (b == 0) return 0;
  long long aa, ab;
  if (is32) {
    int a32 = (int)a, b32 = (int)b;
    aa = (a32 == INT32_MIN) ? (long long)INT32_MIN : (long long)(a32 < 0 ? -a32 : a32);
    ab = (b32 == INT32_MIN) ? (long long)INT32_MIN : (long long)(b32 < 0 ? -b32 : b32);
  } else {
    aa = (a == INT64_MIN) ? INT64_MIN : (a < 0 ? -a : a);
    ab = (b == INT64_MIN) ? INT64_MIN : (b < 0 ? -b : b);
  }
  long long r = floordiv64(aa, ab);
  int s = ((a > 0) - (a < 0)) * ((b > 0) - (b < 0));
  unsigned long long ur = (unsigned long long)r;
  if (s == 0) return 0;
  if (s < 0) ur = 0ull - ur;
  return is32 ? (long long)(int)(unsigned int)ur : (long long)ur;
}

__device__ long long arith(int op, int t, long long x, long long y) {
  if (t == T_F32) {
    float a = as_f(x), b = as_f(y);
    float r = op == 0 ? __fadd_rn(a, b) : op == 1 ? __fsub_rn(a, b)
            : op == 2 ? __fmul_rn(a, b) : __fdiv_rn(a, b);
    return from_f(r);
  }
  bool is32 = (t == T_I32);
  if (op == 3) return int_div(x, y, is32);
  unsigned long long a = (unsigned long long)x, b = (unsigned long long)y;
  unsigned long long r = op == 0 ? a + b : op == 1 ? a - b : a * b;
  return is32 ? (long long)(int)(unsigned int)r : (long long)r;
}

__device__ bool compare(int op, int t, long long x, long long y) {
  if (t == T_F32) {
    float a = as_f(x), b = as_f(y);
    switch (op) {
      case 0: return a < b; case 1: return a <= b; case 2: return a > b;
      case 3: return a >= b; case 4: return a == b; default: return a != b;
    }
  }
  if (t == T_I64) {
    switch (op) {
      case 0: return x < y; case 1: return x <= y; case 2: return x > y;
      case 3: return x >= y; case 4: return x == y; default: return x != y;
    }
  }
  int a = (int)x, b = (int)y;
  switch (op) {
    case 0: return a < b; case 1: return a <= b; case 2: return a > b;
    case 3: return a >= b; case 4: return a == b; default: return a != b;
  }
}

// One atom's filter for the slot `p`: the incoming event under the atom's
// own ref, every other ref from slot p's (pre-capture) captures.
__device__ bool eval_filter(const Key& key, int atom, int p, const long long* ev) {
  const StepPlan& pl = key.pl;
  int len = pl.code_len[atom];
  if (len == 0) return true;
  long long stk[MAX_STACK];
  int sp = 0;
  const int* code = pl.code + pl.code_start[atom];
  for (int pc = 0; pc < len;) {
    switch (code[pc]) {
      case OP_LOAD_EV: stk[sp++] = ev[code[pc + 1]]; pc += 2; break;
      case OP_LOAD_CAP: stk[sp++] = key.cap(code[pc + 1], code[pc + 2], p); pc += 3; break;
      case OP_CONST:
        stk[sp++] = ((long long)code[pc + 2] << 32) | (unsigned int)code[pc + 1];
        pc += 3;
        break;
      case OP_ARITH:
      case OP_CMP: {
        int op = code[pc + 1], t = code[pc + 2], lt = code[pc + 3], rt = code[pc + 4];
        int lnk = code[pc + 5], rnk = code[pc + 6];
        long long b = stk[--sp], a = stk[--sp];
        long long x = cast(a, lt, t), y = cast(b, rt, t);
        bool nul = is_null(a, lnk) || is_null(b, rnk);
        long long r;
        if (code[pc] == OP_ARITH) {
          r = nul ? (t == T_I32 ? (long long)INT32_MIN : t == T_I64 ? INT64_MIN
                                                          : (long long)0x7fc00000)
                  : arith(op, t, x, y);
        } else {
          r = (!nul && compare(op, t, x, y)) ? 1 : 0;
        }
        stk[sp++] = r;
        pc += 7;
        break;
      }
      case OP_AND: { long long b = stk[--sp]; stk[sp - 1] = (stk[sp - 1] != 0) && (b != 0); pc += 1; break; }
      case OP_OR: { long long b = stk[--sp]; stk[sp - 1] = (stk[sp - 1] != 0) || (b != 0); pc += 1; break; }
      case OP_NOT: stk[sp - 1] = (stk[sp - 1] == 0); pc += 1; break;
      case OP_ISNULL: stk[sp - 1] = is_null(stk[sp - 1], code[pc + 1]) ? 1 : 0; pc += 2; break;
      default: return false;
    }
  }
  return stk[0] != 0;
}

__device__ void store_row(const StepPlan& pl, long long row, bool valid, long long ts,
                          const Key* key, int slot, const long long* ev) {
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

// One key's E events.  Returns its emitted-row and dropped-row counts and
// its slab-overflow count through the out parameters.
__device__ void step_key(const StepPlan& pl, long long col, int k,
                         unsigned& n_valid, unsigned& n_drop, unsigned& n_fork_drop) {
  const Key key{pl, col};
  const int P = pl.P, S = pl.S;
  unsigned active = 0;
  for (int p = 0; p < P; ++p) active |= (key.w32(pl.off_active + p) != 0 ? 1u : 0u) << p;
  bool seed_on = key.w32(pl.off_seed_on) != 0;
  bool done = key.w32(pl.off_done) != 0;
  int rank = 0;
  long long ev[MAX_COLS];
  for (int e = 0; e < pl.E; ++e) {
    int si = pl.sel_idx[(long long)k * pl.E + e];
    bool valid = si >= 0;
    int ci = si < 0 ? 0 : (si > pl.B - 1 ? pl.B - 1 : si);
    long long ts = pl.ts_wire ? pl.ts_base + (long long)pl.ts_delta[ci] : pl.raw_ts[ci];
    for (int c = 0; c < pl.ev_ncols; ++c) {
      int ty = pl.ev_ty[c];
      const void* src = pl.ev_col[c];
      ev[c] = ty == T_I64 ? ((const long long*)src)[ci] : (long long)((const int*)src)[ci];
    }
    long long now_k = valid ? ts : pl.now;
    // phase 1: within expiry
    if (pl.has_within) {
      for (int p = 0; p < P; ++p)
        if ((active >> p & 1u) && now_k - key.w64(pl.off_start + p) > pl.within)
          active &= ~(1u << p);
    }
    // phase 3: match evaluation on the pre-capture state
    bool ev_ok = valid && !done;
    unsigned m = 0, complete = 0;
    if (ev_ok) {
      for (int p = 0; p < P; ++p) {
        if (!(active >> p & 1u)) continue;
        int a = key.w32(pl.off_pos + p);
        if (a < 0 || a >= S || !(pl.stream_atom_mask >> a & 1)) continue;
        if (eval_filter(key, a, p, ev)) {
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
      if (complete || seed_complete) done = true;
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
      bool v = slot < P ? (complete >> slot & 1u) != 0 : seed_complete;
      if (pl.compact) {
        if (!v) continue;
        if (rank < pl.R) {
          store_row(pl, (long long)rank * pl.Kb + k, true, ts, &key, slot, ev);
          ++n_valid;
        } else {
          ++n_drop;
        }
        ++rank;
      } else {
        long long row = ((long long)e * (P + 1) + slot) * pl.Kb + k;
        store_row(pl, row, v, ts, &key, slot, ev);
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
          bool seed_has = (a == 0);  // atom 0 is on this stream: it matched
          key.w64(pl.cap_ts[a] + j) = seed_has ? ts : -1;
          for (int c = 0; c < pl.n_cols[a]; ++c)
            key.set_cap(a, c, j, seed_has ? ev[c] : pl.cap_null[a][c]);
        }
      }
    }
    // phase 7: advance or deactivate the matched slots
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
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned n_valid = 0, n_drop = 0, n_fork_drop = 0;
  if (k < pl.Kb) {
    long long col = pl.dense ? pl.key_lo + k : (long long)pl.key_idx[k];
    if (col >= 0 && col < pl.K) step_key(pl, col, k, n_valid, n_drop, n_fork_drop);
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
