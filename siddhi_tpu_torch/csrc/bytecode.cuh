// The typed postfix bytecode of kernels/filter_bytecode.py on the device:
// one interpreter for every kernel that evaluates filters.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace siddhi {

constexpr int MAX_STACK = 16;

enum : int { T_I32 = 0, T_I64 = 1, T_F32 = 2, T_BOOL = 3 };
enum : int { N_NONE = 0, N_INT = 1, N_LONG = 2, N_NAN = 3, N_ID = 4 };
enum : int {
  OP_LOAD_EV = 1, OP_LOAD_CAP, OP_CONST, OP_ARITH, OP_CMP, OP_AND, OP_OR,
  OP_NOT, OP_ISNULL, OP_LOAD_OTHER, OP_COALESCE, OP_IN, OP_LOAD_CAPD
};

// `x in Table` (OP_IN): the valid rows' first-column values of a table,
// cast to one compare type, in an open-addressing hash set built by
// csrc/in_probe.cu (kernel K14).  `slots` has mask + 1 entries, EMPTY
// marks a free one; a table value equal to EMPTY sets *has_empty instead.
constexpr int MAX_IN = 4;
constexpr long long IN_EMPTY = (long long)0xa5a5a5a5a5a5a5a5ULL;

struct InSet {
  const long long* slots;
  const int* has_empty;
  long long mask;
};

__device__ __forceinline__ float as_f(long long v) { return __int_as_float((int)v); }
__device__ __forceinline__ long long from_f(float f) { return (long long)__float_as_int(f); }

__device__ inline bool is_null(long long v, int nk) {
  switch (nk) {
    case N_INT: return (int)v == INT32_MIN;
    case N_LONG: return v == INT64_MIN;
    case N_NAN: { float f = as_f(v); return f != f; }
    case N_ID: return (int)v == -1;
    default: return false;
  }
}

// plain astype between the stack's value types (no null mapping)
__device__ inline long long cast(long long v, int from, int to) {
  if (from == to) return v;
  if (to == T_F32) {
    if (from == T_I64) return from_f(__ll2float_rn(v));
    return from_f(__int2float_rn((int)v));  // int32 and bool
  }
  if (to == T_I64) return v;                // int32 and bool are sign-extended
  return (long long)(int)v;                 // to int32
}

// floor division of b != 0 (Python // on integers)
__device__ inline long long floordiv64(long long a, long long b) {
  long long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}

// Java integer division as the reference computes it:
// sign(a) * sign(b) * (|a| // |b|), wrapping, with a zero divisor giving 0
__device__ inline long long int_div(long long a, long long b, bool is32) {
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

__device__ inline long long arith(int op, int t, long long x, long long y) {
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

__device__ inline bool compare(int op, int t, long long x, long long y) {
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

// The null of a null kind as a 64-bit stack slot.
__device__ inline long long null_slot(int nk) {
  switch (nk) {
    case N_INT: return (long long)INT32_MIN;
    case N_LONG: return INT64_MIN;
    case N_NAN: return (long long)0x7fc00000;
    default: return -1;  // N_ID
  }
}

// astype from -> to, a null of kind nk becoming the null of kind onk
__device__ inline long long null_cast(long long v, int from, int to, int nk, int onk) {
  if (nk != N_NONE && onk != N_NONE && is_null(v, nk)) return null_slot(onk);
  return cast(v, from, to);
}

// A value of compare type ct as its hash-set key; false for a value that
// equals nothing (NaN).  -0.0 and +0.0 are one key.
__device__ __forceinline__ bool in_key(long long v, int ct, long long* key) {
  if (ct == T_F32) {
    float f = as_f(v);
    if (f != f) return false;
    if (f == 0.0f) f = 0.0f;
    *key = (long long)(unsigned int)__float_as_int(f);
    return true;
  }
  *key = ct == T_I64 ? v : (long long)(int)v;
  return true;
}

// murmur3's 64-bit finaliser
__device__ __forceinline__ unsigned long long in_hash(long long key) {
  unsigned long long h = (unsigned long long)key;
  h ^= h >> 33;
  h *= 0xff51afd7ed558ccdULL;
  h ^= h >> 33;
  h *= 0xc4ceb9fe1a85ec53ULL;
  h ^= h >> 33;
  return h;
}

// Is v (of compare type ct) in the set?  Linear probing to the first
// free slot.
__device__ inline bool in_lookup(const InSet& s, long long v, int ct) {
  long long key;
  if (!in_key(v, ct, &key)) return false;
  if (key == IN_EMPTY) return *s.has_empty != 0;
  unsigned long long h = in_hash(key) & (unsigned long long)s.mask;
  for (;;) {
    long long x = s.slots[h];
    if (x == key) return true;
    if (x == IN_EMPTY) return false;
    h = (h + 1) & (unsigned long long)s.mask;
  }
}

// The absent load_capd of eval_bytecode: OP_LOAD_CAPD is then not
// compiled in, and the callers that never emit it build as before.
struct NoCapD {};

// Runs `len` (> 0) words of bytecode and returns the 64-bit slot on top of
// the stack (0 after an unknown opcode).  load_ev(col) returns an event
// column as a 64-bit stack slot, load_cap(atom, col) a capture column,
// load_capd(set, col, depth) a capture column at a depth (-1: the deepest
// filled one) and load_other(col) a column of a join's candidate row;
// `sets` are the hash sets OP_IN reads (word 1 indexes them).
template <class LoadEv, class LoadCap, class LoadOther, class LoadCapD = NoCapD>
__device__ __forceinline__ long long eval_slot(const int* code, int len, LoadEv load_ev, LoadCap load_cap,
                                               LoadOther load_other, const InSet* sets,
                                               LoadCapD load_capd = {}) {
  long long stk[MAX_STACK];
  int sp = 0;
  for (int pc = 0; pc < len;) {
    switch (code[pc]) {
      case OP_LOAD_EV: stk[sp++] = load_ev(code[pc + 1]); pc += 2; break;
      case OP_LOAD_CAP: stk[sp++] = load_cap(code[pc + 1], code[pc + 2]); pc += 3; break;
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
      case OP_LOAD_OTHER: stk[sp++] = load_other(code[pc + 1]); pc += 2; break;
      case OP_COALESCE: {
        int t = code[pc + 1], lt = code[pc + 2], rt = code[pc + 3];
        int lnk = code[pc + 4], rnk = code[pc + 5], onk = code[pc + 6];
        long long b = stk[--sp], a = stk[--sp];
        long long x = null_cast(a, lt, t, lnk, onk);
        stk[sp++] = is_null(x, onk) ? null_cast(b, rt, t, rnk, onk) : x;
        pc += 7;
        break;
      }
      case OP_IN: {
        // set, compare type, operand type, operand null kind: a null is a
        // value like any other, as the reference's == treats it
        int ct = code[pc + 2], ot = code[pc + 3];
        stk[sp - 1] = in_lookup(sets[code[pc + 1]], cast(stk[sp - 1], ot, ct), ct) ? 1 : 0;
        pc += 5;
        break;
      }
      default:
        // OP_LOAD_CAPD, where the caller reads indexed captures
        if constexpr (!std::is_same_v<LoadCapD, NoCapD>) {
          if (code[pc] == OP_LOAD_CAPD) {
            stk[sp++] = load_capd(code[pc + 1], code[pc + 2], code[pc + 3]);
            pc += 4;
            break;
          }
        }
        return 0;
    }
  }
  return stk[0];
}

// A filter: the bytecode's boolean result (true for no words).
template <class LoadEv, class LoadCap, class LoadOther, class LoadCapD = NoCapD>
__device__ __forceinline__ bool eval_bytecode(const int* code, int len, LoadEv load_ev, LoadCap load_cap,
                                              LoadOther load_other, const InSet* sets,
                                              LoadCapD load_capd = {}) {
  if (len == 0) return true;
  return eval_slot(code, len, load_ev, load_cap, load_other, sets, load_capd) != 0;
}

template <class LoadEv, class LoadCap, class LoadOther>
__device__ __forceinline__ bool eval_bytecode(const int* code, int len, LoadEv load_ev, LoadCap load_cap,
                                              LoadOther load_other) {
  return eval_bytecode(code, len, load_ev, load_cap, load_other, (const InSet*)nullptr);
}

template <class LoadEv, class LoadCap>
__device__ __forceinline__ bool eval_bytecode(const int* code, int len, LoadEv load_ev, LoadCap load_cap) {
  return eval_bytecode(code, len, load_ev, load_cap, [](int) { return 0LL; });
}

template <class LoadEv, class LoadCap>
__device__ __forceinline__ bool eval_bytecode_in(const int* code, int len, LoadEv load_ev, LoadCap load_cap,
                                                 const InSet* sets) {
  return eval_bytecode(code, len, load_ev, load_cap, [](int) { return 0LL; }, sets);
}

// A column element as a 64-bit stack slot (floats as their bits).
__device__ __forceinline__ long long load_slot(const void* src, long long i, int ty) {
  if (ty == T_I64) return ((const long long*)src)[i];
  return (long long)((const int*)src)[i];
}

}  // namespace siddhi
