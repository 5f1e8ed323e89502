// The range programs of core/window_expr.py on the device: one typed
// postfix interpreter for the expression windows (kernels K25 / K26).
//
// A value is a 64-bit slot: an int32 or a bool (0 / 1) sign-extended, an
// int64 as itself, a float32's bits in the low word (as bytecode.cuh keeps
// them), a float64's bits.  Every operation's operands are already cast to
// its type by the compiler, which copies JAX's promotion; each float
// operation rounds once (the _rn intrinsics; the build also turns FMA
// contraction off), so the results are those of the reference's XLA ops.
#pragma once

#include <cuda_runtime.h>

#include "bytecode.cuh"

namespace siddhi {

constexpr int T_F64 = 4;
constexpr int R_MAX_STACK = 16;
enum : int {
  R_CONST = 1, R_FIRST, R_LAST, R_COUNT, R_AGG, R_CAST, R_ARITH, R_CMP, R_AND, R_OR, R_NOT,
  R_TRUTH, R_COL
};
enum : int { A_ADD = 0, A_SUB = 1, A_MUL = 2, A_DIV = 3, A_MOD = 4 };
enum : int { AGG_SUM = 0, AGG_AVG = 1, AGG_MIN = 2, AGG_MAX = 3 };

__device__ __forceinline__ double as_d(long long v) { return __longlong_as_double(v); }
__device__ __forceinline__ long long from_d(double d) { return __double_as_longlong(d); }

// astype(from -> to) along JAX's promotions (never float -> int)
__device__ inline long long r_cast(long long v, int from, int to) {
  if (from == to) return v;
  switch (to) {
    case T_I32: return (long long)(int)v;
    case T_I64: return (long long)v;
    case T_F32:
      if (from == T_I64) return from_f(__ll2float_rn(v));
      if (from == T_F64) return from_f(__double2float_rn(as_d(v)));
      return from_f(__int2float_rn((int)v));
    case T_F64:
      if (from == T_F32) return from_d((double)as_f(v));
      if (from == T_I64) return from_d(__ll2double_rn(v));
      return from_d((double)(int)v);
    default: return v != 0;
  }
}

// jnp.remainder of floats: fmod, moved to the divisor's sign
__device__ __forceinline__ double fmod_floor(double a, double b) {
  double t = fmod(a, b);
  return ((t < 0.0) != (b < 0.0) && t != 0.0) ? __dadd_rn(t, b) : t;
}

__device__ __forceinline__ float fmod_floorf(float a, float b) {
  float t = fmodf(a, b);
  return ((t < 0.0f) != (b < 0.0f) && t != 0.0f) ? __fadd_rn(t, b) : t;
}

__device__ inline long long r_arith(int op, int t, long long x, long long y) {
  if (t == T_F64) {
    double a = as_d(x), b = as_d(y), r;
    switch (op) {
      case A_ADD: r = __dadd_rn(a, b); break;
      case A_SUB: r = __dsub_rn(a, b); break;
      case A_MUL: r = __dmul_rn(a, b); break;
      case A_DIV: r = __ddiv_rn(a, b); break;
      default: r = fmod_floor(a, b);
    }
    return from_d(r);
  }
  if (t == T_F32) {
    float a = as_f(x), b = as_f(y), r;
    switch (op) {
      case A_ADD: r = __fadd_rn(a, b); break;
      case A_SUB: r = __fsub_rn(a, b); break;
      case A_MUL: r = __fmul_rn(a, b); break;
      case A_DIV: r = __fdiv_rn(a, b); break;
      default: r = fmod_floorf(a, b);
    }
    return from_f(r);
  }
  // integers wrap; % is the floor modulo, 0 for a divisor of 0 (or -1)
  unsigned long long a = (unsigned long long)x, b = (unsigned long long)y, r;
  switch (op) {
    case A_ADD: r = a + b; break;
    case A_SUB: r = a - b; break;
    case A_MUL: r = a * b; break;
    default: {
      if (y == 0 || y == -1) {
        r = 0;
      } else {
        long long m = x % y;
        if (m != 0 && ((m < 0) != (y < 0))) m += y;
        r = (unsigned long long)m;
      }
    }
  }
  return t == T_I32 ? (long long)(int)(unsigned)r : (long long)r;
}

__device__ inline bool r_compare(int op, int t, long long x, long long y) {
  if (t == T_F64) {
    double a = as_d(x), b = as_d(y);
    switch (op) {
      case 0: return a < b; case 1: return a <= b; case 2: return a > b;
      case 3: return a >= b; case 4: return a == b; default: return a != b;
    }
  }
  if (t == T_F32) return compare(op, T_F32, x, y);
  return compare(op, T_I64, x, y);   // int32 and bool slots are sign-extended
}

__device__ __forceinline__ bool r_truth(long long v, int t) {
  if (t == T_F64) return as_d(v) != 0.0;
  if (t == T_F32) return as_f(v) != 0.0f;
  return v != 0;
}

// jnp.minimum / jnp.maximum: NaN if either is NaN, -0.0 below +0.0
__device__ __forceinline__ double ext_step(double a, double b, bool is_min) {
  if (a != a || b != b) return __longlong_as_double(0x7ff8000000000000LL);
  if (is_min ? a < b : a > b) return a;
  if (is_min ? b < a : b > a) return b;
  bool neg = __double_as_longlong(a) < 0;
  return (is_min ? neg : !neg) ? a : b;
}

// Runs a range program (or, with R_COL loads, a per-row one) and returns
// its top slot.  lane(op, l, t): the R_FIRST / R_LAST / R_COL value of
// lane l; agg(a): the float64 value of aggregate a.
template <class Lane, class Agg>
__device__ __forceinline__ long long run_range(const int* code, int len, long long count,
                                               Lane lane, Agg agg) {
  long long stk[R_MAX_STACK];
  int sp = 0;
  for (int pc = 0; pc < len;) {
    switch (code[pc]) {
      case R_CONST:
        stk[sp++] = ((long long)code[pc + 3] << 32) | (unsigned)code[pc + 2];
        pc += 4;
        break;
      case R_FIRST:
      case R_LAST:
      case R_COL:
        stk[sp++] = lane(code[pc], code[pc + 1], code[pc + 2]);
        pc += 3;
        break;
      case R_COUNT: stk[sp++] = count; pc += 1; break;
      case R_AGG: stk[sp++] = from_d(agg(code[pc + 1])); pc += 2; break;
      case R_CAST: stk[sp - 1] = r_cast(stk[sp - 1], code[pc + 1], code[pc + 2]); pc += 3; break;
      case R_ARITH: {
        long long b = stk[--sp];
        stk[sp - 1] = r_arith(code[pc + 1], code[pc + 2], stk[sp - 1], b);
        pc += 3;
        break;
      }
      case R_CMP: {
        long long b = stk[--sp];
        stk[sp - 1] = r_compare(code[pc + 1], code[pc + 2], stk[sp - 1], b) ? 1 : 0;
        pc += 3;
        break;
      }
      case R_AND: { long long b = stk[--sp]; stk[sp - 1] = (stk[sp - 1] != 0) && (b != 0); pc += 1; break; }
      case R_OR: { long long b = stk[--sp]; stk[sp - 1] = (stk[sp - 1] != 0) || (b != 0); pc += 1; break; }
      case R_NOT: stk[sp - 1] = stk[sp - 1] == 0; pc += 1; break;
      case R_TRUTH: stk[sp - 1] = r_truth(stk[sp - 1], code[pc + 1]) ? 1 : 0; pc += 2; break;
      default: return 0;
    }
  }
  return stk[0];
}

}  // namespace siddhi
