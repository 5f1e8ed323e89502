// in_probe: the `x in Table` probe (kernel K14), for sm_90a.
//
// Replaces, in the JAX package's jitted steps, the dense [B, C] compare of
// every operand value against a table's first column,
//   siddhi_tpu/core/planner.py   _probe_env (and its copy in kstep)
//   siddhi_tpu/core/pattern.py   PatternExec._build_env
//   siddhi_tpu/core/pattern_block.py  the block step's probe_env
// any(v == col0[c] & valid[c]) over the table's C rows.  That compare is
// B*C operations (1.4e11 at a 2^20-row table and a 131,072-event send), so
// the port does not carry it over.  A build launch writes the valid rows'
// first-column values, cast to the probe's compare type, into an
// open-addressing hash set of a power of two >= 2C slots; it runs only
// when the table changed since the last build.  Each probe is then one
// lookup (OP_IN in bytecode.cuh, inside K1, K11, pattern_step and K8, or
// the lookup launch here for a probe in a select list).
//
// Semantics kept: values compare in the promoted type of the operand and
// the column (an INT column probed with a LONG operand compares as LONG);
// -0.0 and +0.0 are one key; NaN is never inserted and never found; an
// in-band null (INT_MIN, LONG_MIN, the string id -1) is a value like any
// other; strings compare by interned id.
//
// Bound: the build reads the column and its valid flags once and writes
// the set (2C 8-byte slots cleared, C inserted); a lookup reads the
// operand and about one 32-byte sector of the set per probe.  Both are
// bound by bytes.  Design: the clear and the insert are two launches, the
// insert one thread per table row with a 64-bit atomicCAS per probe step
// (duplicates stop at the equal key, so the set holds each value once).
#include "bytecode.cuh"

using namespace siddhi;

namespace {

constexpr int BLOCK = 256;

__global__ void in_clear(long long* slots, long long n, int* has_empty) {
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i < n) slots[i] = IN_EMPTY;
  if (i == 0) *has_empty = 0;
}

__global__ void in_insert(const void* col, int col_ty, const unsigned char* valid, long long C,
                          int ct, long long* slots, long long mask, int* has_empty) {
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= C || !valid[i]) return;
  long long key;
  if (!in_key(cast(load_slot(col, i, col_ty), col_ty, ct), ct, &key)) return;
  if (key == IN_EMPTY) {
    *has_empty = 1;
    return;
  }
  unsigned long long h = in_hash(key) & (unsigned long long)mask;
  for (;;) {
    unsigned long long prev = atomicCAS((unsigned long long*)&slots[h], (unsigned long long)IN_EMPTY,
                                        (unsigned long long)key);
    if (prev == (unsigned long long)IN_EMPTY || prev == (unsigned long long)key) return;
    h = (h + 1) & (unsigned long long)mask;
  }
}

__global__ void in_find(const void* vals, int val_ty, long long n, int ct, InSet set,
                        unsigned char* out) {
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  out[i] = in_lookup(set, cast(load_slot(vals, i, val_ty), val_ty, ct), ct) ? 1 : 0;
}

}  // namespace

// Rebuild the set of column `col` (type col_ty; bool columns arrive as
// int32) under compare type ct.  Launches on `stream`; returns the
// launches' cudaError_t (0 = launched).
extern "C" int siddhi_in_build(const void* col, int col_ty, const unsigned char* valid, long long C,
                               int ct, long long* slots, long long nslots, int* has_empty,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  in_clear<<<(unsigned)((nslots + BLOCK - 1) / BLOCK), BLOCK, 0, s>>>(slots, nslots, has_empty);
  if (C > 0)
    in_insert<<<(unsigned)((C + BLOCK - 1) / BLOCK), BLOCK, 0, s>>>(col, col_ty, valid, C, ct, slots,
                                                                    nslots - 1, has_empty);
  return (int)cudaGetLastError();
}

// out[i] = vals[i] in the set, for n operand values of type val_ty.
extern "C" int siddhi_in_lookup(const void* vals, int val_ty, long long n, int ct,
                                const long long* slots, long long nslots, const int* has_empty,
                                unsigned char* out, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  InSet set{slots, has_empty, nslots - 1};
  in_find<<<(unsigned)((n + BLOCK - 1) / BLOCK), BLOCK, 0, s>>>(vals, val_ty, n, ct, set, out);
  return (int)cudaGetLastError();
}
