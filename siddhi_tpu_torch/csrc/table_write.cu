// table_write: the row writes of an in-memory table, for sm_90a.
//
// Replaces the JAX package's jitted table steps:
//   siddhi_tpu/core/table.py  TableRuntime._write_impl (:133): scatter a
//   batch's valid rows into their slots (each column cast to the table
//   column's type), set their ts and mark them valid;
//   siddhi_tpu/core/table.py  TableRuntime._masked_delete_impl (:144):
//   valid &= ~kill.
// A primary-key batch that carries one key twice gives two rows one slot.
// The reference's scatter keeps the last of them in batch order (its CPU
// scatter applies the rows in order; the tier-1 tests hold that), and a
// CUDA scatter with duplicate targets is a race.  So the winner is chosen
// explicitly: a claim pass takes atomicMax of the batch row index into a
// per-slot scratch word, a write pass lets only the winning row write,
// and a reset pass puts the scratch words it touched back to -1 (the
// scratch lives with the table, all -1 between launches, so no pass over
// the whole table is needed).
//
// Bound: the write reads each valid row's columns, ts and slot once and
// writes its slot's columns, ts and valid once (T1's upsert: 131,072 rows
// of 8 + 4 + 8 B columns), plus the scratch word of each slot three times;
// random 4-8 B stores into a 2^20-row table, so it is bound by bytes, at
// the rate of scattered stores.  The delete reads kill and valid and
// writes valid over [C]: bytes.
// Design: one thread per batch row (write) or table row (delete); column
// types and widths travel in the plan, so one build serves every table.
#include "bytecode.cuh"

using namespace siddhi;

namespace {

constexpr int MAX_COLS = 16;
constexpr int BLOCK = 256;

}  // namespace

// Mirrored field for field by kernels/table_write.py (ctypes.Structure).
struct WritePlan {
  long long B, C;
  int ncols, pad_;
  int dst_ty[MAX_COLS], src_ty[MAX_COLS];
  void* dst[MAX_COLS];          // table columns [C]
  const void* src[MAX_COLS];    // batch columns [B]
  long long* ts;                // [C]
  unsigned char* valid;         // [C]
  const long long* new_ts;      // [B]
  const int* slots;             // [B]
  const unsigned char* row_valid;  // [B]
  int* win;                     // [C] scratch, -1 between launches
  const unsigned char* kill;    // [C] (delete)
};

namespace {

// A column element of type code `ty` as a 64-bit slot (floats as bits).
__device__ __forceinline__ long long load_typed(const void* p, long long i, int ty) {
  switch (ty) {
    case T_I64: return ((const long long*)p)[i];
    case T_BOOL: return ((const unsigned char*)p)[i] != 0;
    default: return (long long)((const int*)p)[i];
  }
}

// astype from `from` to `to`, as torch's `.to(dtype)` computes it on the
// finite values a table stores: integers wrap, floats truncate toward zero.
__device__ __forceinline__ void store_cast(void* p, long long i, int to, long long v, int from) {
  if (to == T_BOOL) {
    bool b = from == T_F32 ? as_f(v) != 0.0f : v != 0;
    ((unsigned char*)p)[i] = b ? 1 : 0;
    return;
  }
  if (from == T_F32 && to != T_F32) {
    float f = as_f(v);
    if (to == T_I64) ((long long*)p)[i] = (long long)f;
    else ((int*)p)[i] = (int)f;
    return;
  }
  long long c = cast(v, from == T_BOOL ? T_I32 : from, to);
  if (to == T_I64) ((long long*)p)[i] = c;
  else ((int*)p)[i] = (int)c;
}

__device__ __forceinline__ bool in_batch(const WritePlan& pl, long long i, int* slot) {
  if (!pl.row_valid[i]) return false;
  int s = pl.slots[i];
  *slot = s;
  return s >= 0 && s < pl.C;
}

__global__ void tw_claim(const WritePlan pl) {
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  int s;
  if (i < pl.B && in_batch(pl, i, &s)) atomicMax(&pl.win[s], (int)i);
}

__global__ void tw_write(const WritePlan pl) {
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  int s;
  if (i >= pl.B || !in_batch(pl, i, &s) || pl.win[s] != (int)i) return;
  for (int j = 0; j < pl.ncols; ++j)
    store_cast(pl.dst[j], s, pl.dst_ty[j], load_typed(pl.src[j], i, pl.src_ty[j]),
               pl.src_ty[j]);
  pl.ts[s] = pl.new_ts[i];
  pl.valid[s] = 1;
}

__global__ void tw_reset(const WritePlan pl) {
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  int s;
  if (i < pl.B && in_batch(pl, i, &s)) pl.win[s] = -1;
}

__global__ void tw_delete(const WritePlan pl) {
  long long c = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (c < pl.C && pl.kill[c]) pl.valid[c] = 0;
}

}  // namespace

extern "C" int siddhi_write_plan_size() { return (int)sizeof(WritePlan); }

// Launches on `stream`; returns the launches' cudaError_t (0 = launched).
extern "C" int siddhi_table_write(const WritePlan* plan, void* stream) {
  const WritePlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  if (pl.B > 0) {
    unsigned nb = (unsigned)((pl.B + BLOCK - 1) / BLOCK);
    tw_claim<<<nb, BLOCK, 0, s>>>(pl);
    tw_write<<<nb, BLOCK, 0, s>>>(pl);
    tw_reset<<<nb, BLOCK, 0, s>>>(pl);
  }
  return (int)cudaGetLastError();
}

extern "C" int siddhi_table_delete(const WritePlan* plan, void* stream) {
  const WritePlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  if (pl.C > 0)
    tw_delete<<<(unsigned)((pl.C + BLOCK - 1) / BLOCK), BLOCK, 0, s>>>(pl);
  return (int)cudaGetLastError();
}
