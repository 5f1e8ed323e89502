// post_filter: the filters after a single-stream query's window (kernel
// K15), for sm_90a.
//
// Replaces the JAX package's `_apply_chain` over the post-window chain
// (siddhi_tpu/core/planner.py:124) inside `select_body` (:501-516) and the
// keyed step `kstep` (:574-580): over the window's output rows, each
// CURRENT or EXPIRED row stays valid only if it was valid and passes every
// filter; TIMER and RESET rows pass untouched.  The filters are the typed
// postfix bytecode of kernels/filter_bytecode.py (bytecode.cuh, with
// `x in Table` as a lookup in the hash sets of csrc/in_probe.cu).
//
// Design: one thread per row evaluates the bytecode on the row's columns
// and writes the new valid flag; nothing moves, so the rows keep their
// order and the selector that follows reads them as before.
//
// Bound: each row's kind, valid flag and the columns the filters load are
// read once and its flag written once; the filter is a few dozen integer
// or float operations a row.  Bound by bytes.
#include "bytecode.cuh"
#include "rows.cuh"

using namespace siddhi;

namespace {

constexpr int MAX_COLS = 16;
constexpr int MAX_CODE = 256;
constexpr int BLOCK = 256;

}  // namespace

// Mirrored field for field by kernels/post_filter.py (ctypes.Structure).
struct PostPlan {
  long long R;
  int ncols, code_len;
  int col_ty[MAX_COLS];
  int code[MAX_CODE];
  const int* kind;
  const unsigned char* valid;
  const void* col[MAX_COLS];
  unsigned char* out_valid;
  InSet in_sets[MAX_IN];
};

namespace {

__global__ void pf_rows(const PostPlan pl) {
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= pl.R) return;
  bool v = pl.valid[i] != 0;
  int k = pl.kind[i];
  if (v && (k == K_CURRENT || k == K_EXPIRED))
    v = eval_bytecode_in(
        pl.code, pl.code_len, [&](int c) { return load_slot(pl.col[c], i, pl.col_ty[c]); },
        [&](int, int) { return 0LL; }, pl.in_sets);
  pl.out_valid[i] = (unsigned char)v;
}

}  // namespace

extern "C" int siddhi_post_plan_size() { return (int)sizeof(PostPlan); }

// Launch on `stream`; returns the launch's cudaError_t (0 = launched).
extern "C" int siddhi_post_filter(const PostPlan* plan, void* stream) {
  const PostPlan& pl = *plan;
  if (pl.R <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  pf_rows<<<(unsigned)((pl.R + BLOCK - 1) / BLOCK), BLOCK, 0, s>>>(pl);
  return (int)cudaGetLastError();
}
