// agg_base: the base values of an incremental aggregation (kernel K27),
// for sm_90a.
//
// Replaces the JAX package's aggregation `step`
// (siddhi_tpu/core/aggregation.py:483-506): for each row of a batch, its
// keep flag (valid, CURRENT and passing every filter of the aggregation's
// input) and, for every base aggregation, its value in f64: 1.0 for a
// count() base, 1.0 / 0.0 for a non-null count, else the argument in f64
// with its in-band null (INT_MIN, LONG_MIN or NaN) replaced by the base's
// identity.  The filters and arguments are the typed postfix bytecode of
// kernels/filter_bytecode.py, run by bytecode.cuh's interpreter (a filter
// through eval_bytecode, an argument through eval_slot).
//
// Design: one thread per row evaluates the filters and every base's
// argument and writes keep[i] and vals[b][i]; nothing moves.
//
// Bound: each row's kind, valid flag and the columns the programs load are
// read once, its keep flag and n_base f64 values written once; the
// programs are a few dozen integer or float operations a row.  Bound by
// bytes.
#include "bytecode.cuh"
#include "rows.cuh"

using namespace siddhi;

namespace {

constexpr int MAX_COLS = 16;
constexpr int MAX_CODE = 256;
constexpr int MAX_BASE = 16;
constexpr int MAX_VCODE = 256;
constexpr int BLOCK = 256;
enum : int { M_ONE = 0, M_NONNULL = 1, M_VALUE = 2 };

}  // namespace

// Mirrored field for field by kernels/agg_base.py (ctypes.Structure).
struct BasePlan {
  long long B;
  int ncols, nbase, fcode_len, pad;
  int col_ty[MAX_COLS];
  int fcode[MAX_CODE];
  int vcode[MAX_VCODE];
  int voff[MAX_BASE], vlen[MAX_BASE], mode[MAX_BASE], vty[MAX_BASE], vnk[MAX_BASE];
  double ident[MAX_BASE];
  const int* kind;
  const unsigned char* valid;
  const void* col[MAX_COLS];
  unsigned char* keep;
  double* vals;
};

namespace {

// A stack slot of value type `ty` as f64 (a 64-bit integer rounds to
// nearest, as the reference's astype does).
__device__ __forceinline__ double slot_f64(long long v, int ty) {
  if (ty == T_F32) return (double)as_f(v);
  if (ty == T_I64) return __ll2double_rn(v);
  return (double)(int)v;
}

__global__ void ab_rows(const BasePlan pl) {
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= pl.B) return;
  auto load = [&](int c) { return load_slot(pl.col[c], i, pl.col_ty[c]); };
  auto nocap = [](int, int) { return 0LL; };
  auto noother = [](int) { return 0LL; };
  bool keep = pl.valid[i] != 0 && pl.kind[i] == K_CURRENT;
  if (keep) keep = eval_bytecode(pl.fcode, pl.fcode_len, load, nocap, noother);
  pl.keep[i] = (unsigned char)keep;
  for (int b = 0; b < pl.nbase; ++b) {
    double v = 1.0;
    if (pl.mode[b] != M_ONE) {
      long long s = eval_slot(pl.vcode + pl.voff[b], pl.vlen[b], load, nocap, noother,
                              (const InSet*)nullptr);
      bool nul = is_null(s, pl.vnk[b]);
      if (pl.mode[b] == M_NONNULL) v = nul ? 0.0 : 1.0;
      else v = nul ? pl.ident[b] : slot_f64(s, pl.vty[b]);
    }
    pl.vals[(long long)b * pl.B + i] = v;
  }
}

}  // namespace

extern "C" int siddhi_agg_base_plan_size() { return (int)sizeof(BasePlan); }

// Launch on `stream`; returns the launch's cudaError_t (0 = launched).
extern "C" int siddhi_agg_base(const BasePlan* plan, void* stream) {
  const BasePlan& pl = *plan;
  if (pl.B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  ab_rows<<<(unsigned)((pl.B + BLOCK - 1) / BLOCK), BLOCK, 0, s>>>(pl);
  return (int)cudaGetLastError();
}
