// table_match: which table rows a batch's condition matches, for sm_90a.
//
// Replaces the JAX package's eager device work of
//   siddhi_tpu/core/table.py  TableRuntime._match (:259-316) and
//   match_matrix (:318): the [B, C] condition over (batch row, table row)
//   pairs, reduced to hit [C] (some valid batch row matches the table
//   row), src [C] (the LAST matching batch row, -1 where none) and
//   matched_any [B] (the batch row matches some valid table row); on the
//   indexed path the same three outputs from the host's [B, K] candidates
//   (the @PrimaryKey allocator or an @Index lane table), each re-verified
//   against the full condition and the table's valid column on the
//   device (the reference fetched the whole valid column to the host and
//   reduced with np.maximum.at there).
// The condition is the typed filter bytecode of bytecode.cuh: LOAD_EV
// reads the batch row, LOAD_OTHER the table row, as in join_probe.
//
// Bound: dense, B x C pair evaluations of an interpreted condition, so
// operations (T2: 4,096 x 4,096 pairs; a 2^20-row table against 1,024
// batch rows: 2^30 pairs); candidates, the gathers of each candidate's
// table row and the [C] outputs' initialisation, so bytes.
// Design, dense: no [B, C] matrix.  One thread per table row walks a
// slice of the batch in tiles of TB rows that the block stages in shared
// memory (only the columns the condition loads), in ascending batch
// order; the batch is cut into as many slices (blockIdx.y) as it takes
// to give the card about two blocks an SM when the table is small (a
// 4,096-row table is 16 blocks of table rows).  Each thread's last match
// in its slice goes to src by atomicMax; hit and matched_any are flag
// stores (every writer stores 1).  Candidates: one thread per (batch row,
// candidate), the same atomicMax and flag stores.  An initialisation pass
// over [C] and [B] comes first in both modes.
#include "bytecode.cuh"

using namespace siddhi;

namespace {

constexpr int MAX_COLS = 16;
constexpr int MAX_CODE = 256;
constexpr int BLOCK = 256;
constexpr int TB = 128;   // batch rows staged per tile
constexpr long long SMS = 132;   // the H100 SXM's multiprocessors

}  // namespace

// Mirrored field for field by kernels/table_match.py (ctypes.Structure).
struct MatchPlan {
  long long B, C, K;            // K = 0: dense; else candidates [B, K]
  int ncols_ev, ncols_tab, code_len, ev_used;  // ev_used: bit j = column j loaded
  int ev_bytes[MAX_COLS], tab_bytes[MAX_COLS];
  int code[MAX_CODE];
  const void* ev_col[MAX_COLS];     // batch columns [B]
  const void* tab_col[MAX_COLS];    // table columns [C]
  const unsigned char* ev_valid;    // [B]
  const unsigned char* tab_valid;   // [C]
  const int* cand;                  // [B * K], -1 where none
  unsigned char* hit;               // [C]
  int* src;                         // [C]
  unsigned char* any;               // [B]
};

namespace {

__device__ __forceinline__ long long load_col(const void* p, long long i, int bytes) {
  if (bytes == 8) return ((const long long*)p)[i];
  if (bytes == 4) return (long long)((const int*)p)[i];
  return (long long)((const unsigned char*)p)[i];
}

__global__ void tm_init(const MatchPlan pl) {
  long long t = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (t < pl.C) {
    pl.hit[t] = 0;
    pl.src[t] = -1;
  }
  if (t < pl.B) pl.any[t] = 0;
}

// `per` batch rows a slice; slice blockIdx.y holds [y * per, (y+1) * per)
__global__ void tm_dense(const MatchPlan pl, long long per) {
  __shared__ long long tile[MAX_COLS][TB];
  __shared__ unsigned char tv[TB];
  const long long c = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const bool live = c < pl.C && pl.tab_valid[c];
  const long long lo = (long long)blockIdx.y * per;
  const long long hi = lo + per < pl.B ? lo + per : pl.B;
  int best = -1;
  for (long long b0 = lo; b0 < hi; b0 += TB) {
    for (int t = threadIdx.x; t < TB; t += BLOCK) {
      long long b = b0 + t;
      bool in = b < hi;
      tv[t] = in && pl.ev_valid[b];
      for (int j = 0; j < pl.ncols_ev; ++j)
        if (pl.ev_used >> j & 1) tile[j][t] = in ? load_col(pl.ev_col[j], b, pl.ev_bytes[j]) : 0;
    }
    __syncthreads();
    if (live) {
      const int n = hi - b0 < TB ? (int)(hi - b0) : TB;
      for (int t = 0; t < n; ++t) {
        if (!tv[t]) continue;
        bool m = eval_bytecode(
            pl.code, pl.code_len, [&](int j) { return tile[j][t]; },
            [&](int, int) { return 0LL; },
            [&](int j) { return load_col(pl.tab_col[j], c, pl.tab_bytes[j]); });
        if (m) {
          best = (int)(b0 + t);
          pl.any[b0 + t] = 1;
        }
      }
    }
    __syncthreads();
  }
  if (best >= 0) {
    pl.hit[c] = 1;
    atomicMax(&pl.src[c], best);
  }
}

__global__ void tm_cand(const MatchPlan pl) {
  long long idx = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (idx >= pl.B * pl.K) return;
  const long long b = idx / pl.K;
  const long long c = pl.cand[idx];
  if (c < 0 || c >= pl.C || !pl.ev_valid[b] || !pl.tab_valid[c]) return;
  bool m = eval_bytecode(
      pl.code, pl.code_len, [&](int j) { return load_col(pl.ev_col[j], b, pl.ev_bytes[j]); },
      [&](int, int) { return 0LL; },
      [&](int j) { return load_col(pl.tab_col[j], c, pl.tab_bytes[j]); });
  if (!m) return;
  pl.hit[c] = 1;
  atomicMax(&pl.src[c], (int)b);
  pl.any[b] = 1;
}

}  // namespace

extern "C" int siddhi_match_plan_size() { return (int)sizeof(MatchPlan); }

// Launches on `stream`; returns the launches' cudaError_t (0 = launched).
extern "C" int siddhi_table_match(const MatchPlan* plan, void* stream) {
  const MatchPlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  long long n_init = pl.C > pl.B ? pl.C : pl.B;
  if (n_init > 0)
    tm_init<<<(unsigned)((n_init + BLOCK - 1) / BLOCK), BLOCK, 0, s>>>(pl);
  if (pl.K > 0) {
    long long n = pl.B * pl.K;
    if (n > 0) tm_cand<<<(unsigned)((n + BLOCK - 1) / BLOCK), BLOCK, 0, s>>>(pl);
  } else if (pl.C > 0 && pl.B > 0) {
    long long cb = (pl.C + BLOCK - 1) / BLOCK;
    long long tiles = (pl.B + TB - 1) / TB;
    long long splits = (2 * SMS + cb - 1) / cb;
    if (splits > tiles) splits = tiles;
    if (splits > 65535) splits = 65535;
    long long per = (tiles + splits - 1) / splits * TB;
    splits = (pl.B + per - 1) / per;
    tm_dense<<<dim3((unsigned)cb, (unsigned)splits), BLOCK, 0, s>>>(pl, per);
  }
  return (int)cudaGetLastError();
}
