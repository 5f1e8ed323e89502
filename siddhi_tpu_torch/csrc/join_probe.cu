// join_probe: the probe and emission compaction of a join step, for
// sm_90a: stream-stream (the other side a ring) and stream-table (the
// other side a table, scanned whole or through the host's index
// candidates).
//
// Replaces, in the JAX package's jitted join step:
//   siddhi_tpu/core/join.py  make_step (:458-649): the [R, Q] candidate
//   grid (bucket lanes or the whole buffer), the compiled ON condition,
//   the matched-pair and unmatched index lists, the selector's having,
//   and the stable valid-first argsort that cuts the rows to the cap.
// Each trigger row (a CURRENT or EXPIRED row of the window's output)
// walks its candidates: its bucket's lane of the other ring (lane
// entries ascend, so the walk stops at the first empty entry), every
// live row of it in ring order, every valid row of a table in row order
// (`make_step`'s table branch, :495-497), or on the table fast path the
// valid rows of the host's [B, K] candidates (`siddhi_tpu/core/join.py`
// :533-547), picked through the batch-row index the trigger side's
// window carries as its last column (:476-482).  The ON bytecode reads the trigger row
// through LOAD_EV and the candidate through LOAD_OTHER; the having
// bytecode, when the query has one, gates each joined row the same way,
// and an unmatched row's LOAD_OTHER reads the null of each column.
// Output: index rows (li, ri, null): all pairs in trigger-row order and
// ascending candidate within a row, then the unmatched rows of an outer
// side, cut to `cap`, and [n_valid, n_current, n_dropped].
//
// Bound: each trigger row's columns are read once per candidate from
// registers, each candidate's columns the ON reads are gathered once
// (random 4-8 B reads from the ring), and 9 B are written per kept row;
// at J2's shape (262,144 trigger rows, 8 candidates each, so about 9 of a
// lane's 32 entries read: the walk stops at the first empty one) the
// gathers and lane reads dominate, so the probe is bound by bytes, and by
// the latency of its dependent random reads.  On T1's table fast path
// (131,072 trigger rows, one candidate each, a 2^20-row table) the same
// holds.  The grid over a table evaluates R x C pairs: operations.
// Design: one thread per trigger row, two passes over the candidates so
// that nothing per candidate is stored: a counting pass, two device-wide
// exclusive scans (pairs and unmatched rows) that give every row its
// stable place, and a writing pass; a last pass fills the rows past
// n_valid and the header.  The CURRENT count inside the cut is an integer
// atomic sum.
#include "bytecode.cuh"
#include "rows.cuh"

using namespace siddhi;

namespace {

constexpr int MAX_COLS = 16;
constexpr int MAX_CODE = 256;
constexpr int BLOCK = 256;

}  // namespace

// Mirrored field for field by kernels/join_probe.py (ctypes.Structure).
struct ProbePlan {
  long long R, C, cap, nbl, lane_k, nscan;
  int ncols_this, ncols_other, on_len, hv_len, emit_unmatched, jslot_col;
  int t_ty[MAX_COLS], t_bytes[MAX_COLS];
  int o_ty[MAX_COLS], o_bytes[MAX_COLS];
  int on_code[MAX_CODE];
  int hv_code[MAX_CODE];
  long long o_null[MAX_COLS];
  const int* t_kind;
  const unsigned char* t_valid;
  const void* t_col[MAX_COLS];
  const void* o_col[MAX_COLS];
  const long long* o_meta;   // the other ring's [head, tail, ...]
  const int* lanes;          // [nbl * lane_k], or null on the grid path
  long long* pc;             // [R] emitted pairs a row, then offsets
  long long* uc;             // [R] unmatched flags, then offsets
  long long* sums_p;
  long long* sums_u;
  int* out_li;
  int* out_ri;
  unsigned char* out_null;
  unsigned char* out_valid;
  long long* hdr;            // [n_valid, n_current, n_dropped]
  // the other side is a table: its valid column [C] (else null), and on
  // the table fast path the host's candidates [cand_b, cand_k] (else
  // null), which a trigger row picks through its batch-index column
  const unsigned char* o_valid;
  const int* cand;
  long long cand_b, cand_k;
};

namespace {

// A column element as a 64-bit stack slot; bool columns are 1 byte.
__device__ __forceinline__ long long load_col(const void* src, long long i, int bytes) {
  if (bytes == 8) return ((const long long*)src)[i];
  if (bytes == 4) return (long long)((const int*)src)[i];
  return (long long)((const unsigned char*)src)[i];
}

__device__ __forceinline__ bool is_data(const ProbePlan& pl, long long i) {
  int k = pl.t_kind[i];
  return pl.t_valid[i] && (k == K_CURRENT || k == K_EXPIRED);
}

// f(p) for every candidate of trigger row i, p the physical row of the
// other side, in the reference's order: a ring's buffer order, a table's
// row order (the fast path's candidates arrive ascending)
template <class F>
__device__ __forceinline__ void for_candidates(const ProbePlan& pl, long long i, F f) {
  if (pl.cand != nullptr) {
    long long b = load_col(pl.t_col[pl.jslot_col], i, 4);
    b = b < 0 ? 0 : (b >= pl.cand_b ? pl.cand_b - 1 : b);
    const int* row = pl.cand + b * pl.cand_k;
    for (long long q = 0; q < pl.cand_k; ++q) {
      long long c = row[q];
      if (c >= 0 && c < pl.C && pl.o_valid[c]) f(c);
    }
    return;
  }
  if (pl.o_valid != nullptr) {
    for (long long c = 0; c < pl.C; ++c)
      if (pl.o_valid[c]) f(c);
    return;
  }
  const long long head = pl.o_meta[0];
  if (pl.lane_k > 0) {
    long long s = load_col(pl.t_col[pl.jslot_col], i, 4) % pl.nbl;
    if (s < 0) s += pl.nbl;
    const int* lane = pl.lanes + s * pl.lane_k;
    for (long long q = 0; q < pl.lane_k; ++q) {
      long long j = lane[q];
      if (j >= pl.C) break;
      f((head + j) % pl.C);
    }
  } else {
    const long long n = pl.o_meta[1] - head;
    for (long long j = 0; j < n; ++j) f((head + j) % pl.C);
  }
}

__device__ __forceinline__ bool cond(const ProbePlan& pl, const int* code, int len, long long i,
                                     long long p, bool other_null) {
  return eval_bytecode(
      code, len, [&](int c) { return load_col(pl.t_col[c], i, pl.t_bytes[c]); },
      [&](int, int) { return 0LL; },
      [&](int c) { return other_null ? pl.o_null[c] : load_col(pl.o_col[c], p, pl.o_bytes[c]); });
}

__global__ void jp_count(const ProbePlan pl) {
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i == 0) pl.hdr[1] = 0;
  if (i >= pl.R) return;
  long long m_on = 0, m_emit = 0;
  bool data = is_data(pl, i);
  if (data)
    for_candidates(pl, i, [&](long long p) {
      if (cond(pl, pl.on_code, pl.on_len, i, p, false)) {
        ++m_on;
        if (pl.hv_len == 0 || cond(pl, pl.hv_code, pl.hv_len, i, p, false)) ++m_emit;
      }
    });
  bool un = data && pl.emit_unmatched && m_on == 0 &&
            (pl.hv_len == 0 || cond(pl, pl.hv_code, pl.hv_len, i, 0, true));
  pl.pc[i] = m_emit;
  pl.uc[i] = un ? 1 : 0;
}

__global__ void jp_write(const ProbePlan pl) {
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= pl.R || !is_data(pl, i)) return;
  const long long total_p = pl.sums_p[pl.nscan];
  const long long total_u = pl.sums_u[pl.nscan];
  const bool cur = pl.t_kind[i] == K_CURRENT;
  long long pos = pl.pc[i];
  const long long end = i + 1 < pl.R ? pl.pc[i + 1] : total_p;
  unsigned long long n_cur = 0;
  if (pos < end && pos < pl.cap)
    for_candidates(pl, i, [&](long long p) {
      if (pos >= pl.cap || !cond(pl, pl.on_code, pl.on_len, i, p, false)) return;
      if (pl.hv_len != 0 && !cond(pl, pl.hv_code, pl.hv_len, i, p, false)) return;
      pl.out_li[pos] = (int)i;
      pl.out_ri[pos] = (int)p;
      pl.out_null[pos] = 0;
      pl.out_valid[pos] = 1;
      n_cur += cur;
      ++pos;
    });
  const long long uo = pl.uc[i];
  const long long un = (i + 1 < pl.R ? pl.uc[i + 1] : total_u) - uo;
  if (un) {
    const long long q = total_p + uo;
    if (q < pl.cap) {
      pl.out_li[q] = (int)i;
      pl.out_ri[q] = 0;
      pl.out_null[q] = 1;
      pl.out_valid[q] = 1;
      n_cur += cur;
    }
  }
  if (n_cur) atomicAdd((unsigned long long*)&pl.hdr[1], n_cur);
}

__global__ void jp_finish(const ProbePlan pl) {
  long long p = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const long long total = pl.R > 0 ? pl.sums_p[pl.nscan] + pl.sums_u[pl.nscan] : 0;
  const long long nv = total < pl.cap ? total : pl.cap;
  if (p < pl.cap && p >= nv) {
    pl.out_li[p] = 0;
    pl.out_ri[p] = 0;
    pl.out_null[p] = 1;
    pl.out_valid[p] = 0;
  }
  if (p == 0) {
    pl.hdr[0] = nv;
    pl.hdr[2] = total - nv;
    if (pl.R == 0) pl.hdr[1] = 0;
  }
}

}  // namespace

extern "C" int siddhi_probe_plan_size() { return (int)sizeof(ProbePlan); }

// Launches on `stream`; returns the launches' cudaError_t (0 = launched).
extern "C" int siddhi_join_probe(const ProbePlan* plan, void* stream) {
  const ProbePlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  if (pl.R > 0) {
    unsigned nb = (unsigned)((pl.R + BLOCK - 1) / BLOCK);
    jp_count<<<nb, BLOCK, 0, s>>>(pl);
    exclusive_scan(pl.pc, pl.R, pl.sums_p, s);
    exclusive_scan(pl.uc, pl.R, pl.sums_u, s);
    jp_write<<<nb, BLOCK, 0, s>>>(pl);
  }
  long long fin = pl.cap > 1 ? pl.cap : 1;
  jp_finish<<<(unsigned)((fin + BLOCK - 1) / BLOCK), BLOCK, 0, s>>>(pl);
  return (int)cudaGetLastError();
}
