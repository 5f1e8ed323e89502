// expr_window: the expression window kernels K25 expr_window and K26
// expr_batch, for sm_90a.
//
// Replace the JAX package's ExpressionWindow.process and
// ExpressionBatchWindow.process (siddhi_tpu/core/window_expr.py:227,
// :329): at the top level on one key row, and inside a partition under the
// keyed step kstep (siddhi_tpu/core/planner.py:539-584: the pre-window
// filters, the gather of each key's events, process under vmap, the
// scatter back, the rows flattened key-major).  kernels/expr_window.py
// states the windows' rules, their rows, their numbering and the slab.
//
// Design.  The reference evaluates the window expression, for each
// arrival in turn (a lax.scan), at every candidate oldest row of the
// combined array.  Whether the expression holds over [j, hi] does not
// depend on the front or the start the scan carries, so it is computed for
// every (arrival, candidate) pair at once, and only the walk that picks a
// front or a flush from those bits is sequential:
//   ew_arrivals (a block per key row): the key's arrivals (its sel entries
//     that are valid CURRENT rows and pass the filter bytecode, compacted
//     in batch order by a block scan) and their number; a device-wide scan
//     of those numbers gives each key row's first arrival slot.  The
//     scratch is sized by the arrivals, never by the widest key row: a key
//     row's combined array takes C + its arrivals slots from r C + its
//     first arrival slot, its arrivals' bits and walk outputs one slot each
//     from its first arrival slot (the batch holds at most A arrivals: a
//     batch row is an arrival of at most one key row).
//   ew_stage (a block per key row): its combined array's lanes (the
//     columns the program reads, and ts) as 64-bit slots; each aggregate's
//     per-row float64 values and, for sum / avg, their inclusive prefix (a
//     block scan with a running carry); each arrival's key row.
//   ew_sat (a thread per arrival): the range program (csrc/range_expr.cuh)
//     at each candidate j from hi down to hi - C (K25; hi - C + 1 for K26),
//     min / max running down with j, sum / avg as P[hi] - P[j] + x[j]; one
//     bit each, packed into words.
//   ew_walk (a warp per key row): the arrivals in order.  K25 looks for the
//     first set bit at or after max(front, hi - C) and clamps the front at
//     hi + 1 - C; K26 reads the bit at its start.  The chain is sequential,
//     so the warp takes 32 arrivals at once, a lane each, and steps them
//     from its neighbours' outputs until nothing changes (a fixpoint: at
//     most 32 rounds, usually one or two), each lane reading its own bit
//     row.  It writes the fronts (K25) or the flush starts (K26) and counts
//     the key's rows; a device-wide scan gives each key's offset and the
//     total, which the host reads to size the output.
//   ew_write (a block per key row): each row at its place, found in closed
//     form from the fronts or flush starts (a binary search per row), then
//     the slab's blocks rewritten: the new previous batch (K26), then the
//     kept rows shifted down a chunk at a time (every thread reads its row,
//     the block synchronises, every thread writes).
//
// Bound: each arrival is read once; of each stepped key, the lanes of its
// kept rows and the rows that leave are read, the rows that enter (and, for
// K26, a flushing key's previous batch) written; each output row written
// once.  Bound by bytes.  The kernels also
// move their scratch (the lanes, the prefix, the bits) through device
// memory, and the sat pass does C + 1 program evaluations per arrival.
#include <climits>

#include "range_expr.cuh"
#include "rows.cuh"

using namespace siddhi;

namespace {

constexpr int MAX_COLS = 16;
constexpr int MAX_CODE = 256;
constexpr int MAX_PROG = 256;
constexpr int MAX_LANES = 16;
constexpr int MAX_AGGS = 8;
constexpr int SB = 256;          // ew_stage / ew_write threads
constexpr int SAT_BLOCK = 128;
constexpr int WW = 4;            // ew_walk warps a block
constexpr int TS_LANE = -2;
constexpr unsigned FULL = 0xffffffffu;

}  // namespace

// Mirrored field for field by kernels/expr_window.py (ctypes.Structure).
struct ExprPlan {
  long long Kb, E, K, C, W, nwords, A, LT, cap;
  int ncols, code_len, prog_len, nlanes, naggs, inc, stream, pad;
  int lane_col[MAX_LANES];
  int lane_ty[MAX_LANES];
  int agg_kind[MAX_AGGS];
  int agg_off[MAX_AGGS];
  int agg_len[MAX_AGGS];
  int agg_ty[MAX_AGGS];
  int col_ty[MAX_COLS];
  int col_w[MAX_COLS];
  int code[MAX_CODE];       // the filter bytecode
  int prog[MAX_PROG];       // the range program, then the per-row programs
  const long long* ts;
  const int* kind;
  const unsigned char* valid;
  const int* gslot;
  const void* col[MAX_COLS];
  const int* key_idx;
  const int* sel;
  long long* s_ts;          // the main block [K, C]
  int* s_gslot;
  void* s_col[MAX_COLS];
  int* count;
  long long* seq;
  long long* p_ts;          // K26: the previous batch [K, C + 1]
  int* p_gslot;
  void* p_col[MAX_COLS];
  int* p_count;
  int* arr;                 // [Kb, E] each key row's arrivals (batch rows)
  int* n_arr;               // [Kb]
  long long* aoff;          // [Kb] each key row's first arrival slot
  const long long* atot;    // the arrivals in all (aoff's scan total)
  int* arow;                // [A] each arrival slot's key row
  long long* lane;          // [nlanes, LT] the combined arrays' lanes
  double* aggx;             // [naggs, LT] per-row aggregate values
  double* aggp;             // [naggs, LT] their prefix (sum / avg)
  unsigned* bits;           // [A, nwords]
  long long* walk;          // [A] K25: fronts; K26: flush starts
  long long* wres;          // [Kb, 2] final front / start, flushes
  long long* ocnt;          // [Kb] rows, then offsets
  long long* sums;
  long long* asums;         // aoff's scan: block sums, then the total
  long long* out_ts;
  int* out_kind;
  long long* out_seq;
  int* out_gslot;
  void* out_col[MAX_COLS];
  InSet in_sets[MAX_IN];
};

namespace {

__device__ __forceinline__ long long key_of(const ExprPlan& pl, long long r) {
  long long k = pl.key_idx[r];
  return (k >= 0 && k < pl.K) ? k : -1;
}

// Key row r's combined array in the lane scratch: C + its arrivals slots.
__device__ __forceinline__ long long comb_base(const ExprPlan& pl, long long r) {
  return r * pl.C + pl.aoff[r];
}

// A key row's combined array: the slab's rows [0, cnt) of key k, then its
// arrivals.  Row v's column q (-2: ts, -1: gslot) as raw bits.
struct Comb {
  long long k, cnt, C;
  const int* arr;
};

__device__ __forceinline__ long long comb_raw(const ExprPlan& pl, const Comb& c, long long v, int q) {
  if (v < c.cnt) {
    long long i = c.k * c.C + v;
    if (q == -2) return pl.s_ts[i];
    if (q == -1) return pl.s_gslot[i];
    return load_raw(pl.s_col[q], i, pl.col_w[q]);
  }
  long long i = c.arr[v - c.cnt];
  if (q == -2) return pl.ts[i];
  if (q == -1) return pl.gslot[i];
  return load_raw(pl.col[q], i, pl.col_w[q]);
}

// Output row o: `kind`, `ts`, `seq`, and the gslot and columns of combined
// row v (prev: row v of the previous batch instead).
__device__ void emit(const ExprPlan& pl, const Comb& c, long long o, long long v, bool prev,
                     int kind, long long ts, long long seq) {
  if (o < 0 || o >= pl.cap) return;
  pl.out_ts[o] = ts;
  pl.out_kind[o] = kind;
  pl.out_seq[o] = seq;
  long long pi = c.k * (c.C + 1) + v;
  pl.out_gslot[o] = prev ? pl.p_gslot[pi] : (int)comb_raw(pl, c, v, -1);
  for (int q = 0; q < pl.ncols; ++q)
    store_bits(pl.out_col[q], o, prev ? load_raw(pl.p_col[q], pi, pl.col_w[q]) : comb_raw(pl, c, v, q),
               pl.col_w[q]);
}

// ---- ew_arrivals -------------------------------------------------------------
__global__ void __launch_bounds__(SB) ew_arrivals(const ExprPlan pl) {
  __shared__ long long sh[2 * SB];
  for (long long r = blockIdx.x; r < pl.Kb; r += gridDim.x) {
    long long k = key_of(pl, r);
    if (k < 0) {
      if (threadIdx.x == 0) pl.n_arr[r] = pl.aoff[r] = 0;
      continue;
    }
    int* arr = pl.arr + r * pl.E;
    long long na = 0;
    for (long long e0 = 0; e0 < pl.E; e0 += SB) {
      long long e = e0 + threadIdx.x;
      long long i = e < pl.E ? pl.sel[r * pl.E + e] : -1;
      bool keep = false;
      if (i >= 0) {
        keep = pl.valid[i] && pl.kind[i] == K_CURRENT;
        if (keep && pl.code_len > 0)
          keep = eval_bytecode_in(
              pl.code, pl.code_len, [&](int q) { return load_slot(pl.col[q], i, pl.col_ty[q]); },
              [&](int, int) { return 0LL; }, pl.in_sets);
      }
      long long tot;
      long long ex = block_excl_scan<SB>((long long)keep, sh, &tot);
      if (keep) arr[na + ex] = (int)i;
      na += tot;
    }
    if (threadIdx.x == 0) pl.n_arr[r] = (int)(pl.aoff[r] = na);
    __syncthreads();
  }
}

// ---- ew_stage ----------------------------------------------------------------
__global__ void __launch_bounds__(SB) ew_stage(const ExprPlan pl) {
  __shared__ double shd[2 * SB];
  for (long long r = blockIdx.x; r < pl.Kb; r += gridDim.x) {
    long long k = key_of(pl, r);
    if (k < 0) continue;
    const long long na = pl.n_arr[r], a0 = pl.aoff[r];
    const Comb c{k, pl.count[k], pl.C, pl.arr + r * pl.E};
    const long long total = c.cnt + na;
    long long* lanes = pl.lane + comb_base(pl, r);
    double* ax = pl.aggx + comb_base(pl, r);
    double* ap = pl.aggp + comb_base(pl, r);
    for (long long kk = threadIdx.x; kk < na; kk += SB) pl.arow[a0 + kk] = (int)r;
    for (long long v = threadIdx.x; v < total; v += SB) {
      for (int l = 0; l < pl.nlanes; ++l) {
        int q = pl.lane_col[l];
        long long raw = comb_raw(pl, c, v, q == TS_LANE ? -2 : q);
        if (q != TS_LANE && pl.col_w[q] != 8) raw = (long long)(int)raw;
        lanes[l * pl.LT + v] = raw;
      }
      for (int a = 0; a < pl.naggs; ++a) {
        long long x = run_range(
            pl.prog + pl.agg_off[a], pl.agg_len[a], 0,
            [&](int, int l, int) { return lanes[l * pl.LT + v]; }, [](int) { return 0.0; });
        ax[a * pl.LT + v] = as_d(r_cast(x, pl.agg_ty[a], T_F64));
      }
    }
    __syncthreads();
    // the inclusive prefix of each sum / avg aggregate's values
    for (int a = 0; a < pl.naggs; ++a) {
      if (pl.agg_kind[a] != AGG_SUM && pl.agg_kind[a] != AGG_AVG) continue;
      double carry = 0.0;
      for (long long v0 = 0; v0 < total; v0 += SB) {
        long long v = v0 + threadIdx.x;
        double x = v < total ? ax[a * pl.LT + v] : 0.0;
        double* b0 = shd;
        double* b1 = shd + SB;
        b0[threadIdx.x] = x;
        __syncthreads();
        for (int off = 1; off < SB; off <<= 1) {
          double y = b0[threadIdx.x];
          if (threadIdx.x >= off) y = __dadd_rn(b0[threadIdx.x - off], y);
          b1[threadIdx.x] = y;
          __syncthreads();
          double* t = b0; b0 = b1; b1 = t;
        }
        if (v < total) ap[a * pl.LT + v] = __dadd_rn(carry, b0[threadIdx.x]);
        carry = __dadd_rn(carry, b0[SB - 1]);
        __syncthreads();
      }
    }
  }
}

// ---- ew_sat ------------------------------------------------------------------
template <bool BATCH>
__global__ void __launch_bounds__(SAT_BLOCK) ew_sat(const ExprPlan pl) {
  const long long item = (long long)blockIdx.x * SAT_BLOCK + threadIdx.x;
  if (item >= *pl.atot) return;
  const long long r = pl.arow[item], kk = item - pl.aoff[r];
  const long long k = key_of(pl, r);
  const long long hi = pl.count[k] + kk;
  const long long lo = BATCH ? pl.C - 1 : pl.C;     // j = hi - lo + o
  const long long* lanes = pl.lane + comb_base(pl, r);
  const double* ax = pl.aggx + comb_base(pl, r);
  const double* ap = pl.aggp + comb_base(pl, r);
  double ext[MAX_AGGS], phi[MAX_AGGS];
  for (int a = 0; a < pl.naggs; ++a) {
    bool mn = pl.agg_kind[a] == AGG_MIN;
    ext[a] = mn ? __longlong_as_double(0x7ff0000000000000LL) : __longlong_as_double((long long)0xfff0000000000000ULL);
    phi[a] = (pl.agg_kind[a] == AGG_SUM || pl.agg_kind[a] == AGG_AVG)
                 ? __dadd_rn(ap[a * pl.LT + hi], 0.0) : 0.0;
  }
  unsigned* out = pl.bits + item * pl.nwords;
  unsigned word = 0;
  for (long long o = pl.W - 1; o >= 0; --o) {
    long long j = hi - lo + o;
    bool s = false;
    if (j >= 0) {
      for (int a = 0; a < pl.naggs; ++a)
        if (pl.agg_kind[a] == AGG_MIN || pl.agg_kind[a] == AGG_MAX)
          ext[a] = ext_step(ax[a * pl.LT + j], ext[a], pl.agg_kind[a] == AGG_MIN);
      const long long cnt = hi - j + 1;
      long long res = run_range(
          pl.prog, pl.prog_len, cnt,
          [&](int op, int l, int t) {
            if (op == R_FIRST) return lanes[l * pl.LT + j];
            long long x = lanes[l * pl.LT + hi];
            return t == T_F32 ? from_f(__fadd_rn(as_f(x), 0.0f)) : x;
          },
          [&](int a) {
            int kind = pl.agg_kind[a];
            if (kind == AGG_MIN || kind == AGG_MAX) return ext[a];
            double sm = __dadd_rn(__dsub_rn(phi[a], ap[a * pl.LT + j]), ax[a * pl.LT + j]);
            if (kind == AGG_AVG) sm = __ddiv_rn(sm, (double)(cnt > 1 ? cnt : 1));
            return sm;
          });
      s = res != 0;
    }
    if (s) word |= 1u << (o & 31);
    if ((o & 31) == 0) {
      out[o >> 5] = word;
      word = 0;
    }
  }
}

// ---- ew_walk -----------------------------------------------------------------
// The first set bit of row b at or after bit `off` (-1: none), over nw
// words, by one lane.
__device__ __forceinline__ long long first_bit(const unsigned* b, long long nw, long long off) {
  for (long long wi = off >> 5; wi < nw; ++wi) {
    unsigned x = b[wi];
    if (wi == (off >> 5)) x &= FULL << (off & 31);
    if (x) return (wi << 5) + __ffs(x) - 1;
  }
  return -1;
}

// One arrival's step: the front (K25) or the start (K26) after arrival hi,
// from the one before it (`in`); *flush: K26's flush.
template <bool BATCH>
__device__ __forceinline__ long long walk_step(const ExprPlan& pl, const unsigned* b, long long hi,
                                               long long in, bool* flush) {
  const long long C = pl.C;
  if (!BATCH) {
    const long long base = hi - C;
    const long long f = first_bit(b, pl.nwords, (in > base ? in : base) - base);
    long long nf = f >= 0 ? base + f : hi + 1;
    return nf < hi + 1 - C ? hi + 1 - C : nf;
  }
  const long long base = hi - C + 1;
  const bool over = in < base;
  bool s = false;
  if (!over) {
    const long long o = in - base;
    s = (b[o >> 5] >> (o & 31)) & 1u;
  }
  *flush = in <= hi && (!s || over);
  return *flush ? (pl.inc ? hi + 1 : hi) : in;
}

// A warp per key row.  Its arrivals go 32 at a time, a lane each: every
// lane steps its arrival from its input (the chunk's entry value for lane
// 0, the lower lane's output for the others); while any lane's input
// changed, the lanes step again from the new inputs.  After r rounds the
// first r + 1 lanes are exact, and when no input changes every lane is
// (each lane's input is then its predecessor's output), so a chunk takes
// at most 32 rounds and usually one or two.  Each lane reads its own bit
// row, so a round's loads are in flight together.
template <bool BATCH>
__global__ void __launch_bounds__(32 * WW) ew_walk(const ExprPlan pl) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * WW + w;
  if (r >= pl.Kb) return;
  const long long k = key_of(pl, r);
  if (k < 0) {
    if (lane == 0) pl.ocnt[r] = 0;
    return;
  }
  const long long na = pl.n_arr[r], cnt = pl.count[k], nw = pl.nwords;
  long long* wk = pl.walk + pl.aoff[r];
  const unsigned* rows = pl.bits + pl.aoff[r] * nw;
  long long cur = 0, F = 0;          // the front / start entering a chunk
  for (long long c0 = 0; c0 < na; c0 += 32) {
    const long long kk = c0 + lane;
    const bool act = kk < na;
    const unsigned* b = rows + (act ? kk : 0) * nw;
    long long in = cur, out;
    bool fl = false;
    for (;;) {
      out = act ? walk_step<BATCH>(pl, b, cnt + kk, in, &fl) : in;
      long long nin = __shfl_up_sync(FULL, out, 1);
      if (lane == 0) nin = cur;
      // (an idle lane passes its input on, so it settles too)
      if (!__any_sync(FULL, nin != in)) break;
      in = nin;
    }
    if (!BATCH) {
      if (act) wk[kk] = out;
    } else {
      fl = fl && act;
      const unsigned bf = __ballot_sync(FULL, fl);
      if (fl) wk[F + __popc(bf & ((1u << lane) - 1u))] = out;
      F += __popc(bf);
    }
    cur = __shfl_sync(FULL, out, 31);
  }
  if (lane == 0) {
    long long rows_out;
    if (!BATCH) {
      pl.wres[2 * r] = cur;
      rows_out = cur + na;
    } else {
      pl.wres[2 * r] = cur;
      pl.wres[2 * r + 1] = F;
      long long pc = pl.p_count[k];
      rows_out = (pl.stream ? na : cur) + (F > 0 ? pc : 0) + (F >= 2 ? wk[F - 2] : 0);
    }
    pl.ocnt[r] = rows_out;
  }
}

// ---- ew_write ----------------------------------------------------------------
// The number of a[0, n) (non-decreasing) that are <= x.
__device__ __forceinline__ long long upper(const long long* a, long long n, long long x) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Combined rows [from, from + n) moved to the main block's [0, n), a chunk
// of SB rows at a time (each thread reads its row, the block synchronises,
// each thread writes), so no row is overwritten before it is read.
__device__ void shift_down(const ExprPlan& pl, const Comb& c, long long from, long long n) {
  long long vals[MAX_COLS + 2];
  for (long long i0 = 0; i0 < n; i0 += SB) {
    long long i = i0 + threadIdx.x;
    if (i < n)
      for (int q = -2; q < pl.ncols; ++q) vals[q + 2] = comb_raw(pl, c, from + i, q);
    __syncthreads();
    if (i < n) {
      long long d = c.k * c.C + i;
      pl.s_ts[d] = vals[0];
      pl.s_gslot[d] = (int)vals[1];
      for (int q = 0; q < pl.ncols; ++q) store_bits(pl.s_col[q], d, vals[q + 2], pl.col_w[q]);
    }
    __syncthreads();
  }
}

template <bool BATCH>
__global__ void __launch_bounds__(SB) ew_write(const ExprPlan pl) {
  const long long N = pl.C + pl.E;
  for (long long r = blockIdx.x; r < pl.Kb; r += gridDim.x) {
    long long k = key_of(pl, r);
    if (k < 0) continue;
    const long long na = pl.n_arr[r], cnt = pl.count[k], seq0 = pl.seq[k], o0 = pl.ocnt[r];
    const long long total = cnt + na;
    const long long* wk = pl.walk + pl.aoff[r];
    const Comb c{k, cnt, pl.C, pl.arr + r * pl.E};
    // every thread has read the key's counters before any moves them
    __syncthreads();
    if (!BATCH) {
      const long long span = N + 1, ff = pl.wres[2 * r];
      for (long long p = threadIdx.x; p < ff; p += SB) {
        long long kp = upper(wk, na, p);
        long long prev = kp > 0 ? wk[kp - 1] : 0;
        emit(pl, c, o0 + p + kp, p, false, K_EXPIRED, comb_raw(pl, c, p, -2),
             seq0 + kp * span + (p - prev));
      }
      for (long long kk = threadIdx.x; kk < na; kk += SB)
        emit(pl, c, o0 + wk[kk] + kk, cnt + kk, false, K_CURRENT, comb_raw(pl, c, cnt + kk, -2),
             seq0 + kk * span + span - 1);
      __syncthreads();
      shift_down(pl, c, ff, total - ff);
      if (threadIdx.x == 0) {
        pl.count[k] = (int)(total - ff);
        pl.seq[k] = seq0 + pl.E * span + 1;
      }
    } else {
      const long long span = 2 * N + 2, sfin = pl.wres[2 * r], F = pl.wres[2 * r + 1];
      const long long pc = pl.p_count[k];
      const long long base = pl.stream ? seq0 + pl.E : seq0;
      const long long lead = pl.stream ? na : 0;   // the streamed CURRENT rows
      if (F > 0)
        for (long long i = threadIdx.x; i < pc; i += SB)
          emit(pl, c, o0 + lead + i, i, true, K_EXPIRED, pl.p_ts[k * (pl.C + 1) + i], base + i);
      for (long long p = threadIdx.x; p < sfin; p += SB) {
        long long f = upper(wk, F, p);             // p's flush ordinal
        long long sf = f > 0 ? wk[f - 1] : 0, rank = p - sf;
        long long ts = comb_raw(pl, c, p, -2);
        if (!pl.stream)
          emit(pl, c, o0 + pc + sf + p, p, false, K_CURRENT, ts, seq0 + f * span + N + 1 + rank);
        if (f + 1 < F)
          emit(pl, c, pl.stream ? o0 + na + pc + p : o0 + pc + wk[f] + p, p, false, K_EXPIRED, ts,
               base + (f + 1) * span + rank);
      }
      if (pl.stream)
        for (long long kk = threadIdx.x; kk < na; kk += SB)
          emit(pl, c, o0 + kk, cnt + kk, false, K_CURRENT, comb_raw(pl, c, cnt + kk, -2), seq0 + kk);
      __syncthreads();
      if (F > 0) {
        // the last flushed batch becomes the previous one
        const long long s0 = F >= 2 ? wk[F - 2] : 0;
        for (long long i = threadIdx.x; i < sfin - s0; i += SB) {
          long long d = k * (pl.C + 1) + i;
          pl.p_ts[d] = comb_raw(pl, c, s0 + i, -2);
          pl.p_gslot[d] = (int)comb_raw(pl, c, s0 + i, -1);
          for (int q = 0; q < pl.ncols; ++q)
            store_bits(pl.p_col[q], d, comb_raw(pl, c, s0 + i, q), pl.col_w[q]);
        }
        if (threadIdx.x == 0) pl.p_count[k] = (int)(sfin - s0);
      }
      __syncthreads();
      shift_down(pl, c, sfin, total - sfin);
      if (threadIdx.x == 0) {
        pl.count[k] = (int)(total - sfin);
        pl.seq[k] = seq0 + (pl.E + 2) * span;
      }
    }
    __syncthreads();
  }
}

inline unsigned rows_grid(const ExprPlan& pl) {
  long long g = pl.Kb < (1LL << 20) ? pl.Kb : (1LL << 20);
  return (unsigned)(g > 0 ? g : 1);
}

template <bool BATCH>
int count_launch(const ExprPlan* plan, void* stream) {
  const ExprPlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  if (pl.Kb == 0) return 0;
  ew_arrivals<<<rows_grid(pl), SB, 0, s>>>(pl);
  exclusive_scan(pl.aoff, pl.Kb, pl.asums, s);
  ew_stage<<<rows_grid(pl), SB, 0, s>>>(pl);
  if (pl.A > 0)
    ew_sat<BATCH><<<(unsigned)((pl.A + SAT_BLOCK - 1) / SAT_BLOCK), SAT_BLOCK, 0, s>>>(pl);
  ew_walk<BATCH><<<(unsigned)((pl.Kb + WW - 1) / WW), 32 * WW, 0, s>>>(pl);
  exclusive_scan(pl.ocnt, pl.Kb, pl.sums, s);
  return (int)cudaGetLastError();
}

template <bool BATCH>
int write_launch(const ExprPlan* plan, void* stream) {
  const ExprPlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  ew_write<BATCH><<<rows_grid(pl), SB, 0, s>>>(pl);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int siddhi_expr_plan_size() { return (int)sizeof(ExprPlan); }

// Each kernel's entry points: the count launch (stage, sat, walk and the
// scan of the row counts; the total lands in sums[last]) and the write
// launch, on `stream`; each returns the launches' cudaError_t (0 =
// launched).
extern "C" int siddhi_expr_window_count(const ExprPlan* p, void* s) { return count_launch<false>(p, s); }
extern "C" int siddhi_expr_window_write(const ExprPlan* p, void* s) { return write_launch<false>(p, s); }
extern "C" int siddhi_expr_batch_count(const ExprPlan* p, void* s) { return count_launch<true>(p, s); }
extern "C" int siddhi_expr_batch_write(const ExprPlan* p, void* s) { return write_launch<true>(p, s); }
