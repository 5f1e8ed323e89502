// block_nfa: the single-key (non-partitioned) pattern / sequence step, K8,
// for sm_90a.
//
// Replaces the jitted XLA step of the JAX package's block NFA:
//   siddhi_tpu/core/pattern_block.py  make_block_step (seeds, the S-1 stages
//                                     per W-event chunk, the slab refill, the
//                                     `within` cut, the packed write-back and
//                                     the arrival-ordered emission)
// The selector's projection and the valid-first cut to the emission cap
// stay outside, as plain torch ops on the ordered rows.
//
// What it computes: the advance of ONE key's NFA over E events, in chunks of
// W = min(128, E) events.  Threads of a chunk are the P slab slots and one
// candidate per in-chunk seed event (T = P + W).  A PATTERN thread at stage s
// advances at its first matching event after its last capture; a SEQUENCE
// thread must match the next valid event or die.  Completions are ordered by
// (event index, thread); threads still pending at the chunk's end refill the
// free slab slots by rank, and the rest count into `dropped`.  The reference's
// documented divergences from its scan path are kept (see
// core/pattern_block.py), and so is its one-hot movement of values between
// threads: a float32 -0.0 captured by a stage or moved by the refill comes out
// +0.0.
//
// Design: the carry depends on the previous chunk, so the chunks run in
// order, in ONE block of T threads (rounded up to a warp) that loops over
// them with the carry in shared memory: per-thread fields (alive, position,
// start, entry) and the capture columns of every thread ([ncap][T], the slab
// rows first).  Per chunk: load the W events into shared memory; each seed
// thread evaluates atom 0's filter on its event; each thread then runs all
// S-1 stages on its own (a PATTERN stage scans its chunk from `avail` for the
// first match, a SEQUENCE stage evaluates one event, the next valid one);
// each completing thread counts the completions that order before it and
// writes its row at the running output offset plus that rank; ballots give
// the refill's ranks.  Filters are the typed postfix bytecode of
// kernels/filter_bytecode.py (csrc/bytecode.cuh).
//
// Bound: the step must read E events (the selection, the ts and the columns)
// and write the rows it emits and the slab once: a few bytes per event, a
// few microseconds at 3.35 TB/s for 131,072 events.  This kernel keeps ONE
// SM busy of 132, and a chunk costs six block barriers and a dependent chain
// of filter evaluations, so it runs far above that bound; making it fast
// (chunks on many SMs with a carry pass between them) is later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "bytecode.cuh"

using namespace siddhi;

namespace {

constexpr int MAX_ATOMS = 8;
constexpr int MAX_COLS = 16;
constexpr int MAX_EMIT = 32;
constexpr int MAX_CODE = 256;
constexpr int MAX_P = 32;

}  // namespace

// Mirrored field for field by kernels/block_nfa.py (ctypes.Structure).
struct BlockPlan {
  int E, B, P, S, W, C, T;
  int is_seq, every, a0_here, has_within, ts_wire, stream_atom_mask;
  int ncap, n_emit, smem;
  long long within, now, ts_base;
  // state layout: blob rows of slot 0 (slot p adds p); K = 1
  int off_active, off_pos, off_count, off_lmask, off_seed_on, off_done;
  int off_start, off_entry;
  int n_cols[MAX_ATOMS];
  int cap_base[MAX_ATOMS];           // first thread-capture index of atom a
  int cap_off[MAX_ATOMS][MAX_COLS];  // blob row of the atom's column, slot 0
  int cap_ty[MAX_ATOMS][MAX_COLS];
  int seed_ev[MAX_ATOMS];            // 1: a seed's capture of atom a = its event
  int ev_ncols;
  int ev_ty[MAX_COLS];
  int code_start[MAX_ATOMS];
  int code_len[MAX_ATOMS];
  int code[MAX_CODE];
  int emit_atom[MAX_EMIT];
  int emit_col[MAX_EMIT];
  // buffers
  int* b32;
  long long* b64;
  long long* dropped;
  const void* ev_col[MAX_COLS];
  const long long* raw_ts;
  const int* ts_delta;
  const int* sel_idx;
  long long* out_ts;
  unsigned char* out_valid;
  void* out_col[MAX_EMIT];
  long long* header;  // [completions written]
  InSet in_sets[MAX_IN];
};

namespace {

// a capture value as the reference's one-hot take returns it: -0.0f -> +0.0f
__device__ __forceinline__ long long take_norm(long long v, int ty) {
  return (ty == T_F32 && (unsigned int)v == 0x80000000u) ? 0LL : v;
}

__device__ __forceinline__ long long load_blob(const BlockPlan& pl, int row, int ty) {
  return ty == T_I64 ? pl.b64[row] : (long long)pl.b32[row];
}

__device__ __forceinline__ void store_blob(const BlockPlan& pl, int row, int ty, long long v) {
  if (ty == T_I64) pl.b64[row] = v; else pl.b32[row] = (int)v;
}

__global__ void __launch_bounds__(MAX_P + 128)
block_nfa_kernel(const __grid_constant__ BlockPlan pl) {
  extern __shared__ long long smem[];
  const int W = pl.W, T = pl.T, P = pl.P, S = pl.S, NC = pl.ev_ncols;
  const int t = threadIdx.x;
  const int nthreads = blockDim.x;
  // shared layout (8-byte words first)
  long long* s_ev = smem;                        // [NC][W]
  long long* s_ts = s_ev + (long long)NC * W;    // [W]
  long long* s_caps = s_ts + W;                  // [ncap][T]
  long long* s_start = s_caps + (long long)pl.ncap * T;  // [T]
  long long* s_entry = s_start + T;              // [T]
  long long* s_cts = s_entry + T;                // [T] completion ts
  int* s_valid = (int*)(s_cts + T);              // [W]
  int* s_nv = s_valid + W;                       // [W] next valid event
  int* s_alive = s_nv + W;                       // [T]
  int* s_pos = s_alive + T;                      // [T]
  int* s_cj = s_pos + T;                         // [T] completion event, -1 none
  int* s_slot_of = s_cj + T;                     // [MAX_P]
  unsigned* s_ballot = (unsigned*)(s_slot_of + MAX_P);  // [8]
  __shared__ int s_first, s_cstar, s_seed_on, s_done;
  __shared__ long long s_nout, s_dropped;

  // ---- the carry from the packed state ----------------------------------
  if (t < P) {
    s_alive[t] = pl.b32[pl.off_active + t] != 0;
    s_pos[t] = pl.b32[pl.off_pos + t];
    s_start[t] = pl.b64[pl.off_start + t];
    s_entry[t] = pl.b64[pl.off_entry + t];
    for (int a = 0; a < S; ++a)
      for (int c = 0; c < pl.n_cols[a]; ++c)
        s_caps[(long long)(pl.cap_base[a] + c) * T + t] =
            load_blob(pl, pl.cap_off[a][c] + t, pl.cap_ty[a][c]);
  }
  if (t == 0) {
    s_seed_on = pl.b32[pl.off_seed_on] != 0;
    s_done = pl.b32[pl.off_done] != 0;
    s_nout = 0;
    s_dropped = 0;
  }
  __syncthreads();

  for (int ch = 0; ch < pl.C; ++ch) {
    const long long base = (long long)ch * W;
    // ---- phase A: the chunk's events into shared memory ------------------
    for (int k = t; k < W; k += nthreads) {
      long long e = base + k;
      int valid = 0;
      long long ts = 0;
      if (e < pl.E) {
        int si = pl.sel_idx[e];
        valid = si >= 0;
        int ci = si < 0 ? 0 : (si > pl.B - 1 ? pl.B - 1 : si);
        ts = pl.ts_wire ? pl.ts_base + (long long)pl.ts_delta[ci] : pl.raw_ts[ci];
        for (int c = 0; c < NC; ++c) s_ev[(long long)c * W + k] = load_slot(pl.ev_col[c], ci, pl.ev_ty[c]);
      } else {
        for (int c = 0; c < NC; ++c) s_ev[(long long)c * W + k] = 0;  // zero padding
      }
      s_ts[k] = ts;
      s_valid[k] = valid;
    }
    if (t == 0) { s_first = W; s_cstar = W; }
    __syncthreads();

    // ---- phase B: next valid event (SEQUENCE) and seed filters -----------
    if (pl.is_seq)
      for (int k = t; k < W; k += nthreads) {
        int nv = k;
        while (nv < W && !s_valid[nv]) ++nv;
        s_nv[k] = nv;
      }
    const bool done0 = s_done != 0;  // the chunk-start latch (the stages' gate)
    bool c0 = false;
    const int j = t - P;             // a seed thread's event
    if (t >= P && t < T && pl.a0_here && s_valid[j] && !done0) {
      c0 = eval_bytecode_in(
          pl.code + pl.code_start[0], pl.code_len[0],
          [&](int c) { return s_ev[(long long)c * W + j]; },
          [&](int, int) { return 0LL; }, pl.in_sets);  // other atoms read zeros
    }
    if (c0 && !pl.every) atomicMin(&s_first, j);
    __syncthreads();

    // ---- phase C: thread arrays, then every stage of this thread ---------
    bool alive = false, comp = false;
    int cpos = 0, avail = 0, cj = -1;
    long long start = 0, entry = 0, cts = 0;
    if (t < P) {
      alive = s_alive[t] != 0;
      cpos = s_pos[t];
      start = s_start[t];
      entry = s_entry[t];
    } else if (t < T) {
      bool fire = pl.every ? c0 : (c0 && j == s_first && s_seed_on);
      alive = fire;
      cpos = 1;
      avail = j + 1;
      start = entry = s_ts[j];
      for (int a = 0; a < S; ++a)
        for (int c = 0; c < pl.n_cols[a]; ++c)
          s_caps[(long long)(pl.cap_base[a] + c) * T + t] =
              pl.seed_ev[a] ? s_ev[(long long)c * W + j] : 0;
      if (S == 1 && fire) {  // a single-atom pattern completes at its seed
        comp = true;
        cj = j;
        cts = s_ts[j];
        alive = false;
      }
    }
    if (t < T) {
      for (int s = 1; s < S; ++s) {
        const bool eligible = alive && cpos == s;
        if (!eligible) continue;
        if (!(pl.stream_atom_mask >> s & 1)) {
          // strict continuity: any remaining valid event kills a thread
          // waiting on another stream's atom
          if (pl.is_seq && avail < W && s_nv[avail] < W) alive = false;
          continue;
        }
        int hit = -1;
        const int* code = pl.code + pl.code_start[s];
        const int len = pl.code_len[s];
        auto cap = [&](int a, int c) { return s_caps[(long long)(pl.cap_base[a] + c) * T + t]; };
        if (pl.is_seq) {
          const bool exists = avail < W && s_nv[avail] < W;
          if (exists && !done0) {
            const int k = s_nv[avail];
            if ((!pl.has_within || s_ts[k] - start <= pl.within) &&
                eval_bytecode_in(code, len, [&](int c) { return s_ev[(long long)c * W + k]; }, cap, pl.in_sets))
              hit = k;
          }
          if (exists && hit < 0) alive = false;  // the next event did not match
        } else if (!done0) {
          for (int k = avail; k < W; ++k) {
            if (!s_valid[k]) continue;
            if (pl.has_within && s_ts[k] - start > pl.within) continue;
            if (eval_bytecode_in(code, len, [&](int c) { return s_ev[(long long)c * W + k]; }, cap, pl.in_sets)) {
              hit = k;
              break;
            }
          }
        }
        if (hit < 0) continue;
        for (int c = 0; c < pl.n_cols[s]; ++c)
          s_caps[(long long)(pl.cap_base[s] + c) * T + t] =
              take_norm(s_ev[(long long)c * W + hit], pl.cap_ty[s][c]);
        avail = hit + 1;
        entry = s_ts[hit];
        if (s == S - 1) {
          comp = true;
          cj = hit;
          cts = s_ts[hit];
          alive = false;
        } else {
          cpos = s + 1;
        }
      }
      s_alive[t] = alive;
      s_pos[t] = cpos;
      s_start[t] = start;
      s_entry[t] = entry;
      s_cj[t] = comp ? cj : -1;
      s_cts[t] = cts;
      if (comp && !pl.every) atomicMin(&s_cstar, cj);
    }
    // refill flags: a free slab slot, or a pending seed
    const bool flag = t < P ? !alive : (t < T && alive);
    const unsigned bal = __ballot_sync(0xffffffffu, flag);
    if ((t & 31) == 0) s_ballot[t >> 5] = bal;
    __syncthreads();

    // ---- phase D: emission rows and the refill ranks ---------------------
    // only the FIRST completion of a non-every pattern emits
    const int cstar = s_cstar;
    const bool emits = comp && (pl.every || S == 1 || cj == cstar);
    int before = 0;  // set flags before this thread
    for (int w = 0; w < (t >> 5); ++w) before += __popc(s_ballot[w]);
    before += __popc(bal & ((1u << (t & 31)) - 1u));
    int nfree = 0, nflag = 0;
    for (int w = 0; w < (nthreads >> 5); ++w) nflag += __popc(s_ballot[w]);
    // slab threads are 0..P-1: the free count is the prefix at thread P
    {
      int pw = P >> 5, pl_ = P & 31;
      for (int w = 0; w < pw; ++w) nfree += __popc(s_ballot[w]);
      if (pl_) nfree += __popc(s_ballot[pw] & ((1u << pl_) - 1u));
    }
    const int npend = nflag - nfree;
    if (emits) {
      const long long key = (long long)cj * (T + 1) + t;
      int rank = 0;
      for (int u = 0; u < T; ++u) {
        const int uj = s_cj[u];
        if (uj < 0 || u == t) continue;
        if (!(pl.every || S == 1 || uj == cstar)) continue;
        if ((long long)uj * (T + 1) + u < key) ++rank;
      }
      const long long row = s_nout + rank;
      pl.out_ts[row] = cts;
      pl.out_valid[row] = 1;
      for (int i = 0; i < pl.n_emit; ++i) {
        const int a = pl.emit_atom[i], c = pl.emit_col[i];
        const int ty = pl.cap_ty[a][c];
        const long long v = s_caps[(long long)(pl.cap_base[a] + c) * T + t];
        void* dst = pl.out_col[i];
        if (ty == T_I64) ((long long*)dst)[row] = v;
        else if (ty == T_BOOL) ((unsigned char*)dst)[row] = (unsigned char)(v != 0);
        else ((int*)dst)[row] = (int)v;
      }
    }
    if (t < P && flag) s_slot_of[before] = t;  // free slot of free-rank `before`
    const int ncomp = __syncthreads_count(emits);

    // ---- phase E: pending seeds move into the free slots -----------------
    if (t >= P && t < T && flag) {
      const int r = before - nfree;  // rank among the pending seeds
      if (r < nfree) {
        const int p = s_slot_of[r];
        s_alive[p] = 1;
        s_pos[p] = cpos;
        s_start[p] = start;
        s_entry[p] = entry;
        for (int a = 0; a < S; ++a)
          for (int c = 0; c < pl.n_cols[a]; ++c) {
            long long* row = s_caps + (long long)(pl.cap_base[a] + c) * T;
            row[p] = take_norm(row[t], pl.cap_ty[a][c]);
          }
      }
    }
    if (t == 0) {
      s_nout += ncomp;
      if (npend > nfree) s_dropped += npend - nfree;
      if (!pl.every) {
        if (s_first < W) s_seed_on = 0;
        if (ncomp > 0) s_done = 1;
      }
    }
    __syncthreads();
  }

  // ---- the final `within` cut and the packed write-back -----------------
  if (t < P) {
    bool act = s_alive[t] != 0;
    if (pl.has_within && pl.now - s_start[t] > pl.within) act = false;
    pl.b32[pl.off_active + t] = act ? 1 : 0;
    pl.b32[pl.off_pos + t] = s_pos[t];
    pl.b32[pl.off_count + t] = 0;
    pl.b32[pl.off_lmask + t] = 0;
    pl.b64[pl.off_start + t] = s_start[t];
    pl.b64[pl.off_entry + t] = s_entry[t];
    for (int a = 0; a < S; ++a)
      for (int c = 0; c < pl.n_cols[a]; ++c)
        store_blob(pl, pl.cap_off[a][c] + t, pl.cap_ty[a][c],
                   s_caps[(long long)(pl.cap_base[a] + c) * T + t]);
  }
  if (t == 0) {
    pl.b32[pl.off_seed_on] = s_seed_on;
    pl.b32[pl.off_done] = s_done;
    *pl.dropped += s_dropped;
    pl.header[0] = s_nout;
  }
}

}  // namespace

extern "C" int siddhi_block_nfa_plan_size() { return (int)sizeof(BlockPlan); }

// Launches on `stream`; returns the launch's cudaError_t (0 = launched).
extern "C" int siddhi_block_nfa(const BlockPlan* plan, void* stream) {
  if (plan->E <= 0) return 0;
  int threads = (plan->T + 31) / 32 * 32;
  // above 48 KB the block's dynamic shared memory must be allowed first;
  // raised only when a launch needs more than before (so a graph capture
  // of a launch already made makes no such call)
  static int smem_allowed = 48 * 1024;
  if (plan->smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(block_nfa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           plan->smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = plan->smem;
  }
  block_nfa_kernel<<<1, threads, plan->smem, (cudaStream_t)stream>>>(*plan);
  return (int)cudaGetLastError();
}
