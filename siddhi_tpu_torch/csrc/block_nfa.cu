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
// W = min(128, E) events.  Rows of a chunk are the P slab slots and one
// candidate per in-chunk seed event (T = P + W).  A PATTERN row at stage s
// advances at its first matching event after its last capture; a SEQUENCE
// row must match the next valid event or die.  Completions are ordered by
// (event index, row); rows still pending at the chunk's end refill the
// free slab slots by rank, and the rest count into `dropped`.  The
// reference's documented divergences from its scan path are kept (see
// core/pattern_block.py), and so is its one-hot movement of values between
// rows: a float32 -0.0 captured by a stage or moved by the refill comes out
// +0.0.
//
// Design: the carry depends on the previous chunk (and chunk boundaries are
// part of the semantics), so the chunks run in order in ONE block of NT
// threads that loops over them with the carry in shared memory: per-row
// fields (alive, stage, next event, start, entry, completion) and the
// capture columns of every row ([ncap][T], the slab rows first).  The last
// 128 threads are stagers: while the rows run chunk c, they turn chunk c +
// 1's events, copied raw into shared memory by cp.async during chunk c - 1,
// into 64-bit slots, its valid mask (a ballot per 32 events) and atom 0's
// filter on each event, then start the copies of chunk c + 2's events (its
// selection arrived a chunk earlier) and of the selection after it; every
// staged array alternates by chunk, so the block never waits on device
// memory and the seeds cost the rows nothing.  Per chunk the rows:
//  B. read atom 0's result for each seed (a non-every pattern then finds
//     the chunk's first seed, across a barrier);
//  C. run their stages, each in its own thread (a SEQUENCE stage's next
//     valid event from the valid mask's words, not a loop over events);
//     a PATTERN row examines at most BUDGET events so, and a row still
//     scanning then is finished by a warp: lane l evaluates the stage's
//     filter at event avail + l with the row's captures and the `within`
//     cut, __ballot_sync / __ffs give the first match, and the row stops
//     at its first non-zero word (at most 4 evaluations a lane a stage,
//     not up to 128 in one thread);
//  D. each completing row packs its order key (event, row) at its place
//     among the completions (a ballot prefix), counts the keys below its
//     own and writes its row at the running output offset plus that rank;
//     ballots give the refill's ranks;
//  E. pending seeds move into the free slab slots.
// Filters are the typed postfix bytecode of kernels/filter_bytecode.py
// (csrc/bytecode.cuh).
//
// Bound: the step must read E events (the selection, the ts and the columns)
// and write the rows it emits and the slab once: a few bytes per event, a
// few microseconds at 3.35 TB/s for 131,072 events.  This kernel keeps ONE
// SM busy of 132: a chunk costs five block barriers (six without `every`)
// and, per row, a chain of filter evaluations in the bytecode interpreter
// (one a stage for a SEQUENCE row; about 6,000 of a chunk's 10,300 cycles
// at S1-wide on an H100), so it runs far above that bound.  Spreading the seeds of many chunks over many SMs, with
// a carry pass of the P slab slots between them, is the next lever.

#include <cstdint>
#include <cuda_pipeline.h>
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

constexpr int NT = 512;       // the block's threads
constexpr int NW = NT / 32;
constexpr int BUDGET = 8;     // events a PATTERN row's own thread examines
constexpr unsigned FULL = 0xffffffffu;

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

// The low 32 bits of a raw slot, sign-extended (a 4-byte value staged there).
__device__ __forceinline__ long long low32(long long v) { return (long long)(int)(unsigned)(v & 0xffffffffLL); }

// cp.async of chunk ch's selection entry k into *dst (nothing past E).
__device__ __forceinline__ void fetch_sel(const BlockPlan& pl, int* dst, int ch, int k) {
  const long long e = (long long)ch * pl.W + k;
  if (ch < pl.C && e < pl.E) __pipeline_memcpy_async(dst, pl.sel_idx + e, 4);
}

// cp.async of chunk ch's event k (selection si) into raw slots: its ts (the
// delta or the raw ts) and each column (4 or 8 bytes a slot's low bytes).
__device__ __forceinline__ void fetch_events(const BlockPlan& pl, long long* raw, long long* tsraw, int si,
                                             int ch, int k) {
  const long long e = (long long)ch * pl.W + k;
  if (ch >= pl.C || e >= pl.E) return;
  const int ci = si < 0 ? 0 : (si > pl.B - 1 ? pl.B - 1 : si);
  if (pl.ts_wire) __pipeline_memcpy_async(&tsraw[k], pl.ts_delta + ci, 4);
  else __pipeline_memcpy_async(&tsraw[k], pl.raw_ts + ci, 8);
  for (int c = 0; c < pl.ev_ncols; ++c) {
    const int bytes = pl.ev_ty[c] == T_I64 ? 8 : 4;
    __pipeline_memcpy_async(&raw[(long long)c * pl.W + k], (const char*)pl.ev_col[c] + (long long)ci * bytes,
                            bytes);
  }
}

// A row's fields while its stages run.
struct Row {
  bool alive, comp;
  int cpos, avail, cj;
  long long start, entry, cts;
};

// The chunk's shared arrays a row's stages read and write.
struct Chunk {
  const long long* ev;    // [NC][W]
  const long long* ts;    // [W]
  const int* valid;       // [W]
  const unsigned* vbal;   // [W / 32] the valid mask's words
  long long* caps;        // [ncap][T]
  int W, T;
  bool done0;             // the chunk-start latch: no stage advances

  // the first valid event at or after a, W when none
  __device__ int next_valid(int a) const {
    if (a >= W) return W;
    int w = a >> 5;
    unsigned m = vbal[w] & (FULL << (a & 31));
    while (!m) {
      if (++w >= (W + 31) >> 5) return W;
      m = vbal[w];
    }
    return (w << 5) + __ffs(m) - 1;
  }
};

__device__ __forceinline__ bool stage_filter(const BlockPlan& pl, const Chunk& ck, int s, int k, int row) {
  return eval_bytecode_in(
      pl.code + pl.code_start[s], pl.code_len[s],
      [&](int c) { return ck.ev[(long long)c * ck.W + k]; },
      [&](int a, int c) { return ck.caps[(long long)(pl.cap_base[a] + c) * ck.T + row]; }, pl.in_sets);
}

__device__ __forceinline__ void capture(const BlockPlan& pl, const Chunk& ck, int s, int k, int row) {
  for (int c = 0; c < pl.n_cols[s]; ++c)
    ck.caps[(long long)(pl.cap_base[s] + c) * ck.T + row] =
        take_norm(ck.ev[(long long)c * ck.W + k], pl.cap_ty[s][c]);
}

__device__ __forceinline__ void advance(const BlockPlan& pl, const Chunk& ck, Row& r, int s, int hit) {
  r.avail = hit + 1;
  r.entry = ck.ts[hit];
  if (s == pl.S - 1) {
    r.comp = true;
    r.cj = hit;
    r.cts = ck.ts[hit];
    r.alive = false;
  } else {
    r.cpos = s + 1;
  }
}

// A row's stages in its own thread.  A PATTERN stage examines at most
// `budget` events; returns true when the row stopped on that budget (its
// avail is then the next event to examine).
__device__ __forceinline__ bool row_thread(const BlockPlan& pl, const Chunk& ck, Row& r, int row, int budget) {
  for (int s = 1; s < pl.S; ++s) {
    if (!(r.alive && r.cpos == s)) continue;
    if (!(pl.stream_atom_mask >> s & 1)) {
      // strict continuity: any remaining valid event kills a row waiting
      // on another stream's atom
      if (pl.is_seq && ck.next_valid(r.avail) < ck.W) r.alive = false;
      continue;
    }
    int hit = -1;
    if (pl.is_seq) {
      const int k = ck.next_valid(r.avail);
      const bool exists = k < ck.W;
      if (exists && !ck.done0 && (!pl.has_within || ck.ts[k] - r.start <= pl.within) &&
          stage_filter(pl, ck, s, k, row))
        hit = k;
      if (exists && hit < 0) r.alive = false;  // the next event did not match
    } else if (!ck.done0) {
      for (int k = r.avail; k < ck.W; ++k) {
        if (budget-- <= 0) {
          r.avail = k;
          return true;
        }
        if (!ck.valid[k]) continue;
        if (pl.has_within && ck.ts[k] - r.start > pl.within) continue;
        if (stage_filter(pl, ck, s, k, row)) {
          hit = k;
          break;
        }
      }
    }
    if (hit < 0) continue;
    capture(pl, ck, s, hit, row);
    advance(pl, ck, r, s, hit);
  }
  return false;
}

// A PATTERN row's remaining stages by a warp (every lane holds the same
// Row): 32 events a ballot, the first set bit the match.
__device__ __forceinline__ void row_warp(const BlockPlan& pl, const Chunk& ck, Row& r, int row) {
  const int lane = threadIdx.x & 31;
  for (int s = r.cpos; s < pl.S; ++s) {
    if (!(r.alive && r.cpos == s) || !(pl.stream_atom_mask >> s & 1)) continue;
    int hit = -1;
    for (int b0 = r.avail; b0 < ck.W; b0 += 32) {
      const int k = b0 + lane;
      bool m = false;
      if (k < ck.W && ck.valid[k] && !(pl.has_within && ck.ts[k] - r.start > pl.within))
        m = stage_filter(pl, ck, s, k, row);
      const unsigned bm = __ballot_sync(FULL, m);
      if (bm) {
        hit = b0 + __ffs(bm) - 1;
        break;
      }
    }
    if (hit < 0) continue;
    if (lane == 0) capture(pl, ck, s, hit, row);
    __syncwarp();
    advance(pl, ck, r, s, hit);
  }
}

__global__ void __launch_bounds__(NT, 1) block_nfa_kernel(const __grid_constant__ BlockPlan pl) {
  extern __shared__ long long smem[];
  const int W = pl.W, T = pl.T, P = pl.P, S = pl.S, NC = pl.ev_ncols;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // shared layout (8-byte words first; kernels/block_nfa.py smem_bytes);
  // [2] buffers alternate by chunk: one is staged while the other runs
  long long* s_raw = smem;                                 // [2][NC][W] staged events
  long long* s_tsraw = s_raw + 2LL * NC * W;               // [2][W] staged ts
  long long* s_ev2 = s_tsraw + 2 * W;                      // [2][NC][W] events
  long long* s_ts2 = s_ev2 + 2LL * NC * W;                 // [2][W] their ts
  long long* s_caps = s_ts2 + 2 * W;                       // [ncap][T]
  long long* s_start = s_caps + (long long)pl.ncap * T;    // [T]
  long long* s_entry = s_start + T;                        // [T]
  long long* s_cts = s_entry + T;                          // [T] completion ts
  long long* s_ekey = s_cts + T;                           // [T] completions' order keys
  int* s_sel = (int*)(s_ekey + T);                         // [2][W] staged selection
  int* s_valid2 = s_sel + 2 * W;                           // [2][W]
  int* s_c02 = s_valid2 + 2 * W;                           // [2][W] atom 0's filter
  int* s_alive = s_c02 + 2 * W;                            // [T]
  int* s_pos = s_alive + T;                                // [T]
  int* s_avail = s_pos + T;                                // [T]
  int* s_cj = s_avail + T;                                 // [T] completion event, -1 none
  int* s_hard = s_cj + T;                                  // [T] 1: a warp finishes the row
  int* s_slot_of = s_hard + T;                             // [MAX_P]
  unsigned* s_ballot = (unsigned*)(s_slot_of + MAX_P);     // [NW] refill flags
  unsigned* s_ebal = s_ballot + NW;                        // [NW] emitting rows
  unsigned* s_vbal2 = s_ebal + NW;                         // [2][4] valid events
  __shared__ int s_first, s_cstar, s_seed_on, s_done;
  __shared__ long long s_nout, s_dropped;
  Chunk ck{s_ev2, s_ts2, s_valid2, s_vbal2, s_caps, W, T, false};

  // The stagers (the last 128 threads; rows use at most MAX_P + 128 < NT -
  // 128) turn chunk ch's staged bytes into its buffers: 64-bit events, ts,
  // valid flags and their ballot words, atom 0's filter (the seeds'); then
  // they start the copies of chunk ch + 1's events and chunk ch + 2's
  // selection.  The rows of chunk ch - 1 meanwhile run on the other buffer.
  const int k = t - (NT - 128);
  auto stage = [&](int ch) {
    const int b = ch & 1;
    bool valid = false;
    if (k < W) {
      __pipeline_wait_prior(0);
      const long long e = (long long)ch * W + k;
      const long long* raw = s_raw + (long long)b * NC * W;
      long long* ev = s_ev2 + (long long)b * NC * W;
      long long ts = 0;
      if (e < pl.E) {
        valid = s_sel[b * W + k] >= 0;
        const long long tr = s_tsraw[b * W + k];
        ts = pl.ts_wire ? pl.ts_base + low32(tr) : tr;
        for (int c = 0; c < NC; ++c) {
          const long long v = raw[(long long)c * W + k];
          ev[(long long)c * W + k] = pl.ev_ty[c] == T_I64 ? v : low32(v);
        }
      } else {
        for (int c = 0; c < NC; ++c) ev[(long long)c * W + k] = 0;  // zero padding
      }
      s_ts2[b * W + k] = ts;
      s_valid2[b * W + k] = valid;
      s_c02[b * W + k] = valid && pl.a0_here &&
                         eval_bytecode_in(
                             pl.code + pl.code_start[0], pl.code_len[0],
                             [&](int c) { return ev[(long long)c * W + k]; },
                             [&](int, int) { return 0LL; }, pl.in_sets);  // other atoms read zeros
      fetch_events(pl, s_raw + (long long)(b ^ 1) * NC * W, s_tsraw + (b ^ 1) * W, s_sel[(b ^ 1) * W + k],
                   ch + 1, k);
      fetch_sel(pl, s_sel + b * W + k, ch + 2, k);
      __pipeline_commit();
    }
    const unsigned vb = __ballot_sync(FULL, valid);
    if ((k & 31) == 0) s_vbal2[b * 4 + (k >> 5)] = vb;
  };

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
    s_first = W;
    s_cstar = W;
  }
  // chunk 0 staged and converted, chunk 1's selection on its way
  if (k >= 0) {
    if (k < W) {
      const int si = pl.sel_idx[k];
      s_sel[k] = si;
      fetch_events(pl, s_raw, s_tsraw, si, 0, k);
      fetch_sel(pl, s_sel + W + k, 1, k);
      __pipeline_commit();
    }
    stage(0);
  }
  __syncthreads();

  for (int ch = 0; ch < pl.C; ++ch) {
    const int p = ch & 1;
    ck.ev = s_ev2 + (long long)p * NC * W;
    ck.ts = s_ts2 + p * W;
    ck.valid = s_valid2 + p * W;
    ck.vbal = s_vbal2 + p * 4;
    const long long* s_ev = ck.ev;
    const long long* s_ts = ck.ts;

    // ---- phase B: the seeds (atom 0's filter, staged with the events) ----
    ck.done0 = s_done != 0;  // the chunk-start latch (the stages' gate)
    const int j = t - P;     // a seed row's event
    const bool c0 = t >= P && t < T && s_c02[p * W + j] && !ck.done0;
    if (!pl.every) {         // a non-every seed fires only as the chunk's first
      if (c0) atomicMin(&s_first, j);
      __syncthreads();
    }
    // the stagers meanwhile: the next chunk
    if (k >= 0 && ch + 1 < pl.C) stage(ch + 1);

    // ---- phase C: each row's stages, in its thread, then by warps --------
    int hard = 0;
    if (t < T) {
      Row r{false, false, 0, 0, -1, 0, 0, 0};
      if (t < P) {
        r.alive = s_alive[t] != 0;
        r.cpos = s_pos[t];
        r.start = s_start[t];
        r.entry = s_entry[t];
      } else {
        const bool fire = pl.every ? c0 : (c0 && j == s_first && s_seed_on);
        r.alive = fire;
        r.cpos = 1;
        r.avail = j + 1;
        r.start = r.entry = s_ts[j];
        for (int a = 0; a < S; ++a)
          for (int c = 0; c < pl.n_cols[a]; ++c)
            s_caps[(long long)(pl.cap_base[a] + c) * T + t] =
                pl.seed_ev[a] ? s_ev[(long long)c * W + j] : 0;
        if (S == 1 && fire) {  // a single-atom pattern completes at its seed
          r.comp = true;
          r.cj = j;
          r.cts = s_ts[j];
          r.alive = false;
        }
      }
      hard = row_thread(pl, ck, r, t, pl.is_seq ? W : BUDGET);
      s_alive[t] = r.alive;
      s_pos[t] = r.cpos;
      s_avail[t] = r.avail;
      s_start[t] = r.start;
      s_entry[t] = r.entry;
      s_cj[t] = r.comp ? r.cj : -1;
      s_cts[t] = r.cts;
      s_hard[t] = hard;
      if (r.comp && !pl.every) atomicMin(&s_cstar, r.cj);
    }
    if (__syncthreads_count(hard)) {
      for (int u = warp; u < T; u += NW) {
        if (!s_hard[u]) continue;
        Row r{s_alive[u] != 0, false, s_pos[u], s_avail[u], -1, s_start[u], s_entry[u], 0};
        row_warp(pl, ck, r, u);
        if (lane == 0) {
          s_alive[u] = r.alive;
          s_pos[u] = r.cpos;
          s_entry[u] = r.entry;
          s_cj[u] = r.comp ? r.cj : -1;
          s_cts[u] = r.cts;
          if (r.comp && !pl.every) atomicMin(&s_cstar, r.cj);
        }
        __syncwarp();
      }
      __syncthreads();
    }

    // ---- phase D: emission rows and the refill ranks ---------------------
    bool alive = false;
    int cpos = 0, cj = -1;
    long long start = 0, entry = 0;
    if (t < T) {
      alive = s_alive[t] != 0;
      cpos = s_pos[t];
      cj = s_cj[t];
      start = s_start[t];
      entry = s_entry[t];
    }
    // refill flags: a free slab slot, or a pending seed
    const bool flag = t < P ? !alive : (t < T && alive);
    // only the FIRST completion of a non-every pattern emits
    const bool emits = cj >= 0 && (pl.every || S == 1 || cj == s_cstar);
    const unsigned bal = __ballot_sync(FULL, flag);
    const unsigned ebal = __ballot_sync(FULL, emits);
    if (lane == 0) {
      s_ballot[warp] = bal;
      s_ebal[warp] = ebal;
    }
    __syncthreads();
    const int rw = (T + 31) >> 5;  // warps holding rows
    int before = 0;  // set flags before this thread
    for (int w = 0; w < warp && w < rw; ++w) before += __popc(s_ballot[w]);
    before += __popc(bal & ((1u << lane) - 1u));
    int nfree = 0, nflag = 0;
    for (int w = 0; w < rw; ++w) nflag += __popc(s_ballot[w]);
    // slab rows are 0..P-1: the free count is the prefix at row P
    {
      int pw = P >> 5, pl_ = P & 31;
      for (int w = 0; w < pw; ++w) nfree += __popc(s_ballot[w]);
      if (pl_) nfree += __popc(s_ballot[pw] & ((1u << pl_) - 1u));
    }
    const int npend = nflag - nfree;
    // completions in (event, row) order: each emitting row's key, packed
    // at its rank among the emitting rows, then counted below its own
    int ebefore = 0, nemit = 0;
    for (int w = 0; w < rw; ++w) {
      const int c = __popc(s_ebal[w]);
      if (w < warp) ebefore += c;
      nemit += c;
    }
    ebefore += __popc(ebal & ((1u << lane) - 1u));
    const long long key = (long long)cj * (T + 1) + t;
    if (emits) s_ekey[ebefore] = key;
    if (t < P && flag) s_slot_of[before] = t;  // free slot of free-rank `before`
    __syncthreads();
    if (emits) {
      int rank = 0;
      for (int i = 0; i < nemit; ++i) rank += s_ekey[i] < key;
      const long long row = s_nout + rank;
      pl.out_ts[row] = s_cts[t];
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
    const int ncomp = nemit;
    __syncthreads();   // the rows read their captures before the refill

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
      s_first = W;
      s_cstar = W;
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
  block_nfa_kernel<<<1, NT, plan->smem, (cudaStream_t)stream>>>(*plan);
  return (int)cudaGetLastError();
}
