// frequent: one step of the Misra-Gries frequent window (kernel K19), for
// sm_90a.
//
// Replaces the JAX package's FrequentWindow.process
// (siddhi_tpu/core/window_ext.py:1023: a lax.scan over the batch that
// writes a [B, n + 1] grid of rows, then a sort of the grid by seq), under
// frequent(n, ...) and lossyFrequent(support, ...).  kernels/frequent.py
// states the cases, the rows and their numbering.
//
// Design: the window is sequential by nature (each arrival's case depends
// on every earlier one), so one warp resolves the arrivals in batch order,
// but 32 at a time, and writes no row itself.  Three launches:
//
//  1. fq_walk, one block: warp 0 resolves, warps 1..NPROD are producers.
//     The producers convert the next tile of TILE arrivals' key words and
//     hash them into the other half of a double buffer in shared memory
//     while warp 0 resolves this tile (one block barrier a tile), so the
//     resolving warp reads no device memory.  The counters live in shared
//     memory when they fit (else in device memory, so every n the
//     reference accepts runs): counts, keys, an open-addressing hash of the
//     live keys (linear probing, at least 4n slots, a power of two; a slot
//     holds the key's hash beside its counter, so a probe step is one
//     load and a key is compared only where the hashes agree), each
//     counter's source (the arrival whose event it holds, or -1: the
//     state's stored event) and the free counters as a queue in counter
//     order.  A group of 32 arrivals: each lane probes the hash;
//     __match_any_sync on the key hashes (checked by a shuffle of the key
//     words, a vote on every word where two keys of one hash meet) groups
//     equal keys, and so the lanes on one counter: a later lane of a new
//     key hits the counter its first lane inserts; the first lanes of new
//     keys take the queue's head counters by rank (__popc of the ballot).
//     The first new key past the free counters is a full miss: the lanes
//     before it commit, the warp counts every counter down, appends those
//     reaching 0 (counter order) to the eviction list and to the emptied
//     free queue (a full miss happens only when no counter is free, so the
//     queue then holds exactly the freed counters, in order), rebuilds the
//     hash from the live counters in the same pass (their key hashes are
//     kept), and resumes at the next arrival.  Per arrival the walk writes
//     a record (its first row's offset, its counter or -1, the source of
//     its EXPIRED row).  A counter's count, source and the hash change in
//     one lane each: the last lane of a counter's match group writes count
//     and source, the inserting lane the key and its hash slot (atomicCAS,
//     lanes race for slots, from where the probe met a free one).
//  2. fq_rows, a grid over every SM: each arrival's EXPIRED row (from its
//     source: an arrival, or the stored event as it stood before the step)
//     and CURRENT row, and each eviction's EXPIRED row, at the walk's
//     offsets, a thread a record.
//  3. fq_store, a grid over the counters: each stored event that an
//     arrival replaced is written, after every row has read the old ones;
//     the seq counter advances.
// Rows go out in seq order, so nothing is sorted; the output is sized by
// the bound 3A + n (not the reference's A * (n + 1) grid).
//
// Bound: the arrivals are read once and each output row written once; the
// counters stay on chip.  What bounds it now is the walk's chain of
// dependent warp instructions, a group of 32 arrivals after another (a
// probe, the key vote, the other votes and the updates, 400-600 cycles
// each: about 2,200 cycles a group on an H100), plus n / 32 steps and a
// rebuild a full miss; a hit or an insert no longer scans the counters.
// The rows are written at the memory rate by every SM.
#include "rows.cuh"

using namespace siddhi;

namespace {

constexpr int MAX_COLS = 16;
constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE = 512;        // arrivals staged a tile
constexpr int NPROD = 4;         // producer warps of the walk
constexpr int EMPTY = -1;        // a free hash slot's counter
// a hash slot: the counter's key hash (high word) and index (low word)
constexpr unsigned long long EMPTY_SLOT = 0xffffffffULL;
enum : int { T_I32 = 0, T_I64 = 1, T_F32 = 2, T_F64 = 3, T_BOOL = 4 };

}  // namespace

// Mirrored field for field by kernels/frequent.py (ctypes.Structure).
struct FreqPlan {
  long long n, B, cap;   // B: the batch's capacity; cap: the output's rows
  int ncols, nkeys;
  int shared;            // 1: the counters in shared memory
  int hbits;             // the hash has 1 << hbits slots
  int smem, pad;         // smem: the walk's dynamic shared memory in bytes
  int col_bytes[MAX_COLS];
  int key_col[MAX_COLS];
  int key_ty[MAX_COLS];
  long long* counts;   // [n]
  long long* keys;     // [n, nkeys]
  long long* s_ts;     // the stored events
  int* s_gslot;
  void* s_col[MAX_COLS];
  long long* meta;     // [seq]
  const long long* a_ts;
  const int* a_gslot;
  const void* a_col[MAX_COLS];
  const long long* a_row;   // each arrival's input row
  const long long* n_arr;
  long long* out_ts;
  int* out_kind;
  long long* out_seq;
  int* out_gslot;
  void* out_col[MAX_COLS];
  long long* n_out;
  // scratch of the three launches
  unsigned long long* g_tab;   // [1 << hbits] the hash when the counters are in device memory
  int* g_src;    // [n] each counter's source after the walk
  int* g_free;   // [2n] the free queue and the counters' key hashes, likewise
  int* rec;      // [3, B] per arrival: first row's offset, counter (-1: a
                 // full miss), source (-2: an insert, -1: the state's event)
  int4* evl;     // [n + B] evictions: (counter, source, arrival, offset)
  int* n_ev;     // [1]
};

namespace {

__device__ __forceinline__ long long key_word(const FreqPlan& pl, int w, long long i) {
  const void* c = pl.a_col[pl.key_col[w]];
  switch (pl.key_ty[w]) {
    case T_I32: return ((const int*)c)[i];
    case T_I64:
    case T_F64: return ((const long long*)c)[i];
    case T_F32: return f32_key(((const unsigned*)c)[i]);
    default: return ((const unsigned char*)c)[i] != 0;
  }
}

// The hash of a key's words (kernels/frequent.py `key_hash` mirrors it).
__device__ __forceinline__ unsigned long long mix(unsigned long long h, long long w) {
  h = (h ^ (unsigned long long)w) * 0xff51afd7ed558ccdULL;
  return h ^ (h >> 33);
}
constexpr unsigned long long H0 = 0x9e3779b97f4a7c15ULL;
__device__ __forceinline__ unsigned fold(unsigned long long h) { return (unsigned)(h ^ (h >> 32)); }

// Counter j (key hash h) into the hash: the first free slot from slot s
// on (atomicCAS: lanes insert distinct keys at once).
__device__ __forceinline__ void hash_insert(unsigned long long* tab, unsigned hmask, unsigned s, unsigned h,
                                            int j) {
  const unsigned long long v = ((unsigned long long)h << 32) | (unsigned)j;
  while (atomicCAS(&tab[s], EMPTY_SLOT, v) != EMPTY_SLOT) s = (s + 1) & hmask;
}

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

// KC: the key's word count when fixed at compile time (the words then stay
// in registers), 0 for any count up to MAX_COLS.
template <int KC>
__global__ void __launch_bounds__(32 * (1 + NPROD)) fq_walk(const FreqPlan pl) {
  extern __shared__ long long smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = (int)pl.n, K = KC ? KC : pl.nkeys;
  const int H = 1 << pl.hbits;
  const unsigned hmask = (unsigned)H - 1u;
  // shared layout: 8-byte words first
  long long* skey = smem;                                  // [2][K][TILE]
  long long* cnt = pl.counts;
  long long* key = pl.keys;
  unsigned long long* tab = pl.g_tab;
  int* src = pl.g_src;
  int* fq = pl.g_free;
  unsigned* shash;                                         // [2][TILE]
  if (pl.shared) {
    cnt = skey + 2 * K * TILE;
    key = cnt + n;
    tab = (unsigned long long*)(key + (long long)n * K);
    shash = (unsigned*)(tab + H);
    src = (int*)(shash + 2 * TILE);
    fq = src + n;
    for (int j = tid; j < n; j += blockDim.x) cnt[j] = pl.counts[j];
    for (long long j = tid; j < (long long)n * K; j += blockDim.x) key[j] = pl.keys[j];
  } else {
    shash = (unsigned*)(skey + 2 * K * TILE);
  }
  unsigned* ctag = (unsigned*)(fq + n);                    // [n] each live counter's key hash
  for (int s = tid; s < H; s += blockDim.x) tab[s] = EMPTY_SLOT;
  for (int j = tid; j < n; j += blockDim.x) src[j] = -1;
  const long long na = pl.n_arr[0];
  const int ntiles = (int)((na + TILE - 1) / TILE);

  // a tile's key words and hashes into buffer b (producer threads)
  auto stage = [&](int t, int b) {
    for (int i = tid - 32; i < TILE; i += 32 * NPROD) {
      const long long q = (long long)t * TILE + i;
      if (q >= na) break;
      unsigned long long h = H0;
      for (int w = 0; w < K; ++w) {
        const long long v = key_word(pl, w, q);
        skey[((long long)b * K + w) * TILE + i] = v;
        h = mix(h, v);
      }
      shash[b * TILE + i] = fold(h);
    }
  };
  if (warp > 0 && ntiles > 0) stage(0, 0);
  __syncthreads();
  for (int j = tid; j < n; j += blockDim.x)
    if (cnt[j] > 0) {
      unsigned long long h = H0;
      for (int w = 0; w < K; ++w) h = mix(h, key[(long long)j * K + w]);
      ctag[j] = fold(h);
      hash_insert(tab, hmask, ctag[j] & hmask, ctag[j], j);
    }
  __syncthreads();

  // the resolving warp's running state (equal in every lane)
  int fhead = 0, ftail = 0, nev = 0;
  long long o = 0;
  if (warp == 0)
    for (int c0 = 0; c0 < n; c0 += 32) {   // the free queue, counter order
      const int j = c0 + lane;
      const bool f = j < n && cnt[j] == 0;
      const unsigned b = __ballot_sync(FULL, f);
      if (f) fq[ftail + __popc(b & lanes_below(lane))] = j;
      ftail += __popc(b);
    }
  int* rec_off = pl.rec;
  int* rec_j = pl.rec + pl.B;
  int* rec_src = pl.rec + 2 * pl.B;

  for (int t = 0; t < ntiles; ++t) {
    const int b = t & 1;
    if (warp > 0) {
      if (t + 1 < ntiles) stage(t + 1, b ^ 1);
    } else {
      const long long t0 = (long long)t * TILE;
      const long long tend = min(t0 + TILE, na);
      long long q0 = t0;
      while (q0 < tend) {
        const int g = (int)min((long long)32, tend - q0);
        const bool valid = lane < g;
        const unsigned vmask = g == 32 ? FULL : lanes_below(g);
        const int i = (int)(q0 - t0) + lane;
        long long kv[KC ? KC : MAX_COLS];
        unsigned h = 0, send = 0;   // send: where the probe met a free slot
        int j = -1;
        for (int w = 0; w < K; ++w) kv[w] = valid ? skey[((long long)b * K + w) * TILE + i] : 0;
        if (valid) {
          h = shash[b * TILE + i];
          for (unsigned s = h & hmask;; s = (s + 1) & hmask) {
            const unsigned long long e = tab[s];
            const int c = (int)(unsigned)e;
            if (c == EMPTY) { send = s; break; }
            if ((unsigned)(e >> 32) != h) continue;
            bool eq = true;
            for (int w = 0; w < K; ++w)
              if (key[(long long)c * K + w] != kv[w]) { eq = false; break; }
            if (eq) { j = c; break; }
          }
        }
        // the lanes carrying my key: those of my hash, unless two keys of
        // one hash meet in the group (then a vote on every key word)
        unsigned same = __match_any_sync(FULL, h) & vmask;
        bool eq = true;
        const int fh = valid ? __ffs(same) - 1 : lane;
        for (int w = 0; w < K; ++w) eq &= __shfl_sync(FULL, kv[w], fh) == kv[w];
        if (!__all_sync(FULL, eq)) {
          same = vmask;
          for (int w = 0; w < K; ++w) same &= __match_any_sync(FULL, kv[w]);
        }
        const int first = valid ? __ffs(same) - 1 : lane;
        const bool isnew = valid && j < 0;
        const bool leader = isnew && first == lane;
        const unsigned lead = __ballot_sync(FULL, leader);
        const int r = __popc(lead & lanes_below(lane));
        const int nfree = ftail - fhead;
        const unsigned over = __ballot_sync(FULL, leader && r >= nfree);
        const int m = over ? __ffs(over) - 1 : g;   // lanes below m commit
        if (leader && r < nfree) j = fq[fhead + r];
        const int jl = __shfl_sync(FULL, j, first);
        if (isnew) j = jl;
        const bool act = lane < m;
        const unsigned actm = m == 32 ? FULL : lanes_below(m);
        const unsigned insm = lead & actm;
        const bool ins = act && leader;
        // the committed lanes on my counter: those of my key
        const unsigned cm = same & actm;
        const unsigned below = cm & lanes_below(lane);
        if (act) {
          const long long q = q0 + lane;
          int source;
          if (ins) source = -2;
          else if (below) source = (int)(q0 + 31 - __clz(below));
          else source = src[j];
          rec_off[q] = (int)(o + 2 * __popc(actm & lanes_below(lane)) -
                             __popc(insm & lanes_below(lane)));
          rec_j[q] = j;
          rec_src[q] = source;
        }
        __syncwarp();
        if (act && (cm >> lane) == 1u) {      // the last lane on its counter
          const bool fresh = (insm >> (__ffs(cm) - 1)) & 1u;
          cnt[j] = (fresh ? 0 : cnt[j]) + __popc(cm);
          src[j] = (int)(q0 + lane);
        }
        if (ins) {
          for (int w = 0; w < K; ++w) key[(long long)j * K + w] = kv[w];
          ctag[j] = h;
          hash_insert(tab, hmask, send, h, j);
        }
        o += 2 * __popc(actm) - __popc(insm);
        fhead += __popc(insm);
        __syncwarp();
        if (m < g) {
          // a full miss: every count - 1, the counters reaching 0 evicted
          // in counter order and queued free; the hash rebuilt
          const long long qm = q0 + m;
          if (lane == 0) {
            rec_off[qm] = (int)o;
            rec_j[qm] = -1;
            rec_src[qm] = -1;
          }
          for (int sl = lane; sl < H; sl += 32) tab[sl] = EMPTY_SLOT;
          __syncwarp();
          int nf = 0;
          for (int c0 = 0; c0 < n; c0 += 32) {
            const int e = c0 + lane;
            long long c = 0;
            if (e < n) {
              c = cnt[e] - 1;
              cnt[e] = c;
            }
            const unsigned bv = __ballot_sync(FULL, e < n && c == 0);
            if (e < n && c == 0) {
              const int p = nf + __popc(bv & lanes_below(lane));
              pl.evl[nev + p] = make_int4(e, src[e], (int)qm, (int)(o + p));
              fq[p] = e;
            } else if (c > 0) {
              hash_insert(tab, hmask, ctag[e] & hmask, ctag[e], e);
            }
            nf += __popc(bv);
          }
          o += nf;
          nev += nf;
          fhead = 0;
          ftail = nf;
          __syncwarp();
          q0 += m + 1;
        } else {
          q0 += g;
        }
      }
    }
    __syncthreads();
  }
  if (pl.shared) {
    for (int j = tid; j < n; j += blockDim.x) {
      pl.counts[j] = cnt[j];
      pl.g_src[j] = src[j];
    }
    for (long long j = tid; j < (long long)n * K; j += blockDim.x) pl.keys[j] = key[j];
  }
  if (tid == 0) {
    *pl.n_out = o;
    *pl.n_ev = nev;
  }
}

// One EXPIRED row at o: the arrival q's ts and seq, the event of `source`
// (an arrival, or counter j's stored event when source < 0).
__device__ __forceinline__ void expired_row(const FreqPlan& pl, long long o, long long ts, long long seq,
                                            int source, int j) {
  if (o >= pl.cap) return;
  pl.out_ts[o] = ts;
  pl.out_kind[o] = K_EXPIRED;
  pl.out_seq[o] = seq;
  if (source >= 0) {
    pl.out_gslot[o] = pl.a_gslot[source];
    for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.out_col[c], o, pl.a_col[c], source, pl.col_bytes[c]);
  } else {
    pl.out_gslot[o] = pl.s_gslot[j];
    for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.out_col[c], o, pl.s_col[c], j, pl.col_bytes[c]);
  }
}

__global__ void __launch_bounds__(256) fq_rows(const FreqPlan pl) {
  const long long na = pl.n_arr[0], nev = pl.n_ev[0], n = pl.n;
  const long long seq0 = pl.meta[0];
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < na + nev;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < na) {
      const int j = pl.rec[pl.B + i];
      if (j < 0) continue;                        // a full miss: its evictions below
      long long o = pl.rec[i];
      const int source = pl.rec[2 * pl.B + i];
      const long long base = seq0 + pl.a_row[i] * (n + 1), ts = pl.a_ts[i];
      if (source != -2) expired_row(pl, o++, ts, base + j, source, j);
      if (o < pl.cap) {
        pl.out_ts[o] = ts;
        pl.out_kind[o] = K_CURRENT;
        pl.out_seq[o] = base + n;
        pl.out_gslot[o] = pl.a_gslot[i];
        for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.out_col[c], o, pl.a_col[c], i, pl.col_bytes[c]);
      }
    } else {
      const int4 e = pl.evl[i - na];
      expired_row(pl, e.w, pl.a_ts[e.z], seq0 + pl.a_row[e.z] * (n + 1) + e.x, e.y, e.x);
    }
  }
}

__global__ void __launch_bounds__(256) fq_store(const FreqPlan pl) {
  const long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (j == 0) pl.meta[0] += pl.B * (pl.n + 1);
  if (j >= pl.n) return;
  const int s = pl.g_src[j];
  if (s < 0) return;
  pl.s_ts[j] = pl.a_ts[s];
  pl.s_gslot[j] = pl.a_gslot[s];
  for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.s_col[c], j, pl.a_col[c], s, pl.col_bytes[c]);
}

}  // namespace

extern "C" int siddhi_freq_plan_size() { return (int)sizeof(FreqPlan); }

// Launches the walk, the rows and the store on `stream`; returns the first
// launch error (a cudaError_t, 0 = launched).
extern "C" int siddhi_frequent(const FreqPlan* plan, void* stream) {
  const FreqPlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  // above 48 KB the dynamic shared memory must be allowed first; raised
  // only when a launch needs more than before (so a graph capture of a
  // launch already made makes no such call)
  static int smem_allowed = 48 * 1024;
  auto walk = pl.nkeys == 1 ? fq_walk<1> : pl.nkeys == 2 ? fq_walk<2> : fq_walk<0>;
  if (pl.smem > smem_allowed) {
    for (auto f : {fq_walk<1>, fq_walk<2>, fq_walk<0>}) {
      cudaError_t e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
      if (e != cudaSuccess) return (int)e;
    }
    smem_allowed = pl.smem;
  }
  walk<<<1, 32 * (1 + NPROD), pl.smem, s>>>(pl);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long rows = 2 * pl.B + pl.n;         // arrivals + evictions, at most
  const int grid = (int)min((rows + 255) / 256, 132LL * 8);
  fq_rows<<<grid > 0 ? grid : 1, 256, 0, s>>>(pl);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fq_store<<<(int)((pl.n + 255) / 256) > 0 ? (int)((pl.n + 255) / 256) : 1, 256, 0, s>>>(pl);
  return (int)cudaGetLastError();
}
