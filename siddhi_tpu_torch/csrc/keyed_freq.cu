// keyed_freq: the keyed frequent kernel K24, for sm_90a: frequent(n, ...)
// and lossyFrequent(support, ...) kept once per partition key.
//
// Replaces, in the JAX package's keyed step kstep
// (siddhi_tpu/core/planner.py:539-584), the pre-window filters, the gather
// of each key's events, FrequentWindow.process / LossyFrequentWindow.process
// (siddhi_tpu/core/window_ext.py:1023, :1103) under vmap with B = E, the
// scatter back that drops padding keys and the rows flattened key-major.
// kernels/keyed_freq.py states the cases, the rows, their numbering and the
// slab.
//
// Design: a key's counters move arrival by arrival, so one warp walks one
// key row's arrivals in batch order, and the key rows run in parallel (a
// warp each, WARPS to a block, a grid-stride loop over the rows).  The
// count launch compacts the row's arrivals (its sel entries that are valid
// CURRENT rows and pass the filter bytecode, by ballot), then walks them on
// a working copy of the key's counters (count, key words and the source of
// each stored event: the slab or an arrival) in shared memory (a slice of a
// global workspace when n (2 + nk) words do not fit) and counts the rows; a
// device-wide scan gives each row's offset and the total, which the host
// reads to size the output.  The write launch walks again, writes each row
// at its place (the rows come out in seq order, so nothing is sorted) and
// then writes the counters and the stored events back.  Per arrival the
// warp scans the counters 32 at a time: a ballot of the lanes whose counter
// holds the key and of the free ones, __ffs for the lowest; a full miss
// decrements every counter and writes the evicted ones' rows at the running
// offset plus the __popc of the lower lanes' evictions (K19's walk).
//
// Bound: each arrival is read once, each stepped key's counters, keys and
// stored events once, each output row written once and the key's state
// written back once.  Bound by bytes; the walk is serial within a key
// (n / 32 ballots an arrival) and runs twice (count and write).
#include "bytecode.cuh"
#include "rows.cuh"

using namespace siddhi;

namespace {

constexpr int MAX_COLS = 16;
constexpr int MAX_CODE = 256;
constexpr int MAX_KEYS = 16;
constexpr int WARPS = 4;
constexpr unsigned FULL = 0xffffffffu;

}  // namespace

// Mirrored field for field by kernels/keyed_freq.py (ctypes.Structure).
struct KFreqPlan {
  long long Kb, E, K, n, cap, ws_words;
  int nk, ncols, code_len, ws_global;
  int key_col[MAX_KEYS];
  int col_ty[MAX_COLS];
  int col_w[MAX_COLS];
  int code[MAX_CODE];
  const long long* ts;
  const int* kind;
  const unsigned char* valid;
  const int* gslot;
  const void* col[MAX_COLS];
  const int* key_idx;
  const int* sel;
  long long* s_ts;          // the stored events [K, n]
  int* s_gslot;
  void* s_col[MAX_COLS];
  long long* counts;        // [K, n]
  long long* keys;          // [K, n, nk]
  long long* seq;           // [K]
  int* arr;                 // [Kb, E] each key row's arrivals (batch rows)
  int* apos;                // [Kb, E] their sel columns
  int* n_arr;               // [Kb]
  long long* ocnt;          // [Kb] rows, then offsets
  long long* sums;
  long long* ws;            // the global workspace (ws_global)
  long long* out_ts;
  int* out_kind;
  long long* out_seq;
  int* out_gslot;
  void* out_col[MAX_COLS];
  InSet in_sets[MAX_IN];
};

namespace {

// Key word w of batch row i.
__device__ __forceinline__ long long key_word(const KFreqPlan& pl, int w, long long i) {
  int q = pl.key_col[w];
  switch (pl.col_ty[q]) {
    case T_I64: return ((const long long*)pl.col[q])[i];
    case T_F32: return f32_key(((const unsigned*)pl.col[q])[i]);
    case T_BOOL: return ((const int*)pl.col[q])[i] != 0;
    default: return ((const int*)pl.col[q])[i];
  }
}

// Output row o: kind, ts, seq; the group slot and columns of the stored
// event (src < 0: the slab's row sj; else batch row src).
__device__ void emit(const KFreqPlan& pl, long long o, int kind, long long ts, long long seq,
                     long long src, long long sj) {
  if (o >= pl.cap) return;
  pl.out_ts[o] = ts;
  pl.out_kind[o] = kind;
  pl.out_seq[o] = seq;
  pl.out_gslot[o] = src < 0 ? pl.s_gslot[sj] : pl.gslot[src];
  for (int q = 0; q < pl.ncols; ++q)
    store_bits(pl.out_col[q], o, src < 0 ? load_raw(pl.s_col[q], sj, pl.col_w[q])
                                         : load_raw(pl.col[q], src, pl.col_w[q]), pl.col_w[q]);
}

template <bool W>
__global__ void __launch_bounds__(32 * WARPS) kf_walk(const KFreqPlan pl) {
  extern __shared__ long long smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n = pl.n;
  const int nk = pl.nk;
  long long* ws = (pl.ws_global ? pl.ws + (long long)blockIdx.x * WARPS * pl.ws_words : smem) +
                  w * pl.ws_words;
  long long* cnt = ws;          // [n] counts
  long long* src = ws + n;      // [n] stored event: -1 the slab's, else a batch row
  long long* key = ws + 2 * n;  // [n, nk]
  const long long stride = (long long)gridDim.x * WARPS;
  for (long long r = (long long)blockIdx.x * WARPS + w; r < pl.Kb; r += stride) {
    long long k = pl.key_idx[r];
    if (k < 0 || k >= pl.K) {
      if (!W && lane == 0) pl.ocnt[r] = pl.n_arr[r] = 0;
      continue;
    }
    int* arr = pl.arr + r * pl.E;
    int* apos = pl.apos + r * pl.E;
    long long na;
    if (!W) {
      // the key row's arrivals, compacted in batch order
      na = 0;
      for (long long e0 = 0; e0 < pl.E; e0 += 32) {
        long long e = e0 + lane;
        long long i = e < pl.E ? pl.sel[r * pl.E + e] : -1;
        bool keep = false;
        if (i >= 0) {
          keep = pl.valid[i] && pl.kind[i] == K_CURRENT;
          if (keep && pl.code_len > 0)
            keep = eval_bytecode_in(
                pl.code, pl.code_len, [&](int q) { return load_slot(pl.col[q], i, pl.col_ty[q]); },
                [&](int, int) { return 0LL; }, pl.in_sets);
        }
        unsigned b = __ballot_sync(FULL, keep);
        if (keep) {
          long long at = na + __popc(b & ((1u << lane) - 1u));
          arr[at] = (int)i;
          apos[at] = (int)e;
        }
        na += __popc(b);
      }
      if (lane == 0) pl.n_arr[r] = (int)na;
    } else {
      na = pl.n_arr[r];
    }
    const long long kb = k * n;
    for (long long j = lane; j < n; j += 32) {
      cnt[j] = pl.counts[kb + j];
      src[j] = -1;
    }
    for (long long j = lane; j < n * nk; j += 32) key[j] = pl.keys[kb * nk + j];
    __syncwarp();
    const long long seq0 = pl.seq[k];
    long long o = W ? pl.ocnt[r] : 0;
    long long kv[MAX_KEYS];
    for (long long q = 0; q < na; ++q) {
      const long long i = arr[q];
      for (int x = 0; x < nk; ++x) kv[x] = key_word(pl, x, i);
      const long long base = seq0 + (long long)apos[q] * (n + 1), ts = pl.ts[i];
      long long midx = -1, fidx = -1;
      for (long long c0 = 0; c0 < n; c0 += 32) {
        const long long j = c0 + lane;
        bool hit = false, fr = false;
        if (j < n) {
          const long long cj = cnt[j];
          fr = cj == 0;
          if (cj > 0) {
            hit = true;
            for (int x = 0; x < nk; ++x)
              if (key[j * nk + x] != kv[x]) { hit = false; break; }
          }
        }
        const unsigned bh = __ballot_sync(FULL, hit);
        if (bh) { midx = c0 + __ffs(bh) - 1; break; }
        const unsigned bf = __ballot_sync(FULL, fr);
        if (fidx < 0 && bf) fidx = c0 + __ffs(bf) - 1;
      }
      if (midx >= 0 || fidx >= 0) {
        const long long j = midx >= 0 ? midx : fidx;
        if (midx >= 0) {
          // a hit: the stored event leaves, the arrival replaces it
          if (W && lane == 0) emit(pl, o, K_EXPIRED, ts, base + j, src[j], kb + j);
          ++o;
        }
        __syncwarp();
        if (lane == 0) {
          cnt[j] = midx >= 0 ? cnt[j] + 1 : 1;
          if (midx < 0)
            for (int x = 0; x < nk; ++x) key[j * nk + x] = kv[x];
          src[j] = i;
          if (W) emit(pl, o, K_CURRENT, ts, base + n, i, 0);
        }
        ++o;
      } else {
        // a full miss: every count - 1, the counters reaching 0 evicted in
        // counter order
        for (long long c0 = 0; c0 < n; c0 += 32) {
          const long long j = c0 + lane;
          bool ev = false;
          if (j < n) {
            const long long cj = cnt[j] - 1;
            cnt[j] = cj;
            ev = cj == 0;
          }
          const unsigned b = __ballot_sync(FULL, ev);
          if (W && ev)
            emit(pl, o + __popc(b & ((1u << lane) - 1u)), K_EXPIRED, ts, base + j, src[j], kb + j);
          o += __popc(b);
        }
      }
      __syncwarp();
    }
    if (!W) {
      if (lane == 0) pl.ocnt[r] = o;
    } else {
      // the counters and the stored events written back
      for (long long j = lane; j < n; j += 32) {
        pl.counts[kb + j] = cnt[j];
        long long s = src[j];
        if (s >= 0) {
          pl.s_ts[kb + j] = pl.ts[s];
          pl.s_gslot[kb + j] = pl.gslot[s];
          for (int q = 0; q < pl.ncols; ++q)
            store_bits(pl.s_col[q], kb + j, load_raw(pl.col[q], s, pl.col_w[q]), pl.col_w[q]);
        }
      }
      for (long long j = lane; j < n * nk; j += 32) pl.keys[kb * nk + j] = key[j];
      if (lane == 0) pl.seq[k] = seq0 + pl.E * (n + 1);
    }
    __syncwarp();
  }
}

inline unsigned grid(const KFreqPlan& pl) {
  long long g = (pl.Kb + WARPS - 1) / WARPS;
  long long cap = pl.ws_global ? 1024 : (1LL << 20);
  if (g > cap) g = cap;
  return (unsigned)(g > 0 ? g : 1);
}

inline size_t smem_bytes(const KFreqPlan& pl) {
  return pl.ws_global ? 0 : (size_t)WARPS * pl.ws_words * sizeof(long long);
}

int count_launch(const KFreqPlan* plan, void* stream) {
  const KFreqPlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  size_t b = smem_bytes(pl);
  if (b > 48 * 1024) {
    int e = (int)cudaFuncSetAttribute(kf_walk<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b);
    if (!e) e = (int)cudaFuncSetAttribute(kf_walk<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b);
    if (e) return e;
  }
  kf_walk<false><<<grid(pl), 32 * WARPS, b, s>>>(pl);
  if (pl.Kb > 0) exclusive_scan(pl.ocnt, pl.Kb, pl.sums, s);
  return (int)cudaGetLastError();
}

int write_launch(const KFreqPlan* plan, void* stream) {
  const KFreqPlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  kf_walk<true><<<grid(pl), 32 * WARPS, smem_bytes(pl), s>>>(pl);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int siddhi_keyed_freq_plan_size() { return (int)sizeof(KFreqPlan); }

// The count launch (the walk on a copy of the counters, and the scan of the
// row counts; the total lands in sums[last]) and the write launch, on
// `stream`; each returns the launches' cudaError_t (0 = launched).
extern "C" int siddhi_keyed_freq_count(const KFreqPlan* p, void* s) { return count_launch(p, s); }
extern "C" int siddhi_keyed_freq_write(const KFreqPlan* p, void* s) { return write_launch(p, s); }
