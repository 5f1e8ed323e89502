// order_limit: a selector's `order by` / `limit` / `offset` (kernel K13),
// for sm_90a.
//
// Replaces the JAX package's SelectorExec._order_limit
// (siddhi_tpu/core/selector.py:545): stable argsorts of the step's output
// rows by each order-by key, the last key first (DESC by negation in the
// key's own type, or logical not for a bool; invalid rows last), then a
// rank of the valid rows that keeps [offset, offset + limit).  That chain of
// stable sorts is the lexicographic order of (key 1 bits, ..., key k bits,
// row index) over the valid rows, each key as order-preserving unsigned
// bits: the sign bit flipped for an int (a DESC int null wraps to itself,
// so null ints sort first under DESC, as in the reference); for a float,
// -0.0 and +0.0 one value, every NaN one value above +inf, and the IEEE
// flip; a bool 0 or 1.  Consecutive keys share a 64-bit word while their
// widths (64, 32, 32, 1) fit; the first key is the most significant.
//
// Two modes, chosen on the host (kernels/order_limit.py `mode`):
//   * top-k, when a limit is given and m = offset + limit <= TOPK_MAX (256):
//     no compaction and no radix pass.  Each block of ol_topk streams its
//     share of the rows, TK_THREADS a round, and keeps the K least
//     (word 0, row index) pairs, K the power of two >= m: a row that orders
//     before the block's threshold (the K-th least kept so far) joins a
//     shared buffer by ballot, and a buffer that cannot take another round
//     (and the first full round's) is shrunk to its K least by a bitonic
//     network (runs of K sorted alternately ascending and descending, then
//     halvings: the elementwise least of two neighbouring runs is a
//     bitonic run of their K least, which a bitonic merge sorts).  After
//     the first round most rows fail the threshold with one comparison.  A
//     tie on word 0 reads the later words from the key columns; an
//     invalid row never joins.  A second launch (a third where the blocks'
//     candidates pass 4 TK_T) reduces the blocks' K candidates the same
//     way, takes ranks [offset, m) and gathers those rows' ts, kind and
//     columns to the output's front, the rest invalid and zero.  It moves
//     each row's valid flag and key columns once and the kept rows once.
//   * sort, otherwise: the valid rows compacted in order (flags, a scan of
//     block sums, a scatter), then a stable LSD radix sort over 8-bit
//     digits, the last word first.  A word of 32 bits or fewer sorts as a
//     32-bit key.  One launch counts every digit position of every word in
//     one read of the rows (ol_hist); ol_pinfo scans those counts into each
//     digit's base and marks a pass whose keys all share one digit, which
//     then does not run.  Each remaining pass is one launch (ol_pass): a
//     tile of PTILE keys counts its digits, publishes them and looks back
//     over the earlier tiles' published counts for its offsets (a decoupled
//     look-back), then ranks its keys stably into shared memory by digit
//     and writes each digit's run out contiguously.  A word's first pass reads its keys
//     from the rows; each later pass re-reads and re-writes (key, index)
//     pairs, 8 bytes a row for a 32-bit word and 12 for a 64-bit one, which
//     is this mode's cost above the bound.
//
// Bound: each row's valid flag and each valid row's keys are read once and
// each kept row written once.  Bound by bytes.
#include "rows.cuh"

using namespace siddhi;

namespace {

constexpr int MAX_COLS = 16;
constexpr int MAX_KEYS = 16;
constexpr int MAX_PASSES = 8 * MAX_KEYS;
constexpr int BLOCK = 256;
constexpr int RADIX = 256;
// top-k mode
constexpr int TK_T = 4096;                 // items a block holds in shared memory
constexpr int TK_THREADS = 512;
constexpr int TK_SMEM = TK_T * (8 + 4);
constexpr int SENT = -1;                   // the index of an empty item
// sort mode
constexpr int PB = 256;                    // threads a pass block (one a digit)
constexpr int PROUNDS = 8;
constexpr int PTILE = PB * PROUNDS;        // keys a pass tile
constexpr int PW = PB / 32;
constexpr unsigned long long FLAG_A = 1ULL << 62;   // a tile's own digit counts
constexpr unsigned long long FLAG_P = 2ULL << 62;   // its counts and all before it
constexpr unsigned long long VMASK = FLAG_A - 1;
constexpr int LOOK = 8;                    // look-back words read at once

}  // namespace

// Mirrored field for field by kernels/order_limit.py (ctypes.Structure).
struct OrderPlan {
  long long N, cap, lo, limit;   // limit < 0: none
  long long nb, ptiles;          // sort: the compaction's blocks, the pass tiles
  int ncols, nkeys, nwords, npass;
  int topk_k, topk_grid1, topk_grid2;   // topk_k: K (0: sort mode)
  int col_bytes[MAX_COLS];
  int key_ty[MAX_KEYS];          // 0 int32, 1 int64, 2 float32, 3 bool
  int key_desc[MAX_KEYS];
  int key_word[MAX_KEYS];        // the word a key is in, and its shift there
  int key_shift[MAX_KEYS];
  int word_pass0[MAX_KEYS];      // sort: each word's first pass and passes
  int word_np[MAX_KEYS];
  int pass_word[MAX_PASSES];     // each pass's word, digit shift and key
  int pass_shift[MAX_PASSES];    // width (1: above 32 bits), in the order
  int pass_wide[MAX_PASSES];     // they run
  const void* key_col[MAX_KEYS];
  const long long* ts;
  const int* kind;
  const unsigned char* valid;
  const void* col[MAX_COLS];
  unsigned long long* cand_key[2];   // top-k: the blocks' candidates
  int* cand_idx[2];
  unsigned char* flags;          // sort mode from here
  long long* block_sums;         // [nb + 1]; the valid count at the end
  int* idx[2];
  void* key[2];
  unsigned long long* ghist;     // [npass, RADIX] digit counts, then bases
  unsigned long long* status;    // [npass, ptiles, RADIX] look-back words
  int* tile_ctr;                 // [npass]
  long long zero_bytes;          // ghist, status and tile_ctr: one zeroed span
  int* pinfo;                    // [npass] {skip, src, gather, store}, then the final buffer
  long long* out_ts;
  int* out_kind;
  unsigned char* out_valid;
  void* out_col[MAX_COLS];
};

namespace {

// Key q of row r as order-preserving unsigned bits.
__device__ __forceinline__ unsigned long long key_bits(const OrderPlan& pl, int q, long long r) {
  const void* col = pl.key_col[q];
  const int desc = pl.key_desc[q];
  const int ty = pl.key_ty[q];
  if (ty == 1) {
    long long v = ((const long long*)col)[r];
    if (desc) v = (long long)(0ULL - (unsigned long long)v);
    return (unsigned long long)v ^ 0x8000000000000000ULL;
  }
  if (ty == 2) {
    float f = ((const float*)col)[r];
    if (desc) f = -f;
    unsigned b = f != f ? 0x7fc00000u : (f == 0.0f ? 0u : __float_as_uint(f));
    return (b & 0x80000000u) ? (unsigned long long)(~b) : (unsigned long long)(b | 0x80000000u);
  }
  if (ty == 3) {
    unsigned v = ((const unsigned char*)col)[r] != 0;
    return desc ? !v : v;
  }
  int v = ((const int*)col)[r];
  if (desc) v = (int)(0u - (unsigned)v);
  return (unsigned long long)((unsigned)v ^ 0x80000000u);
}

// Word w of row r: its keys' bits side by side.
__device__ __forceinline__ unsigned long long word_of(const OrderPlan& pl, int w, long long r) {
  unsigned long long x = 0;
  for (int q = 0; q < pl.nkeys; ++q)
    if (pl.key_word[q] == w) x |= key_bits(pl, q, r) << pl.key_shift[q];
  return x;
}

__global__ void ol_flags(const OrderPlan pl) {
  __shared__ long long sh[2 * BLOCK];
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  int f = i < pl.N && pl.valid[i];
  if (i < pl.N) pl.flags[i] = (unsigned char)f;
  long long tot;
  block_excl_scan<BLOCK>((long long)f, sh, &tot);
  if (threadIdx.x == 0) pl.block_sums[blockIdx.x] = tot;
}

__global__ void ol_compact(const OrderPlan pl) {
  __shared__ long long sh[2 * BLOCK];
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  int f = i < pl.N ? pl.flags[i] : 0;
  long long tot;
  long long r = block_excl_scan<BLOCK>((long long)f, sh, &tot) + pl.block_sums[blockIdx.x];
  if (f) pl.idx[0][r] = (int)i;
}

// The kept rows [lo, lo + limit) of the order to the output's front; the
// rest of the output invalid.
__global__ void ol_emit(const OrderPlan pl) {
  long long p = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (p >= pl.cap) return;
  const int cur = pl.npass > 0 ? pl.pinfo[4 * pl.npass] : 0;
  const long long n = pl.block_sums[pl.nb];
  long long kept = n - pl.lo;
  if (kept < 0) kept = 0;
  if (pl.limit >= 0 && kept > pl.limit) kept = pl.limit;
  if (p >= kept) {
    pl.out_ts[p] = 0;
    pl.out_kind[p] = 0;
    pl.out_valid[p] = 0;
    for (int c = 0; c < pl.ncols; ++c) store_bits(pl.out_col[c], p, 0, pl.col_bytes[c]);
    return;
  }
  long long r = pl.idx[cur][pl.lo + p];
  pl.out_ts[p] = pl.ts[r];
  pl.out_kind[p] = pl.kind[r];
  pl.out_valid[p] = 1;
  for (int c = 0; c < pl.ncols; ++c) copy_elem(pl.out_col[c], p, pl.col[c], r, pl.col_bytes[c]);
}

// ---- top-k mode -------------------------------------------------------------

// (ka, ia) before (kb, ib): word 0, then the later words, then the index;
// an empty item after every row.
__device__ __forceinline__ bool tk_less(const OrderPlan& pl, unsigned long long ka, int ia,
                                        unsigned long long kb, int ib) {
  if (ka != kb) return ka < kb;
  if (ia == SENT || ib == SENT) return ib == SENT && ia != SENT;
  for (int w = 1; w < pl.nwords; ++w) {
    const unsigned long long a = word_of(pl, w, ia), b = word_of(pl, w, ib);
    if (a != b) return a < b;
  }
  return ia < ib;
}

__device__ __forceinline__ void tk_cmpswap(const OrderPlan& pl, unsigned long long* key, int* idx,
                                           int a, int b, bool up) {
  const bool swap = up ? tk_less(pl, key[b], idx[b], key[a], idx[a])
                       : tk_less(pl, key[a], idx[a], key[b], idx[b]);
  if (swap) {
    const unsigned long long k = key[a];
    key[a] = key[b];
    key[b] = k;
    const int i = idx[a];
    idx[a] = idx[b];
    idx[b] = i;
  }
}

// The K least of key / idx[0, np) to [0, K), ascending (K and np powers
// of two, 2 K <= np <= TK_T).
__device__ void tk_reduce(const OrderPlan& pl, unsigned long long* key, int* idx, int K, int np) {
  const int t = threadIdx.x;
  // runs of K sorted, alternately ascending and descending
  for (int k = 2; k <= K; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = t; i < np / 2; i += TK_THREADS) {
        const int a = 2 * i - (i & (j - 1));
        tk_cmpswap(pl, key, idx, a, a + j, (a & k) == 0);
      }
      __syncthreads();
    }
  constexpr int PER = TK_T / 2 / TK_THREADS;
  for (int n = np; n > K; n >>= 1) {
    // the least of runs 2r and 2r + 1, element by element, to run r
    unsigned long long kk[PER];
    int ii[PER];
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int m = t + p * TK_THREADS;
      if (m < n / 2) {
        const int a = m + (m & ~(K - 1)), b = a + K;
        const bool lb = tk_less(pl, key[b], idx[b], key[a], idx[a]);
        kk[p] = lb ? key[b] : key[a];
        ii[p] = lb ? idx[b] : idx[a];
      }
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int m = t + p * TK_THREADS;
      if (m < n / 2) {
        key[m] = kk[p];
        idx[m] = ii[p];
      }
    }
    __syncthreads();
    // each bitonic run merged, alternately ascending and descending (the
    // last one ascending)
    for (int j = K >> 1; j > 0; j >>= 1) {
      for (int i = t; i < n / 4; i += TK_THREADS) {
        const int a = 2 * i - (i & (j - 1));
        tk_cmpswap(pl, key, idx, a, a + j, (a & K) == 0);
      }
      __syncthreads();
    }
  }
}

// The buffer's n items reduced to its K least (sorted, at [0, K)); the
// threshold becomes the K-th of them (still empty while fewer than K rows
// were seen).
__device__ void tk_shrink(const OrderPlan& pl, unsigned long long* key, int* idx, int n, int K,
                          int* s_n, unsigned long long* s_tk, int* s_ti) {
  int np = 2 * K;
  while (np < n) np <<= 1;
  for (int q = n + threadIdx.x; q < np; q += TK_THREADS) {
    key[q] = ~0ULL;
    idx[q] = SENT;
  }
  __syncthreads();
  tk_reduce(pl, key, idx, K, np);
  if (threadIdx.x == 0) {
    *s_n = K;
    *s_tk = key[K - 1];
    *s_ti = idx[K - 1];
  }
  __syncthreads();
}

// Each block streams its share of n_in items (the rows, or the candidates
// of the level before), TK_THREADS a round: an item that orders before
// the block's threshold (the K-th least it has kept) joins the buffer by
// ballot; a buffer that cannot take another round is shrunk to its K
// least, and so is the first full round's (the threshold then exists).
// Writes the block's K least to out_key / out_idx; with `emit` (one
// block) the output instead.
template <bool ROWS>
__global__ void __launch_bounds__(TK_THREADS) ol_topk(const OrderPlan pl, const unsigned long long* in_key,
                                                      const int* in_idx, long long n_in,
                                                      unsigned long long* out_key, int* out_idx,
                                                      int emit) {
  extern __shared__ unsigned long long tk_key[];
  int* tk_idx = (int*)(tk_key + TK_T);
  __shared__ int s_n, s_ti;
  __shared__ unsigned long long s_tk;
  const int K = pl.topk_k, t = threadIdx.x, lane = t & 31;
  const long long per = (n_in + gridDim.x - 1) / gridDim.x;
  const long long r0 = (long long)blockIdx.x * per;
  const long long r1 = r0 + per < n_in ? r0 + per : n_in;
  if (t == 0) {
    s_n = 0;
    s_tk = ~0ULL;
    s_ti = SENT;
  }
  __syncthreads();
  for (long long c = r0; c < r1; c += TK_THREADS) {
    const long long r = c + t;
    unsigned long long kv = ~0ULL;
    int iv = SENT;
    if (r < r1) {
      if (ROWS) {
        if (pl.valid[r]) {
          kv = pl.nwords > 0 ? word_of(pl, 0, r) : 0;
          iv = (int)r;
        }
      } else {
        kv = in_key[r];
        iv = in_idx[r];
      }
    }
    const bool in = iv != SENT && tk_less(pl, kv, iv, s_tk, s_ti);
    const unsigned b = __ballot_sync(0xffffffffu, in);
    int base = 0;
    if (lane == 0 && b) base = atomicAdd(&s_n, __popc(b));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (in) {
      const int q = base + __popc(b & ((1u << lane) - 1u));
      tk_key[q] = kv;
      tk_idx[q] = iv;
    }
    __syncthreads();
    const int n = s_n;
    const bool shrink = n > TK_T - TK_THREADS || (s_ti == SENT && n >= TK_THREADS);
    __syncthreads();   // every thread has read the counters before they move
    if (shrink) tk_shrink(pl, tk_key, tk_idx, n, K, &s_n, &s_tk, &s_ti);
  }
  tk_shrink(pl, tk_key, tk_idx, s_n, K, &s_n, &s_tk, &s_ti);
  if (!emit) {
    for (int q = t; q < K; q += TK_THREADS) {
      out_key[(long long)blockIdx.x * K + q] = tk_key[q];
      out_idx[(long long)blockIdx.x * K + q] = tk_idx[q];
    }
    return;
  }
  for (long long p = t; p < pl.cap; p += TK_THREADS) {
    const int r = tk_idx[pl.lo + p];
    if (r == SENT) {
      pl.out_ts[p] = 0;
      pl.out_kind[p] = 0;
      pl.out_valid[p] = 0;
      for (int q = 0; q < pl.ncols; ++q) store_bits(pl.out_col[q], p, 0, pl.col_bytes[q]);
    } else {
      pl.out_ts[p] = pl.ts[r];
      pl.out_kind[p] = pl.kind[r];
      pl.out_valid[p] = 1;
      for (int q = 0; q < pl.ncols; ++q) copy_elem(pl.out_col[q], p, pl.col[q], r, pl.col_bytes[q]);
    }
  }
}

// ---- sort mode --------------------------------------------------------------

// Every digit position of word blockIdx.y, counted over the valid rows in
// one read (the counts do not depend on the order).
__global__ void ol_hist(const OrderPlan pl) {
  __shared__ unsigned h[8][RADIX];
  const int w = blockIdx.y, t = threadIdx.x;
  const int p0 = pl.word_pass0[w], np = pl.word_np[w];
  for (int q = 0; q < np; ++q) h[q][t] = 0;
  __syncthreads();
  for (long long r = (long long)blockIdx.x * BLOCK + t; r < pl.N; r += (long long)gridDim.x * BLOCK) {
    if (!pl.valid[r]) continue;
    const unsigned long long x = word_of(pl, w, r);
    for (int q = 0; q < np; ++q) atomicAdd(&h[q][(x >> pl.pass_shift[p0 + q]) & 0xff], 1u);
  }
  __syncthreads();
  for (int q = 0; q < np; ++q)
    if (h[q][t]) atomicAdd(pl.ghist + (long long)(p0 + q) * RADIX + t, (unsigned long long)h[q][t]);
}

// One block: each pass's digit counts scanned into digit bases (in place)
// and its flags: skip (one digit holds every key), the buffer it reads,
// gather (its word's first pass to run: keys from the rows), store (a
// later pass of its word runs: keys written); then the final buffer.
__global__ void ol_pinfo(const OrderPlan pl) {
  __shared__ long long sh[2 * RADIX];
  const int t = threadIdx.x;
  const long long n = pl.block_sums[pl.nb];
  int buf = 0, word = -1;
  for (int p = 0; p < pl.npass; ++p) {
    unsigned long long* g = pl.ghist + (long long)p * RADIX;
    const long long c = (long long)g[t];
    const bool skip = __syncthreads_or(c == n);   // n == 0: every count is n
    long long tot;
    g[t] = (unsigned long long)block_excl_scan<RADIX>(c, sh, &tot);
    if (t == 0) {
      int* f = pl.pinfo + 4 * p;
      f[0] = skip;
      f[1] = buf;
      f[2] = !skip && pl.pass_word[p] != word;
      f[3] = 0;
      if (!skip) {
        word = pl.pass_word[p];
        buf ^= 1;
      }
    }
  }
  if (t == 0) {
    pl.pinfo[4 * pl.npass] = buf;
    int later = -1;   // the word of the next pass that runs
    for (int p = pl.npass - 1; p >= 0; --p) {
      int* f = pl.pinfo + 4 * p;
      if (f[0]) continue;
      f[3] = later == pl.pass_word[p];
      later = pl.pass_word[p];
    }
  }
}

// One LSD pass: a tile's digits counted, published and looked back on for
// its offsets; each key ranked stably in the tile (each warp with
// __match_any_sync, the tile's warps and rounds in order) into a shared
// staging array ordered by digit, then written out so that neighbouring
// threads store neighbouring places of a digit's run.
template <typename KT>
__global__ void __launch_bounds__(PB) ol_pass(const OrderPlan pl, int p) {
  __shared__ int wc[PW][RADIX];
  __shared__ int run[RADIX];
  __shared__ int lstart[RADIX];            // the tile's first place of each digit
  __shared__ long long off[RADIX];
  __shared__ long long scan_sh[2 * PB];
  __shared__ KT skey[PTILE];
  __shared__ int sidx[PTILE];
  __shared__ long long s_tile;
  const int* info = pl.pinfo + 4 * p;
  if (info[0]) return;
  const int src = info[1], gather = info[2], store = info[3];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  if (t == 0) s_tile = atomicAdd(pl.tile_ctr + p, 1);
  run[t] = 0;
  __syncthreads();
  const long long n = pl.block_sums[pl.nb];
  const long long tile = s_tile, base = tile * PTILE;
  if (base >= n) return;   // no later tile has keys: none looks back here
  const int shift = pl.pass_shift[p], w = pl.pass_word[p];
  const KT* kin = (const KT*)pl.key[src];
  const int* iin = pl.idx[src];
  KT* kout = (KT*)pl.key[1 - src];
  int* iout = pl.idx[1 - src];
  KT kv[PROUNDS];
  int iv[PROUNDS], dg[PROUNDS];
#pragma unroll
  for (int q = 0; q < PROUNDS; ++q) {
    const long long j = base + q * PB + t;
    dg[q] = RADIX;
    if (j < n) {
      iv[q] = iin[j];
      kv[q] = gather ? (KT)word_of(pl, w, iv[q]) : kin[j];
      dg[q] = (int)((kv[q] >> shift) & 0xff);
      atomicAdd(&run[dg[q]], 1);
    }
  }
  __syncthreads();
  const unsigned long long agg = (unsigned long long)run[t];
  long long tot;
  lstart[t] = (int)block_excl_scan<PB>((long long)agg, scan_sh, &tot);
  // digit t: publish the tile's count, add the earlier tiles' (decoupled
  // look-back: an inclusive prefix ends the walk), publish the prefix
  unsigned long long* st = pl.status + (long long)p * pl.ptiles * RADIX + t;
  volatile unsigned long long* mine = st + tile * RADIX;
  unsigned long long excl = 0;
  if (tile == 0) {
    *mine = FLAG_P | agg;
  } else {
    *mine = FLAG_A | agg;
    // LOOK words a step, nearest first, up to an unpublished one (read
    // again) or an inclusive prefix (the end)
    for (long long q = tile - 1;;) {
      unsigned long long v[LOOK];
#pragma unroll
      for (int u = 0; u < LOOK; ++u)
        v[u] = q - u >= 0 ? *(volatile unsigned long long*)(st + (q - u) * RADIX)
                          : (unsigned long long)FLAG_P;   // before tile 0: the end
      int u = 0;
      bool done = false;
#pragma unroll
      for (int x = 0; x < LOOK; ++x) {
        if (done || u < x || !(v[x] & ~VMASK)) continue;
        excl += v[x] & VMASK;
        done = (v[x] & FLAG_P) != 0;
        u = x + 1;
      }
      if (done) break;
      q -= u;
    }
    *mine = FLAG_P | (excl + agg);
  }
  off[t] = (long long)(pl.ghist[(long long)p * RADIX + t] + excl);
  run[t] = 0;
  __syncthreads();
  for (int q = 0; q < PROUNDS; ++q) {
    for (int x = 0; x < PW; ++x) wc[x][t] = 0;
    __syncthreads();
    const int d = dg[q];
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (d < RADIX && rank == 0) wc[warp][d] = __popc(peers);
    __syncthreads();
    // per digit t: the warps' exclusive offsets, after the earlier rounds
    int acc = run[t];
    for (int x = 0; x < PW; ++x) {
      const int c = wc[x][t];
      wc[x][t] = acc;
      acc += c;
    }
    run[t] = acc;
    __syncthreads();
    if (d < RADIX) {
      const int at = lstart[d] + wc[warp][d] + rank;
      skey[at] = kv[q];
      sidx[at] = iv[q];
    }
    __syncthreads();
  }
  const int tn = n - base < PTILE ? (int)(n - base) : PTILE;
  for (int at = t; at < tn; at += PB) {
    const KT x = skey[at];
    const int d = (int)((x >> shift) & 0xff);
    const long long dst = off[d] + at - lstart[d];
    if (store) kout[dst] = x;
    iout[dst] = sidx[at];
  }
}

}  // namespace

extern "C" int siddhi_order_plan_size() { return (int)sizeof(OrderPlan); }

// Launches on `stream`.  Top-k mode (topk_k > 0): ol_topk over the rows,
// then over the candidates (one or two levels, the last writing the
// output).  Sort mode: the compaction; with keys, the digit counts, the
// pass flags and one launch a pass; then the output.  Returns the
// launches' cudaError_t (0 = launched).
extern "C" int siddhi_order_limit(const OrderPlan* plan, void* stream) {
  const OrderPlan& pl = *plan;
  if (pl.N <= 0 || pl.cap <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (pl.topk_k > 0) {
    const unsigned g1 = (unsigned)pl.topk_grid1, g2 = (unsigned)pl.topk_grid2;
    const long long K = pl.topk_k;
    // the buffer and the block's counters pass the 48 KB a block takes
    // without asking
    int e = (int)cudaFuncSetAttribute(ol_topk<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      TK_SMEM);
    if (!e)
      e = (int)cudaFuncSetAttribute(ol_topk<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    TK_SMEM);
    if (e) return e;
    ol_topk<true><<<g1, TK_THREADS, TK_SMEM, s>>>(pl, nullptr, nullptr, pl.N, pl.cand_key[0],
                                                  pl.cand_idx[0], g1 == 1);
    if (g1 > 1) {
      ol_topk<false><<<g2, TK_THREADS, TK_SMEM, s>>>(pl, pl.cand_key[0], pl.cand_idx[0], g1 * K,
                                                     pl.cand_key[1], pl.cand_idx[1], g2 == 1);
      if (g2 > 1)
        ol_topk<false><<<1, TK_THREADS, TK_SMEM, s>>>(pl, pl.cand_key[1], pl.cand_idx[1], g2 * K,
                                                      nullptr, nullptr, 1);
    }
    return (int)cudaGetLastError();
  }
  ol_flags<<<(unsigned)pl.nb, BLOCK, 0, s>>>(pl);
  scan_sums_kernel<<<1, SCAN_BLOCK, 0, s>>>(pl.block_sums, pl.nb);
  ol_compact<<<(unsigned)pl.nb, BLOCK, 0, s>>>(pl);
  if (pl.npass > 0) {
    int e = (int)cudaMemsetAsync(pl.ghist, 0, (size_t)pl.zero_bytes, s);
    if (e) return e;
    const long long hb = pl.nb < 1024 ? pl.nb : 1024;
    ol_hist<<<dim3((unsigned)hb, (unsigned)pl.nwords), BLOCK, 0, s>>>(pl);
    ol_pinfo<<<1, RADIX, 0, s>>>(pl);
    for (int p = 0; p < pl.npass; ++p) {
      if (pl.pass_wide[p])
        ol_pass<unsigned long long><<<(unsigned)pl.ptiles, PB, 0, s>>>(pl, p);
      else
        ol_pass<unsigned><<<(unsigned)pl.ptiles, PB, 0, s>>>(pl, p);
    }
  }
  ol_emit<<<(unsigned)((pl.cap + BLOCK - 1) / BLOCK), BLOCK, 0, s>>>(pl);
  return (int)cudaGetLastError();
}
