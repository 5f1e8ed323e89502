// shard_route: each shard's view of a batch on a mesh of n shards (kernel
// K31), for sm_90a.
//
// Replaces, inside the JAX package's shard_map bodies:
//   siddhi_tpu/core/planner.py:193-195  (_shard_plain_step: owned rows)
//       lvalid = valid & (gslot % n == dev); local = owned ? gslot // n : 0
//   siddhi_tpu/core/planner.py:269-270  (_shard_keyed_step: owned keys)
//       key_l = (key_idx % n == dev && key_idx < K) ? key_idx // n : drop
// and adds the placement the port needs where a shard's step compacts its
// rows (a keyed window emits exactly its rows, key-major): from each
// shard's per-key-row output counts, the row each shard row takes in the
// merged output, which is key-row-major as an unsharded step's is.
//
// Modes:
//   plain  one thread per (shard, row): lvalid [n, B] u8, local [n, B] i32,
//          with floor division and modulo, as jnp's % and // on int32.
//   keyed  one thread per (shard, key row): key_l [n, Kb] i32; a key the
//          shard does not own, and a padding row (index >= K), gets the
//          sentinel (the shard's row count, K / n), which every keyed
//          window kernel drops (each tests `k < K` of its own slab).
//   place  one block: a scan of the counts [n, Kb] (each thread a run of
//          key rows, the run totals scanned by thread 0), then each thread
//          writes its key rows' positions: shard d's rows go to the flat
//          `pos` at base_d + (the row's rank in shard d), each holding
//          global offset of its key row + its rank within the key row.
//
// Bound: plain reads B gslot / valid pairs and writes n * B flags and
// slots; keyed reads Kb keys and writes n * Kb rows; place reads n * Kb
// counts and writes one position a merged row.  All bound by bytes.

namespace {

constexpr int BLOCK = 256;
constexpr int PLACE_THREADS = 256;
constexpr int MAX_SHARDS = 16;

}  // namespace

// Mirrored field for field by kernels/shard_route.py (ctypes.Structure).
struct RoutePlan {
  long long B;              // rows (plain) or key rows (keyed, place)
  int n, mode;              // shards; 0 plain, 1 keyed, 2 place
  long long K;              // keyed: global key capacity
  long long sentinel;       // keyed: the drop row of a shard's slab
  const int* gslot;         // plain [B]
  const unsigned char* valid;
  unsigned char* lvalid;    // plain [n, B]
  int* local;               // plain [n, B]
  const int* key_idx;       // keyed [B]
  int* key_l;               // keyed [n, B]
  const long long* counts;  // place [n, B]
  long long* pos;           // place [sum of counts]
};

namespace {

__device__ __forceinline__ long long floor_mod(long long a, long long n) {
  long long m = a % n;
  return m < 0 ? m + n : m;
}

__global__ void sr_plain(const RoutePlan pl) {
  long long t = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (t >= pl.B * pl.n) return;
  long long d = t / pl.B, i = t - d * pl.B;
  long long g = pl.gslot[i];
  long long m = floor_mod(g, pl.n);
  bool owned = m == d;
  pl.lvalid[t] = (unsigned char)(owned && pl.valid[i] != 0);
  pl.local[t] = owned ? (int)((g - m) / pl.n) : 0;
}

__global__ void sr_keyed(const RoutePlan pl) {
  long long t = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (t >= pl.B * pl.n) return;
  long long d = t / pl.B, r = t - d * pl.B;
  long long k = pl.key_idx[r];
  bool owned = floor_mod(k, pl.n) == d && k < pl.K;
  pl.key_l[t] = (int)(owned ? (k - d) / pl.n : pl.sentinel);
}

__global__ void __launch_bounds__(PLACE_THREADS) sr_place(const RoutePlan pl) {
  // per thread: a run of key rows; shared: each run's totals per shard
  // and over all shards, scanned in place by thread 0
  __shared__ long long run_g[PLACE_THREADS];
  __shared__ long long run_d[MAX_SHARDS][PLACE_THREADS];
  __shared__ long long base[MAX_SHARDS];
  const int n = pl.n;
  const long long per = (pl.B + PLACE_THREADS - 1) / PLACE_THREADS;
  const long long lo = threadIdx.x * per;
  const long long hi = lo + per < pl.B ? lo + per : pl.B;
  long long g = 0;
  for (int d = 0; d < n; ++d) {
    long long s = 0;
    for (long long r = lo; r < hi; ++r) s += pl.counts[d * pl.B + r];
    run_d[d][threadIdx.x] = s;
    g += s;
  }
  run_g[threadIdx.x] = g;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long acc = 0;
    for (int t = 0; t < PLACE_THREADS; ++t) {
      long long x = run_g[t];
      run_g[t] = acc;
      acc += x;
    }
    long long b = 0;
    for (int d = 0; d < n; ++d) {
      long long a = 0;
      for (int t = 0; t < PLACE_THREADS; ++t) {
        long long x = run_d[d][t];
        run_d[d][t] = a;
        a += x;
      }
      base[d] = b;
      b += a;
    }
  }
  __syncthreads();
  long long og = run_g[threadIdx.x];
  long long od[MAX_SHARDS];
  for (int d = 0; d < n; ++d) od[d] = base[d] + run_d[d][threadIdx.x];
  for (long long r = lo; r < hi; ++r) {
    for (int d = 0; d < n; ++d) {
      long long c = pl.counts[d * pl.B + r];
      for (long long i = 0; i < c; ++i) pl.pos[od[d] + i] = og + i;
      od[d] += c;
      og += c;
    }
  }
}

}  // namespace

extern "C" int siddhi_route_plan_size() { return (int)sizeof(RoutePlan); }

// Launches on `stream`; returns the launch's cudaError_t (0 = launched).
extern "C" int siddhi_shard_route(const RoutePlan* plan, void* stream) {
  const RoutePlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  if (pl.B <= 0 || pl.n <= 0 || pl.n > MAX_SHARDS) return 0;
  long long total = pl.B * pl.n;
  unsigned grid = (unsigned)((total + BLOCK - 1) / BLOCK);
  if (pl.mode == 0)
    sr_plain<<<grid, BLOCK, 0, s>>>(pl);
  else if (pl.mode == 1)
    sr_keyed<<<grid, BLOCK, 0, s>>>(pl);
  else
    sr_place<<<1, PLACE_THREADS, 0, s>>>(pl);
  return (int)cudaGetLastError();
}
