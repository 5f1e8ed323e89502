// shard_merge: the one-card form of the collectives that combine the shards
// of a mesh-sharded step (kernel K32), for sm_90a.
//
// Replaces, inside the JAX package's shard_map bodies:
//   siddhi_tpu/core/planner.py:141-148      _merge_rows (psum of the
//       row-aligned outputs, each valid on its owner alone; bools as an
//       int32 psum > 0)
//   siddhi_tpu/core/planner.py:242-254      dmerge (the keyed step's
//       replicated selector state: old + psum(where(new != old, new - old,
//       0)), bools through int32)
//   siddhi_tpu/core/planner.py:209-212,
//   siddhi_tpu/core/pattern_planner.py:517-524  the header psum, the
//       scalar counters' old + psum(new - old), the wake pmin
//
// Modes (each launch serves one column, one leaf or one header):
//   rows    one thread per merged row r: acc = t_0, then acc += t_d for
//           d = 1..n-1, with t_d = valid_d[r] ? col_d[r] : 0 in the
//           column's own type.  Row-aligned inputs (`pos` null) read row r
//           of every shard.  With `pos`, shard d's rows are compacted and
//           row j goes to merged row pos_d[j] (every merged row has one
//           source; kernel K31's place mode computes them): the row is then
//           t + 0 on a mesh of two or more shards, as the psum's sum with
//           the other shards' zeros is.  Either way an owned -0.0 comes out
//           +0.0 when n >= 2 (and stays -0.0 on one shard), NaN and +-inf
//           pass, integers are exact, a bool column is the int32 sum > 0.
//   delta   one thread per element: old + (delta_0 + delta_1 + ...), each
//           delta_d = new_d - old (masked: 0 where new_d == old), in the
//           element's type; a bool leaf goes through int32.  old = +inf,
//           new = 5 gives NaN; a NaN old stays NaN.  With `masked` = 2
//           (`finite_old`) a changed element whose old value is NaN or
//           +-inf takes the changed copy instead (the port's keyed step:
//           a min / max accumulator leaves its identity without turning
//           NaN, as it does unsharded).
//   header  one thread: the sum over shards of each header word, or the min
//           for the words `min_mask` marks (the wakes).
//
// Bound: every input element read once, every output written once; the
// arithmetic is one add per shard.  Bound by bytes.

namespace {

constexpr int BLOCK = 256;
constexpr int MAX_SHARDS = 16;
constexpr int MAX_HDR = 8;

enum Ty { F32 = 0, F64 = 1, I32 = 2, I64 = 3, BOOL = 4 };

}  // namespace

// Mirrored field for field by kernels/shard_merge.py (ctypes.Structure).
struct MergePlan {
  int n, mode;              // shards; 0 rows, 1 delta, 2 header
  int ty, masked;           // element type (Ty); delta: 0, 1 dmerge, 2 finite_old
  int hdr_len, min_mask;    // header words, the words that take the min
  long long R;              // rows: merged rows; delta: leaf elements
  long long rows[MAX_SHARDS];               // rows: each shard's rows (pos)
  const void* src[MAX_SHARDS];              // per shard: column / new leaf
  const unsigned char* valid[MAX_SHARDS];   // rows: per shard valid flags
  const long long* pos[MAX_SHARDS];         // rows: placement, or null
  const void* old;          // delta: the replicated old leaf
  void* out;                // merged column / leaf / header
  unsigned char* out_valid; // rows: merged valid flags, or null
};

namespace {

template <typename T>
__device__ __forceinline__ T elem(const void* p, long long i) {
  return static_cast<const T*>(p)[i];
}

// rows, row-aligned: merged row r sums every shard's row r
template <typename T, typename A>
__device__ void rows_aligned(const MergePlan& pl, long long r) {
  A acc = 0;
  int any = 0;
  for (int d = 0; d < pl.n; ++d) {
    bool v = pl.valid[d][r] != 0;
    A t = v ? (A)elem<T>(pl.src[d], r) : (A)0;
    acc = d == 0 ? t : acc + t;
    any += v;
  }
  if (pl.out != nullptr) {
    if (pl.ty == BOOL)
      static_cast<unsigned char*>(pl.out)[r] = (unsigned char)(acc > 0);
    else
      static_cast<T*>(pl.out)[r] = (T)acc;
  }
  if (pl.out_valid != nullptr) pl.out_valid[r] = (unsigned char)(any > 0);
}

__global__ void sm_rows(const MergePlan pl) {
  long long r = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (r >= pl.R) return;
  switch (pl.ty) {
    case F32: rows_aligned<float, float>(pl, r); break;
    case F64: rows_aligned<double, double>(pl, r); break;
    case I32: rows_aligned<int, int>(pl, r); break;
    case I64: rows_aligned<long long, long long>(pl, r); break;
    default: rows_aligned<unsigned char, int>(pl, r); break;
  }
}

// rows, placed: shard blockIdx.y's row j goes to merged row pos[j]
template <typename T, typename A>
__device__ void rows_placed(const MergePlan& pl, int d, long long j) {
  long long r = pl.pos[d][j];
  bool v = pl.valid[d][j] != 0;
  A t = v ? (A)elem<T>(pl.src[d], j) : (A)0;
  if (pl.n >= 2) t = t + (A)0;
  if (pl.out != nullptr) {
    if (pl.ty == BOOL)
      static_cast<unsigned char*>(pl.out)[r] = (unsigned char)(t > 0);
    else
      static_cast<T*>(pl.out)[r] = (T)t;
  }
  if (pl.out_valid != nullptr) pl.out_valid[r] = (unsigned char)v;
}

__global__ void sm_placed(const MergePlan pl) {
  int d = blockIdx.y;
  long long j = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (j >= pl.rows[d]) return;
  switch (pl.ty) {
    case F32: rows_placed<float, float>(pl, d, j); break;
    case F64: rows_placed<double, double>(pl, d, j); break;
    case I32: rows_placed<int, int>(pl, d, j); break;
    case I64: rows_placed<long long, long long>(pl, d, j); break;
    default: rows_placed<unsigned char, int>(pl, d, j); break;
  }
}

template <typename A>
__device__ __forceinline__ bool finite(A x) {
  return !(x != x) && x - x == x - x;   // false for NaN and +-inf
}

template <typename T, typename A>
__device__ void delta_one(const MergePlan& pl, long long i) {
  A o = (A)elem<T>(pl.old, i);
  A acc = 0, last = o;
  bool changed = false;
  for (int d = 0; d < pl.n; ++d) {
    A x = (A)elem<T>(pl.src[d], i);
    bool c = x != o;
    A t = (pl.masked && !c) ? (A)0 : (A)(x - o);
    acc = d == 0 ? t : acc + t;
    if (c) last = x;
    changed = changed || c;
  }
  // finite_old: a changed element whose old value is not finite (a min /
  // max identity) takes the changed copy, where old + delta is undefined
  A m = (pl.masked == 2 && changed && !finite(o)) ? last : o + acc;
  if (pl.ty == BOOL)
    static_cast<unsigned char*>(pl.out)[i] = (unsigned char)(m != 0);
  else
    static_cast<T*>(pl.out)[i] = (T)m;
}

__global__ void sm_delta(const MergePlan pl) {
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= pl.R) return;
  switch (pl.ty) {
    case F32: delta_one<float, float>(pl, i); break;
    case F64: delta_one<double, double>(pl, i); break;
    case I32: delta_one<int, int>(pl, i); break;
    case I64: delta_one<long long, long long>(pl, i); break;
    default: delta_one<unsigned char, int>(pl, i); break;
  }
}

__global__ void sm_header(const MergePlan pl) {
  long long* out = static_cast<long long*>(pl.out);
  for (int w = 0; w < pl.hdr_len; ++w) {
    bool take_min = (pl.min_mask >> w) & 1;
    long long acc = elem<long long>(pl.src[0], w);
    for (int d = 1; d < pl.n; ++d) {
      long long x = elem<long long>(pl.src[d], w);
      acc = take_min ? (x < acc ? x : acc) : acc + x;
    }
    out[w] = acc;
  }
}

}  // namespace

extern "C" int siddhi_merge_plan_size() { return (int)sizeof(MergePlan); }

// Launches on `stream`; returns the launch's cudaError_t (0 = launched).
extern "C" int siddhi_shard_merge(const MergePlan* plan, void* stream) {
  const MergePlan& pl = *plan;
  cudaStream_t s = (cudaStream_t)stream;
  if (pl.n <= 0 || pl.n > MAX_SHARDS) return 0;
  if (pl.mode == 2) {
    if (pl.hdr_len <= 0 || pl.hdr_len > MAX_HDR) return 0;
    sm_header<<<1, 1, 0, s>>>(pl);
  } else if (pl.mode == 1) {
    if (pl.R <= 0) return 0;
    sm_delta<<<(unsigned)((pl.R + BLOCK - 1) / BLOCK), BLOCK, 0, s>>>(pl);
  } else if (pl.pos[0] != nullptr) {
    long long most = 0;
    for (int d = 0; d < pl.n; ++d) most = pl.rows[d] > most ? pl.rows[d] : most;
    if (most <= 0) return 0;
    dim3 grid((unsigned)((most + BLOCK - 1) / BLOCK), (unsigned)pl.n);
    sm_placed<<<grid, BLOCK, 0, s>>>(pl);
  } else {
    if (pl.R <= 0) return 0;
    sm_rows<<<(unsigned)((pl.R + BLOCK - 1) / BLOCK), BLOCK, 0, s>>>(pl);
  }
  return (int)cudaGetLastError();
}
