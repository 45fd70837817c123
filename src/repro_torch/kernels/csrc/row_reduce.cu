// Per-row (max |g|, sum g^2) on Hopper, in a wider accumulator.
//
// Replaces the Pallas TPU kernel src/repro/kernels/row_reduce.py
// row_maxabs_sumsq_2d (body _kernel): the per-device gradient statistics
// the digital baselines score devices by (Best Channel-Norm ranks its
// candidates by sqrt(sum g^2) every round). Row r of g (R, d) gives
// out[r] = (max_i |g_ri|, sum_i g_ri^2) in the accumulator type: f64 from
// f64, f32 from f32, f32 from a bf16 payload (the reference's acc_dtype;
// a bf16 sum of squares saturates after a few hundred terms).
//
// The order of the sum is fixed by d and g's type alone (never by the SM
// count, the number of rows, a row's alignment or the launch shape), so
// that the plain PyTorch version (kernels/ref.py row_maxabs_sumsq_ref)
// repeats it and the two agree bit for bit. With C = 8 chunks, T = 256
// threads and V = 16 / sizeof(g) entries to a vector (2 in f64, 4 in f32,
// 8 in bf16; ref.py REDUCE_CLUSTER, REDUCE_THREADS, reduce_chunk):
//
//   * chunks: row r is cut into C contiguous chunks of L = ceil(d / (C V)) V
//     entries, chunk c = [c L, min((c + 1) L, d)) (empty when d < c L);
//   * threads: in a chunk, thread t of T owns vectors t, t + T, t + 2T, ...
//     (vector v = entries c L + v V .. + V - 1 of the chunk); lane k of
//     each vector goes to accumulator k, which starts at +0 and adds x * x
//     in step order;
//   * lanes: the V accumulators combine in order, ((a0 + a1) + a2) + ...;
//   * threads: the T partials go through the halving tree s = 128, 64, ...,
//     1, acc[j] = acc[j] + acc[j + s] for j < s (its first three steps
//     added by warp 0 from shared memory after one barrier, its last five
//     as a __shfl_xor_sync butterfly, whose lane 0 gets the same bits:
//     IEEE addition commutes);
//   * chunks: the C partials add in rank order, ((p0 + p1) + p2) + ...
//
// Every product and sum is an _rn intrinsic, so nvcc cannot contract them
// into an FMA. Entries missing from a vector (the ragged end of a row)
// and empty chunks add nothing, which is the same as adding +0: the sums
// are never -0. The maximum does not depend on order; a NaN entry makes
// it NaN, as torch.amax.
//
// Bound: bytes. Each entry is read once for one multiply, one add and one
// compare, far below the card's operations per byte. Design: one launch
// of R clusters of C blocks (__cluster_dims__), block c of cluster r doing
// chunk c of row r, the row on the grid's x dimension (C R <= 2^31 - 1).
// A thread loads 16-byte vectors, four of them in flight before it adds
// them in order. The blocks' partials meet in rank 0's shared memory over
// the cluster's distributed shared memory: one launch, no workspace, no
// atomics, no second pass. A chunk whose start is not 16-byte aligned
// (d * sizeof(g) not a multiple of 16, or a view off a vector) and the
// ragged last vector load entry by entry into the same accumulators:
// vectors are how the kernel loads, not part of the order.

#include <cooperative_groups.h>
#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;  // ref.py REDUCE_THREADS
constexpr int CLUSTER = 8;    // ref.py REDUCE_CLUSTER (the portable size)
constexpr int UNROLL = 4;     // vectors a thread has in flight

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float widen(float x) { return x; }
// bf16 payloads travel as their raw 16 bits
__device__ __forceinline__ float widen(uint16_t x) {
  return __bfloat162float(__ushort_as_bfloat16(x));
}

// |x| as torch's abs gives it on the card (read there: PTX leaves abs's
// NaN result unspecified), so that a NaN row's maximum has the plain
// version's bits: the sign bit cleared, except that an f64 NaN passes
// through unchanged and an f32 NaN becomes the canonical 0x7fffffff
__device__ __forceinline__ double abs_(double x) {
  return x != x ? x
                : __longlong_as_double(__double_as_longlong(x) &
                                       0x7fffffffffffffffLL);
}
__device__ __forceinline__ float abs_(float x) {
  return __int_as_float(x != x ? 0x7fffffff
                               : __float_as_int(x) & 0x7fffffff);
}

// max that keeps a NaN once one is seen
template <typename A>
__device__ __forceinline__ A max_nan(A m, A a) {
  return (a > m || a != a) ? a : m;
}

// V entries of G in one 16-byte load
template <typename G>
struct alignas(16) Vec {
  G v[16 / sizeof(G)];
};

template <typename G>
__device__ __forceinline__ Vec<G> load_vec(const G* chunk, int64_t v) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(chunk) + v);
  Vec<G> x;
  memcpy(&x, &raw, sizeof(x));
  return x;
}

template <typename G, typename A>
__device__ __forceinline__ void add_vec(const Vec<G>& x,
                                        A (&acc)[16 / sizeof(G)], A& mx) {
#pragma unroll
  for (int k = 0; k < (int)(16 / sizeof(G)); ++k) {
    const A a = widen(x.v[k]);
    acc[k] = add_rn(acc[k], mul_rn(a, a));
    mx = max_nan(mx, abs_(a));
  }
}

template <typename G, typename A>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
row_maxabs_sumsq_kernel(const G* __restrict__ g, A* __restrict__ out,
                        int64_t d, int64_t chunk_len) {
  constexpr int V = 16 / sizeof(G);
  __shared__ A s_acc[THREADS];
  __shared__ A s_max[THREADS];
  __shared__ A s_part[2 * CLUSTER];  // rank 0's: each block's (sum, max)
  // every block of the cluster must have started before one writes into
  // another's shared memory: arrive now, wait just before that write
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned c = cluster.block_rank();
  const int64_t r = blockIdx.x / CLUSTER;
  const int t = threadIdx.x;
  const int64_t lo = (int64_t)c * chunk_len;
  const int64_t n =  // the chunk's entries
      lo >= d ? 0 : (d - lo < chunk_len ? d - lo : chunk_len);
  const G* chunk = g + r * d + lo;
  const int64_t n_vec = (n + V - 1) / V;
  const int64_t n_full =
      (reinterpret_cast<uintptr_t>(chunk) % 16 == 0) ? n / V : 0;

  A acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = A(0);
  A mx = A(0);
  int64_t v = t;
  for (; v + (UNROLL - 1) * THREADS < n_full; v += UNROLL * THREADS) {
    Vec<G> x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) x[u] = load_vec(chunk, v + u * THREADS);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) add_vec(x[u], acc, mx);
  }
  for (; v < n_full; v += THREADS) add_vec(load_vec(chunk, v), acc, mx);
  for (; v < n_vec; v += THREADS) {  // entry by entry, into the same lanes
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (v * V + k < n) {
        const A a = widen(chunk[v * V + k]);
        acc[k] = add_rn(acc[k], mul_rn(a, a));
        mx = max_nan(mx, abs_(a));
      }
    }
  }
  A p = acc[0];
#pragma unroll
  for (int k = 1; k < V; ++k) p = add_rn(p, acc[k]);

  // the halving tree over the block's T partials: its first three steps
  // (s = 128, 64, 32) give lane l of warp 0 the sum
  // ((a[l] + a[l+128]) + (a[l+64] + a[l+192]))
  //   + ((a[l+32] + a[l+160]) + (a[l+96] + a[l+224])),
  // which it adds from shared memory after one barrier; the last five
  // are the butterfly
  static_assert(THREADS == 256, "the tree below is written for 256");
  s_acc[t] = p;
  s_max[t] = mx;
  __syncthreads();
  if (t < 32) {
    const A* a = s_acc;
    const A* m = s_max;
    p = add_rn(add_rn(add_rn(a[t], a[t + 128]), add_rn(a[t + 64], a[t + 192])),
               add_rn(add_rn(a[t + 32], a[t + 160]),
                      add_rn(a[t + 96], a[t + 224])));
    mx = m[t];
#pragma unroll
    for (int k = 32; k < THREADS; k += 32) mx = max_nan(mx, m[t + k]);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      p = add_rn(p, __shfl_xor_sync(0xffffffffu, p, s));
      mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, s));
    }
  }
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (t == 0) {
    A* dst = cluster.map_shared_rank(s_part, 0);
    dst[2 * c] = p;
    dst[2 * c + 1] = mx;
  }
  cluster.sync();
  if (c == 0 && t == 0) {
    A sum = s_part[0];
    A m = s_part[1];
#pragma unroll
    for (int k = 1; k < CLUSTER; ++k) {
      sum = add_rn(sum, s_part[2 * k]);
      m = max_nan(m, s_part[2 * k + 1]);
    }
    out[2 * r] = m;
    out[2 * r + 1] = sum;
  }
}

template <typename G, typename A>
int launch(const void* g, void* out, int64_t rows, int64_t d, void* stream) {
  constexpr int64_t V = 16 / sizeof(G);
  if (rows < 1 || d < 1 || rows > 2147483647 / CLUSTER)
    return (int)cudaErrorInvalidValue;
  const int64_t chunk_len = (d + CLUSTER * V - 1) / (CLUSTER * V) * V;
  row_maxabs_sumsq_kernel<G, A>
      <<<(unsigned)(rows * CLUSTER), THREADS, 0, (cudaStream_t)stream>>>(
          (const G*)g, (A*)out, d, chunk_len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int row_maxabs_sumsq_f64(const void* g, void* out, int64_t rows, int64_t d,
                         void* stream) {
  return launch<double, double>(g, out, rows, d, stream);
}

int row_maxabs_sumsq_f32(const void* g, void* out, int64_t rows, int64_t d,
                         void* stream) {
  return launch<float, float>(g, out, rows, d, stream);
}

int row_maxabs_sumsq_bf16_f32(const void* g, void* out, int64_t rows,
                              int64_t d, void* stream) {
  return launch<uint16_t, float>(g, out, rows, d, stream);
}

}  // extern "C"
