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
// The order of the sum is fixed, so that the plain PyTorch version
// (kernels/ref.py row_maxabs_sumsq_ref) repeats it and the two agree bit
// for bit: one block of 256 threads per row; thread j walks entries
// j, j + 256, j + 512, ... in turn with acc = acc + x * x from 0 (each
// product and sum an _rn intrinsic, so nvcc cannot contract them into an
// FMA); then a fixed halving tree in shared memory, s = 128, 64, ..., 1,
// with acc[j] = acc[j] + acc[j + s] for j < s. No atomics. The maximum
// does not depend on order; a NaN entry makes it NaN, as torch.amax.
//
// Bound: bytes. Each entry is read once for one multiply, one add and one
// compare, far below the card's operations per byte. This first design
// keeps one block per row (the Fig. 2 digital path has 40 rows of 7850,
// at the launch-latency floor) and scalar coalesced loads, unrolled so
// that several loads are in flight while the adds stay in order; several
// blocks per row and vector loads are later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

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

// max that keeps a NaN once one is seen
template <typename A>
__device__ __forceinline__ A max_nan(A m, A a) {
  return (a > m || a != a) ? a : m;
}

template <typename G, typename A>
__global__ void __launch_bounds__(THREADS)
row_maxabs_sumsq_kernel(const G* __restrict__ g, A* __restrict__ out,
                        int64_t d) {
  __shared__ A s_acc[THREADS];
  __shared__ A s_max[THREADS];
  const int j = threadIdx.x;
  const G* row = g + (int64_t)blockIdx.x * d;
  A acc = A(0);
  A mx = A(0);
#pragma unroll 8
  for (int64_t i = j; i < d; i += THREADS) {
    const A x = widen(row[i]);
    acc = add_rn(acc, mul_rn(x, x));
    mx = max_nan(mx, x < A(0) ? -x : x);
  }
  s_acc[j] = acc;
  s_max[j] = mx;
  __syncthreads();
#pragma unroll
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (j < s) {
      s_acc[j] = add_rn(s_acc[j], s_acc[j + s]);
      s_max[j] = max_nan(s_max[j], s_max[j + s]);
    }
    __syncthreads();
  }
  if (j == 0) {
    out[2 * (int64_t)blockIdx.x] = s_max[0];
    out[2 * (int64_t)blockIdx.x + 1] = s_acc[0];
  }
}

template <typename G, typename A>
int launch(const void* g, void* out, int64_t rows, int64_t d, void* stream) {
  if (rows > 2147483647) return (int)cudaErrorInvalidValue;
  row_maxabs_sumsq_kernel<G, A>
      <<<(unsigned)rows, THREADS, 0, (cudaStream_t)stream>>>(
          (const G*)g, (A*)out, d);
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
