// OTA epilogue on Hopper: out[r, i] = widen(g[r, i]) * inv_alpha[r] + z[r, i].
//
// Replaces the Pallas TPU kernel src/repro/kernels/ota_combine.py
// ota_combine_2d (body _kernel): the PS post-scale and AWGN injection of
// eq. (6), with the noise z arriving already scaled by inv_alpha. Rows are
// Monte-Carlo trials, so inv_alpha is per row (Vanilla OTA's alpha = N
// gamma_t differs per trial). The payload g may be narrower than the
// accumulator: f64/f64, f32/f32, or a bf16 payload with f32 accumulation
// (the reference's acc_dtype).
//
// Bound: bytes. Each element reads g and z and writes out (24 bytes in f64)
// for two floating-point operations, far below the card's ~10 flops per
// byte, so the kernel is one streaming pass over memory. Design: a flat
// grid-stride loop over rows * d, VEC consecutive elements per thread
// (16-byte loads and stores of z and out), the row index tracked
// incrementally across a vector so any d works; the n % VEC tail is handled
// one element per thread. __dmul_rn/__dadd_rn (__fmul_rn/__fadd_rn) keep
// the multiply and the add separate: nvcc may not contract them into an
// FMA, so the result is bit-equal to PyTorch's g * inv_alpha + z.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

template <typename G, typename A, int VEC>
__global__ void ota_combine_kernel(const G* __restrict__ g,
                                   const A* __restrict__ inv_alpha,
                                   const A* __restrict__ z,
                                   A* __restrict__ out, int64_t rows,
                                   int64_t d) {
  const int64_t n = rows * d;
  const int64_t n_vec = n / VEC;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const Pack<G, VEC>* gv = reinterpret_cast<const Pack<G, VEC>*>(g);
  const Pack<A, VEC>* zv = reinterpret_cast<const Pack<A, VEC>*>(z);
  Pack<A, VEC>* ov = reinterpret_cast<Pack<A, VEC>*>(out);
  for (int64_t v = tid; v < n_vec; v += stride) {
    const int64_t i0 = v * VEC;
    int64_t r = i0 / d;
    int64_t c = i0 - r * d;
    const Pack<G, VEC> gp = gv[v];
    const Pack<A, VEC> zp = zv[v];
    Pack<A, VEC> op;
    A s = inv_alpha[r];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (c == d) {  // the vector crosses into the next row
        ++r;
        c = 0;
        s = inv_alpha[r];
      }
      op.v[j] = add_rn(mul_rn(widen(gp.v[j]), s), zp.v[j]);
      ++c;
    }
    ov[v] = op;
  }
  const int64_t i = n_vec * VEC + tid;  // ragged tail: fewer than VEC left
  if (i < n) {
    out[i] = add_rn(mul_rn(widen(g[i]), inv_alpha[i / d]), z[i]);
  }
}

template <typename G, typename A>
int launch(const void* g, const void* inv_alpha, const void* z, void* out,
           int64_t rows, int64_t d, void* stream) {
  constexpr int VEC = 16 / sizeof(A);
  constexpr int THREADS = 256;
  const int64_t n_vec = rows * d / VEC;
  int64_t blocks = (n_vec + THREADS - 1) / THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16/SM
  if (blocks < 1) blocks = 1;                  // the tail needs a block
  ota_combine_kernel<G, A, VEC>
      <<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
          (const G*)g, (const A*)inv_alpha, (const A*)z, (A*)out, rows, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ota_combine_f64(const void* g, const void* inv_alpha, const void* z,
                    void* out, int64_t rows, int64_t d, void* stream) {
  return launch<double, double>(g, inv_alpha, z, out, rows, d, stream);
}

int ota_combine_f32(const void* g, const void* inv_alpha, const void* z,
                    void* out, int64_t rows, int64_t d, void* stream) {
  return launch<float, float>(g, inv_alpha, z, out, rows, d, stream);
}

int ota_combine_bf16_f32(const void* g, const void* inv_alpha, const void* z,
                         void* out, int64_t rows, int64_t d, void* stream) {
  return launch<uint16_t, float>(g, inv_alpha, z, out, rows, d, stream);
}

}  // extern "C"
