// Dithered stochastic quantize-dequantize on Hopper, in two entries that
// share one device function (quantize_entry):
//
//   dithered_quantize_rows_{f64,f32} replaces the Pallas TPU kernel
//   src/repro/kernels/dithered_quant.py dithered_quantize_rows_2d: the
//   digital-FL uplink compressor of paper Sec. II-B, one row per device of
//   one trial, each with its own scal[r] = (m, L);
//   dithered_quantize_{f64,f32} replaces dithered_quantize_2d (line 43):
//   one whole tensor of n entries (one stacked gradient leaf of the FL-LM
//   collective, up to 2^31 entries and more: int64 indices) with one
//   (m, L) pair read from device memory.
//
// For scale m = ||g||_inf and L = 2^r - 1 levels:
//
//   valid = L > 0 && m > 0
//   safe  = valid ? 2m / L : 1
//   x     = (g + m) / safe;  lo = floor(x)
//   q     = clamp(lo + (u < x - lo), 0, L)
//   out   = valid ? -m + safe * q : 0
//
// op for op as the reference. Every division, add and multiply is an _rn
// intrinsic: an FMA or an approximate division moves x across a floor
// boundary and flips a code. The dither u stays f32 in memory and widens
// in registers (exact), which reads half the bytes of an f64 dither.
//
// Bound: bytes. Each element reads g (8 or 4 bytes) and u (4) and writes
// out for about ten operations, one of them a division, so the kernel is
// one streaming pass. Design of the rows entry: blockIdx.y walks rows
// (grid-stride past 65535), each block loads its row's (m, L) once, and
// threads stride over the row's columns with coalesced scalar loads; d
// needs no padding, the loop bound masks the ragged edge. The whole-tensor
// entry is one flat grid-stride loop over n (at most 16 blocks an SM), each
// thread reading the (m, L) pair once; the Pallas kernel's (R, 128) padding
// is not needed.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double floor_(double x) { return floor(x); }
__device__ __forceinline__ float floor_(float x) { return floorf(x); }
__device__ __forceinline__ double fmax_(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float fmax_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double fmin_(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float fmin_(float a, float b) { return fminf(a, b); }

// One entry of the quantizer: q in [0, L], dequantized as -m + safe * q.
template <typename T>
__device__ __forceinline__ T quantize_entry(T g, float u, T m, T safe,
                                            T levels) {
  const T x = div_rn(add_rn(g, m), safe);
  const T lo = floor_(x);
  const T up = (T(u) < sub_rn(x, lo)) ? T(1) : T(0);
  const T q = fmin_(fmax_(add_rn(lo, up), T(0)), levels);
  return add_rn(-m, mul_rn(safe, q));
}

template <typename T>
__global__ void dithered_quantize_kernel(const T* __restrict__ g,
                                         const float* __restrict__ u,
                                         const T* __restrict__ scal,
                                         T* __restrict__ out, int64_t n) {
  const T m = scal[0];
  const T levels = scal[1];
  const bool valid = levels > T(0) && m > T(0);
  const T safe = valid ? div_rn(mul_rn(T(2), m), levels) : T(1);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = valid ? quantize_entry(g[i], u[i], m, safe, levels) : T(0);
  }
}

template <typename T>
__global__ void dithered_quantize_rows_kernel(const T* __restrict__ g,
                                              const float* __restrict__ u,
                                              const T* __restrict__ scal,
                                              T* __restrict__ out,
                                              int64_t rows, int64_t d) {
  const int64_t c0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t cstride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const T m = scal[2 * r];
    const T levels = scal[2 * r + 1];
    const bool valid = levels > T(0) && m > T(0);
    const T safe = valid ? div_rn(mul_rn(T(2), m), levels) : T(1);
    const T* gr = g + r * d;
    const float* ur = u + r * d;
    T* outr = out + r * d;
    for (int64_t c = c0; c < d; c += cstride) {
      outr[c] = valid ? quantize_entry(gr[c], ur[c], m, safe, levels) : T(0);
    }
  }
}

template <typename T>
int launch(const void* g, const void* u, const void* scal, void* out,
           int64_t rows, int64_t d, void* stream) {
  constexpr int THREADS = 256;
  int64_t bx = (d + THREADS - 1) / THREADS;
  if (bx > 1024) bx = 1024;
  const int64_t by = rows < 65535 ? rows : 65535;
  const dim3 grid((unsigned)bx, (unsigned)by);
  dithered_quantize_rows_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)g, (const float*)u, (const T*)scal, (T*)out, rows, d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tensor(const void* g, const void* u, const void* scal, void* out,
                  int64_t n, void* stream) {
  constexpr int THREADS = 256;
  int64_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16/SM
  dithered_quantize_kernel<T><<<(unsigned)blocks, THREADS, 0,
                                (cudaStream_t)stream>>>(
      (const T*)g, (const float*)u, (const T*)scal, (T*)out, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dithered_quantize_f64(const void* g, const void* u, const void* scal,
                          void* out, int64_t n, void* stream) {
  return launch_tensor<double>(g, u, scal, out, n, stream);
}

int dithered_quantize_f32(const void* g, const void* u, const void* scal,
                          void* out, int64_t n, void* stream) {
  return launch_tensor<float>(g, u, scal, out, n, stream);
}

int dithered_quantize_rows_f64(const void* g, const void* u, const void* scal,
                               void* out, int64_t rows, int64_t d,
                               void* stream) {
  return launch<double>(g, u, scal, out, rows, d, stream);
}

int dithered_quantize_rows_f32(const void* g, const void* u, const void* scal,
                               void* out, int64_t rows, int64_t d,
                               void* stream) {
  return launch<float>(g, u, scal, out, rows, d, stream);
}

}  // extern "C"
