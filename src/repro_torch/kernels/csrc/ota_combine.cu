// OTA epilogue on Hopper, in two entries:
//
//   ota_combine_{f64,f32,bf16_f32} (the row entry): out[r, i] =
//   widen(g[r, i]) * inv_alpha[r] + z[r, i], with z given (the FL path's
//   host-made replay noise);
//   ota_combine_keyed_{f64,f32} (the keyed entry): out[i] = g[i] *
//   inv_alpha + (scale * normal_i) cast to g's type, normal_i drawn in the
//   kernel from a threefry key (the FL-LM collective's noise), below.
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

// ------------------------------------------------------------ keyed entry
//
// The same epilogue for one whole tensor (one stacked gradient leaf of the
// FL-LM collective, up to 2^31 entries and more: int64 indices), with its
// noise drawn in the kernel instead of read from memory:
//
//   out[i] = g[i] * inv_alpha + (T)(scale * normal_i)
//
// where normal_i is jax.random.normal(key, (n,), float32)[i] as the port's
// plain version draws it (core/rngstream.py normal), bit for bit:
//   1. counter i split as (hi, lo) = (i >> 32, i & 0xffffffff) goes
//      through threefry2x32 under key (k0, k1) (20 rounds, partitionable
//      layout), bits = y0 ^ y1;
//   2. u = bitcast((bits >> 9) | 0x3F800000) - 1, in [0, 1);
//   3. x = max(u * 2 + lo, lo), lo = nextafter(-1, 0) in f32; XLA's f32
//      erfinv (w = -log1p(-x * x); a degree-8 polynomial in w - 2.5 for
//      w < 5, else in sqrt(w) - 3, by Horner steps c + p * w; times x);
//   4. times sqrt(2) in f32, times scale (f32), cast to T.
// Each multiply and add is an _rn intrinsic in the plain version's order;
// log1pf and sqrtf are the libdevice functions torch's CUDA log1p and sqrt
// call (sqrtf correctly rounded without fast math). inv_alpha (T), scale
// (f32) and the key come as launch arguments; the kernel reads g once,
// writes out once and never writes the normals to memory.
//
// Bound: integer issue, not bytes. Each entry reads and writes 4 bytes
// (f32) but costs about 80 32-bit integer instructions (threefry's 20
// rounds of add, rotate and xor, its key injections, the counter split)
// on a pipe of 64 lanes an SM, and some 40 f32 operations. Design: a flat
// grid-stride loop over vectors of 16 bytes of g (4 entries in f32, 2 in
// f64: 16-byte loads and stores, four independent threefry chains a
// thread in f32), at most 8 blocks of 256 threads an SM; the n % V tail and
// a g off a vector's boundary take the same arithmetic entry by entry.

constexpr uint32_t THREEFRY_PARITY = 0x1BD11BDAu;

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ THREEFRY_PARITY};
  constexpr int ROT[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, ROT[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// jax.random.normal's f32 normal of counter i (steps 1-3 and sqrt(2))
__device__ __forceinline__ float threefry_normal(uint32_t k0, uint32_t k1,
                                                 int64_t i) {
  uint32_t y0 = (uint32_t)((uint64_t)i >> 32);
  uint32_t y1 = (uint32_t)((uint64_t)i & 0xffffffffu);
  threefry2x32(k0, k1, y0, y1);
  const uint32_t bits = ((y0 ^ y1) >> 9) | 0x3F800000u;
  const float u = __fsub_rn(__uint_as_float(bits), 1.0f);
  const float lo = -0x1.fffffep-1f;  // nextafter(-1, 0): 1 - lo rounds to 2
  const float x = fmaxf(__fadd_rn(__fmul_rn(u, 2.0f), lo), lo);
  // XLA's erfinv (Giles' single-precision approximation); the constants
  // are the f32 values of rngstream's _ERFINV_W_LT5 and _ERFINV_W_GE5
  float w = -log1pf(__fmul_rn(-x, x));
  float p;
  if (w < 5.0f) {
    w = __fsub_rn(w, 2.5f);
    p = 0x1.e2cb1p-26f;
    p = __fadd_rn(0x1.70966cp-22f, __fmul_rn(p, w));
    p = __fadd_rn(-0x1.d8e6aep-19f, __fmul_rn(p, w));
    p = __fadd_rn(-0x1.26b582p-18f, __fmul_rn(p, w));
    p = __fadd_rn(0x1.ca65b6p-13f, __fmul_rn(p, w));
    p = __fadd_rn(-0x1.48a81p-10f, __fmul_rn(p, w));
    p = __fadd_rn(-0x1.11c9dep-8f, __fmul_rn(p, w));
    p = __fadd_rn(0x1.f91ec6p-3f, __fmul_rn(p, w));
    p = __fadd_rn(0x1.805c5ep+0f, __fmul_rn(p, w));
  } else {
    w = __fsub_rn(sqrtf(w), 3.0f);
    p = -0x1.a3e136p-13f;
    p = __fadd_rn(0x1.a76ad6p-14f, __fmul_rn(p, w));
    p = __fadd_rn(0x1.61b8e4p-10f, __fmul_rn(p, w));
    p = __fadd_rn(-0x1.e17bcep-9f, __fmul_rn(p, w));
    p = __fadd_rn(0x1.7824f6p-8f, __fmul_rn(p, w));
    p = __fadd_rn(-0x1.f38baep-8f, __fmul_rn(p, w));
    p = __fadd_rn(0x1.354afcp-7f, __fmul_rn(p, w));
    p = __fadd_rn(0x1.006db6p+0f, __fmul_rn(p, w));
    p = __fadd_rn(0x1.6a9efcp+1f, __fmul_rn(p, w));
  }
  const float e = fabsf(x) == 1.0f ? __fmul_rn(x, 0x1.fffffep+127f)
                                   : __fmul_rn(p, x);
  return __fmul_rn(e, 0x1.6a09e6p+0f);  // sqrt(2) in f32
}

template <typename T>
__device__ __forceinline__ T keyed_entry(T g, int64_t i, T inv_alpha,
                                         float scale, uint32_t k0,
                                         uint32_t k1) {
  const T z = (T)__fmul_rn(scale, threefry_normal(k0, k1, i));
  return add_rn(mul_rn(g, inv_alpha), z);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(256)
ota_combine_keyed_kernel(const T* __restrict__ g, T* __restrict__ out,
                         int64_t n, T inv_alpha, float scale, uint32_t k0,
                         uint32_t k1) {
  const int64_t n_vec = n / VEC;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const Pack<T, VEC>* gv = reinterpret_cast<const Pack<T, VEC>*>(g);
  Pack<T, VEC>* ov = reinterpret_cast<Pack<T, VEC>*>(out);
  for (int64_t v = tid; v < n_vec; v += stride) {
    const Pack<T, VEC> gp = gv[v];
    Pack<T, VEC> op;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      op.v[j] = keyed_entry(gp.v[j], v * VEC + j, inv_alpha, scale, k0, k1);
    }
    ov[v] = op;
  }
  const int64_t i = n_vec * VEC + tid;  // ragged tail: fewer than VEC left
  if (i < n) out[i] = keyed_entry(g[i], i, inv_alpha, scale, k0, k1);
}

template <typename T>
int launch_keyed(const void* g, void* out, int64_t n, double inv_alpha,
                 double scale, uint32_t k0, uint32_t k1, void* stream) {
  constexpr int THREADS = 256;
  constexpr int VEC = 16 / sizeof(T);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const bool aligned = ((uintptr_t)g % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const int64_t n_vec = aligned ? n / VEC : n;
  int64_t blocks = (n_vec + THREADS - 1) / THREADS;
  if (blocks > (int64_t)sms * 8) blocks = (int64_t)sms * 8;  // one wave
  if (blocks < 1) blocks = 1;                  // the tail needs a block
  if (aligned) {
    ota_combine_keyed_kernel<T, VEC>
        <<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
            (const T*)g, (T*)out, n, (T)inv_alpha, (float)scale, k0, k1);
  } else {
    ota_combine_keyed_kernel<T, 1>
        <<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
            (const T*)g, (T*)out, n, (T)inv_alpha, (float)scale, k0, k1);
  }
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

int ota_combine_keyed_f64(const void* g, void* out, int64_t n,
                          double inv_alpha, double scale, uint32_t k0,
                          uint32_t k1, void* stream) {
  return launch_keyed<double>(g, out, n, inv_alpha, scale, k0, k1, stream);
}

int ota_combine_keyed_f32(const void* g, void* out, int64_t n,
                          double inv_alpha, double scale, uint32_t k0,
                          uint32_t k1, void* stream) {
  return launch_keyed<float>(g, out, n, inv_alpha, scale, k0, k1, stream);
}

}  // extern "C"
