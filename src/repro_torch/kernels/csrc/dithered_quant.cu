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
// one streaming pass.
//
// Design of the rows entry: the (rows, d) arrays are one flat index space
// of n = rows * d entries, cut into vectors of V = 2 consecutive entries
// (one 8-byte load of u, one 16-byte load of g in f64 or 8-byte in f32,
// the matching store). Two entries a thread, not four: each entry's
// correctly rounded division is a long dependent chain, and at the main
// path's shape a thread does one vector, so its divisions decide its time
// (four were a quarter slower in f64 on the card; PERF.md,
// scripts/compare_uplink.py). Each block takes one contiguous run of
// vectors, its threads striding over it by the block's width, so a warp's
// loads are whole lines and a thread stays in one row for many strides. A
// thread tracks its row and column by adding (it divides once, at its
// start), and computes a row's constants (m, L, safe = 2m/L, valid) only
// when its row changes: the per-row division is not repeated per entry,
// and only x = (g + m) / safe is. A vector that crosses into the next row (d may be
// odd) and the ragged end of the array take the same arithmetic entry by
// entry. Operands whose address is not aligned to a vector (a contiguous
// view may start anywhere) are cut into vectors of V = 1 entry, with
// scalar loads. The grid is at most one wave of resident 128-thread
// blocks; indices are 32-bit unless n nears 2^31.
// Rows that do not quantize read nothing and write zeros. The whole-tensor
// entry is one flat grid-stride loop over n (at most 16 blocks an SM), each
// thread reading the (m, L) pair once; the Pallas kernel's (R, 128) padding
// is not needed.

#include <atomic>
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

constexpr int ROW_THREADS = 128;      // of 64, 128 and 256 the fastest
constexpr int MAX_DEVICES = 64;

// A row's constants: the step 2m/L, and whether the row quantizes at all.
template <typename T, typename I>
__device__ __forceinline__ void row_consts(const T* __restrict__ scal, I r,
                                           T& m, T& levels, T& safe,
                                           bool& valid) {
  m = scal[2 * r];
  levels = scal[2 * r + 1];
  valid = levels > T(0) && m > T(0);
  safe = valid ? div_rn(mul_rn(T(2), m), levels) : T(1);
}

// V consecutive entries: V = 2, one 16-byte load or store of doubles or
// an 8-byte one of floats; V = 1, single entries; V = 4 (16-byte loads of
// floats, two of doubles) is kept for scripts/compare_uplink.py's
// 4-entry variant.
template <int V>
__device__ __forceinline__ void load_vec(const double* p, double (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = *p;
  } else {
#pragma unroll
    for (int k = 0; k < V; k += 2) {
      const double2 a = reinterpret_cast<const double2*>(p)[k / 2];
      v[k] = a.x;
      v[k + 1] = a.y;
    }
  }
}
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else if constexpr (V == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void store_vec(double* p, const double (&v)[V]) {
  if constexpr (V == 1) {
    *p = v[0];
  } else {
#pragma unroll
    for (int k = 0; k < V; k += 2)
      reinterpret_cast<double2*>(p)[k / 2] = make_double2(v[k], v[k + 1]);
  }
}
template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// Block b owns vectors [b * per_block, (b + 1) * per_block) of the flat
// array, vectors of V entries: V = 2 when g, u and out all start on a
// vector's boundary, else V = 1. I is int32 when the indices fit, else
// int64.
template <typename T, typename I, int V>
__global__ void __launch_bounds__(ROW_THREADS)
dithered_quantize_rows_kernel(const T* __restrict__ g,
                              const float* __restrict__ u,
                              const T* __restrict__ scal, T* __restrict__ out,
                              I d, I n, I per_block) {
  const I n_vec = (n + V - 1) / V;
  const I v_first = (I)blockIdx.x * per_block;
  const I v_end = n_vec - v_first < per_block ? n_vec : v_first + per_block;
  I v = v_first + (I)threadIdx.x;
  if (v >= v_end) return;
  const I step = (I)blockDim.x * V;     // entries between a thread's vectors
  const I step_r = step / d, step_c = step - step_r * d;
  I i0 = v * V;
  I r = i0 / d, c = i0 - r * d;
  I cur = -1;                            // the row whose constants are held
  T m = T(0), levels = T(0), safe = T(1);
  bool valid = false;
  for (; v < v_end; v += blockDim.x) {
    if (r != cur) {
      row_consts(scal, r, m, levels, safe, valid);
      cur = r;
    }
    if (c + V <= d) {                    // the whole vector in row r
      T res[V];
      if (valid) {
        T gv[V];
        float uv[V];
        load_vec<V>(g + i0, gv);
        load_vec<V>(u + i0, uv);
#pragma unroll
        for (int k = 0; k < V; ++k)
          res[k] = quantize_entry(gv[k], uv[k], m, safe, levels);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) res[k] = T(0);
      }
      store_vec<V>(out + i0, res);
    } else {                             // entry by entry, rows as they come
      I rr = r, cc = c;
      T m2 = m, l2 = levels, s2 = safe;
      bool ok = valid;
      for (int k = 0; k < V && i0 + k < n; ++k, ++cc) {
        if (cc == d) {
          ++rr;
          cc = 0;
          row_consts(scal, rr, m2, l2, s2, ok);
        }
        const I i = i0 + k;
        out[i] = ok ? quantize_entry(g[i], u[i], m2, s2, l2) : T(0);
      }
    }
    i0 += step;
    r += step_r;
    c += step_c;
    if (c >= d) {
      c -= d;
      ++r;
    }
  }
}

// Blocks of `kernel` resident on the current device at once (SMs x blocks
// an SM at ROW_THREADS threads), found once a device and kept in `cache`
// (0: not yet).
template <typename K>
int resident_blocks(K kernel, std::atomic<int>* cache, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < MAX_DEVICES && (*blocks = cache[dev].load()) > 0) return 0;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        ROW_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  *blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  if (dev < MAX_DEVICES) cache[dev].store(*blocks);
  return 0;
}

template <typename T, typename I, int V>
int launch_rows(const void* g, const void* u, const void* scal, void* out,
                int64_t d, int64_t n, void* stream) {
  static std::atomic<int> cache[MAX_DEVICES];
  auto kernel = dithered_quantize_rows_kernel<T, I, V>;
  int wave = 0;
  const int err = resident_blocks(kernel, cache, &wave);
  if (err) return err;
  // at most one wave; each block's run a whole number of strides
  const int64_t n_vec = (n + V - 1) / V;
  int64_t blocks = (n_vec + ROW_THREADS - 1) / ROW_THREADS;
  if (blocks > wave) blocks = wave;
  int64_t per_block = (n_vec + blocks - 1) / blocks;
  per_block = (per_block + ROW_THREADS - 1) / ROW_THREADS * ROW_THREADS;
  blocks = (n_vec + per_block - 1) / per_block;
  kernel<<<(unsigned)blocks, ROW_THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)g, (const float*)u, (const T*)scal, (T*)out, (I)d, (I)n,
      (I)per_block);
  return (int)cudaGetLastError();
}

template <typename T, typename I>
int launch_rows_v(const void* g, const void* u, const void* scal, void* out,
                  int64_t d, int64_t n, void* stream) {
  const bool aligned =
      (((uintptr_t)g | (uintptr_t)out) & (2 * sizeof(T) - 1)) == 0 &&
      ((uintptr_t)u & (2 * sizeof(float) - 1)) == 0;
  return aligned ? launch_rows<T, I, 2>(g, u, scal, out, d, n, stream)
                 : launch_rows<T, I, 1>(g, u, scal, out, d, n, stream);
}

template <typename T>
int launch(const void* g, const void* u, const void* scal, void* out,
           int64_t rows, int64_t d, void* stream) {
  const int64_t n = rows * d;
  // int32 indices while every index a thread forms (up to n plus one
  // stride) stays below 2^31
  if (n < (int64_t(1) << 31) - (int64_t(1) << 16))
    return launch_rows_v<T, int32_t>(g, u, scal, out, d, n, stream);
  return launch_rows_v<T, int64_t>(g, u, scal, out, d, n, stream);
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
