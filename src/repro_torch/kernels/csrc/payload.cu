// The digital uplink's payload path on Hopper: dither -> quantize ->
// bit-pack, unpack -> dequantize, and unpack -> dequantize -> weighted sum.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/payload.py:
//   quantize_pack_rows_2d   (_pack_kernel)          -> quantize_pack_rows
//   unpack_dequant_rows_2d  (_unpack_kernel)        -> unpack_dequant_rows
//   packed_weighted_sum_2d  (_wsum_kernel and the
//                            device-blocked variant) -> packed_weighted_sum
//
// Wire format, the reference's (payload.py:71-81): a row of d entries,
// zero-padded (g = 0, u = 0) to W*K*128, is laid out as lane-rows of 128
// entries; the uint32 word (w, l) holds the codes of lane-rows w*K + k,
// k = 0..K-1, at bits k*CB, K = 32/CB, CB in {4, 8, 16}. Row r with scale
// m = ||g_r||_inf and L = 2^r - 1 levels (scal[r] = (m, L)):
//
//   valid = L > 0 && m > 0;   safe = valid ? 2m / L : 1
//   x = (g + m) / safe;  lo = floor(x);  q = clamp(lo + (u < x - lo), 0, L)
//   code = valid ? q : 0;     value = valid ? -m + safe * code : 0
//
// op for op as the reference: every division, add and multiply is an _rn
// intrinsic, since an FMA or an approximate division moves x across a
// floor boundary and flips a code. The dither stays f32 in memory and
// widens in registers (exact).
//
// packed_weighted_sum adds devices 0..N-1 in index order, acc = acc + w*v
// from acc = 0, with no atomics and no tree over devices: that order is the
// reference's contract (payload.py:17-28, 233-237). A device out of the
// round has w = 0 and leaves acc as it was.
//
// Bound: bytes. Pack reads g and u (12 or 8 bytes an entry) and writes
// CB/8; unpack reads CB/8 and writes 8 or 4; the weighted sum reads N words
// per K outputs and writes one float per output. Design: one thread per
// packed word, so a word is read or written once; neighbouring threads own
// neighbouring lanes, so every read and write of g, u, the words and the
// output is coalesced. blockIdx.y walks rows (or trials), grid-stride past
// 65535; the tail past d is masked, not padded in memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 128;
constexpr int THREADS = 256;
constexpr int DEV_CHUNK = 128;  // devices whose constants a block stages at once

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

// The step 2m/L of a row, and whether the row quantizes at all.
template <typename T>
__device__ __forceinline__ bool row_step(T m, T levels, T* safe) {
  const bool valid = levels > T(0) && m > T(0);
  *safe = valid ? div_rn(mul_rn(T(2), m), levels) : T(1);
  return valid;
}

template <typename T, int CB>
__global__ void quantize_pack_rows_kernel(const T* __restrict__ g,
                                          const float* __restrict__ u,
                                          const T* __restrict__ scal,
                                          uint32_t* __restrict__ words,
                                          int64_t rows, int64_t d,
                                          int64_t wpr) {
  constexpr int K = 32 / CB;
  const int64_t j0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t jstride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const T m = scal[2 * r];
    const T levels = scal[2 * r + 1];
    T safe;
    const bool valid = row_step(m, levels, &safe);
    const T* gr = g + r * d;
    const float* ur = u + r * d;
    uint32_t* wr = words + r * wpr;
    for (int64_t j = j0; j < wpr; j += jstride) {
      uint32_t word = 0;
      if (valid) {
        const int64_t base = (j / LANES) * K * LANES + (j % LANES);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int64_t e = base + (int64_t)k * LANES;
          const T gv = e < d ? gr[e] : T(0);       // the reference's zero pad
          const T uv = e < d ? T(ur[e]) : T(0);
          const T x = div_rn(add_rn(gv, m), safe);
          const T lo = floor_(x);
          const T up = (uv < sub_rn(x, lo)) ? T(1) : T(0);
          const T q = fmin_(fmax_(add_rn(lo, up), T(0)), levels);
          word |= (uint32_t)q << (k * CB);
        }
      }
      wr[j] = word;
    }
  }
}

template <typename T, int CB>
__global__ void unpack_dequant_rows_kernel(const uint32_t* __restrict__ words,
                                           const T* __restrict__ scal,
                                           T* __restrict__ out, int64_t rows,
                                           int64_t d, int64_t wpr) {
  constexpr int K = 32 / CB;
  constexpr uint32_t MASK = (1u << CB) - 1u;
  const int64_t j0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t jstride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const T m = scal[2 * r];
    T safe;
    const bool valid = row_step(m, scal[2 * r + 1], &safe);
    const uint32_t* wr = words + r * wpr;
    T* outr = out + r * d;
    for (int64_t j = j0; j < wpr; j += jstride) {
      const int64_t base = (j / LANES) * K * LANES + (j % LANES);
      const uint32_t word = valid ? wr[j] : 0u;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int64_t e = base + (int64_t)k * LANES;
        if (e < d) {
          const T q = T((word >> (k * CB)) & MASK);
          outr[e] = valid ? add_rn(-m, mul_rn(safe, q)) : T(0);
        }
      }
    }
  }
}

// One block row per trial: the block stages each chunk of its devices'
// (m, safe, w, valid) in shared memory, and each thread carries the K
// sums of its word's entries across all N devices in registers.
template <typename T, int CB>
__global__ void packed_weighted_sum_kernel(const uint32_t* __restrict__ words,
                                           const T* __restrict__ scal,
                                           T* __restrict__ out, int64_t trials,
                                           int64_t n_dev, int64_t d,
                                           int64_t wpr) {
  constexpr int K = 32 / CB;
  constexpr uint32_t MASK = (1u << CB) - 1u;
  __shared__ T s_m[DEV_CHUNK], s_safe[DEV_CHUNK], s_w[DEV_CHUNK];
  __shared__ bool s_valid[DEV_CHUNK];
  const int64_t jstride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = blockIdx.y; t < trials; t += gridDim.y) {
    const T* st = scal + t * n_dev * 3;
    const uint32_t* wt = words + t * n_dev * wpr;
    T* outt = out + t * d;
    // every thread of the block runs the same number of passes, so the
    // barriers below are reached by all of them
    for (int64_t j0 = (int64_t)blockIdx.x * blockDim.x; j0 < wpr;
         j0 += jstride) {
      const int64_t j = j0 + threadIdx.x;
      T acc[K];
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = T(0);
      for (int64_t c0 = 0; c0 < n_dev; c0 += DEV_CHUNK) {
        const int64_t nc = (n_dev - c0) < DEV_CHUNK ? (n_dev - c0) : DEV_CHUNK;
        __syncthreads();
        for (int64_t i = threadIdx.x; i < nc; i += blockDim.x) {
          const T* s = st + (c0 + i) * 3;
          T safe;
          s_valid[i] = row_step(s[0], s[1], &safe);
          s_m[i] = s[0];
          s_safe[i] = safe;
          s_w[i] = s[2];
        }
        __syncthreads();
        if (j < wpr) {
          for (int64_t i = 0; i < nc; ++i) {
            const uint32_t word = wt[(c0 + i) * wpr + j];
            const bool valid = s_valid[i];
            const T nm = -s_m[i], safe = s_safe[i], w = s_w[i];
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const T q = T((word >> (k * CB)) & MASK);
              const T v = valid ? add_rn(nm, mul_rn(safe, q)) : T(0);
              acc[k] = add_rn(acc[k], mul_rn(w, v));
            }
          }
        }
      }
      if (j < wpr) {
        const int64_t base = (j / LANES) * K * LANES + (j % LANES);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int64_t e = base + (int64_t)k * LANES;
          if (e < d) outt[e] = acc[k];
        }
      }
    }
  }
}

dim3 grid_for(int64_t wpr, int64_t rows) {
  int64_t bx = (wpr + THREADS - 1) / THREADS;
  if (bx > 4096) bx = 4096;
  const int64_t by = rows < 65535 ? rows : 65535;
  return dim3((unsigned)bx, (unsigned)by);
}

template <typename T, int CB>
int pack(const void* g, const void* u, const void* scal, void* words,
         int64_t rows, int64_t d, int64_t wpr, void* stream) {
  quantize_pack_rows_kernel<T, CB>
      <<<grid_for(wpr, rows), THREADS, 0, (cudaStream_t)stream>>>(
          (const T*)g, (const float*)u, (const T*)scal, (uint32_t*)words, rows,
          d, wpr);
  return (int)cudaGetLastError();
}

template <typename T, int CB>
int unpack(const void* words, const void* scal, void* out, int64_t rows,
           int64_t d, int64_t wpr, void* stream) {
  unpack_dequant_rows_kernel<T, CB>
      <<<grid_for(wpr, rows), THREADS, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)words, (const T*)scal, (T*)out, rows, d, wpr);
  return (int)cudaGetLastError();
}

template <typename T, int CB>
int wsum(const void* words, const void* scal, void* out, int64_t trials,
         int64_t n_dev, int64_t d, int64_t wpr, void* stream) {
  packed_weighted_sum_kernel<T, CB>
      <<<grid_for(wpr, trials), THREADS, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)words, (const T*)scal, (T*)out, trials, n_dev, d,
          wpr);
  return (int)cudaGetLastError();
}

// code_bits is a template parameter; an unsupported width is refused
// (cudaErrorInvalidValue) before anything launches.
template <typename T>
int pack_cb(int cb, const void* g, const void* u, const void* scal,
            void* words, int64_t rows, int64_t d, int64_t wpr, void* stream) {
  switch (cb) {
    case 4: return pack<T, 4>(g, u, scal, words, rows, d, wpr, stream);
    case 8: return pack<T, 8>(g, u, scal, words, rows, d, wpr, stream);
    case 16: return pack<T, 16>(g, u, scal, words, rows, d, wpr, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int unpack_cb(int cb, const void* words, const void* scal, void* out,
              int64_t rows, int64_t d, int64_t wpr, void* stream) {
  switch (cb) {
    case 4: return unpack<T, 4>(words, scal, out, rows, d, wpr, stream);
    case 8: return unpack<T, 8>(words, scal, out, rows, d, wpr, stream);
    case 16: return unpack<T, 16>(words, scal, out, rows, d, wpr, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int wsum_cb(int cb, const void* words, const void* scal, void* out,
            int64_t trials, int64_t n_dev, int64_t d, int64_t wpr,
            void* stream) {
  switch (cb) {
    case 4: return wsum<T, 4>(words, scal, out, trials, n_dev, d, wpr, stream);
    case 8: return wsum<T, 8>(words, scal, out, trials, n_dev, d, wpr, stream);
    case 16: return wsum<T, 16>(words, scal, out, trials, n_dev, d, wpr, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int quantize_pack_rows_f64(int cb, const void* g, const void* u,
                           const void* scal, void* words, int64_t rows,
                           int64_t d, int64_t wpr, void* stream) {
  return pack_cb<double>(cb, g, u, scal, words, rows, d, wpr, stream);
}

int quantize_pack_rows_f32(int cb, const void* g, const void* u,
                           const void* scal, void* words, int64_t rows,
                           int64_t d, int64_t wpr, void* stream) {
  return pack_cb<float>(cb, g, u, scal, words, rows, d, wpr, stream);
}

int unpack_dequant_rows_f64(int cb, const void* words, const void* scal,
                            void* out, int64_t rows, int64_t d, int64_t wpr,
                            void* stream) {
  return unpack_cb<double>(cb, words, scal, out, rows, d, wpr, stream);
}

int unpack_dequant_rows_f32(int cb, const void* words, const void* scal,
                            void* out, int64_t rows, int64_t d, int64_t wpr,
                            void* stream) {
  return unpack_cb<float>(cb, words, scal, out, rows, d, wpr, stream);
}

int packed_weighted_sum_f64(int cb, const void* words, const void* scal,
                            void* out, int64_t trials, int64_t n_dev,
                            int64_t d, int64_t wpr, void* stream) {
  return wsum_cb<double>(cb, words, scal, out, trials, n_dev, d, wpr, stream);
}

int packed_weighted_sum_f32(int cb, const void* words, const void* scal,
                            void* out, int64_t trials, int64_t n_dev,
                            int64_t d, int64_t wpr, void* stream) {
  return wsum_cb<float>(cb, words, scal, out, trials, n_dev, d, wpr, stream);
}

}  // extern "C"
