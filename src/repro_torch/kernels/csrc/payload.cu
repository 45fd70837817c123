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
// reference's contract (payload.py:17-28, 233-237).
//
// Bound: bytes. Pack reads g and u (12 or 8 bytes an entry) and writes
// CB/8; unpack reads CB/8 and writes 8 or 4; the weighted sum reads N words
// per K outputs and writes one float per output. Design of pack and
// unpack: one thread per packed word, so a word is read or written once;
// neighbouring threads own neighbouring lanes, so every read and write of
// g, u, the words and the output is coalesced. blockIdx.y walks rows (or
// trials), grid-stride past 65535; the tail past d is masked, not padded
// in memory.
//
// Design of the weighted sum. A thread owns WV = 2 neighbouring words of
// one trial (one 8-byte load a device; rows of words are whole lane-rows of
// 128, so a pair never straddles one) and keeps their 2 K sums in
// registers across all devices. Two words a thread, not four with 16-byte
// loads: at Fig. 3's shape (4 trials x 37,120 words) that doubles the
// warps an SM has to hide the latency of the staging and the loads, and it
// was the faster on the card (PERF.md, scripts/compare_uplink.py). The
// block first stages its trial's devices in shared memory, one device a
// thread, and keeps only those that add something, in index order (a warp
// ballot and a prefix over warps): a device whose every term w * v is +-0
// -- out of the round (w = 0) with finite values, or a row that does not
// quantize (v = 0) under a finite weight -- is skipped. That is exact: acc
// starts at +0.0 and is only ever added to under round-to-nearest, so it
// is never -0.0, and adding +-0.0 leaves it as it was, bit for bit. Then
// each thread walks the kept devices in order with the words of the next
// DEPTH = 4 devices already loaded into registers, so the loads of a
// trial's devices are in flight together instead of one memory latency a
// device. In f64 half the codes become doubles from their bits, 2^52 + q
// less 2^52 (exact for every code, on the FP64 pipe), and half by I2F.F64,
// which runs at a quarter of that rate on a unit of its own; in f32 I2F.F32
// was as fast or faster than the 2^23 + q analogue. More devices than a
// block has threads are staged chunk by chunk, every thread reaching each
// barrier. Words whose address is not 8-byte aligned (a contiguous view may
// start anywhere) are read one at a time.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 128;
constexpr int THREADS = 256;
constexpr int WSUM_THREADS = 64;  // the weighted sum's block
constexpr int WV = 2;              // words a thread: one 8-byte load a device
                                  // (4, for scripts/compare_uplink.py's variant)
constexpr int DEPTH = 4;          // devices whose words are in flight

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

// A code q < 2^CB as a double, exactly, on the FP64 pipe: the bits of
// 2^52 + q, less 2^52.
__device__ __forceinline__ double code_from_bits(uint32_t q) {
  return __dsub_rn(__hiloint2double(0x43300000, (int)q), 4503599627370496.0);
}

struct Words {
  uint32_t w[WV];
};

// WV words at p in one load where p is aligned to their size, else one
// at a time.
template <bool ALIGNED>
__device__ __forceinline__ Words load_words(const uint32_t* __restrict__ p) {
  Words out;
  if constexpr (ALIGNED && WV == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    out.w[0] = v.x;
    out.w[1] = v.y;
  } else if constexpr (ALIGNED && WV == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    out.w[0] = v.x;
    out.w[1] = v.y;
    out.w[2] = v.z;
    out.w[3] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < WV; ++q) out.w[q] = p[q];
  }
  return out;
}

// acc[q][k] = acc[q][k] + w * (-m + safe * code_k(word_q)) for one device.
// In f64 every other code converts by I2F.F64 and the rest from their
// bits, so the conversion unit and the FP64 pipe share the work: on the
// card that was faster than either alone. Both are exact.
template <typename T, int CB>
__device__ __forceinline__ void add_device(T (&acc)[WV][32 / CB],
                                           const Words& words, T nm, T safe,
                                           T w) {
  constexpr int K = 32 / CB;
  constexpr uint32_t MASK = (1u << CB) - 1u;
#pragma unroll
  for (int q = 0; q < WV; ++q) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t code = (words.w[q] >> (k * CB)) & MASK;
      const T c = sizeof(T) == 4 || (q * K + k) % 2 ? T(code)
                                                    : T(code_from_bits(code));
      acc[q][k] = add_rn(acc[q][k], mul_rn(w, add_rn(nm, mul_rn(safe, c))));
    }
  }
}

// The devices of chunk [c0, c0 + blockDim.x) of one trial that add
// something, in index order: their -m, safe, w and word offset to
// s_nm/s_safe/s_w/s_off. A row that does not quantize but carries a
// non-finite weight is kept with -m = safe = 0, so that its v = +0.0 as
// the plain version's, and w * v is the same NaN. Returns how many; every
// thread of the block calls it.
template <typename T, int CB>
__device__ __forceinline__ int stage_devices(
    const T* __restrict__ st, int64_t c0, int64_t n_dev, int64_t wpr,
    T* s_nm, T* s_safe, T* s_w, int64_t* s_off, int* s_count) {
  constexpr uint32_t MASK = (1u << CB) - 1u;
  const int64_t i = c0 + threadIdx.x;
  bool live = false;
  T nm = T(0), safe = T(0), w = T(0);
  if (i < n_dev) {
    const T m = st[3 * i], levels = st[3 * i + 1];
    w = st[3 * i + 2];
    const bool valid = row_step(m, levels, &safe);
    // silent: every term is +-0 (w finite and v = 0, or w = 0 and every
    // value -m + safe * q finite for q up to the largest code)
    const bool silent = valid ? (w == T(0) && isfinite(mul_rn(safe, T(MASK))))
                              : isfinite(w);
    live = !silent;
    if (valid) {
      nm = -m;
    } else {
      safe = T(0);
    }
  }
  const unsigned mask = __ballot_sync(0xffffffffu, live);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_count[warp] = __popc(mask);
  __syncthreads();             // the counts, and no thread reads the last chunk
  int before = 0, total = 0;
  for (int k = 0; k < WSUM_THREADS / 32; ++k) {
    const int c = s_count[k];
    before += k < warp ? c : 0;
    total += c;
  }
  if (live) {
    const int at = before + __popc(mask & ((1u << lane) - 1u));
    s_nm[at] = nm;
    s_safe[at] = safe;
    s_w[at] = w;
    s_off[at] = i * wpr;
  }
  __syncthreads();
  return total;
}

// The kept devices 0..n-1 of a chunk, in order, into acc; wj is this
// thread's first word in device 0 of its trial. The words of the next
// DEPTH devices are loaded before the current one is added.
template <typename T, int CB, bool ALIGNED>
__device__ __forceinline__ void add_devices(
    T (&acc)[WV][32 / CB], const uint32_t* __restrict__ wj, int n,
    const T* s_nm, const T* s_safe, const T* s_w, const int64_t* s_off) {
  Words buf[DEPTH];
#pragma unroll
  for (int p = 0; p < DEPTH; ++p)
    if (p < n) buf[p] = load_words<ALIGNED>(wj + s_off[p]);
  int i = 0;
  for (; i + DEPTH <= n; i += DEPTH) {
#pragma unroll
    for (int p = 0; p < DEPTH; ++p) {
      const Words cur = buf[p];
      if (i + p + DEPTH < n)
        buf[p] = load_words<ALIGNED>(wj + s_off[i + p + DEPTH]);
      add_device<T, CB>(acc, cur, s_nm[i + p], s_safe[i + p], s_w[i + p]);
    }
  }
#pragma unroll
  for (int p = 0; p < DEPTH - 1; ++p)
    if (i + p < n)
      add_device<T, CB>(acc, buf[p], s_nm[i + p], s_safe[i + p],
                        s_w[i + p]);
}

// The outputs of words l..l+WV-1 at one k: WV consecutive entries of the
// row (left of them inside d), stored 16 bytes (8 for two floats) at a time
// where aligned.
template <typename T>
__device__ __forceinline__ void store_run(T* __restrict__ p, const T (&v)[WV],
                                          int64_t left) {
  constexpr int STEP = sizeof(T) * WV < 16 ? WV : 16 / sizeof(T);
  if (left >= WV && ((uintptr_t)p & (sizeof(T) * STEP - 1)) == 0) {
#pragma unroll
    for (int q = 0; q < WV; q += STEP) {
      if constexpr (sizeof(T) == 8) {
        *reinterpret_cast<double2*>(p + q) = make_double2(v[q], v[q + 1]);
      } else if constexpr (STEP == 4) {
        *reinterpret_cast<float4*>(p + q) =
            make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
      } else {
        *reinterpret_cast<float2*>(p + q) = make_float2(v[q], v[q + 1]);
      }
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < WV; ++q)
    if (q < left) p[q] = v[q];
}

// blockIdx.y walks trials; blockIdx.x and the passes walk groups of WV
// words. Block-uniform control: every barrier is reached by all threads.
template <typename T, int CB, bool ALIGNED>
__global__ void __launch_bounds__(WSUM_THREADS)
packed_weighted_sum_kernel(const uint32_t* __restrict__ words,
                           const T* __restrict__ scal, T* __restrict__ out,
                           int64_t trials, int64_t n_dev, int64_t d,
                           int64_t wpr) {
  constexpr int K = 32 / CB;
  __shared__ T s_nm[WSUM_THREADS], s_safe[WSUM_THREADS], s_w[WSUM_THREADS];
  __shared__ int64_t s_off[WSUM_THREADS];
  __shared__ int s_count[WSUM_THREADS / 32];
  const int64_t groups = wpr / WV;
  const int64_t gstride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = blockIdx.y; t < trials; t += gridDim.y) {
    const T* st = scal + t * n_dev * 3;
    const uint32_t* wt = words + t * n_dev * wpr;
    T* outt = out + t * d;
    int kept = 0;
    bool staged = false;
    for (int64_t g0 = (int64_t)blockIdx.x * blockDim.x; g0 < groups;
         g0 += gstride) {
      const int64_t gi = g0 + threadIdx.x;
      const bool active = gi < groups;
      T acc[WV][K];
#pragma unroll
      for (int q = 0; q < WV; ++q)
#pragma unroll
        for (int k = 0; k < K; ++k) acc[q][k] = T(0);
      for (int64_t c0 = 0; c0 < n_dev; c0 += WSUM_THREADS) {
        // one chunk: staged once a trial and kept across passes
        if (!staged || n_dev > WSUM_THREADS) {
          kept = stage_devices<T, CB>(st, c0, n_dev, wpr, s_nm, s_safe, s_w,
                                      s_off, s_count);
          staged = true;
        }
        if (active)
          add_devices<T, CB, ALIGNED>(acc, wt + gi * WV, kept, s_nm, s_safe,
                                      s_w, s_off);
      }
      if (active) {
        const int64_t j = gi * WV;
        const int64_t base = (j / LANES) * K * LANES + (j % LANES);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int64_t e = base + (int64_t)k * LANES;
          T v[WV];
#pragma unroll
          for (int q = 0; q < WV; ++q) v[q] = acc[q][k];
          if (e < d) store_run(outt + e, v, d - e);
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
  int64_t bx = (wpr / WV + WSUM_THREADS - 1) / WSUM_THREADS;
  if (bx > 65535) bx = 65535;
  const dim3 grid((unsigned)bx, (unsigned)(trials < 65535 ? trials : 65535));
  if (((uintptr_t)words & (sizeof(uint32_t) * WV - 1)) == 0)
    packed_weighted_sum_kernel<T, CB, true>
        <<<grid, WSUM_THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)words, (const T*)scal, (T*)out, trials, n_dev,
            d, wpr);
  else
    packed_weighted_sum_kernel<T, CB, false>
        <<<grid, WSUM_THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)words, (const T*)scal, (T*)out, trials, n_dev,
            d, wpr);
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
