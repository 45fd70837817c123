// Fused Mamba-1 selective scan on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/selective_scan.py
// selective_scan_bfsn (body _kernel): the recurrence of every Mamba layer's
// prefill, with the C-projection fused, so that nothing of size
// (S, D, n) is ever stored: per channel d of batch row b,
//
//   h_t[j] = exp(dt_t * A[d, j]) * h_{t-1}[j] + (dt_t * B_t[j]) * x_t
//   y_t    = sum_j h_t[j] * C_t[j]          (j = 0, 1, ..., n - 1 in order)
//
// dt, x, y: (B, S, D); B, C: (B, S, n); A: (D, n); h0, h_last: (B, D, n);
// all f32 and contiguous, n <= 16.
//
// Layout. Not the Pallas block layout: no (B, F, S, 128) transpose and no
// padding of S or D. One thread owns one (b, d) channel and keeps its n
// states and its row of A in registers; a block of 128 threads covers 128
// neighbouring channels of one batch row, so the loads of dt_t and x_t and
// the store of y_t are coalesced along D. The block stages B_t and C_t for
// TILE steps at a time in shared memory (every thread of the block reads
// the same n values a step), then walks those steps in order.
//
// Arithmetic. Every product and sum is an _rn intrinsic (nvcc cannot
// contract them into an FMA) and exp is the accurate expf (no __expf, no
// --use_fast_math), so the plain PyTorch version (kernels/ref.py
// selective_scan_ref) repeats it op for op and the two agree bit for bit
// on the card. The b-term is (dt * B) * x, as the reference's jnp oracle
// and model routes compute it (the Pallas kernel computes (dt * x) * B).
//
// Bound. The bytes are one read of dt and x and one write of y (B*S*D
// floats each) plus the small B, C, A, h0 and h_last; the operations are
// B*S*D*n expf and about 6 flops each. At the falcon-mamba prefill shape
// (4, 512, 8192, 16) both bounds are near 0.06 ms; this first design walks
// S in order with one thread per channel (256 blocks of 128 threads), so
// it is bound by the latency of the sequential chain, not by either. A
// parallel scan over S or several threads per channel is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int TILE = 64;       // steps of B_t, C_t staged at a time

template <int N>
__global__ void __launch_bounds__(THREADS)
selective_scan_kernel(const float* __restrict__ dt,
                      const float* __restrict__ x,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ a_w,
                      const float* __restrict__ h0,
                      float* __restrict__ y,
                      float* __restrict__ h_last,
                      int64_t S, int64_t D) {
  __shared__ float s_b[TILE * N];
  __shared__ float s_c[TILE * N];
  const int64_t b = blockIdx.y;
  const int64_t d = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const bool live = d < D;

  float a[N], h[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    a[j] = live ? a_w[d * N + j] : 0.f;
    h[j] = live ? h0[(b * D + d) * N + j] : 0.f;
  }
  const float* dt_b = dt + b * S * D + d;
  const float* x_b = x + b * S * D + d;
  float* y_b = y + b * S * D + d;
  const float* bm_b = bm + b * S * N;
  const float* cm_b = cm + b * S * N;

  for (int64_t t0 = 0; t0 < S; t0 += TILE) {
    const int steps = (int)(S - t0 < TILE ? S - t0 : TILE);
    __syncthreads();             // the previous tile is read by everyone
    for (int i = threadIdx.x; i < steps * N; i += THREADS) {
      s_b[i] = bm_b[t0 * N + i];
      s_c[i] = cm_b[t0 * N + i];
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int k = 0; k < steps; ++k) {
      const int64_t off = (t0 + k) * D;
      const float dtv = dt_b[off];
      const float xv = x_b[off];
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float da = expf(__fmul_rn(dtv, a[j]));
        const float db = __fmul_rn(__fmul_rn(dtv, s_b[k * N + j]), xv);
        h[j] = __fadd_rn(__fmul_rn(da, h[j]), db);
        const float p = __fmul_rn(h[j], s_c[k * N + j]);
        acc = j == 0 ? p : __fadd_rn(acc, p);
      }
      y_b[off] = acc;
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < N; ++j) h_last[(b * D + d) * N + j] = h[j];
  }
}

template <int N>
int launch(const float* dt, const float* x, const float* bm, const float* cm,
           const float* a_w, const float* h0, float* y, float* h_last,
           int64_t B, int64_t S, int64_t D, cudaStream_t stream) {
  const dim3 grid((unsigned)((D + THREADS - 1) / THREADS), (unsigned)B);
  selective_scan_kernel<N><<<grid, THREADS, 0, stream>>>(
      dt, x, bm, cm, a_w, h0, y, h_last, S, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch; cudaErrorInvalidValue for a
// state size outside 1..16 or a grid the card cannot launch.
int selective_scan_f32(const void* dt, const void* x, const void* bm,
                       const void* cm, const void* a_w, const void* h0,
                       void* y, void* h_last, int64_t B, int64_t S,
                       int64_t D, int64_t n, void* stream) {
  if (B < 1 || B > 65535 || D < 1 || (D + THREADS - 1) / THREADS > 2147483647
      || S < 1)
    return (int)cudaErrorInvalidValue;
  const float *dt_ = (const float*)dt, *x_ = (const float*)x,
              *bm_ = (const float*)bm, *cm_ = (const float*)cm,
              *a_ = (const float*)a_w, *h0_ = (const float*)h0;
  float *y_ = (float*)y, *hl_ = (float*)h_last;
  cudaStream_t st = (cudaStream_t)stream;
#define SCAN_CASE(NN)                                                     \
  case NN:                                                                \
    return launch<NN>(dt_, x_, bm_, cm_, a_, h0_, y_, hl_, B, S, D, st);
  switch (n) {
    SCAN_CASE(1) SCAN_CASE(2) SCAN_CASE(3) SCAN_CASE(4)
    SCAN_CASE(5) SCAN_CASE(6) SCAN_CASE(7) SCAN_CASE(8)
    SCAN_CASE(9) SCAN_CASE(10) SCAN_CASE(11) SCAN_CASE(12)
    SCAN_CASE(13) SCAN_CASE(14) SCAN_CASE(15) SCAN_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SCAN_CASE
}

}  // extern "C"
