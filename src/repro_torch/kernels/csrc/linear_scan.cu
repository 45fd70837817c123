// First-order linear scan on Hopper: h_t = a_t * h_{t-1} + b_t.
//
// Replaces the Pallas TPU kernel src/repro/kernels/linear_scan.py
// linear_scan_fsl (body _kernel): the recurrence of every RG-LRU layer's
// prefill (recurrentgemma), over (B, S, D) in f32,
//
//   h_t[b, d] = a_t[b, d] * h_{t-1}[b, d] + b_t[b, d],   h_{-1} = h0[b, d]
//
// a, b, h_all: (B, S, D); h0, h_last: (B, D); all f32 and contiguous.
//
// Layout. Not the Pallas one: the TPU kernel transposes to (B*D/128, S,
// 128) feature blocks, walks S in chunks of 256 on a sequential grid axis
// with the carry in VMEM, and runs a Hillis-Steele scan inside each chunk.
// Hopper blocks run in no order, so no carry can cross blocks; instead one
// thread owns one (b, d) channel and walks S in order, and a block of 64
// threads covers 64 neighbouring channels of one batch row, so every load
// of a_t, b_t and store of h_t is coalesced along D. No padding of S or D.
// The loads do not depend on h: each thread reads the next U = 32 steps of
// a and b ahead of that stretch of the dependent chain, then runs it; a
// scalar loop takes the last S % U steps. This form (offsets from the
// restrict-qualified arguments, no predicate a step) ran faster on the
// card than walking pointers or predicating every step.
//
// Arithmetic. __fmul_rn then __fadd_rn: nvcc would contract a * h + b into
// an FMA, which rounds once, while the plain PyTorch version
// (kernels/ref.py linear_scan_ref) rounds the product and the sum apart;
// with the intrinsics the two agree bit for bit on the card.
//
// Bound. One read of a and b and one write of h_all (12 bytes a step and
// channel) plus h0 and h_last; two flops a step. At recurrentgemma-2b's
// prefill shape (4, 2560, 2560) that is 314.6 MB, a byte bound of
// 0.094 ms at 3.35 TB/s. This first design is bound by the latency of
// each channel's sequential chain and of its loads, not by bytes: that
// shape has only 10,240 channels (160 blocks of 64 threads on 132 SMs).
// It is kept because it is simple and right; a chunked parallel scan
// (several threads a channel, a carry pass between chunks) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int U = 32;          // steps of a and b loaded ahead of the chain

__global__ void __launch_bounds__(THREADS)
linear_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ h0, float* __restrict__ h_all,
                   float* __restrict__ h_last, int64_t S, int64_t D) {
  const int64_t bi = blockIdx.y;
  const int64_t d = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (d >= D) return;
  float h = h0[bi * D + d];
  int64_t off = bi * S * D + d;        // of step t of this channel
  int64_t t = 0;
  for (; t + U <= S; t += U, off += U * D) {
    float av[U], bv[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {      // issued before the chain needs them
      av[k] = a[off + k * D];
      bv[k] = b[off + k * D];
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      h = __fadd_rn(__fmul_rn(av[k], h), bv[k]);
      h_all[off + k * D] = h;
    }
  }
  for (; t < S; ++t, off += D) {       // the last S % U steps
    h = __fadd_rn(__fmul_rn(a[off], h), b[off]);
    h_all[off] = h;
  }
  h_last[bi * D + d] = h;
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch; cudaErrorInvalidValue for an
// empty sequence or a grid the card cannot launch.
int linear_scan_f32(const void* a, const void* b, const void* h0,
                    void* h_all, void* h_last, int64_t B, int64_t S,
                    int64_t D, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1
      || (D + THREADS - 1) / THREADS > 2147483647)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((D + THREADS - 1) / THREADS), (unsigned)B);
  linear_scan_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)h0, (float*)h_all,
      (float*)h_last, S, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
