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
// Arithmetic. __fmul_rn then __fadd_rn: nvcc would contract a * h + b into
// an FMA, which rounds once, while the plain PyTorch version
// (kernels/ref.py linear_scan_ref) rounds the product and the sum apart;
// with the intrinsics the two agree bit for bit on the card. Each channel
// walks S in order. A chunked parallel scan (composing the affine maps of
// a chunk, then a carry pass) would round differently and lose that
// bit-equality; it would also buy nothing here: recurrentgemma-2b's
// prefill has 10,240 independent channels, and what the card lacks is
// bytes in flight, not parallelism along S.
//
// Bound. One read of a and b and one write of h_all (12 bytes a step and
// channel) plus h0 and h_last; two flops a step. At recurrentgemma-2b's
// prefill shape (4, 2560, 2560) that is 314.6 MB, a byte bound of
// 0.0939 ms at 3.35 TB/s; the chain itself (a multiply then an add, ~8
// cycles a step) takes ~12 us for 2,560 steps. The kernel is bound by the
// bytes the card keeps in flight: at ~1.5 us of latency under load, 3.35
// TB/s needs ~5 MB in flight, ~38 KB an SM.
//
// Design. Not the Pallas layout (feature blocks of 128 walked in S chunks
// on a sequential grid axis with a Hillis-Steele scan inside each): one
// thread owns one (b, d) channel, a block of CH = 32 threads covers
// neighbouring channels of one batch row, so each step's loads and store
// are one coalesced line. Each thread stages its own channel's a and b in
// a shared-memory ring of R = 8 tiles of T = 32 steps with 4-byte
// cp.async (any D, no alignment needed; TMA would want row strides that
// are multiples of 16 bytes), keeping the copies of the next R - 1 tiles
// (~57 KB a block) in flight while its chain runs on the current one;
// h_t goes straight to device memory. A thread reads back only what it
// copied itself, so cp.async.wait_group is all the ordering it needs: the
// block never synchronises, and a lane past D leaves at once. Of six
// tilings timed on the card (PERF.md) this was the fastest; 16-channel
// blocks, which issue half lines, were the slowest.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CH = 32;                 // channels (threads) a block
constexpr int T = 32;                  // steps a tile (one ring stage)
constexpr int R = 8;                   // tiles in the ring
constexpr size_t BYTES = 2 * sizeof(float) * (size_t)R * T * CH;
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

__global__ void __launch_bounds__(CH)
linear_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ h0, float* __restrict__ h_all,
                   float* __restrict__ h_last, int S, int64_t D) {
  extern __shared__ float smem[];    // a: [R][T][CH], then b: [R][T][CH]
  const int lane = threadIdx.x;
  const int64_t bi = blockIdx.y;
  const int64_t d = (int64_t)blockIdx.x * CH + lane;
  if (d >= D) return;                // no barrier below: safe to leave
  float* s_a = smem + lane;
  float* s_b = smem + R * T * CH + lane;
  const int64_t base = bi * S * D + d;
  const int ntiles = (S + T - 1) / T;

  auto stage = [&](int tile) {       // issue the copies of one tile
    if (tile < ntiles) {
      const int t0 = tile * T;
      const int steps = S - t0 < T ? S - t0 : T;
      float* da = s_a + (tile % R) * T * CH;
      float* db = s_b + (tile % R) * T * CH;
      const float* ga = a + base + (int64_t)t0 * D;
      const float* gb = b + base + (int64_t)t0 * D;
      if (steps == T) {
#pragma unroll
        for (int i = 0; i < T; ++i) {
          cp_async4(da + i * CH, ga + i * D);
          cp_async4(db + i * CH, gb + i * D);
        }
      } else {
        for (int i = 0; i < steps; ++i) {
          cp_async4(da + i * CH, ga + i * D);
          cp_async4(db + i * CH, gb + i * D);
        }
      }
    }
    cp_async_commit();               // empty past the end: counts stay even
  };

#pragma unroll
  for (int k = 0; k < R - 1; ++k) stage(k);
  float h = h0[bi * D + d];
  float* out = h_all + base;
  for (int k = 0; k < ntiles; ++k, out += T * D) {
    stage(k + R - 1);                // into the slot tile k - 1 has left
    cp_async_wait<R - 1>();          // tile k has landed
    const float* ra = s_a + (k % R) * T * CH;
    const float* rb = s_b + (k % R) * T * CH;
    const int steps = S - k * T < T ? S - k * T : T;
    if (steps == T) {
#pragma unroll
      for (int i = 0; i < T; ++i) {
        h = __fadd_rn(__fmul_rn(ra[i * CH], h), rb[i * CH]);
        out[i * D] = h;
      }
    } else {
      for (int i = 0; i < steps; ++i) {
        h = __fadd_rn(__fmul_rn(ra[i * CH], h), rb[i * CH]);
        out[i * D] = h;
      }
    }
  }
  cp_async_wait<0>();
  h_last[bi * D + d] = h;
}

// The kernel's 64 KB of dynamic shared memory is above the default 48 KB
// limit, which belongs to each device's context: raised once a device,
// the raise's cudaError_t kept and returned on every later launch there.
int raise_smem_limit() {
  static std::atomic<int> state[MAX_DEVICES];  // 0 not yet, else 1 + error
  int dev;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const auto raise = [] {
    return (int)cudaFuncSetAttribute(
        linear_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)BYTES);
  };
  if (dev >= MAX_DEVICES) return raise();
  int s = state[dev].load(std::memory_order_acquire);
  if (s == 0) {
    s = 1 + raise();
    state[dev].store(s, std::memory_order_release);
  }
  return s - 1;
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (or of raising the kernel's shared
// memory limit); cudaErrorInvalidValue for S outside 1..2^31 - T or a grid
// the card cannot launch.
int linear_scan_f32(const void* a, const void* b, const void* h0,
                    void* h_all, void* h_last, int64_t B, int64_t S,
                    int64_t D, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || S > 2147483647 - T || D < 1
      || (D + CH - 1) / CH > 2147483647)
    return (int)cudaErrorInvalidValue;
  const int err = raise_smem_limit();
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((D + CH - 1) / CH), (unsigned)B);
  linear_scan_kernel<<<grid, CH, BYTES, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)h0, (float*)h_all,
      (float*)h_last, (int)S, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
