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
// Arithmetic. Every product and sum is an _rn intrinsic (nvcc cannot
// contract them into an FMA) and exp is the accurate expf (no __expf, no
// --use_fast_math), so the plain PyTorch version (kernels/ref.py
// selective_scan_ref) repeats it op for op and the two agree bit for bit
// on the card. The b-term is (dt * B) * x, as the reference's jnp oracle
// and model routes compute it (the Pallas kernel computes (dt * x) * B).
// Each recurrence runs in S order and y sums its n products in j order,
// so the design below changes where the work runs, never its rounding.
//
// Bounds. The bytes are one read of dt and x and one write of y (B*S*D
// floats each) plus the small B, C, A, h0 and h_last: at the
// falcon-mamba-7b prefill shape (4, 512, 8192, 16) 206.3 MB, 0.0616 ms at
// 3.35 TB/s. That is not the floor: bit-equality needs the accurate expf
// (8 instructions, one MUFU.EX2) and six un-fused products and sums for
// each (b, t, d, j). With the shared loads and the hand-over, the
// unrolled body of a full tile is 16.5 to 17.2 SASS instructions an
// element on sm_90a, one body for each role a warp takes (first, middle,
// last), and the tile loop's wait, barrier, copies and dispatch add at
// most 8.5 more (chip_smoke.py counts both with cuobjdump). On 268 M
// elements that is an issue-slot floor of roughly 0.13 to 0.21 ms at four
// warp-instructions a clock on 132 SMs at the SM clock read while the
// kernel runs (chip_smoke.py's issue_floor line). The kernel is bound by
// issue slots, and by the latency of each chain where too few warps are
// resident to hide it.
//
// Design. A block covers 32 neighbouring channels of one batch row (lane
// = channel, so every access of dt_t, x_t and y_t is one 128-byte line)
// with G = min(4, n) warps; warp g owns states [g*n/G, (g+1)*n/G) of
// those channels in registers, with its part of A.
// At the prefill shape that is 1,024 blocks of 4 warps, about 31 warps an
// SM to hide the chains' latency (one thread a channel gave 8).
//  * Staging: a ring of G + 2 stages in shared memory, each holding
//    T = 8 steps of dt, x (x 32 channels) and B, C (x n), filled with
//    4-byte cp.async; the copies of tile k + 2 are in flight while the
//    warps run tiles k - G + 1 .. k. B and C rows are padded to a
//    multiple of 4, so a warp reads its states with vector loads.
//  * The y sum: warp g runs tile k - g (a wavefront), adds its states'
//    products in j order onto the partial sum that warp g - 1 left for
//    the same step in shared memory (double-buffered by tile), and hands
//    its own on; warp 0 starts from -0.0 (-0.0 + p == p for every p), the
//    last warp stores y_t. One __syncthreads a tile orders the copies, the
//    partial sums and the reuse of ring slots.
// Lanes past D and steps past S are never copied; the former compute on
// stale values and store nothing, the latter are not run. Four warps and
// tiles of 8 steps were the fastest of seven tilings timed on the card
// (PERF.md), at batch 4 and at batch 1. The ring and the partial sums
// take at most 24 KB a block, under the default 48 KB limit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;
constexpr int WARPS = 4;               // warps a block, splitting the n states
constexpr int T = 8;                   // steps a tile (one ring stage)

template <int N>
struct Plan {
  static constexpr int G = N < WARPS ? N : WARPS;
  static constexpr int PER = (N + G - 1) / G;     // most states a warp owns
  static constexpr bool EVEN = N % G == 0;
  static constexpr int NP = (N + 3) / 4 * 4;      // padded row of B and C
  static constexpr int STAGES = G + 2;
  static constexpr int STAGE = 2 * T * LANES + 2 * T * NP;     // floats
  static constexpr int PART = (G - 1) * 2 * T * LANES;         // floats
  static constexpr size_t BYTES = 4 * (size_t)(STAGES * STAGE + PART);
  static_assert(BYTES <= 48 * 1024, "launches without raising the limit");
};

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

// PER values of a padded B or C row from shared memory, 16 or 8 bytes at a
// time where the warp's first state is aligned for it.
template <int N>
__device__ __forceinline__ void load_row(const float* p, float* v, int cnt) {
  using P = Plan<N>;
  if constexpr (P::EVEN && P::PER % 4 == 0) {
#pragma unroll
    for (int q = 0; q < P::PER / 4; ++q) {
      const float4 w = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = w.x; v[4 * q + 1] = w.y; v[4 * q + 2] = w.z;
      v[4 * q + 3] = w.w;
    }
  } else if constexpr (P::EVEN && P::PER % 2 == 0) {
#pragma unroll
    for (int q = 0; q < P::PER / 2; ++q) {
      const float2 w = reinterpret_cast<const float2*>(p)[q];
      v[2 * q] = w.x; v[2 * q + 1] = w.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < P::PER; ++j) v[j] = j < cnt ? p[j] : 0.f;
  }
}

// One warp's part of one tile: `steps` steps (all T where FULL, so that
// every shared-memory offset is an immediate) of its states, the partial
// sums read from the previous warp (-0.0 for the FIRST) and handed to the
// next one, or stored as y_t by the LAST.
template <int N, bool FIRST, bool LAST, bool FULL>
__device__ __forceinline__ void run_tile(
    const float* __restrict__ s, int lane, int lo, int cnt,
    const float (&a)[Plan<N>::PER], float (&h)[Plan<N>::PER],
    const float* __restrict__ pin, float* __restrict__ pout,
    float* __restrict__ y_t, int64_t D, bool live, int steps) {
  using P = Plan<N>;
  const float* s_dt = s + lane;
  const float* s_x = s_dt + T * LANES;
  const float* s_b = s + 2 * T * LANES + lo;
  const float* s_c = s_b + T * P::NP;
#pragma unroll
  for (int i = 0; i < T; ++i) {
    if (!FULL && i >= steps) break;
    const float dtv = s_dt[i * LANES];
    const float xv = s_x[i * LANES];
    float bj[P::PER], cj[P::PER];
    load_row<N>(s_b + i * P::NP, bj, cnt);
    load_row<N>(s_c + i * P::NP, cj, cnt);
    float acc = FIRST ? -0.0f : pin[i * LANES];
#pragma unroll
    for (int j = 0; j < P::PER; ++j) {
      if (P::EVEN || j < cnt) {
        const float da = expf(__fmul_rn(dtv, a[j]));
        const float db = __fmul_rn(__fmul_rn(dtv, bj[j]), xv);
        h[j] = __fadd_rn(__fmul_rn(da, h[j]), db);
        acc = __fadd_rn(acc, __fmul_rn(h[j], cj[j]));
      }
    }
    if (LAST) {
      if (live) *y_t = acc;
      y_t += D;
    } else {
      pout[i * LANES] = acc;
    }
  }
}

template <int N, bool FIRST, bool LAST>
__device__ __forceinline__ void run_warp(
    const float* s, int lane, int lo, int cnt,
    const float (&a)[Plan<N>::PER], float (&h)[Plan<N>::PER],
    const float* pin, float* pout, float* y_t, int64_t D, bool live,
    int steps) {
  if (steps == T)
    run_tile<N, FIRST, LAST, true>(s, lane, lo, cnt, a, h, pin, pout, y_t,
                                   D, live, T);
  else
    run_tile<N, FIRST, LAST, false>(s, lane, lo, cnt, a, h, pin, pout, y_t,
                                    D, live, steps);
}

template <int N>
__global__ void __launch_bounds__(WARPS * LANES)
selective_scan_kernel(const float* __restrict__ dt,
                      const float* __restrict__ x,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ a_w,
                      const float* __restrict__ h0,
                      float* __restrict__ y,
                      float* __restrict__ h_last,
                      int S, int64_t D) {
  using P = Plan<N>;
  constexpr int THREADS = P::G * LANES;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* part = smem + P::STAGES * P::STAGE;

  const int tid = threadIdx.x, lane = tid % LANES, g = tid / LANES;
  const int64_t b = blockIdx.y;
  const int64_t d0 = (int64_t)blockIdx.x * LANES;
  const int64_t d = d0 + lane;
  const bool live = d < D;
  const int lo = g * N / P::G;
  const int cnt = (g + 1) * N / P::G - lo;

  float a[P::PER], h[P::PER];
#pragma unroll
  for (int j = 0; j < P::PER; ++j) {
    const bool own = live && (P::EVEN || j < cnt);
    a[j] = own ? a_w[d * N + lo + j] : 0.f;
    h[j] = own ? h0[(b * D + d) * N + lo + j] : 0.f;
  }

  const int ntiles = (S + T - 1) / T;
  // thread (g, lane) copies rows g, g + G, ... of a tile's dt and x for
  // its lane's channel, and an even share of its B and C rows
  const float* dt_c = dt + b * S * D + d;
  const float* x_c = x + b * S * D + d;
  const int64_t step_g = (int64_t)P::G * D;
  auto stage = [&](int tile) {       // issue the copies of one tile
    if (tile < ntiles) {
      float* s = ring + (tile % P::STAGES) * P::STAGE;
      const int t0 = tile * T;
      const int steps = S - t0 < T ? S - t0 : T;
      if (live) {
        float* s_row = s + g * LANES + lane;
        int64_t off = (int64_t)(t0 + g) * D;
#pragma unroll
        for (int r = 0; r < (T + P::G - 1) / P::G; ++r, off += step_g) {
          if (g + r * P::G < steps) {
            cp_async4(s_row + r * P::G * LANES, dt_c + off);
            cp_async4(s_row + (T + r * P::G) * LANES, x_c + off);
          }
        }
      }
      const float* bm_t = bm + (b * S + t0) * N;
      const float* cm_t = cm + (b * S + t0) * N;
      float* s_bc = s + 2 * T * LANES;
      for (int e = tid; e < steps * N; e += THREADS) {
        const int i = e / N, j = e - i * N;
        cp_async4(s_bc + i * P::NP + j, bm_t + e);
        cp_async4(s_bc + (T + i) * P::NP + j, cm_t + e);
      }
    }
    cp_async_commit();               // empty past the end: counts stay even
  };

  stage(0);
  stage(1);
  for (int k = 0; k < ntiles + P::G - 1; ++k) {
    cp_async_wait<1>();              // tile k has landed (this thread's part)
    __syncthreads();                 // ... and everyone's; k - 1 is done
    stage(k + 2);                    // into the slot of tile k - G
    const int m = k - g;             // this warp's tile
    if (m < 0 || m >= ntiles) continue;
    const float* s = ring + (m % P::STAGES) * P::STAGE;
    const float* pin = part + ((g - 1) * 2 + (m & 1)) * T * LANES + lane;
    float* pout = part + (g * 2 + (m & 1)) * T * LANES + lane;
    const int steps = S - m * T < T ? S - m * T : T;
    float* y_t = y + (b * S + (int64_t)m * T) * D + d;
    if (P::G == 1)
      run_warp<N, true, true>(s, lane, lo, cnt, a, h, pin, pout, y_t, D,
                              live, steps);
    else if (g == 0)
      run_warp<N, true, false>(s, lane, lo, cnt, a, h, pin, pout, y_t, D,
                               live, steps);
    else if (g == P::G - 1)
      run_warp<N, false, true>(s, lane, lo, cnt, a, h, pin, pout, y_t, D,
                               live, steps);
    else
      run_warp<N, false, false>(s, lane, lo, cnt, a, h, pin, pout, y_t, D,
                                live, steps);
  }
  cp_async_wait<0>();
  if (live) {
#pragma unroll
    for (int j = 0; j < P::PER; ++j)
      if (P::EVEN || j < cnt) h_last[(b * D + d) * N + lo + j] = h[j];
  }
}

template <int N>
int launch(const float* dt, const float* x, const float* bm, const float* cm,
           const float* a_w, const float* h0, float* y, float* h_last,
           int64_t B, int64_t S, int64_t D, cudaStream_t stream) {
  using P = Plan<N>;
  const dim3 grid((unsigned)((D + LANES - 1) / LANES), (unsigned)B);
  selective_scan_kernel<N><<<grid, P::G * LANES, P::BYTES, stream>>>(
      dt, x, bm, cm, a_w, h0, y, h_last, (int)S, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch; cudaErrorInvalidValue for a
// state size outside 1..16, S outside 1..2^31 - T, or a grid the card
// cannot launch.
int selective_scan_f32(const void* dt, const void* x, const void* bm,
                       const void* cm, const void* a_w, const void* h0,
                       void* y, void* h_last, int64_t B, int64_t S,
                       int64_t D, int64_t n, void* stream) {
  if (B < 1 || B > 65535 || D < 1 || (D + LANES - 1) / LANES > 2147483647
      || S < 1 || S > 2147483647 - T)
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
