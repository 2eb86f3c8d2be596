// The RG-LRU recurrence of the hybrid family's recurrent blocks
// (Griffin / recurrentgemma), float32, for Hopper (sm_90a):
//
//   h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) * bx_t,
//   a_t = exp(a_log_t),
//
// over a_log, bx [B, T, W] float32 from h0 [B, W]; writes every h_t to
// out [B, T, W]. A step with a_log 0 and bx 0 (a padded chunk step) is
// the identity.
//
// Replaces no TPU kernel: the JAX package computes this
// (src/repro/models/blocks.py, _rg_lru_scan) as one
// lax.associative_scan that XLA compiles, with no Pallas kernel. It is
// written by hand because the plain PyTorch loop over T launches a few
// kernels a step, in every recurrent layer, over every prompt (18
// layers x 2048 steps x ~4 launches for one recurrentgemma-2b prefill).
// The sequential order rounds differently from the associative scan,
// within float32's rounding of a contraction (|a| < 1).
//
// Bound on the H100: bytes. The function reads a_log and bx and writes
// out once, 12 bytes a (lane, step, channel), and does a handful of
// operations on each: at B 4, T 2048, W 2560 that is 252 MB, 75 us at
// 3.35 TB/s. Design: one thread per (lane, channel), sequential over T;
// a warp's loads at one step are 32 neighbouring channels (128 bytes,
// coalesced), and the loads and the gating of U steps are issued before
// the U dependent updates, so they run ahead of the recurrence. 64
// threads a block spread B * W / 64 blocks over the SMs (160 at B 4,
// W 2560).
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int U = 8;  // steps whose loads are issued ahead of their updates

__device__ __forceinline__ float gated(float al, float x, float &a) {
  a = expf(al);
  return sqrtf(fmaxf(1.f - a * a, 1e-12f)) * x;
}

__global__ void __launch_bounds__(THREADS)
rg_lru_scan_kernel(const float *__restrict__ a_log, const float *__restrict__ bx,
                   const float *__restrict__ h0, float *__restrict__ out, int T,
                   int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const long base = (long)b * T * W + w;
  float h = h0[(long)b * W + w];
  int t = 0;
  for (; t + U <= T; t += U) {
    float a[U], g[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long i = base + (long)(t + u) * W;
      g[u] = gated(__ldg(a_log + i), __ldg(bx + i), a[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h = a[u] * h + g[u];
      out[base + (long)(t + u) * W] = h;
    }
  }
  for (; t < T; ++t) {
    const long i = base + (long)t * W;
    float a;
    const float g = gated(__ldg(a_log + i), __ldg(bx + i), a);
    h = a * h + g;
    out[i] = h;
  }
}

}  // namespace

// a_log, bx, out float32 [B, T, W]; h0 float32 [B, W]; all contiguous.
// Returns a cudaError_t.
extern "C" int rg_lru_scan_launch(const void *a_log, const void *bx,
                                  const void *h0, void *out, int B, int T,
                                  int W, void *stream) {
  if (B <= 0 || T <= 0 || W <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  rg_lru_scan_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float *)a_log, (const float *)bx, (const float *)h0, (float *)out,
      T, W);
  return (int)cudaGetLastError();
}
