// Capacity loss L_cap (paper Eq. 5) and its gradient, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `capacity_loss_pallas`
// (src/repro/kernels/capacity_loss.py, body `_cap_kernel`), and adds the
// backward that the Pallas kernel lacks: the JAX package trains through
// the autodiff of `capacity_loss_chunked(..., log_beta=...)`
// (src/repro/core/losses.py); this file computes that same gradient in
// closed form. Both kernels read lb = log beta as float32 in a [B*H, T]
// layout (the wrapper's transpose of the gates' [B, T, H]).
//
//   S[bh, t]  = sum_{i <= t} exp((t - i) * lb[bh, i])
//   L_cap     = 1/(B*H*T) * sum_{bh, t} max(S[bh, t] - M, 0) / (t + 1)
//   dL/dlb_i  = g/(B*H*T) * sum_{t >= i} h(S_t - M)/(t + 1)
//                                      * (t - i) * exp((t - i) * lb_i)
//
// with h(x) = 1 above 0, 0.5 at 0 (the tie rule of jnp.maximum, which
// the JAX gradient follows) and 0 below.
//
// Forward: one CTA per (bh, tile of 128 rows t), one row per thread. The
// CTA walks the lb tiles from 0 to its diagonal, each staged in shared
// memory and read as a broadcast; tiles above the diagonal are never
// visited, and on the diagonal a row stops at i = t, so the upper
// triangle is masked before any exp is taken. Each tile's 128 terms are
// summed on their own before they join the row's sum: adding ~4096
// terms near 1 one by one into one float32 loses each term's distance
// from 1 once the sum passes 2048 (1.3e-5 relative at the main shape),
// two levels keep it near 1e-7. It writes S (the saved
// residual, [B*H, T] float32) and the tile's sum of the hinge terms;
// the wrapper adds the partial sums and divides by B*H*T, with no
// atomics, so the loss is deterministic. Heavy tiles (near the end of
// the sequence) are launched first.
//
// Backward: one CTA per (bh, tile of 128 columns i), one column per
// thread. The CTA walks the row tiles t from its diagonal to T, staging
// the row weights h(S_t - M)/(t + 1) in shared memory. A tile whose
// weights are all zero (every row under budget) is skipped, and so is
// each zero-weight row: the test is on a broadcast value, so a warp
// never diverges on it. The gradient is written straight into the
// gates' [B, T, H] layout.
//
// Bound on the H100: float32 arithmetic, not the exps. The function
// needs no exp per (t, i) pair: beta_i^(t0+j-i) = beta_i^j *
// beta_i^(t0-i), so a block of k rows is the product of a power table
// beta_i^j (j < k) with one carry per (block, column) — one
// multiply-add per pair in the forward, two in the backward (the
// weights w_t and j * w_t against the same powers), exps and table 1/k
// of that. At the main shape (B=1, H=8, T=4096) that is 67.1 M pairs,
// 134 M FLOPs forward and up to 268 M backward: 2.0 and 4.0 us at
// 67 TFLOP/s. The bytes (lb and S, 131 KB each) are negligible.
//
// What the simple design leaves on the table: it takes one expf per
// pair (a MUFU.EX2 and a range reduction of a few FMAs, about a dozen
// instructions where the power table needs one); a row's terms are summed by
// one thread, so the longest row (T terms in sequence) sets the CTA's
// time and the triangle gives CTAs unequal work. Register-blocking k
// rows per thread on a running product (one exp, then k multiplies and
// adds; float32 error ~k ulp), and splitting long rows across warps,
// would close most of the gap.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;  // rows (forward) or columns (backward) per CTA

__device__ __forceinline__ float block_sum(float v, float *red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < TILE / 32; ++w) s += red[w];  // fixed order
  return s;
}

__global__ void __launch_bounds__(TILE)
capacity_fwd_kernel(const float *__restrict__ lb, float *__restrict__ S,
                    float *__restrict__ partial, int T, float M) {
  __shared__ float lb_s[TILE];
  __shared__ float red[TILE / 32];
  const int n_tiles = gridDim.x;
  const int ti = n_tiles - 1 - blockIdx.x;  // heavy tiles first
  const int bh = blockIdx.y;
  const float *row = lb + (long)bh * T;
  const int t = ti * TILE + threadIdx.x;
  float s = 0.f;
  for (int ii = 0; ii <= ti; ++ii) {
    const int i = ii * TILE + threadIdx.x;
    lb_s[threadIdx.x] = i < T ? row[i] : 0.f;
    __syncthreads();
    // (t - i) for j = 0; exact in float32 for t < 2^24
    const float d0 = (float)(t - ii * TILE);
    // the diagonal tile stops at i = t: the mask comes before the exp
    const int jn = ii < ti ? TILE : threadIdx.x + 1;
    float ts = 0.f;  // the tile's own sum, then one add into s
    for (int j = 0; j < jn; ++j) ts += expf((d0 - (float)j) * lb_s[j]);
    s += ts;
    __syncthreads();
  }
  float contrib = 0.f;
  if (t < T) {
    S[(long)bh * T + t] = s;
    contrib = fmaxf(s - M, 0.f) * (1.f / (float)(t + 1));
  }
  const float tot = block_sum(contrib, red);
  if (threadIdx.x == 0) partial[(long)bh * n_tiles + ti] = tot;
}

__global__ void __launch_bounds__(TILE)
capacity_bwd_kernel(const float *__restrict__ lb, const float *__restrict__ S,
                    const float *__restrict__ g, float *__restrict__ dlb,
                    int H, int T, float M, float inv_n) {
  __shared__ float w_s[TILE];
  const int n_tiles = gridDim.x;
  const int ii = blockIdx.x;  // heavy tiles (early columns) first
  const int bh = blockIdx.y;
  const int i = ii * TILE + threadIdx.x;
  const float lbi = i < T ? lb[(long)bh * T + i] : 0.f;
  float acc = 0.f;
  for (int tt = ii; tt < n_tiles; ++tt) {
    const int t = tt * TILE + threadIdx.x;
    float w = 0.f;
    if (t < T) {
      const float x = S[(long)bh * T + t] - M;
      const float h = x > 0.f ? 1.f : (x == 0.f ? 0.5f : 0.f);
      w = h * (1.f / (float)(t + 1));
    }
    w_s[threadIdx.x] = w;
    if (!__syncthreads_or(w != 0.f)) continue;  // every row under budget
    // (t - i) for j = 0; rows with t < i (j < threadIdx.x on the diagonal)
    // are skipped before the exp
    const float d0 = (float)(tt * TILE - i);
    float ta = 0.f;  // the tile's own sum, then one add into acc
    for (int j = tt == ii ? threadIdx.x : 0; j < TILE; ++j) {
      const float wj = w_s[j];
      if (wj != 0.f) {
        const float d = d0 + (float)j;
        ta += wj * d * expf(d * lbi);
      }
    }
    acc += ta;
    __syncthreads();
  }
  if (i < T) {
    const int b = bh / H, h = bh % H;
    dlb[((long)b * T + i) * H + h] = (*g * inv_n) * acc;
  }
}

}  // namespace

extern "C" int capacity_loss_fwd_launch(const void *lb, void *S, void *partial,
                                        int BH, int T, float M, void *stream) {
  if (BH <= 0 || BH > 65535 || T <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((T + TILE - 1) / TILE, BH), block(TILE);
  capacity_fwd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float *)lb, (float *)S, (float *)partial, T, M);
  return (int)cudaGetLastError();
}

extern "C" int capacity_loss_bwd_launch(const void *lb, const void *S,
                                        const void *g, void *dlb, int B, int H,
                                        int T, float M, void *stream) {
  const int BH = B * H;
  if (BH <= 0 || BH > 65535 || T <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((T + TILE - 1) / TILE, BH), block(TILE);
  const float inv_n = 1.f / ((float)BH * (float)T);
  capacity_bwd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float *)lb, (const float *)S, (const float *)g, (float *)dlb, H,
      T, M, inv_n);
  return (int)cudaGetLastError();
}
