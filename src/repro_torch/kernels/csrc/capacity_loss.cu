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
// Backward: no exp per (t, i) pair. Rows are walked in blocks of
// K = 32 (t0 = 32 rb); for a block wholly after column i,
//
//   sum_j w_{t0+j} (t0+j-i) beta_i^(t0+j-i)
//     = beta_i^(t0-i) * ((t0-i) * A + Bq),
//   A = sum_j w_j beta_i^j,  Bq = sum_j w_j (j beta_i^j),
//
// so each thread (one column) keeps the power table beta_i^j and
// j beta_i^j (j < K) in registers, built once per column with one exp2
// each, and a pair costs two FMAs against the weight w_j, read as a
// float4 broadcast from shared memory; a block costs one exp2 more, its
// carry beta_i^(t0-i). The block on the diagonal (rows t0 <= t < t0 + K
// with t >= i) takes one exp2 per pair, 32 per column. The weights
// w_t = h(S_t - M)/(t + 1) of up to RCH rows at a time are staged in
// shared memory with a flag per block, set when any weight is non-zero:
// a block of rows all under budget is skipped on that broadcast, so a
// warp never diverges on it.
//
// Balance: the work of column tile ii (128 columns) is its rows from the
// diagonal to T, so a CTA takes tiles p and n - 1 - p together
// (bwd_plan in kernels/capacity_loss.py): every CTA holds about the same
// number of pairs. Its n_groups groups of 4 warps split each column's
// row blocks round-robin (block rb to group rb % n_groups), and the
// groups' partial sums meet in shared memory in a fixed order: no
// atomics, so the gradient is deterministic. At the main shape
// (B=1, H=8, T=4096) that is 8 x 16 CTAs of 16 warps, one per SM. The
// gradient is written straight into the gates' [B, T, H] layout.
//
// Bound on the H100: float32 arithmetic, not the exps. The function
// needs no exp per (t, i) pair: beta_i^(t0+j-i) = beta_i^j *
// beta_i^(t0-i), so a block of k rows is the product of a power table
// beta_i^j (j < k) with one carry per (block, column) — one
// multiply-add per pair in the forward, two in the backward (a
// weight against beta_i^j and j beta_i^j), exps and table 1/k of
// that. At the main shape (B=1, H=8, T=4096) that is 67.1 M pairs,
// 134 M FLOPs forward and up to 268 M backward: 2.0 and 4.0 us at
// 67 TFLOP/s. The bytes (lb and S, 131 KB each) are negligible.
//
// What it leaves on the table: the forward still takes one expf per
// pair, one row per thread, and its longest rows set its time (the next
// redesign); the backward's 4 warps of a group read the same weights
// from shared memory, and its CTAs' warps start at different diagonals.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;  // the forward's rows per CTA

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

// the backward: columns per tile (4 warps, one column per thread), rows
// per block (a warp's 32 columns span one block, so a warp's diagonal is
// one block), rows of weights staged at a time, and groups per CTA
constexpr int COLS = 128;
constexpr int K = 32;
constexpr int RCH = 4096;
constexpr int MAX_GROUPS = 4;
constexpr float LOG2E = 1.4426950408889634f;

__global__ void __launch_bounds__(COLS * MAX_GROUPS, 1)
capacity_bwd_kernel(const float *__restrict__ lb, const float *__restrict__ S,
                    const float *__restrict__ g, float *__restrict__ dlb,
                    int H, int T, float M, float inv_n) {
  __shared__ __align__(16) float w_s[RCH];  // row weights of the chunk
  __shared__ int nz_s[RCH / K];             // a block has a weight != 0
  __shared__ float part_s[MAX_GROUPS][2][COLS];
  const int n_tiles = (T + COLS - 1) / COLS, nrb = (T + K - 1) / K;
  const int item = blockIdx.x, bh = blockIdx.y;
  const int n_groups = blockDim.x / COLS, nth = blockDim.x;
  const int tid = threadIdx.x, grp = tid / COLS, c = tid % COLS;
  const int w = c / 32, lane = c % 32;
  const float *lb_row = lb + (long)bh * T, *S_row = S + (long)bh * T;

  for (int half = 0; half < 2; ++half) {
    // tiles item and n_tiles - 1 - item: a long and a short column tile
    const int ii = half == 0 ? item : n_tiles - 1 - item;
    if (half == 1 && ii == item) break;
    const int i = ii * COLS + c, wt = ii * (COLS / K) + w;
    const float lb2 = i < T ? lb_row[i] * LOG2E : 0.f;
    float pw[K], qw[K];  // beta_i^j and j beta_i^j
#pragma unroll
    for (int j = 0; j < K; ++j) {
      pw[j] = exp2f((float)j * lb2);
      qw[j] = (float)j * pw[j];
    }
    float acc = 0.f;
    for (int r0 = ii * COLS; r0 < T; r0 += RCH) {
      __syncthreads();  // every group is done with the last chunk
      const int n_st = min(RCH, (T - r0 + K - 1) / K * K);  // whole blocks
      for (int e = tid; e < n_st; e += nth) {
        const int t = r0 + e;
        float wt_ = 0.f;
        if (t < T) {
          const float x = S_row[t] - M;
          const float h = x > 0.f ? 1.f : (x == 0.f ? 0.5f : 0.f);
          wt_ = h * (1.f / (float)(t + 1));
        }
        w_s[e] = wt_;
        // a warp stages one block of K rows
        const int any = __any_sync(0xffffffffu, wt_ != 0.f);
        if ((tid & 31) == 0) nz_s[e / K] = any;
      }
      __syncthreads();
      const int rb0 = r0 / K, rb1 = min(nrb, (r0 + RCH) / K);
      int rb = max(wt, rb0);
      rb += ((grp - rb) % n_groups + n_groups) % n_groups;  // rb % n_groups == grp
      for (; rb < rb1; rb += n_groups) {
        if (!nz_s[rb - rb0]) continue;  // every row of the block under budget
        const float *wb = w_s + (rb - rb0) * K;
        if (rb == wt) {
          // the diagonal block: rows t = t0 + j >= i, i.e. j >= lane
          float x = 0.f;
#pragma unroll
          for (int j = 0; j < K; ++j) {
            if (j >= lane) {
              const float d = (float)(j - lane);
              x = fmaf(wb[j] * d, exp2f(d * lb2), x);
            }
          }
          acc += x;
        } else {
          float a = 0.f, bq = 0.f;
#pragma unroll
          for (int j = 0; j < K; j += 4) {
            const float4 w4 = *reinterpret_cast<const float4 *>(wb + j);
            a = fmaf(w4.x, pw[j], a);
            bq = fmaf(w4.x, qw[j], bq);
            a = fmaf(w4.y, pw[j + 1], a);
            bq = fmaf(w4.y, qw[j + 1], bq);
            a = fmaf(w4.z, pw[j + 2], a);
            bq = fmaf(w4.z, qw[j + 2], bq);
            a = fmaf(w4.w, pw[j + 3], a);
            bq = fmaf(w4.w, qw[j + 3], bq);
          }
          const float d0 = (float)(rb * K - i);  // t0 - i > 0
          acc = fmaf(exp2f(d0 * lb2), fmaf(d0, a, bq), acc);
        }
      }
    }
    part_s[grp][half][c] = acc;
  }
  __syncthreads();
  if (grp == 0) {
    const int b = bh / H, h = bh % H;
    for (int half = 0; half < 2; ++half) {
      const int ii = half == 0 ? item : n_tiles - 1 - item;
      if (half == 1 && ii == item) break;
      const int i = ii * COLS + c;
      float x = 0.f;
      for (int q = 0; q < n_groups; ++q) x += part_s[q][half][c];  // fixed order
      if (i < T) dlb[((long)b * T + i) * H + h] = (*g * inv_n) * x;
    }
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
                                        int T, int n_items, int n_groups,
                                        float M, void *stream) {
  const int BH = B * H;
  const int n_tiles = (T + COLS - 1) / COLS;
  if (BH <= 0 || BH > 65535 || T <= 0 || n_items != (n_tiles + 1) / 2 ||
      n_groups < 1 || n_groups > MAX_GROUPS)
    return (int)cudaErrorInvalidValue;
  dim3 grid(n_items, BH), block(COLS * n_groups);
  const float inv_n = 1.f / ((float)BH * (float)T);
  capacity_bwd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float *)lb, (const float *)S, (const float *)g, (float *)dlb, H,
      T, M, inv_n);
  return (int)cudaGetLastError();
}
