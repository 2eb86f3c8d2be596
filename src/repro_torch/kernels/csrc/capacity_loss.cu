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
// Forward: no exp per (t, i) pair off the diagonal. Rows are walked in
// blocks of K = 32 (t0 = 32 rb); for a block wholly after column i,
//
//   S_{t0+j} gets beta_i^(t0+j-i) = C[rb, i] * P[i, j],
//   C[rb, i] = beta_i^(t0-i) (the carry),  P[i, j] = beta_i^j (j < K),
//
// so a column tile's share of S over a block is a small product,
// out[rb, j] = sum_i C[rb, i] P[i, j], and a pair costs one FMA. A CTA
// owns column tiles (128 columns) and walks every row block at or below
// their diagonal: it builds the table P of its columns once (one exp2
// per entry, in shared memory), and for each column block of 32 columns
// stages the carries of its row blocks (one exp2 per (block, column),
// each from its own exponent, not a running product, so the error does
// not grow with the distance) and multiplies: each thread holds a
// micro-tile of 4 row blocks x 4 rows j, read as float4 broadcasts, and
// two groups of threads take two column blocks each, their sums meeting
// in shared memory in a fixed order (17 warps at the main shape). The
// first 4 row blocks of a tile hold its diagonal: a block above its
// column block has carry 0 (masked before the exp: (t0 - i) < 0 there,
// and exp2 of it could be inf), and the block on the diagonal (rows
// t0 <= t < t0 + K, t >= i) takes one exp2 per pair, summed once per
// CTA and added after the product. A column past T has carry 0 and no
// diagonal term (its lb is not 0, which would be beta = 1).
//
// Balance: column tile ii holds T - 128 ii rows, so a CTA takes tiles p
// and n - 1 - p together (fwd_plan in kernels/capacity_loss.py): n + 1
// micro-rows of 4 row blocks each, the same for every CTA; where the
// plan has few CTAs (few rows b*h) it splits a CTA's micro-rows over
// n_split CTAs. Each CTA writes its tiles' partial rows of S into a
// [B*H, n, Tp] scratch (tile ii only from row 128 ii; Tp = T rounded up
// to 4, so a thread writes its 4 rows as one float4). A second launch
// adds the partials of each row over its tiles in a fixed order (8
// warps take tiles v, v + 8, ..., then their sums add in warp order)
// and writes S (the saved residual, [B*H, T] float32) and the hinge
// terms' sum per 32 rows; the wrapper adds those and divides by B*H*T.
// No atomics: S and the loss are bit-identical on every launch.
// Summing within a tile (<= 128 terms), then across tiles (<= T/128
// partials) keeps the error near 1e-7: one flat float32 sum of ~4096
// terms near 1 loses each term's distance from 1 once it passes 2048
// (1.3e-5 relative at the main shape). With beta = 1 exactly, every
// term is exp2f(0) = 1 and every sum an exact integer: S_t = t + 1.
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
// What it leaves on the table: the forward's product reads two float4
// from shared memory per 16 FMAs, so shared memory, not the FMA pipe,
// bounds it (a 4 x 8 micro-tile spilled at 640 threads); its second
// launch and its [B*H, n, Tp] scratch (4 MB at the main shape, read
// back from L2); the backward's 4 warps of a group read the same
// weights from shared memory, and its CTAs' warps start at different
// diagonals.
#include <cuda_runtime.h>

namespace {

// columns per tile, rows per row block, row blocks per micro-row (a
// thread's rows of the product), threads across a block's K rows (4
// each), the most micro-rows a CTA takes at a time
constexpr int COLS = 128;
constexpr int K = 32;
constexpr int RB = 4;
constexpr int JT = K / 4;
constexpr int FWD_MAX_ROWS = 40;
constexpr float LOG2E = 1.4426950408889634f;

// shared memory of the forward, in floats: the tables P [2][COLS][K],
// the diagonal blocks' sums D [2][RB][K], lb * log2(e) [2][COLS], then
// each group's carries of one column block [2][K][RB * n_rows] (after
// the product, group 1's sums)
constexpr int FWD_FIXED = 2 * COLS * K + 2 * RB * K + 2 * COLS;

__global__ void __launch_bounds__(2 * JT * FWD_MAX_ROWS)
capacity_fwd_kernel(const float *__restrict__ lb, float *__restrict__ part,
                    int T, int Tp, int n_split) {
  extern __shared__ __align__(16) float smem[];
  float *P = smem, *D = P + 2 * COLS * K, *L2 = D + 2 * RB * K;
  const int tid = threadIdx.x, nth = blockDim.x, ng = nth / 2;
  const int n_rows = ng / JT, nq = RB * n_rows;
  const int n_tiles = (T + COLS - 1) / COLS;
  const int item = blockIdx.x / n_split, split = blockIdx.x % n_split;
  const int bh = blockIdx.y;
  // the CTA's column tiles: item (long) and n - 1 - item (short); its
  // list of micro-rows is tile ta's n - ta, then tile tb's n - tb
  const int ta = item, tb = n_tiles - 1 - item;
  const int halves = tb == ta ? 1 : 2;
  const int len0 = n_tiles - ta, len = len0 + (halves == 2 ? item + 1 : 0);
  const float *row = lb + (long)bh * T;

  for (int e = tid; e < 2 * COLS; e += nth) {
    const int i = (e < COLS ? ta : tb) * COLS + e % COLS;
    L2[e] = e / COLS < halves && i < T ? row[i] * LOG2E : 0.f;
  }
  __syncthreads();
  // the power tables, one exp2 per entry, once per CTA
  for (int e = tid; e < 2 * COLS * K; e += nth)
    P[e] = exp2f((float)(e % K) * L2[e / K]);
  // the diagonal blocks: rows t = 32 (4 ii + r) + j of columns
  // i = 32 (4 ii + r) + lane, lane <= j, one exp2 per pair
  for (int e = tid; e < 2 * RB * K; e += nth) {
    const int h = e / (RB * K), r = e / K % RB, j = e % K;
    const int i0 = (h ? tb : ta) * COLS + r * K;
    const float *l = L2 + h * COLS + r * K;
    float x = 0.f;
    for (int lane = 0; lane <= j && i0 + lane < T; ++lane)
      x += exp2f((float)(j - lane) * l[lane]);
    D[e] = x;
  }

  // two groups of ng threads: group kg takes column blocks 2 kg and
  // 2 kg + 1 of every row block, and its sums meet the other group's in
  // shared memory. Staging: thread tg of a group computes the carries of
  // row block q of the round, for columns c0, c0 + 2, ... (ng = 2 nq),
  // with all its lb loaded before the first store, so its 16 exp2
  // overlap. Product: thread-row ty takes micro-row ty of the round,
  // rows j of its blocks 4 tx .. 4 tx + 3.
  const int kg = tid / ng, tg = tid % ng;
  const int q = tg % nq, c0 = tg / nq, ty = tg / JT, tx = tg % JT;
  float *C = smem + FWD_FIXED + kg * K * nq;
  float *R = smem + FWD_FIXED;  // after the product: group 1's sums
  for (int g0 = split * n_rows; g0 < len; g0 += n_rows * n_split) {
    const int gq = g0 + q / RB, r = q % RB;
    const int hq = gq < len0 ? 0 : 1, mq = gq - hq * len0;
    const int iq = (hq ? tb : ta) * COLS, rbq = RB * (iq / COLS + mq) + r;
    const int g = g0 + ty, h = g < len0 ? 0 : 1, m = g - h * len0;
    const int ii = h ? tb : ta;
    float acc[RB][4] = {};
    for (int s = 0; s < 2; ++s) {
      const int w = 2 * kg + s;
      float lv[K / 2];
#pragma unroll
      for (int k = 0; k < K / 2; ++k)
        lv[k] = L2[hq * COLS + w * K + c0 + 2 * k];
      __syncthreads();  // the carries (or sums) before these are read
#pragma unroll
      for (int k = 0; k < K / 2; ++k) {
        const int c = c0 + 2 * k, i = iq + w * K + c;
        float cv = 0.f;
        // whole blocks below column block w only: mask before the exp
        if (gq < len && (mq > 0 || w < r) && i < T)
          cv = exp2f((float)(rbq * K - i) * lv[k]);
        C[c * nq + q] = cv;
      }
      __syncthreads();
      const float *Pw = P + (h * COLS + w * K) * K + 4 * tx;
      const float *Cw = C + RB * ty;
#pragma unroll 16  // fully unrolled, ptxas spills at the 640-thread bound
      for (int c = 0; c < K; ++c) {
        const float4 cv = *reinterpret_cast<const float4 *>(Cw + c * nq);
        const float4 pv = *reinterpret_cast<const float4 *>(Pw + c * K);
        const float cr[RB] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int rr = 0; rr < RB; ++rr) {
          acc[rr][0] = fmaf(cr[rr], pv.x, acc[rr][0]);
          acc[rr][1] = fmaf(cr[rr], pv.y, acc[rr][1]);
          acc[rr][2] = fmaf(cr[rr], pv.z, acc[rr][2]);
          acc[rr][3] = fmaf(cr[rr], pv.w, acc[rr][3]);
        }
      }
    }
    __syncthreads();  // every group is done with its carries
    if (kg == 1) {
#pragma unroll
      for (int e = 0; e < RB * 4; ++e) R[e * ng + tg] = acc[e / 4][e % 4];
    }
    __syncthreads();
    if (kg == 0 && g < len) {
      float *out = part + ((long)bh * n_tiles + ii) * Tp;
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) {
        const int t0 = (RB * (ii + m) + rr) * K + 4 * tx;
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // column blocks 0-1, then 2-3, then the diagonal block's sum
          x[e] = acc[rr][e] + R[(rr * 4 + e) * ng + tg];
          if (m == 0) x[e] += D[(h * RB + rr) * K + 4 * tx + e];
        }
        // a row of part is Tp >= t0 + 4 floats (Tp a multiple of 4)
        if (t0 < T)
          *reinterpret_cast<float4 *>(out + t0) =
              make_float4(x[0], x[1], x[2], x[3]);
      }
    }
  }
}

// the sum pass: one CTA per (bh, 32 rows t), 8 warps; warp v adds the
// partials of tiles v, v + 8, ... of its row, then warp 0 adds the 8
// sums in order, writes S and the rows' hinge terms' sum
constexpr int SUM_ROWS = 32;
constexpr int SUM_WARPS = 8;

__global__ void __launch_bounds__(SUM_ROWS * SUM_WARPS)
capacity_fwd_sum_kernel(const float *__restrict__ part, float *__restrict__ S,
                        float *__restrict__ partial, int T, int Tp, float M) {
  __shared__ float red[SUM_WARPS][SUM_ROWS];
  const int n_tiles = (T + COLS - 1) / COLS, bh = blockIdx.y;
  const int lane = threadIdx.x % SUM_ROWS, v = threadIdx.x / SUM_ROWS;
  const int t = blockIdx.x * SUM_ROWS + lane;
  const int last = blockIdx.x * SUM_ROWS / COLS;  // t / COLS, for every t
  const float *p = part + (long)bh * n_tiles * Tp + t;
  float s = 0.f;
  if (t < T)
    for (int ii = v; ii <= last; ii += SUM_WARPS) s += p[(long)ii * Tp];
  red[v][lane] = s;
  __syncthreads();
  if (v != 0) return;
  float x = 0.f;
#pragma unroll
  for (int u = 0; u < SUM_WARPS; ++u) x += red[u][lane];  // fixed order
  float contrib = 0.f;
  if (t < T) {
    S[(long)bh * T + t] = x;
    contrib = fmaxf(x - M, 0.f) * (1.f / (float)(t + 1));
  }
  for (int o = 16; o > 0; o >>= 1)
    contrib += __shfl_down_sync(0xffffffffu, contrib, o);
  if (lane == 0) partial[(long)bh * gridDim.x + blockIdx.x] = contrib;
}

// the backward: a column tile is 4 warps, one column per thread (a
// warp's 32 columns span one row block, so a warp's diagonal is one
// block); rows of weights staged at a time, and groups per CTA
constexpr int RCH = 4096;
constexpr int MAX_GROUPS = 4;

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

extern "C" int capacity_loss_fwd_launch(const void *lb, void *S, void *part,
                                        void *partial, int BH, int T,
                                        int n_items, int n_split, int n_rows,
                                        float M, void *stream) {
  const int n_tiles = (T + COLS - 1) / COLS;
  const int Tp = (T + 3) / 4 * 4;  // part's row stride
  if (BH <= 0 || BH > 65535 || T <= 0 || n_items != (n_tiles + 1) / 2 ||
      n_split < 1 || n_rows < 1 || n_rows > FWD_MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  const int smem = (FWD_FIXED + 2 * K * RB * n_rows) * (int)sizeof(float);
  static bool attr_set = false;
  if (!attr_set) {
    const int most =
        (FWD_FIXED + 2 * K * RB * FWD_MAX_ROWS) * (int)sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        capacity_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        most);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  capacity_fwd_kernel<<<dim3(n_items * n_split, BH), 2 * JT * n_rows, smem,
                        (cudaStream_t)stream>>>((const float *)lb,
                                                (float *)part, T, Tp, n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  capacity_fwd_sum_kernel<<<dim3((T + SUM_ROWS - 1) / SUM_ROWS, BH),
                            SUM_ROWS * SUM_WARPS, 0, (cudaStream_t)stream>>>(
      (const float *)part, (float *)S, (float *)partial, T, Tp, M);
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
