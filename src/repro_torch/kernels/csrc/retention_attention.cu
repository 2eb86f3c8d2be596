// Retention-gated causal flash attention in float32, for Hopper
// (sm_90a): the float32 route (bf16 runs retention_attention_tc.cu).
//
// Replaces the Pallas TPU kernel `retention_attention_pallas`
// (src/repro/kernels/retention_attention.py, body `_flash_kernel`) for
// float32 tensors: attention of q [B, Tq, Hq, D] over k, v
// [B, Tk, Hkv, D] with GQA, an optional causal mask and window measured
// from the absolute query position q_offset + row, and an optional
// retention bias (q_pos - i) * log_beta_i added to the logits of
// visible keys (log_beta [B, Tk, Hkv] float32). A float32 model's
// single-shot prefill runs it causal with no bias.
//
// Design: one CTA per (lane, q head, tile of 16 queries). The key
// tiles it walks are cut to those the causal mask and window leave
// visible to its rows, so the upper triangle is never loaded. Rows
// whose keys are all masked give zero (the Pallas kernel returns the
// mean of the masked values there; no caller produces such a row).
//
// Bound on the H100: operations. At the main-path shape (B=4, T=2000,
// Hq=32, D=128, causal) the visible pairs need
// 4 * B * Hq * D * T (T + 1) / 2 ~ 131 GFLOP, about 2.0 ms at
// 67 TF/s float32 outside the tensor cores; the 2 * 4 * 2000 * 8 *
// 128 * 4 B = 66 MB of K/V and 262 MB of q and out take about 0.1 ms.
//
// What the simple design leaves on the table: Q.K and P.V are FMAs
// out of shared memory with tiles of 16 x 32, and K/V are re-read by
// every q tile of every head in the group with scalar loads and a
// barrier per tile.
#include "flash_tile.cuh"

using namespace flash;

struct RetentionMask {
  int causal, window, use_beta;
  __device__ bool operator()(const Smem &sm, int i, int j, float &bias) const {
    int kp = sm.kpos[j];
    int dist = sm.qpos[i] - kp;
    bool ok = kp >= 0 && (!causal || dist >= 0) && (window <= 0 || dist < window);
    bias = (ok && use_beta) ? (float)dist * sm.lb[j] : 0.f;
    return ok;
  }
};

__global__ void __launch_bounds__(NT)
retention_kernel(const float *__restrict__ q, const float *__restrict__ k,
                 const float *__restrict__ v,
                 const float *__restrict__ log_beta, float *__restrict__ out, int Tq, int Tk, int Hq, int Hkv, int D,
                 int causal, int window, int q_offset, float scale) {
  extern __shared__ float smem_f[];
  const int n_qt = (Tq + TQ - 1) / TQ;
  Smem sm = Smem::carve(smem_f, D, 0);
  const int qt = blockIdx.x % n_qt;
  const int h = (blockIdx.x / n_qt) % Hq;
  const int b = blockIdx.x / (n_qt * Hq);
  const int kvh = h / (Hq / Hkv);
  const int r0 = qt * TQ;
  const int nrows = min(TQ, Tq - r0);

  load_rows(sm.q, D + 1, q + (((long)b * Tq + r0) * Hq + h) * D, (long)Hq * D,
            TQ, nrows, D);
  if (threadIdx.x < TQ) sm.qpos[threadIdx.x] = q_offset + r0 + threadIdx.x;
  init_rows(sm);
  float acc[TQ][2];
#pragma unroll
  for (int i = 0; i < TQ; ++i) acc[i][0] = acc[i][1] = 0.f;
  const RetentionMask mask{causal, window, log_beta != nullptr};

  // key range the rows of this tile can see
  const int q_lo = q_offset + r0, q_hi = q_offset + r0 + nrows - 1;
  int j_end = Tk;
  if (causal) j_end = min(j_end, q_hi + 1);
  int j_begin = 0;
  if (window > 0) j_begin = max(0, q_lo - window + 1);
  for (int j0 = (j_begin / TK) * TK; j0 < j_end; j0 += TK) {
    const int valid = min(TK, Tk - j0);
    if (threadIdx.x < TK) {
      const int j = j0 + threadIdx.x;
      sm.kpos[threadIdx.x] = threadIdx.x < valid ? j : -1;
      sm.lb[threadIdx.x] =
          (log_beta != nullptr && threadIdx.x < valid)
              ? log_beta[((long)b * Tk + j) * Hkv + kvh] : 0.f;
    }
    const long row0 = (((long)b * Tk + j0) * Hkv + kvh) * D;
    load_rows(sm.k, D + 1, k + row0, (long)Hkv * D, TK, valid, D);
    load_rows(sm.v, D, v + row0, (long)Hkv * D, TK, valid, D);
    __syncthreads();
    tile_step(sm, D, nrows, scale, mask, acc);
  }
  store_rows(sm, D, nrows, acc, out + (((long)b * Tq + r0) * Hq + h) * D,
             (long)Hq * D);
}

extern "C" int retention_attention_launch(
    const void *q, const void *k, const void *v, const void *log_beta,
    void *out, int B, int Tq, int Tk, int Hq, int Hkv, int D, int causal,
    int window, int q_offset, void *stream) {
  if (D > MAX_D || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  const int n_qt = (Tq + TQ - 1) / TQ;
  const size_t smem = Smem::bytes(D, 0);
  const float scale = 1.0f / sqrtf((float)D);
  cudaError_t err = allow_smem((const void *)retention_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  retention_kernel<<<B * Hq * n_qt, NT, smem, (cudaStream_t)stream>>>(
      (const float *)q, (const float *)k, (const float *)v,
      (const float *)log_beta, (float *)out, Tq, Tk, Hq, Hkv, D, causal,
      window, q_offset, scale);
  return (int)cudaGetLastError();
}
