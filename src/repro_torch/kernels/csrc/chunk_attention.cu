// Flash chunk-query attention over (slot cache ∪ chunk) in float32,
// for Hopper (sm_90a): the float32 route (bf16 runs
// chunk_attention_tc.cu).
//
// Replaces the Pallas TPU kernel `chunk_attention_pallas`
// (src/repro/kernels/chunk_attention.py, body `_chunk_kernel`) for
// float32 tensors: the C queries of a prefill chunk attend over the M
// cache slots (per-head cache_pos, -1 empty) and then causally over
// the chunk's own keys, which come as a separate operand. A key is
// visible iff its position is >= 0 and 0 <= q_pos - k_pos (< window
// when windowed); padded queries (chunk_pos = -1) see nothing and give
// zero. Optional normalized probabilities over the cache slots, per q
// head [B, Hq, C, M]; the wrapper averages them over each GQA group.
//
// Design: one CTA per (lane, q head, tile of 16 queries). It walks the
// cache tiles, then the chunk tiles, 32 keys at a time
// (flash_tile.cuh); a tile with no visible (query, key) pair — empty
// slots, keys after the last query — is skipped before its K/V are
// loaded.
//
// Bound on the H100: operations. At the main-path shape (B=4, C=512,
// Hq=32, Hkv=8, M=512, D=128) a full cache and a causal chunk give
// 4 * B * Hq * D * C * (M + (C + 1) / 2) ~ 25.8 GFLOP per call, about
// 0.38 ms at 67 TF/s float32 outside the tensor cores; the ~101 MB it
// must move take 30 us.
//
// What the simple design leaves on the table: Q.K and P.V run as FMAs
// out of shared memory, so the kernel is bound by shared-memory
// bandwidth; each of the C / 16 q tiles of a head re-reads the whole
// cache and chunk (from L2), and loads are scalar with a barrier per
// tile instead of a TMA ring.
#include "flash_tile.cuh"

using namespace flash;

__global__ void __launch_bounds__(NT)
chunk_kernel(const float *__restrict__ q, const float *__restrict__ k_c,
             const float *__restrict__ v_c, const float *__restrict__ cache_k,
             const float *__restrict__ cache_v,
             const int *__restrict__ cache_pos,
             const int *__restrict__ chunk_pos, float *__restrict__ out,
             float *__restrict__ probs, int C, int Hq, int Hkv, int M, int D,
             int window, float scale) {
  extern __shared__ float smem_f[];
  const int n_qt = (C + TQ - 1) / TQ;
  const int n_mt = (M + TK - 1) / TK;
  const int n_ct = (C + TK - 1) / TK;
  const bool want_probs = probs != nullptr;
  Smem sm = Smem::carve(smem_f, D, want_probs ? n_mt : 0);
  const int qt = blockIdx.x % n_qt;
  const int h = (blockIdx.x / n_qt) % Hq;
  const int b = blockIdx.x / (n_qt * Hq);
  const int kvh = h / (Hq / Hkv);
  const int c0 = qt * TQ;
  const int nrows = min(TQ, C - c0);
  const int *cpos_b = chunk_pos + (long)b * C;

  // q rows: q[b, c0 + i, h, :]
  load_rows(sm.q, D + 1, q + (((long)b * C + c0) * Hq + h) * D, (long)Hq * D,
            TQ, nrows, D);
  if (threadIdx.x < TQ)
    sm.qpos[threadIdx.x] = threadIdx.x < nrows ? cpos_b[c0 + threadIdx.x] : -1;
  init_rows(sm);
  float acc[TQ][2];
#pragma unroll
  for (int i = 0; i < TQ; ++i) acc[i][0] = acc[i][1] = 0.f;
  const PosMask mask{window};

  // cache tiles
  const long bh = (long)b * Hkv + kvh;
  float *probs_base = want_probs ? probs + (((long)b * Hq + h) * C + c0) * M
                                 : nullptr;
  for (int tile = 0; tile < n_mt; ++tile) {
    const int m0 = tile * TK;
    const int valid = min(TK, M - m0);
    if (threadIdx.x < TK)
      sm.kpos[threadIdx.x] =
          threadIdx.x < valid ? cache_pos[bh * M + m0 + threadIdx.x] : -1;
    __syncthreads();
    const bool visible = tile_visible(sm, nrows, mask);
    if (visible) {
      load_rows(sm.k, D + 1, cache_k + (bh * M + m0) * D, D, TK, valid, D);
      load_rows(sm.v, D, cache_v + (bh * M + m0) * D, D, TK, valid, D);
      __syncthreads();
      tile_step(sm, D, nrows, scale, mask, acc);
    }
    if (want_probs)
      store_raw_probs(sm, nrows, visible, probs_base, M, m0, M, tile, n_mt);
  }

  // chunk tiles: keys k_c[b, j, kvh, :]
  for (int tile = 0; tile < n_ct; ++tile) {
    const int j0 = tile * TK;
    const int valid = min(TK, C - j0);
    if (threadIdx.x < TK)
      sm.kpos[threadIdx.x] = threadIdx.x < valid ? cpos_b[j0 + threadIdx.x] : -1;
    __syncthreads();
    if (tile_visible(sm, nrows, mask)) {
      const long row0 = (((long)b * C + j0) * Hkv + kvh) * D;
      load_rows(sm.k, D + 1, k_c + row0, (long)Hkv * D, TK, valid, D);
      load_rows(sm.v, D, v_c + row0, (long)Hkv * D, TK, valid, D);
      __syncthreads();
      tile_step(sm, D, nrows, scale, mask, acc);
    }
  }

  store_rows(sm, D, nrows, acc, out + (((long)b * C + c0) * Hq + h) * D,
             (long)Hq * D);
  if (want_probs) {
    __syncthreads();
    rescale_probs(sm, nrows, probs_base, M, M, n_mt);
  }
}

extern "C" int chunk_attention_launch(
    const void *q, const void *k_c, const void *v_c, const void *cache_k,
    const void *cache_v, const void *cache_pos, const void *chunk_pos,
    void *out, void *probs, int B, int C, int Hq, int Hkv, int M, int D,
    int window, void *stream) {
  if (D > MAX_D || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  const int n_qt = (C + TQ - 1) / TQ;
  const int n_mt = (M + TK - 1) / TK;
  const size_t smem = Smem::bytes(D, probs ? n_mt : 0);
  const float scale = 1.0f / sqrtf((float)D);
  cudaError_t err = allow_smem((const void *)chunk_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  chunk_kernel<<<B * Hq * n_qt, NT, smem, (cudaStream_t)stream>>>(
      (const float *)q, (const float *)k_c, (const float *)v_c,
      (const float *)cache_k, (const float *)cache_v, (const int *)cache_pos,
      (const int *)chunk_pos, (float *)out, (float *)probs, C, Hq, Hkv, M, D,
      window, scale);
  return (int)cudaGetLastError();
}
