// Flash-decode over the bounded slot cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `decode_attention_pallas`
// (src/repro/kernels/decode_attention.py, body `_decode_kernel`): one
// query token per (lane, q head) attends over the M-slot cache
// [B, Hkv, M, D] (slots with pos < 0 masked; optional window against
// the per-lane clock t [B]), with the in-flight token's (k, v) merged
// into the online softmax as a separate operand at distance 0 — visible
// even under a window — and optional normalized slot probabilities
// [B, Hq, M] and in-flight mass p_new [B, Hq].
//
// Design: one CTA per (lane, kv head) serves the whole query group, so
// each K/V byte is read from device memory once. The CTA walks M in
// tiles of 32 slots (flash_tile.cuh), skipping tiles with no visible
// slot, then merges the in-flight token. Probabilities are written raw
// per tile and rescaled at the end with the final (max, denominator).
//
// Bound on the H100: bytes. At the main-path shape (B=4, Hkv=8, M=512,
// D=128, bf16) the cache holds 8.4 MB of K/V, about 2.5 us at
// 3.35 TB/s; the arithmetic (4 * B * Hq * M * D = 33.5 MFLOP) is far
// below the tensor-core line.
//
// What the simple design leaves on the table: only B * Hkv = 32 CTAs
// run, on a quarter of the 132 SMs, each streaming its slab through
// scalar loads with a barrier per tile. Splitting M across CTAs with a
// second reduction pass, 16-byte vector loads and a cp.async/TMA ring
// would bring it toward the bandwidth bound.
#include "flash_tile.cuh"

using namespace flash;

template <typename T>
__global__ void __launch_bounds__(NT)
decode_kernel(const T *__restrict__ q, const T *__restrict__ kc,
              const T *__restrict__ vc, const int *__restrict__ pos,
              const int *__restrict__ t_lane, const T *__restrict__ k_new,
              const T *__restrict__ v_new, T *__restrict__ out,
              float *__restrict__ probs, float *__restrict__ p_new, int Hq,
              int Hkv, int M, int D, int window, float scale) {
  extern __shared__ float smem_f[];
  const int n_tiles = (M + TK - 1) / TK;
  const bool want_probs = probs != nullptr;
  Smem sm = Smem::carve(smem_f, D, want_probs ? n_tiles : 0);
  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;
  const int G = Hq / Hkv;
  const int h0 = kvh * G;                       // first q head of the group
  const long bh = (long)b * Hkv + kvh;
  const T *k_base = kc + bh * M * D;
  const T *v_base = vc + bh * M * D;
  const int *pos_base = pos + bh * M;
  float *probs_base = want_probs ? probs + ((long)b * Hq + h0) * M : nullptr;
  const int t = t_lane[b];

  load_rows(sm.q, D + 1, q + ((long)b * Hq + h0) * D, D, G, G, D);
  init_rows(sm);
  float acc[TQ][2];
#pragma unroll
  for (int i = 0; i < TQ; ++i) acc[i][0] = acc[i][1] = 0.f;
  const SlotMask mask{window, t};

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int m0 = tile * TK;
    const int valid = min(TK, M - m0);
    if (threadIdx.x < TK)
      sm.kpos[threadIdx.x] = threadIdx.x < valid ? pos_base[m0 + threadIdx.x] : -1;
    __syncthreads();
    const bool visible = tile_visible(sm, G, mask);
    if (visible) {
      load_rows(sm.k, D + 1, k_base + (long)m0 * D, D, TK, valid, D);
      load_rows(sm.v, D, v_base + (long)m0 * D, D, TK, valid, D);
      __syncthreads();
      tile_step(sm, D, G, scale, mask, acc);
    }
    if (want_probs)
      store_raw_probs(sm, G, visible, probs_base, M, m0, M, tile, n_tiles);
  }

  if (k_new != nullptr) {
    // in-flight token at distance 0: always visible
    load_rows(sm.k, D + 1, k_new + bh * D, D, 1, 1, D);
    load_rows(sm.v, D, v_new + bh * D, D, 1, 1, D);
    __syncthreads();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int g = warp; g < G; g += NT / 32) {
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s = fmaf(sm.q[g * (D + 1) + d], sm.k[d], s);
      s = warp_sum(s) * scale;
      if (lane == 0) {
        float m_fin = sm.m[g];
        float m2 = fmaxf(m_fin, s);
        float a = expf(m_fin - m2);
        float pn = expf(s - m2);
        float l = sm.l[g] * a + pn;
        sm.a[g] = a;
        sm.p[g] = pn;  // p is free after the last tile
        sm.l[g] = l;
        sm.m[g] = m2;
        if (p_new != nullptr) p_new[(long)b * Hq + h0 + g] = pn / fmaxf(l, 1e-30f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int dd = 0; dd < 2; ++dd) {
      int d = threadIdx.x + dd * NT;
      if (d < D) {
#pragma unroll
        for (int i = 0; i < TQ; ++i)
          if (i < G) acc[i][dd] = acc[i][dd] * sm.a[i] + sm.p[i] * sm.v[d];
      }
    }
  }
  store_rows(sm, D, G, acc, out + ((long)b * Hq + h0) * D, D);
  if (want_probs) {
    __syncthreads();
    rescale_probs(sm, G, probs_base, M, M, n_tiles);
  }
}

extern "C" int decode_attention_launch(
    int is_bf16, const void *q, const void *k_cache, const void *v_cache,
    const void *pos, const void *t, const void *k_new, const void *v_new,
    void *out, void *probs, void *p_new, int B, int Hq, int Hkv, int M,
    int D, int window, void *stream) {
  if (D > MAX_D || Hq % Hkv != 0 || Hq / Hkv > TQ) return (int)cudaErrorInvalidValue;
  const int n_tiles = (M + TK - 1) / TK;
  const size_t smem = Smem::bytes(D, probs ? n_tiles : 0);
  const float scale = 1.0f / sqrtf((float)D);
  dim3 grid(B * Hkv), block(NT);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (is_bf16) {
    using T = __nv_bfloat16;
    err = allow_smem((const void *)decode_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
    decode_kernel<T><<<grid, block, smem, st>>>(
        (const T *)q, (const T *)k_cache, (const T *)v_cache, (const int *)pos,
        (const int *)t, (const T *)k_new, (const T *)v_new, (T *)out,
        (float *)probs, (float *)p_new, Hq, Hkv, M, D, window, scale);
  } else {
    using T = float;
    err = allow_smem((const void *)decode_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
    decode_kernel<T><<<grid, block, smem, st>>>(
        (const T *)q, (const T *)k_cache, (const T *)v_cache, (const int *)pos,
        (const int *)t, (const T *)k_new, (const T *)v_new, (T *)out,
        (float *)probs, (float *)p_new, Hq, Hkv, M, D, window, scale);
  }
  return (int)cudaGetLastError();
}
