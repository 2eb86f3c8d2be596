// The register-blocked flash tile step of the float32 attention kernels
// on the CUDA cores (retention_attention.cu, chunk_attention.cu): full
// float32 FMAs, no TF32.
//
// A CTA of 256 threads holds BR = 128 query rows in shared memory, row
// r = (position r / G, q head r % G of the kv head's group), so each
// tile of BK = 64 keys is staged once for the whole group. Rows and
// keys are zero-padded to DP = 128 floats, padded by 4 so that a warp's
// float4 reads are conflict-free. A thread owns an 8 x 4 block of S
// (rows srg + 16 i, keys skg + 16 j) and an 8 x 8 block of O (rows
// 8 srg + i, dims 4 skg .. 4 skg + 3 and 64 + 4 skg ..), with
// srg = 2 warp + lane / 16 and skg = lane % 16. The online softmax stays
// in registers, in base 2 (logits times log2(e), exp2f): the 16 threads
// of a row reduce its max and sum with shuffles, and only P^T and the
// rescale factors pass through shared memory to the P.V layout.
//
// Every masked probability is set to exactly 0 where it is computed: a
// row whose keys are all masked so far keeps m = NEG_INF, where
// exp2(x - m) = 1, and must not pick those keys up.
#pragma once

#include "flash_tile.cuh"

namespace f32flash {

constexpr int BR = 128;      // query rows per CTA
constexpr int BK = 64;       // keys per tile
constexpr int DP = 128;      // head dim held (D <= DP, zero-padded)
constexpr int NTH = 256;     // threads per CTA
constexpr int QLD = DP + 4;  // Q and K row stride in floats
constexpr int PLD = BR + 4;  // P^T row stride in floats
constexpr int CH = DP / 4;   // 16-byte chunks of a held row
constexpr float LOG2E = 1.4426950408889634f;

// Q [BR][QLD], K [2][BK][QLD], V [BK][DP], P^T [BK][PLD]: the floats
// every kernel on this step holds; each carves its own state after them
constexpr size_t TILE_FLOATS = (size_t)BR * QLD + 2 * (size_t)BK * QLD +
                               (size_t)BK * DP + (size_t)BK * PLD;

__device__ __forceinline__ void cp_async4(void *dst, const void *src,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// max and sum over the 16 lanes that share a row of S
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy the CTA's query rows into sq: row r < n_rows is q[b, r0 + r / G,
// kvh * G + r % G, :] of q [B, T, Hq, D]; other rows and dims >= D are
// zero-filled. Issues cp.async copies and does not commit them.
__device__ __forceinline__ void load_q(float *sq, const float *q, int b,
                                       int T, int r0, int Hq, int kvh,
                                       int G, int n_rows, int D) {
  const int nc = D / 4;
  for (int e = threadIdx.x; e < BR * CH; e += NTH) {
    const int r = e / CH, c = e - r * CH;
    const bool ok = r < n_rows && c < nc;
    const long src =
        ok ? ((long)(b * T + r0 + r / G) * Hq + kvh * G + r % G) * D + 4 * c
           : 0;
    flash::cp_async16(sq + r * QLD + 4 * c, q + src, ok);
  }
}

// Copy a tile of BK key rows into dst (row stride ld_dst): row j < valid
// starts at src + j * ld_src; other rows and dims >= D are zero-filled.
// Issues cp.async copies and does not commit them.
__device__ __forceinline__ void load_keys(float *dst, int ld_dst,
                                          const float *src, long ld_src,
                                          int valid, int D) {
  const int nc = D / 4;
  for (int e = threadIdx.x; e < BK * CH; e += NTH) {
    const int j = e / CH, c = e - j * CH;
    const bool ok = j < valid && c < nc;
    flash::cp_async16(dst + j * ld_dst + 4 * c,
                      src + (ok ? j * ld_src + 4 * c : 0), ok);
  }
}

// This thread's S block: s[i][j] = q row srg + 16 i . k row skg + 16 j.
__device__ __forceinline__ void qk(const float *sq, const float *sk, int srg,
                                   int skg, float (&s)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DP; d += 4) {
    float4 qv[8], kv[4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      qv[i] = *reinterpret_cast<const float4 *>(sq + (srg + 16 * i) * QLD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      kv[j] = *reinterpret_cast<const float4 *>(sk + (skg + 16 * j) * QLD + d);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        x = fmaf(qv[i].x, kv[j].x, x);
        x = fmaf(qv[i].y, kv[j].y, x);
        x = fmaf(qv[i].z, kv[j].z, x);
        x = fmaf(qv[i].w, kv[j].w, x);
        s[i][j] = x;
      }
  }
}

// One row's online-softmax step: x holds its 4 logits in base 2 (masked
// ones NEG_INF), bit j of ok says whether key j is visible. Writes the
// probabilities exp2(x - m_new) (0 where masked) to p, updates the row's
// running max m and denominator l, and returns the rescale factor of
// the earlier tiles.
__device__ __forceinline__ float softmax_row(const float (&x)[4], unsigned ok,
                                             float (&p)[4], float &m,
                                             float &l) {
  const float mx = row_max(fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3])));
  const float m_new = fmaxf(m, mx);
  float psum = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float pj = (ok >> j & 1u) ? exp2f(x[j] - m_new) : 0.f;
    p[j] = pj;
    psum += pj;
  }
  psum = row_sum(psum);
  const float alpha = exp2f(m - m_new);
  l = l * alpha + psum;
  m = m_new;
  return alpha;
}

// Pass this thread's probabilities (as P^T) and its rows' rescale
// factors to the P.V layout.
__device__ __forceinline__ void store_p(float *sp, float *s_alpha,
                                        const float (&s)[8][4],
                                        const float (&alpha)[8], int srg,
                                        int skg) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sp[(skg + 16 * j) * PLD + srg + 16 * i] = s[i][j];
  if (skg == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) s_alpha[srg + 16 * i] = alpha[i];
  }
}

// O = O * alpha + P V over the staged tile (P^T in sp, V in sv).
__device__ __forceinline__ void pv(float (&o)[8][8], const float *sp,
                                   const float *sv, const float *s_alpha,
                                   int srg, int skg) {
  {
    const float4 a0 = *reinterpret_cast<const float4 *>(s_alpha + 8 * srg);
    const float4 a1 = *reinterpret_cast<const float4 *>(s_alpha + 8 * srg + 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) o[i][c] *= a[i];
  }
#pragma unroll 8
  for (int kk = 0; kk < BK; ++kk) {
    const float4 p0 = *reinterpret_cast<const float4 *>(sp + kk * PLD + 8 * srg);
    const float4 p1 =
        *reinterpret_cast<const float4 *>(sp + kk * PLD + 8 * srg + 4);
    const float4 v0 = *reinterpret_cast<const float4 *>(sv + kk * DP + 4 * skg);
    const float4 v1 =
        *reinterpret_cast<const float4 *>(sv + kk * DP + 64 + 4 * skg);
    const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
    const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) o[i][c] = fmaf(p[i], vv[c], o[i][c]);
  }
}

// Write row r = 8 srg + i < n_rows of O over its denominator (s_l[r],
// complete in shared memory) to out[b, r0 + r / G, kvh * G + r % G, :]
// of out [B, T, Hq, D]; a row with no visible key (l = 0) gives 0.
__device__ __forceinline__ void store_out(float *out, const float (&o)[8][8],
                                          const float *s_l, int b, int T,
                                          int r0, int Hq, int kvh, int G,
                                          int n_rows, int D, int srg,
                                          int skg) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * srg + i;
    if (r < n_rows) {
      const float lr = fmaxf(s_l[r], 1e-30f);
      float *dst = out + ((long)(b * T + r0 + r / G) * Hq + kvh * G + r % G) * D;
      if (4 * skg < D)
        *reinterpret_cast<float4 *>(dst + 4 * skg) = make_float4(
            o[i][0] / lr, o[i][1] / lr, o[i][2] / lr, o[i][3] / lr);
      if (64 + 4 * skg < D)
        *reinterpret_cast<float4 *>(dst + 64 + 4 * skg) = make_float4(
            o[i][4] / lr, o[i][5] / lr, o[i][6] / lr, o[i][7] / lr);
    }
  }
}

}  // namespace f32flash
