// The register-blocked flash tile step of the float32 attention kernels
// on the CUDA cores (retention_attention.cu, chunk_attention.cu): full
// float32 FMAs, no TF32.
//
// The step is a template over the head dim held, DP (Tile<DP>): 128
// (any D <= 128) or 256 (D <= 256). A CTA of 256 threads holds BR
// query rows in shared memory, row r = (position r / G, q head r % G of
// the kv head's group), so each tile of BK keys is staged once for the
// whole group: BR = 128, BK = 64 at DP 128; BR = 64, BK = 32 at DP 256,
// which keeps Q, the double-buffered K, V and P^T in 175 KB (at BR 128
// Q alone would take 133 KB). Rows and keys are zero-padded to DP
// floats, padded by 4 so that a warp's float4 reads are conflict-free.
// A thread owns an RI x SJ block of S (rows srg + 16 i, keys skg + 16 j;
// RI = BR / 16, SJ = BK / 16) and an RI x OC block of O (rows RI srg + i,
// dims 64 c + 4 skg .. 64 c + 4 skg + 3; OC = DP / 16), with
// srg = 2 warp + lane / 16 and skg = lane % 16: 8 x 4 and 8 x 8 at
// DP 128, 4 x 2 and 4 x 16 at DP 256. The online softmax stays in
// registers, in base 2 (logits times log2(e), exp2f): the 16 threads of
// a row reduce its max and sum with shuffles, and only P^T and the
// rescale factors pass through shared memory to the P.V layout.
//
// Every masked probability is set to exactly 0 where it is computed: a
// row whose keys are all masked so far keeps m = NEG_INF, where
// exp2(x - m) = 1, and must not pick those keys up.
#pragma once

#include "flash_tile.cuh"

namespace f32flash {

constexpr int NTH = 256;     // threads per CTA
constexpr float LOG2E = 1.4426950408889634f;

template <int DP_> struct Tile {
  static_assert(DP_ == 128 || DP_ == 256, "head dim held 128 or 256");
  static constexpr int DP = DP_;               // head dim held (D <= DP)
  static constexpr int BR = DP == 256 ? 64 : 128;  // query rows per CTA
  static constexpr int BK = DP == 256 ? 32 : 64;   // keys per tile
  static constexpr int QLD = DP + 4;  // Q and K row stride in floats
  static constexpr int PLD = BR + 4;  // P^T row stride in floats
  static constexpr int CH = DP / 4;   // 16-byte chunks of a held row
  static constexpr int RI = BR / 16;  // S and O rows a thread
  static constexpr int SJ = BK / 16;  // S keys a thread
  static constexpr int OC = DP / 16;  // O dims a thread
  // Q [BR][QLD], K [2][BK][QLD], V [BK][DP], P^T [BK][PLD]: the floats
  // every kernel on this step holds; each carves its own state after them
  static constexpr size_t TILE_FLOATS = (size_t)BR * QLD +
                                        2 * (size_t)BK * QLD +
                                        (size_t)BK * DP + (size_t)BK * PLD;
};

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
template <class K>
__device__ __forceinline__ void load_q(float *sq, const float *q, int b,
                                       int T, int r0, int Hq, int kvh,
                                       int G, int n_rows, int D) {
  const int nc = D / 4;
  for (int e = threadIdx.x; e < K::BR * K::CH; e += NTH) {
    const int r = e / K::CH, c = e - r * K::CH;
    const bool ok = r < n_rows && c < nc;
    const long src =
        ok ? ((long)(b * T + r0 + r / G) * Hq + kvh * G + r % G) * D + 4 * c
           : 0;
    flash::cp_async16(sq + r * K::QLD + 4 * c, q + src, ok);
  }
}

// Copy a tile of BK key rows into dst (row stride ld_dst): row j < valid
// starts at src + j * ld_src; other rows and dims >= D are zero-filled.
// Issues cp.async copies and does not commit them.
template <class K>
__device__ __forceinline__ void load_keys(float *dst, int ld_dst,
                                          const float *src, long ld_src,
                                          int valid, int D) {
  const int nc = D / 4;
  for (int e = threadIdx.x; e < K::BK * K::CH; e += NTH) {
    const int j = e / K::CH, c = e - j * K::CH;
    const bool ok = j < valid && c < nc;
    flash::cp_async16(dst + j * ld_dst + 4 * c,
                      src + (ok ? j * ld_src + 4 * c : 0), ok);
  }
}

// This thread's S block: s[i][j] = q row srg + 16 i . k row skg + 16 j.
template <class K>
__device__ __forceinline__ void qk(const float *sq, const float *sk, int srg,
                                   int skg, float (&s)[K::RI][K::SJ]) {
#pragma unroll
  for (int i = 0; i < K::RI; ++i)
#pragma unroll
    for (int j = 0; j < K::SJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < K::DP; d += 4) {
    float4 qv[K::RI], kv[K::SJ];
#pragma unroll
    for (int i = 0; i < K::RI; ++i)
      qv[i] = *reinterpret_cast<const float4 *>(sq + (srg + 16 * i) * K::QLD + d);
#pragma unroll
    for (int j = 0; j < K::SJ; ++j)
      kv[j] = *reinterpret_cast<const float4 *>(sk + (skg + 16 * j) * K::QLD + d);
#pragma unroll
    for (int i = 0; i < K::RI; ++i)
#pragma unroll
      for (int j = 0; j < K::SJ; ++j) {
        float x = s[i][j];
        x = fmaf(qv[i].x, kv[j].x, x);
        x = fmaf(qv[i].y, kv[j].y, x);
        x = fmaf(qv[i].z, kv[j].z, x);
        x = fmaf(qv[i].w, kv[j].w, x);
        s[i][j] = x;
      }
  }
}

// One row's online-softmax step: x holds its SJ logits in base 2
// (masked ones NEG_INF), bit j of ok says whether key j is visible.
// Writes the probabilities exp2(x - m_new) (0 where masked) to p,
// updates the row's running max m and denominator l, and returns the
// rescale factor of the earlier tiles.
template <int SJ>
__device__ __forceinline__ float softmax_row(const float (&x)[SJ], unsigned ok,
                                             float (&p)[SJ], float &m,
                                             float &l) {
  float mx = x[0];
#pragma unroll
  for (int j = 1; j < SJ; ++j) mx = fmaxf(mx, x[j]);
  mx = row_max(mx);
  const float m_new = fmaxf(m, mx);
  float psum = 0.f;
#pragma unroll
  for (int j = 0; j < SJ; ++j) {
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
template <class K>
__device__ __forceinline__ void store_p(float *sp, float *s_alpha,
                                        const float (&s)[K::RI][K::SJ],
                                        const float (&alpha)[K::RI], int srg,
                                        int skg) {
#pragma unroll
  for (int i = 0; i < K::RI; ++i)
#pragma unroll
    for (int j = 0; j < K::SJ; ++j)
      sp[(skg + 16 * j) * K::PLD + srg + 16 * i] = s[i][j];
  if (skg == 0) {
#pragma unroll
    for (int i = 0; i < K::RI; ++i) s_alpha[srg + 16 * i] = alpha[i];
  }
}

// The RI consecutive floats at p (16-byte aligned), as float4 loads.
template <int RI>
__device__ __forceinline__ void load_run(const float *p, float (&x)[RI]) {
#pragma unroll
  for (int q = 0; q < RI / 4; ++q) {
    const float4 v = *reinterpret_cast<const float4 *>(p + 4 * q);
    x[4 * q] = v.x;
    x[4 * q + 1] = v.y;
    x[4 * q + 2] = v.z;
    x[4 * q + 3] = v.w;
  }
}

// O = O * alpha + P V over the staged tile (P^T in sp, V in sv).
template <class K>
__device__ __forceinline__ void pv(float (&o)[K::RI][K::OC], const float *sp,
                                   const float *sv, const float *s_alpha,
                                   int srg, int skg) {
  {
    float a[K::RI];
    load_run(s_alpha + K::RI * srg, a);
#pragma unroll
    for (int i = 0; i < K::RI; ++i)
#pragma unroll
      for (int c = 0; c < K::OC; ++c) o[i][c] *= a[i];
  }
#pragma unroll 8
  for (int kk = 0; kk < K::BK; ++kk) {
    float p[K::RI];
    load_run(sp + kk * K::PLD + K::RI * srg, p);
    float vv[K::OC];
#pragma unroll
    for (int c = 0; c < K::OC / 4; ++c) {
      const float4 v =
          *reinterpret_cast<const float4 *>(sv + kk * K::DP + 64 * c + 4 * skg);
      vv[4 * c] = v.x;
      vv[4 * c + 1] = v.y;
      vv[4 * c + 2] = v.z;
      vv[4 * c + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < K::RI; ++i)
#pragma unroll
      for (int c = 0; c < K::OC; ++c) o[i][c] = fmaf(p[i], vv[c], o[i][c]);
  }
}

// Write row r = RI srg + i < n_rows of O over its denominator (s_l[r],
// complete in shared memory) to out[b, r0 + r / G, kvh * G + r % G, :]
// of out [B, T, Hq, D]; a row with no visible key (l = 0) gives 0.
template <class K>
__device__ __forceinline__ void store_out(float *out,
                                          const float (&o)[K::RI][K::OC],
                                          const float *s_l, int b, int T,
                                          int r0, int Hq, int kvh, int G,
                                          int n_rows, int D, int srg,
                                          int skg) {
#pragma unroll
  for (int i = 0; i < K::RI; ++i) {
    const int r = K::RI * srg + i;
    if (r < n_rows) {
      const float lr = fmaxf(s_l[r], 1e-30f);
      float *dst = out + ((long)(b * T + r0 + r / G) * Hq + kvh * G + r % G) * D;
#pragma unroll
      for (int c = 0; c < K::OC / 4; ++c)
        if (64 * c + 4 * skg < D)
          *reinterpret_cast<float4 *>(dst + 64 * c + 4 * skg) =
              make_float4(o[i][4 * c] / lr, o[i][4 * c + 1] / lr,
                          o[i][4 * c + 2] / lr, o[i][4 * c + 3] / lr);
    }
  }
}

}  // namespace f32flash
