// The float32 chunk kernel's tile machinery (chunk_attention.cu): one
// online-softmax step over a tile of TK keys for up to TQ query rows,
// with every operand staged in shared memory as float32; and the small
// helpers the decode and retention kernels share with it (conversions,
// warp reductions, cp.async copies, the shared-memory opt-in).
//
// A CTA is 128 threads (4 warps). In the score phase warp w owns query
// rows w, w+4, w+8, w+12 and lane j owns key j of the tile (TK == 32),
// so each row's max and sum are one warp shuffle reduction and the row
// state (m, l) has a single writer. In the P.V phase thread t owns
// output dims t and t+128 for every row, so D <= 256.
//
// Every masked probability is set to exactly 0 where it is computed: a
// row whose keys are all masked so far keeps m = NEG_INF, where
// exp(s - m) = 1, and must not pick those keys up. Nothing relies on a
// later tile to rescale them away.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1e30f)

namespace flash {

constexpr int TQ = 16;        // query rows per CTA
constexpr int TK = 32;        // keys per tile (one per lane)
constexpr int NT = 128;       // threads per CTA
constexpr int MAX_D = 2 * NT; // dims a thread can own in the P.V phase

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared-memory views. q and k rows are padded to D + 1 floats so that
// the 32 lanes of a warp, reading key j = lane at the same d, hit 32
// different banks.
struct Smem {
  float *q;    // [TQ][D + 1]
  float *k;    // [TK][D + 1]
  float *v;    // [TK][D]
  float *p;    // [TQ][TK]  masked exp(s - m) of the current tile
  float *m;    // [TQ]      running max
  float *l;    // [TQ]      running denominator
  float *a;    // [TQ]      rescale factor of the current tile
  int *qpos;   // [TQ]      query positions (-1 = padded row)
  int *kpos;   // [TK]      key positions of the current tile (-1 = none)
  float *mblk; // [TQ][n_tiles] running max after each cache tile (probs)

  static size_t bytes(int D, int n_tiles) {
    size_t f = (size_t)TQ * (D + 1) + (size_t)TK * (D + 1) +
               (size_t)TK * D + TQ * TK + 3 * TQ +
               (size_t)TQ * n_tiles;
    return f * sizeof(float) + (TQ + TK) * sizeof(int);
  }

  static __device__ Smem carve(float *base, int D, int n_tiles) {
    Smem s;
    float *f = base;
    s.q = f;    f += TQ * (D + 1);
    s.k = f;    f += TK * (D + 1);
    s.v = f;    f += TK * D;
    s.p = f;    f += TQ * TK;
    s.m = f;    f += TQ;
    s.l = f;    f += TQ;
    s.a = f;    f += TQ;
    s.mblk = f; f += TQ * n_tiles;
    s.qpos = reinterpret_cast<int *>(f);
    s.kpos = s.qpos + TQ;
    return s;
  }
};

// Stage n rows of D elements into dst (row stride ld floats); row r of
// the source starts at src + r * src_ld. Rows >= valid are zero-filled.
__device__ __forceinline__ void load_rows(float *dst, int ld, const float *src,
                                          long src_ld, int n, int valid,
                                          int D) {
  for (int e = threadIdx.x; e < n * D; e += NT) {
    int r = e / D, d = e - r * D;
    dst[r * ld + d] = r < valid ? src[r * src_ld + d] : 0.f;
  }
}

__device__ __forceinline__ void init_rows(const Smem &sm) {
  if (threadIdx.x < TQ) {
    sm.m[threadIdx.x] = NEG_INF;
    sm.l[threadIdx.x] = 0.f;
  }
}

// Key visibility for (row i, key j) of the tile in shared memory:
// kpos >= 0, and with causal positions qpos - kpos >= 0 (and < window
// when window > 0).
struct PosMask {
  int window;
  __device__ bool operator()(const Smem &sm, int i, int j) const {
    int kp = sm.kpos[j];
    int dist = sm.qpos[i] - kp;
    return kp >= 0 && dist >= 0 && (window <= 0 || dist < window);
  }
};

// True when any (row < nrows, key) pair of the staged tile is visible;
// block-uniform, so every thread takes the same branch.
__device__ __forceinline__ bool tile_visible(const Smem &sm, int nrows,
                                             const PosMask &mask) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int any = 0;
  for (int i = warp; i < nrows; i += NT / 32) any |= mask(sm, i, lane);
  return __syncthreads_or(any) != 0;
}

// One online-softmax step over the staged tile (q, k, v, kpos in smem).
// Leaves p (masked exp(s - m_new)), m, l and a updated and acc
// rescaled and accumulated. Ends with a barrier.
__device__ __forceinline__ void tile_step(const Smem &sm, int D, int nrows,
                                          float scale, const PosMask &mask,
                                          float (&acc)[TQ][2]) {
  int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = warp; i < nrows; i += NT / 32) {
    const float *qi = sm.q + i * (D + 1);
    const float *kj = sm.k + lane * (D + 1);
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(qi[d], kj[d], s);
    bool ok = mask(sm, i, lane);
    s = ok ? s * scale : NEG_INF;
    float m_prev = sm.m[i];
    float m_new = fmaxf(m_prev, warp_max(s));
    float p = ok ? expf(s - m_new) : 0.f;
    float psum = warp_sum(p);
    sm.p[i * TK + lane] = p;
    if (lane == 0) {
      float a = expf(m_prev - m_new);
      sm.a[i] = a;
      sm.l[i] = sm.l[i] * a + psum;
      sm.m[i] = m_new;
    }
  }
  __syncthreads();
#pragma unroll
  for (int dd = 0; dd < 2; ++dd) {
    int d = tid + dd * NT;
    if (d < D) {
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        if (i < nrows) {
          float x = acc[i][dd] * sm.a[i];
          const float *pi = sm.p + i * TK;
#pragma unroll 8
          for (int j = 0; j < TK; ++j) x = fmaf(pi[j], sm.v[j * D + d], x);
          acc[i][dd] = x;
        }
      }
    }
  }
  __syncthreads();
}

// Store row i's output acc / max(l, 1e-30) at out + i * out_ld. Starts
// with a barrier, so the row state is complete even when no tile ran.
__device__ __forceinline__ void store_rows(const Smem &sm, int D, int nrows,
                                           const float (&acc)[TQ][2],
                                           float *out, long out_ld) {
  __syncthreads();
  int tid = threadIdx.x;
#pragma unroll
  for (int dd = 0; dd < 2; ++dd) {
    int d = tid + dd * NT;
    if (d < D) {
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        if (i < nrows)
          out[i * out_ld + d] = acc[i][dd] / fmaxf(sm.l[i], 1e-30f);
      }
    }
  }
}

// Flash reconstruction of normalized probabilities written raw, tile by
// tile, as exp(s - m_tile): p * exp(m_tile - m_final) / max(l, 1e-30).
// probs row i starts at probs + i * ld and holds n_cols columns.
__device__ __forceinline__ void rescale_probs(const Smem &sm, int nrows,
                                              float *probs, long ld,
                                              int n_cols, int n_tiles) {
  for (int e = threadIdx.x; e < nrows * n_cols; e += NT) {
    int i = e / n_cols, c = e - i * n_cols;
    float sc = expf(sm.mblk[i * n_tiles + c / TK] - sm.m[i]);
    float *p = probs + i * ld + c;
    *p = *p * sc / fmaxf(sm.l[i], 1e-30f);
  }
}

// Write the current tile's raw probabilities (columns c0.. of n_cols)
// and remember the running max they were scaled by; a skipped tile
// writes zeros.
__device__ __forceinline__ void store_raw_probs(const Smem &sm, int nrows,
                                                bool visible, float *probs,
                                                long ld, int c0, int n_cols,
                                                int tile, int n_tiles) {
  for (int e = threadIdx.x; e < nrows * TK; e += NT) {
    int i = e / TK, j = e - i * TK;
    if (c0 + j < n_cols)
      probs[i * ld + c0 + j] = visible ? sm.p[i * TK + j] : 0.f;
  }
  if (threadIdx.x < nrows) sm.mblk[threadIdx.x * n_tiles + tile] = sm.m[threadIdx.x];
}

// 16-byte asynchronous copy into shared memory; ok false zero-fills
// the destination and reads nothing.
__device__ __forceinline__ void cp_async16(void *dst, const void *src,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are pending
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

inline cudaError_t allow_smem(const void *fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace flash
