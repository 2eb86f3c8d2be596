// Flash-decode over the bounded slot cache, split over a thread-block
// cluster, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `decode_attention_pallas`
// (src/repro/kernels/decode_attention.py, body `_decode_kernel`): one
// query token per (lane, q head) attends over the M-slot cache
// [B, Hkv, M, D] (slots with pos < 0 masked; optional window against
// the per-lane clock t [B]), with the in-flight token's (k, v) merged
// into the softmax as a separate operand at distance 0 — visible even
// under a window — and optional normalized slot probabilities
// [B, Hq, M] and in-flight mass p_new [B, Hq].
//
// A cross-attention memory slab is read as a cache without positions:
// given mem_len [B] instead of pos, slot j of lane b is at position 0
// when j < mem_len[b] and empty (-1) otherwise (core.cache.memory_pos),
// so the caller builds no position array per step.
//
// Bound on the H100: bytes. At the main-path shape (B=4, Hkv=8, M=512,
// D=128, bf16) the cache holds 8.4 MB of K/V, about 2.5 us at
// 3.35 TB/s; the arithmetic (4 * B * Hq * M * D = 33.5 MFLOP) is far
// below the tensor-core line.
//
// Design: one launch of B * Hkv clusters of n_split CTAs (n_split <= 8,
// the portable cluster size; the wrapper's split_plan picks it from M
// and B * Hkv). CTA `split` of a cluster owns slots
// [split * split_len, (split + 1) * split_len) of one (lane, kv head)
// and serves its whole query group, so each K/V byte is read once. It
// walks its slots in tiles of 64 (one tile on the main path): K and V
// of a tile are put in flight at once with 16-byte cp.async copies
// (slots past M zero-filled) before the first multiply-add, the
// positions are read meanwhile, and a tile with no visible slot is
// skipped. Scores take two threads per slot over an XOR-swizzled K
// tile (conflict-free 16-byte reads); P.V takes one thread per pair of
// dims per group of slots. Each CTA leaves a partial (m, l, acc[G][D])
// in float32 in its shared memory; after cluster.sync() every CTA
// reads all partials through distributed shared memory and writes its
// own slice of D of the output: it merges the in-flight token and
// rescales each split by exp(m_s - m). A split with no visible slot
// has l = 0 and weight 0 — never exp(0) = 1 — and a lane with no
// visible slot and no in-flight token gives 0. Probabilities are
// written raw per tile and rescaled by the CTA that wrote them with the
// cluster's final (m, l). No workspace in device memory, no atomics, no
// second kernel.
//
// What it leaves on the table: a split of several tiles (M > 512 at
// B * Hkv = 32) loads its next tile only after this one's P.V; the
// positions and the K/V copies are two dependent memory latencies
// only when a tile is not the split's first; the combine's remote
// reads and the two cluster barriers are a fixed cost of a few
// microseconds per call.
#include <cooperative_groups.h>

#include "flash_tile.cuh"

namespace cg = cooperative_groups;
using flash::cp_async16;
using flash::cp_async_commit;
using flash::cp_async_wait;
using flash::from_f;
using flash::to_f;
using flash::warp_max;
using flash::warp_sum;

namespace {

constexpr int TS = 64;         // slots per tile
constexpr int NTH = 128;       // threads per CTA: two per slot of a tile
constexpr int MAX_G = 16;      // query rows per kv head
constexpr int MAX_DIM = 256;   // head dim
constexpr int MAX_SPLIT = 8;   // portable cluster size

// A 16-byte chunk of T as floats, and a pair of neighbouring elements.
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4 &u, float *f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ float2 pair(const float *p) {
    return *reinterpret_cast<const float2 *>(p);
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4 &u, float *f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ float2 pair(const __nv_bfloat16 *p) {
    const unsigned w = *reinterpret_cast<const unsigned *>(p);
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xffff0000u));
  }
};

// Shared memory of one CTA, every piece 16-byte aligned. k and v hold a
// tile as T (k with its 16-byte chunks XOR-swizzled per slot); the
// float32 pieces from part_acc on are the partial the cluster reads.
struct Smem {
  unsigned char *k, *v;
  float *q;         // [G][D]
  float *knew;      // [D]
  float *s;         // [G][TS] scores, then probabilities, of the tile
  int *vis;         // [TS]
  float *a;         // [G] rescale of the tile
  float *snew;      // [G] in-flight token's score
  float *mblk;      // [G][n_tiles] running max after each tile (probs)
  float *wgt;       // [MAX_SPLIT][G] each split's weight exp(m_s - m)
  float *fin;       // [3][G] the cluster's m, l and in-flight weight
  float *part_acc;  // [NG][G][D]; the cluster reads [0], the CTA's sum
  float *m, *l;     // [G] read by the cluster

  static __host__ __device__ size_t up16(size_t x) { return (x + 15) & ~size_t(15); }

  // Lay the pieces out from base (sm nullptr: only count); returns
  // bytes.
  static __host__ __device__ size_t layout(Smem *sm, unsigned char *base,
                                           int G, int D, int esz, int ng,
                                           int n_tiles) {
    const size_t sizes[14] = {
        (size_t)TS * D * esz, (size_t)TS * D * esz, (size_t)G * D * 4,
        (size_t)D * 4, (size_t)G * TS * 4, (size_t)TS * 4, (size_t)G * 4,
        (size_t)G * 4, (size_t)G * n_tiles * 4, (size_t)MAX_SPLIT * G * 4,
        (size_t)3 * G * 4, (size_t)ng * G * D * 4, (size_t)G * 4,
        (size_t)G * 4};
    size_t off = 0, at[14];
    for (int i = 0; i < 14; ++i) {
      at[i] = off;
      off = up16(off + sizes[i]);
    }
    if (sm != nullptr) {
      unsigned char *p[14];
      for (int i = 0; i < 14; ++i) p[i] = base + at[i];
      sm->k = p[0];
      sm->v = p[1];
      sm->q = (float *)p[2];
      sm->knew = (float *)p[3];
      sm->s = (float *)p[4];
      sm->vis = (int *)p[5];
      sm->a = (float *)p[6];
      sm->snew = (float *)p[7];
      sm->mblk = (float *)p[8];
      sm->wgt = (float *)p[9];
      sm->fin = (float *)p[10];
      sm->part_acc = (float *)p[11];
      sm->m = (float *)p[12];
      sm->l = (float *)p[13];
    }
    return off;
  }
};

// slot groups of the P.V phase: one thread per pair of dims per group
__host__ __device__ __forceinline__ int pv_groups(int D) {
  return NTH / (D / 2);
}

template <typename T>
__global__ void __launch_bounds__(NTH)
decode_split_kernel(const T *__restrict__ q, const T *__restrict__ kc,
                    const T *__restrict__ vc, const int *__restrict__ pos,
                    const int *__restrict__ mem_len,
                    const int *__restrict__ t_lane,
                    const T *__restrict__ k_new, const T *__restrict__ v_new,
                    T *__restrict__ out, float *__restrict__ probs,
                    float *__restrict__ p_new, int Hq, int Hkv, int M, int D,
                    int window, float scale, int n_split, int split_len) {
  using C = Chunk<T>;
  constexpr int E = C::N;  // elements per 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const long bh = blockIdx.x / n_split;  // (lane, kv head)
  const int b = (int)(bh / Hkv);
  const int G = Hq / Hkv, h0 = (int)(bh % Hkv) * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int NC = D / E;                  // 16-byte chunks per row
  const int NG = pv_groups(D);
  const int n_tiles = split_len / TS;
  const bool want_probs = probs != nullptr, has_new = k_new != nullptr;
  Smem sm;
  Smem::layout(&sm, smem_raw, G, D, sizeof(T), NG,
               want_probs ? n_tiles : 0);

  const T *k_base = kc + bh * M * D;
  const T *v_base = vc + bh * M * D;
  const int *pos_base = pos != nullptr ? pos + bh * M : nullptr;
  const int n_mem = mem_len != nullptr ? mem_len[b] : 0;
  // slot j's position: pos, or 0 / -1 inside / past a memory's length
  auto slot_pos = [&](int j) {
    return pos_base != nullptr ? pos_base[j] : (j < n_mem ? 0 : -1);
  };
  const long row0 = (long)b * Hq + h0;   // first q head of the group
  float *probs_base = want_probs ? probs + row0 * M : nullptr;
  const int t = t_lane[b];
  const int s_begin = split * split_len;
  const int s_end = min(M, s_begin + split_len);

  // K (swizzled) and V of the tile at slot j0: one commit group each
  auto load_tile = [&](int j0) {
    const int valid = min(TS, s_end - j0);
    const uint4 *ksrc = reinterpret_cast<const uint4 *>(k_base + (long)j0 * D);
    const uint4 *vsrc = reinterpret_cast<const uint4 *>(v_base + (long)j0 * D);
    uint4 *kdst = reinterpret_cast<uint4 *>(sm.k);
    uint4 *vdst = reinterpret_cast<uint4 *>(sm.v);
    const int swz_on = NC % 8 == 0;
    for (int e = tid; e < TS * NC; e += NTH) {
      const int j = e / NC, c = e - j * NC;
      const bool ok = j < valid;
      cp_async16(kdst + j * NC + (c ^ (swz_on * ((j & 3) << 1))),
                 ksrc + (ok ? e : 0), ok);
    }
    cp_async_commit();
    for (int e = tid; e < TS * NC; e += NTH) {
      const bool ok = e / NC < valid;
      cp_async16(vdst + e, vsrc + (ok ? e : 0), ok);
    }
    cp_async_commit();
  };
  if (s_begin < s_end) load_tile(s_begin);
  // the first tile's positions, in flight with its K/V and q
  int kp0 = tid < TS && s_begin + tid < s_end ? slot_pos(s_begin + tid) : -1;

  // q rows of the group and the in-flight key, as float32
  for (int e = tid; e < G * NC; e += NTH) {
    float f[E];
    C::unpack(reinterpret_cast<const uint4 *>(q + row0 * D)[e], f);
#pragma unroll
    for (int i = 0; i < E; ++i) sm.q[e * E + i] = f[i];
  }
  if (has_new) {
    for (int e = tid; e < NC; e += NTH) {
      float f[E];
      C::unpack(reinterpret_cast<const uint4 *>(k_new + bh * D)[e], f);
#pragma unroll
      for (int i = 0; i < E; ++i) sm.knew[e * E + i] = f[i];
    }
  }
  if (tid < G) {
    sm.m[tid] = NEG_INF;
    sm.l[tid] = 0.f;
  }
  __syncthreads();
  if (has_new) {
    // in-flight token at distance 0: always visible
    for (int g = warp; g < G; g += NTH / 32) {
      float x = 0.f;
      for (int d = lane; d < D; d += 32) x = fmaf(sm.q[g * D + d], sm.knew[d], x);
      x = warp_sum(x);
      if (lane == 0) sm.snew[g] = x * scale;
    }
  }

  // P.V roles: dims 2 pv_p, 2 pv_p + 1 over slots [pv_j0, pv_j1)
  const int n_pairs = D / 2;
  const int pv_p = tid % n_pairs, pv_g = tid / n_pairs;
  const int span = (((TS + NG - 1) / NG) + 3) & ~3;
  const int pv_j0 = min(TS, pv_g * span), pv_j1 = min(TS, pv_j0 + span);
  float acc[MAX_G][2];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) acc[g][0] = acc[g][1] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int j0 = s_begin + tile * TS;
    if (j0 >= s_end) break;
    const int valid = min(TS, s_end - j0);
    int kp = kp0;
    if (tile > 0) {
      load_tile(j0);
      kp = tid < valid ? slot_pos(j0 + tid) : -1;
    }
    int ok = 0;
    if (tid < TS) {
      ok = kp >= 0 && (window <= 0 || t - kp < window);
      sm.vis[tid] = ok;
    }
    const bool any = __syncthreads_or(ok) != 0;
    cp_async_wait<1>();  // K
    __syncthreads();
    if (any) {
      // scores: slot j = tid / 2, chunks c = tid % 2, +2, ...
      const int j = tid >> 1;
      const int swz = NC % 8 == 0 ? (j & 3) << 1 : 0;
      const uint4 *krow = reinterpret_cast<const uint4 *>(sm.k) + j * NC;
      float sc[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) sc[g] = 0.f;
      for (int c = tid & 1; c < NC; c += 2) {
        float kf[E];
        C::unpack(krow[c ^ swz], kf);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g < G) {
            const float4 *qg = reinterpret_cast<const float4 *>(sm.q + g * D + c * E);
            float x = sc[g];
#pragma unroll
            for (int i = 0; i < E / 4; ++i) {
              const float4 qv = qg[i];
              x = fmaf(qv.x, kf[4 * i], x);
              x = fmaf(qv.y, kf[4 * i + 1], x);
              x = fmaf(qv.z, kf[4 * i + 2], x);
              x = fmaf(qv.w, kf[4 * i + 3], x);
            }
            sc[g] = x;
          }
        }
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
          const float x = sc[g] + __shfl_xor_sync(0xffffffffu, sc[g], 1);
          if ((g & 1) == (tid & 1)) sm.s[g * TS + j] = x * scale;
        }
      }
      __syncthreads();
      // online softmax, one warp per row; a masked score is excluded
      // before the exp
      for (int g = warp; g < G; g += NTH / 32) {
        const bool ok0 = sm.vis[lane] != 0, ok1 = sm.vis[lane + 32] != 0;
        const float x0 = ok0 ? sm.s[g * TS + lane] : NEG_INF;
        const float x1 = ok1 ? sm.s[g * TS + lane + 32] : NEG_INF;
        const float m_prev = sm.m[g];
        const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
        const float p0 = ok0 ? expf(x0 - m_new) : 0.f;
        const float p1 = ok1 ? expf(x1 - m_new) : 0.f;
        const float psum = warp_sum(p0 + p1);
        sm.s[g * TS + lane] = p0;
        sm.s[g * TS + lane + 32] = p1;
        if (lane == 0) {
          const float a = expf(m_prev - m_new);
          sm.a[g] = a;
          sm.l[g] = sm.l[g] * a + psum;
          sm.m[g] = m_new;
        }
      }
    }
    cp_async_wait<0>();  // V
    __syncthreads();
    if (any && pv_g < NG) {
      const T *vt = reinterpret_cast<const T *>(sm.v);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
          acc[g][0] *= sm.a[g];
          acc[g][1] *= sm.a[g];
        }
      }
      for (int jj = pv_j0; jj < pv_j1; jj += 4) {
        float2 vv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) vv[u] = C::pair(vt + (jj + u) * D + 2 * pv_p);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g < G) {
            const float4 p = *reinterpret_cast<const float4 *>(sm.s + g * TS + jj);
            float x0 = acc[g][0], x1 = acc[g][1];
            x0 = fmaf(p.x, vv[0].x, x0); x1 = fmaf(p.x, vv[0].y, x1);
            x0 = fmaf(p.y, vv[1].x, x0); x1 = fmaf(p.y, vv[1].y, x1);
            x0 = fmaf(p.z, vv[2].x, x0); x1 = fmaf(p.z, vv[2].y, x1);
            x0 = fmaf(p.w, vv[3].x, x0); x1 = fmaf(p.w, vv[3].y, x1);
            acc[g][0] = x0;
            acc[g][1] = x1;
          }
        }
      }
    }
    if (want_probs) {
      // raw exp(s - m_tile), rescaled after the combine; a skipped
      // tile writes zeros
      for (int e = tid; e < G * valid; e += NTH) {
        const int g = e / valid, jj = e - g * valid;
        probs_base[(long)g * M + j0 + jj] = any ? sm.s[g * TS + jj] : 0.f;
      }
      if (tid < G) sm.mblk[tid * n_tiles + tile] = sm.m[tid];
    }
    __syncthreads();  // k, v and s are rewritten by the next tile
  }

  // this CTA's partial, for the cluster: the slot groups' sums added
  // into group 0's
  if (pv_g < NG) {
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G)
        *reinterpret_cast<float2 *>(sm.part_acc + (pv_g * G + g) * D + 2 * pv_p) =
            make_float2(acc[g][0], acc[g][1]);
    }
  }
  if (NG > 1) {
    __syncthreads();
    for (int e = tid; e < G * D; e += NTH) {
      float x = sm.part_acc[e];
      for (int sg = 1; sg < NG; ++sg) x += sm.part_acc[sg * G * D + e];
      sm.part_acc[e] = x;
    }
  }
  cluster.sync();

  // the cluster's (m, l) per row and each split's weight
  float *fin_m = sm.fin, *fin_l = sm.fin + G, *fin_pn = sm.fin + 2 * G;
  if (tid < G) {
    const int g = tid;
    float ms[MAX_SPLIT], ls[MAX_SPLIT];
    float m = has_new ? sm.snew[g] : NEG_INF;
#pragma unroll
    for (int s = 0; s < MAX_SPLIT; ++s) {
      ms[s] = s < n_split ? cluster.map_shared_rank(sm.m, s)[g] : NEG_INF;
      ls[s] = s < n_split ? cluster.map_shared_rank(sm.l, s)[g] : 0.f;
    }
#pragma unroll
    for (int s = 0; s < MAX_SPLIT; ++s)
      if (ls[s] > 0.f) m = fmaxf(m, ms[s]);
    float l = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_SPLIT; ++s) {
      const float w = ls[s] > 0.f ? expf(ms[s] - m) : 0.f;
      if (s < n_split) sm.wgt[s * G + g] = w;
      l += w * ls[s];
    }
    const float pn = has_new ? expf(sm.snew[g] - m) : 0.f;
    l += pn;
    fin_m[g] = m;
    fin_l[g] = l;
    fin_pn[g] = pn;
    if (p_new != nullptr && split == 0) p_new[row0 + g] = pn / fmaxf(l, 1e-30f);
  }
  __syncthreads();

  // this CTA's slice of D of the output
  const int cs = (D + n_split - 1) / n_split;
  const int d_lo = min(D, split * cs), width = min(D, d_lo + cs) - d_lo;
  for (int e = tid; e < G * width; e += NTH) {
    const int g = e / width, d = d_lo + (e - g * width);
    float part[MAX_SPLIT];
#pragma unroll
    for (int s = 0; s < MAX_SPLIT; ++s)
      part[s] = s < n_split
                    ? cluster.map_shared_rank(sm.part_acc, s)[g * D + d] : 0.f;
    float x = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_SPLIT; ++s)
      if (s < n_split) x = fmaf(sm.wgt[s * G + g], part[s], x);
    if (has_new) x = fmaf(fin_pn[g], to_f(v_new[bh * D + d]), x);
    out[(row0 + g) * D + d] = from_f<T>(x / fmaxf(fin_l[g], 1e-30f));
  }

  if (want_probs) {
    for (int e = tid; e < G * (s_end - s_begin); e += NTH) {
      const int w = s_end - s_begin;
      const int g = e / w, jj = e - g * w;
      const float sc = expf(sm.mblk[g * n_tiles + jj / TS] - fin_m[g]);
      float *p = probs_base + (long)g * M + s_begin + jj;
      *p = *p * sc / fmaxf(fin_l[g], 1e-30f);
    }
  }
  cluster.sync();  // the other CTAs are done reading this one's partial
}

template <typename T>
cudaError_t launch(const void *q, const void *k_cache, const void *v_cache,
                   const void *pos, const void *mem_len, const void *t,
                   const void *k_new, const void *v_new, void *out,
                   void *probs, void *p_new,
                   int B, int Hq, int Hkv, int M, int D, int window,
                   int n_split, int split_len, cudaStream_t st) {
  const int G = Hq / Hkv;
  const size_t smem = Smem::layout(nullptr, nullptr, G, D, sizeof(T),
                                   pv_groups(D),
                                   probs ? split_len / TS : 0);
  auto kernel = decode_split_kernel<T>;
  cudaError_t err = flash::allow_smem((const void *)kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * Hkv * n_split);
  cfg.blockDim = dim3(NTH);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, kernel, (const T *)q, (const T *)k_cache, (const T *)v_cache,
      (const int *)pos, (const int *)mem_len, (const int *)t,
      (const T *)k_new, (const T *)v_new, (T *)out, (float *)probs,
      (float *)p_new, Hq, Hkv, M, D, window,
      1.0f / sqrtf((float)D), n_split, split_len);
}

}  // namespace

extern "C" int decode_attention_launch(
    int is_bf16, const void *q, const void *k_cache, const void *v_cache,
    const void *pos, const void *mem_len, const void *t, const void *k_new,
    const void *v_new, void *out, void *probs, void *p_new, int B, int Hq,
    int Hkv, int M, int D, int window, int n_split, int split_len,
    void *stream) {
  const int chunk = is_bf16 ? 8 : 4;
  if (D > MAX_DIM || D % chunk != 0 || Hq % Hkv != 0 || Hq / Hkv > MAX_G ||
      n_split < 1 || n_split > MAX_SPLIT || split_len < TS ||
      split_len % TS != 0 || (long)n_split * split_len < M ||
      (long)(n_split - 1) * split_len >= (M > 0 ? M : 1) ||
      (pos == nullptr) == (mem_len == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k_cache, v_cache, pos, mem_len, t,
                                      k_new, v_new, out, probs, p_new, B, Hq,
                                      Hkv, M, D, window, n_split, split_len,
                                      st)
              : launch<float>(q, k_cache, v_cache, pos, mem_len, t, k_new,
                              v_new, out, probs, p_new, B, Hq, Hkv, M, D,
                              window, n_split, split_len, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
