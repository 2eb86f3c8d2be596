// Flash chunk-query attention over (slot cache ∪ chunk) on Hopper's
// tensor cores (sm_90a), bf16, head dim D = 64 or 128.
//
// Replaces the Pallas TPU kernel `chunk_attention_pallas`
// (src/repro/kernels/chunk_attention.py, body `_chunk_kernel`) on the
// bf16 route; float32 keeps chunk_attention.cu. Same function: the C
// queries of a prefill chunk attend over the M cache slots of
// cache_k / cache_v [B, Hkv, M, D] (per-slot cache_pos, -1 empty) and
// then over the chunk's own keys k_c / v_c [B, C, Hkv, D], causally by
// chunk_pos. A key is visible iff its position is >= 0 and
// 0 <= q_pos - k_pos (< window when windowed); padded queries
// (chunk_pos -1) see nothing and give 0. With probs, the normalized
// probabilities over the cache slots per q head [B, Hq, C, M] float32
// (the wrapper averages them over each GQA group).
//
// Design (hopper_flash.cuh): one CTA per (lane, q head, 128-row q
// tile), two consumer warpgroups of 64 rows on wgmma, taking turns at
// the tensor cores, one producer thread feeding 128-key tiles by TMA
// through a 2-stage mbarrier ring (4 stages at D = 64, in the same
// room) —
// first the cache tiles (4-D map over [B, Hkv, M, D]), then the chunk
// tiles (4-D map over [B, C, Hkv, D]). Before the roles split, the CTA
// loads every tile's key positions and its own query positions into
// shared memory and classifies each tile; a tile no (query, key) pair
// of the CTA can see (empty slots, an empty cache on the first chunk,
// keys after the last query) is skipped before its TMA load, by
// producer and consumers alike (a list of the loaded tiles in shared
// memory). A consumer warpgroup masks only on tiles its rows do not see
// whole. Probabilities: each cache tile's raw exp(s - m_tile) is
// written with m_tile kept in shared memory, and after the last tile
// the same threads rescale what they wrote by exp(m_tile - m_final) / l.
//
// Bound on the H100: operations. At the dense main-path shape (B 4,
// C 512, Hq 32, Hkv 8, M 512, D 128, full cache, causal chunk) the visible
// pairs need 4 * B * Hq * D * C * (M + (C + 1) / 2) ~ 25.8 GFLOP, 26 us
// at 989 TF/s bf16; the ~38 MB it must move take 11 us. What it
// leaves: each CTA is short (at most 8 tiles), so its set-up (positions,
// spans, the Q load) is a visible share; one CTA per q head re-reads
// its kv head's cache from L2.
#include "hopper_flash.cuh"

using namespace hf;

// a 2-stage ring at D = 128: a third would leave no room for the
// positions; at D = 64 a stage takes half, and 4 fit the same room
template <int D> constexpr int STAGES = D == 64 ? 4 : 2;
template <int D> using KVRing = Ring<STAGES<D>, D>;

namespace {

// Row range of a consumer warpgroup and key range of a tile, over
// positions >= 0 (all: all 64 rows / all BN keys valid).
struct Span {
  int lo, hi, all;
};

// The mask of a warpgroup's tile: key c is visible to query r iff
// kpos[c] >= 0 and 0 <= qpos[r] - kpos[c] (< window when windowed);
// one column (two rows) at a time.
struct PosMask {
  const int *qpos;  // the warpgroup's 64 query positions
  const int *kpos;  // the tile's BN key positions
  int window;
  __device__ void operator()(float (&s)[64]) const {
    const int c0 = frag_col0();
    const int q[2] = {qpos[frag_row()], qpos[frag_row() + 8]};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = kpos[8 * j + c0 + e];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int dist = q[r] - kp;
          if (!(kp >= 0 && dist >= 0 && (window <= 0 || dist < window)))
            s[4 * j + 2 * r + e] = HF_MINUS_INF;
        }
      }
  }
};

// Whether every (query, key) pair of a warpgroup's rows and a tile's
// keys is visible, so the tile needs no mask.
__device__ __forceinline__ bool fully_visible(const Span &q, const Span &k,
                                              int window) {
  return q.all && k.all && q.lo >= k.hi &&
         (window <= 0 || q.hi - k.lo < window);
}

// min / max / all of the positions >= 0 among one value per lane
__device__ __forceinline__ Span warp_span(int p, bool valid) {
  int lo = valid ? p : INT_MAX, hi = valid ? p : -1;
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  return Span{lo, hi, __all_sync(0xffffffffu, valid)};
}
__device__ __forceinline__ Span join(Span a, Span b) {
  return Span{min(a.lo, b.lo), max(a.hi, b.hi), a.all & b.all};
}

// Raw probabilities of a cache tile for one consumer thread's entries,
// and the running max they were scaled by.
struct ProbsHook {
  float *rows[2];   // probs row of the thread's two rows, or null
  float *mblk[2];   // m_tile slot of the two rows for this tile
  int key0, M;
  __device__ void operator()(const float (&p)[64], const float (&m)[2]) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] == nullptr) continue;
      *mblk[r] = m[r];
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = key0 + 8 * j + frag_col0() + e;
          if (key < M) rows[r][key] = p[4 * j + 2 * r + e];
        }
    }
  }
};

// A consumer warpgroup's tiles: the CTA's loaded tiles list[0 .. n),
// with the cache tiles' raw probabilities written when probs is set.
struct ChunkTiles {
  int n, n_mt, window, M;
  const int *list, *qpos_wg, *kpos;
  const Span *spans;
  Span qs;
  float scale_log2;
  bool probs;
  float *prow[2], *mrow[2];
  __device__ int count() const { return n; }
  __device__ void softmax(int it, float (&s)[64], Rows &st,
                          float (&alpha)[2]) const {
    const int t = list[it];
    // a tile this warpgroup cannot see runs masked: all its p are 0
    const bool masked = !fully_visible(qs, spans[t], window);
    const PosMask mask{qpos_wg, kpos + t * BN, window};
    if (t < n_mt && probs)
      softmax_step(s, st, alpha, scale_log2, masked, mask,
                   ProbsHook{{prow[0], prow[1]}, {mrow[0] + t, mrow[1] + t},
                             t * BN, M});
    else
      softmax_step(s, st, alpha, scale_log2, masked, mask, NoHook());
  }
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
chunk_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kc_map,
                const __grid_constant__ CUtensorMap vc_map,
                const __grid_constant__ CUtensorMap ck_map,
                const __grid_constant__ CUtensorMap cv_map,
                const int *__restrict__ cache_pos,
                const int *__restrict__ chunk_pos,
                __nv_bfloat16 *__restrict__ out, float *__restrict__ probs,
                int B, int C, int Hq, int Hkv, int M, int window,
                float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  using R = KVRing<D>;
  constexpr int S = STAGES<D>;
  const R ring = R::carve(smem_raw);
  const int n_qt = (C + BM - 1) / BM;
  const int n_mt = (M + BN - 1) / BN, n_ct = (C + BN - 1) / BN;
  const int n_tiles = n_mt + n_ct;
  const int bh = blockIdx.x % (B * Hq);
  const int qt = n_qt - 1 - blockIdx.x / (B * Hq);  // heaviest first
  const int b = bh / Hq, h = bh % Hq, kvh = h / (Hq / Hkv);
  const int c0 = qt * BM;
  const bool want_probs = probs != nullptr;

  // shared arrays after the ring
  int *qpos = reinterpret_cast<int *>(ring.extra);      // [BM]
  int *kpos = qpos + BM;                                 // [n_tiles * BN]
  Span *tiles = reinterpret_cast<Span *>(kpos + n_tiles * BN);  // [n_tiles]
  Span *wgs = tiles + n_tiles;                           // [2]
  int *vis = reinterpret_cast<int *>(wgs + 2);           // [n_tiles]
  int *list = vis + n_tiles;                             // [n_tiles + 1]
  float *mblk = reinterpret_cast<float *>(list + n_tiles + 1);  // [BM][n_mt]

  const int *cpos_b = chunk_pos + (long)b * C;
  const long bhkv = (long)b * Hkv + kvh;
  for (int r = threadIdx.x; r < BM; r += NTHREADS)
    qpos[r] = c0 + r < C ? cpos_b[c0 + r] : -1;
  for (int e = threadIdx.x; e < n_tiles * BN; e += NTHREADS) {
    const int t = e / BN, key = (t < n_mt ? t : t - n_mt) * BN + e % BN;
    kpos[e] = t < n_mt ? (key < M ? cache_pos[bhkv * M + key] : -1)
                       : (key < C ? cpos_b[key] : -1);
  }
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  // spans of the two warpgroups' rows and of every tile's keys; a tile
  // is loaded iff some (row, key) pair of the CTA is visible
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Span wsp[2];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const int p0 = qpos[64 * w + lane], p1 = qpos[64 * w + 32 + lane];
    wsp[w] = join(warp_span(p0, p0 >= 0), warp_span(p1, p1 >= 0));
  }
  if (threadIdx.x == 0) {
    wgs[0] = wsp[0];
    wgs[1] = wsp[1];
  }
  const int q_hi = max(wsp[0].hi, wsp[1].hi);
  for (int t = warp; t < n_tiles; t += NTHREADS / 32) {
    Span sp{INT_MAX, -1, 1};
    int seen = 0;
#pragma unroll
    for (int i = 0; i < BN / 32; ++i) {
      const int kp = kpos[t * BN + 32 * i + lane];
      sp = join(sp, warp_span(kp, kp >= 0));
      bool v = kp >= 0 && kp <= q_hi;
      if (v && window > 0) {
        v = false;
        for (int r = 0; r < BM && !v; ++r) {
          const int d = qpos[r] - kp;
          v = qpos[r] >= 0 && d >= 0 && d < window;
        }
      }
      seen |= __any_sync(0xffffffffu, v);
    }
    if (lane == 0) {
      tiles[t] = sp;
      vis[t] = seen;
    }
  }
  __syncthreads();
  // the loaded tiles in order; list[n_tiles] holds their count
  if (threadIdx.x == 0) {
    int n = 0;
    for (int t = 0; t < n_tiles; ++t)
      if (vis[t]) list[n++] = t;
    list[n_tiles] = n;
  }
  __syncthreads();
  const int n_load = list[n_tiles];

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(ring.qbar, R::Q_BYTES);
      tma_tile<D>(ring.q, Q_BOX, &qmap, ring.qbar, h, c0, b);
      for (int it = 0; it < n_load; ++it) {
        const int t = list[it], s = it % S;
        mbar_wait(&ring.empty[s], ((it / S) & 1) ^ 1);
        mbar_expect_tx(&ring.full[s], 2 * R::KV_BYTES);
        if (t < n_mt) {
          tma_tile<D>(ring.k(s), KV_BOX, &ck_map, &ring.full[s], t * BN, kvh, b);
          tma_tile<D>(ring.v(s), KV_BOX, &cv_map, &ring.full[s], t * BN, kvh, b);
        } else {
          const int j0 = (t - n_mt) * BN;
          tma_tile<D>(ring.k(s), KV_BOX, &kc_map, &ring.full[s], kvh, j0, b);
          tma_tile<D>(ring.v(s), KV_BOX, &vc_map, &ring.full[s], kvh, j0, b);
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const Span qs = wgs[wg];
    const int *qpos_wg = qpos + 64 * wg;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    Rows st;
    st.init();
    // this thread's two rows: their probs rows (null past C) and m_tile slots
    float *prow[2] = {nullptr, nullptr};
    float *mrow[2] = {nullptr, nullptr};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int R = 64 * wg + frag_row() + 8 * r;
      mrow[r] = mblk + R * n_mt;
      if (want_probs && c0 + R < C)
        prow[r] = probs + (((long)b * Hq + h) * C + c0 + R) * M;
    }
    // zeros for the cache tiles no pair of the CTA can see (not loaded)
    if (want_probs) {
      float zero[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) zero[i] = 0.f;
      for (int t = 0; t < n_mt; ++t)
        if (!vis[t])
          ProbsHook{{prow[0], prow[1]}, {mrow[0] + t, mrow[1] + t}, t * BN,
                    M}(zero, st.m);
    }
    const ChunkTiles walk{n_load, n_mt, window, M, list, qpos_wg, kpos, tiles,
                          qs, scale_log2, want_probs, {prow[0], prow[1]},
                          {mrow[0], mrow[1]}};
    mbar_wait(ring.qbar, 0);
    consume(ring, ring.q + wg * 64 * 128, wg, walk, o, st);  // 64 rows x 128 B
    finish_rows(st);
    store_out(o, st, [&](int r) -> __nv_bfloat16 * {
      const int c = c0 + 64 * wg + r;
      return c < C ? out + (((long)b * C + c) * Hq + h) * D : nullptr;
    });
    if (want_probs) {
      // rescale the raw probabilities this thread wrote
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (prow[r] == nullptr) continue;
        const float inv = 1.f / fmaxf(st.l[r], 1e-30f);
        for (int t = 0; t < n_mt; ++t) {
          const float sc = fast_exp2(mrow[r][t] - st.m[r]) * inv;
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = t * BN + 8 * j + frag_col0() + e;
              if (key < M) prow[r][key] *= sc;
            }
        }
      }
    }
  }
}

template <int D>
size_t chunk_smem(int C, int M, bool probs) {
  const int n_mt = (M + BN - 1) / BN, n_ct = (C + BN - 1) / BN;
  const int n_tiles = n_mt + n_ct;
  return KVRing<D>::bytes() + BM * 4 + (size_t)n_tiles * BN * 4 +
         (size_t)(n_tiles + 2) * sizeof(Span) + (2 * n_tiles + 1) * 4 +
         (probs ? (size_t)BM * n_mt * 4 : 0);
}

template <int D>
cudaError_t launch(const void *q, const void *k_c, const void *v_c,
                   const void *cache_k, const void *cache_v,
                   const void *cache_pos, const void *chunk_pos, void *out,
                   void *probs, int B, int C, int Hq, int Hkv, int M,
                   int window, cudaStream_t stream) {
  CUtensorMap qmap, kc_map, vc_map, ck_map, cv_map;
  cudaError_t err;
  if ((err = map_bthd(&qmap, q, B, C, Hq, D, BM)) != cudaSuccess) return err;
  if ((err = map_bthd(&kc_map, k_c, B, C, Hkv, D, BN)) != cudaSuccess) return err;
  if ((err = map_bthd(&vc_map, v_c, B, C, Hkv, D, BN)) != cudaSuccess) return err;
  if ((err = map_bhmd(&ck_map, cache_k, B, Hkv, M, D, BN)) != cudaSuccess) return err;
  if ((err = map_bhmd(&cv_map, cache_v, B, Hkv, M, D, BN)) != cudaSuccess) return err;
  const size_t smem = chunk_smem<D>(C, M, probs != nullptr);
  if ((err = allow_smem((const void *)chunk_tc_kernel<D>, smem)) != cudaSuccess)
    return err;
  const int n_qt = (C + BM - 1) / BM;
  const float scale_log2 = LOG2E / sqrtf((float)D);
  chunk_tc_kernel<D><<<B * Hq * n_qt, NTHREADS, smem, stream>>>(
      qmap, kc_map, vc_map, ck_map, cv_map, (const int *)cache_pos,
      (const int *)chunk_pos, (__nv_bfloat16 *)out, (float *)probs, B, C, Hq,
      Hkv, M, window, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q, k_c, v_c bf16 [B, C, H*, D]; cache_k, cache_v bf16 [B, Hkv, M, D]
// with D 64 or 128; all contiguous and 16-byte aligned; cache_pos int32
// [B, Hkv, M]; chunk_pos int32 [B, C]; probs float32 [B, Hq, C, M] or
// null. Returns a cudaError_t (cudaErrorInvalidValue when M + C needs
// more shared memory than a block has).
extern "C" int chunk_attention_tc_launch(
    const void *q, const void *k_c, const void *v_c, const void *cache_k,
    const void *cache_v, const void *cache_pos, const void *chunk_pos,
    void *out, void *probs, int B, int C, int Hq, int Hkv, int M, int D,
    int window, void *stream) {
  if (Hq % Hkv != 0 || B <= 0 || C <= 0 || M <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (D == 128)
    return (int)launch<128>(q, k_c, v_c, cache_k, cache_v, cache_pos,
                            chunk_pos, out, probs, B, C, Hq, Hkv, M, window,
                            st);
  if (D == 64)
    return (int)launch<64>(q, k_c, v_c, cache_k, cache_v, cache_pos,
                           chunk_pos, out, probs, B, C, Hq, Hkv, M, window,
                           st);
  return (int)cudaErrorInvalidValue;
}
