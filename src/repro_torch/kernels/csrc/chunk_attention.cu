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
// Head dim D <= 256, a multiple of 4 (the tile step holds 128 or 256
// dims); any G = Hq / Hkv up to the tile's rows (128, or 64 at D > 128).
//
// Bound on the H100: operations. At the main-path shape (B=4, C=512,
// Hq=32, Hkv=8, M=512, D=128) a full cache and a causal chunk give
// 4 * B * Hq * D * C * (M + (C + 1) / 2) ~ 25.8 GFLOP per call, about
// 0.38 ms at 67 TF/s float32 outside the tensor cores; the ~101 MB it
// must move take 30 us. Full float32 FMAs throughout, no TF32: this
// route holds the card to the CPU within 1e-4.
//
// Design: the SGEMM-style tile step of the float32 retention kernel
// (f32_flash.cuh) over two key sources. One CTA of 256 threads per
// (lane, kv head, tile of BQ = 128 / G chunk positions; row_plan in
// kernels/chunk_attention.py) holds 128 query rows, row
// r = (position r / G, head r % G), so each K/V tile is staged once
// for the G heads of the group. Before any key is loaded the CTA reads
// the positions of its queries and of every key, and marks each tile of
// 64 keys — the cache tiles cache_k[b, kvh, m0 : m0 + 64] (contiguous
// rows), then the chunk tiles k_c[b, j0 : j0 + 64, kvh] (row stride
// Hkv * D) — as visible (some (row, key) pair is) and whole (every row
// holds a query and sees every key). It walks only the visible tiles,
// one list and one tile step for both sources: empty cache tiles and
// chunk tiles after the rows' last position are never loaded, and whole
// tiles skip the per-element mask. Tiles are copied with 16-byte
// cp.async, K double-buffered so that the next visible tile's K streams
// in during this one, V during this tile's S. The last (heaviest) row
// tiles are launched first.
//
// Probabilities (need_probs, off the TRIM-KV path): each visible cache
// tile writes its raw exp2(x - m_tile) from P^T, and its rows' running
// max m_tile to the scratch pmax [B, Hq, C, n_cache_tiles]; a last pass
// rescales them by exp2(m_tile - m_final) / l and writes 0 for the
// tiles never loaded.
//
// At head dim 256 (recurrentgemma-2b, gemma3-12b) the step holds 256
// dims, the CTA 64 rows (BQ = 64 / G positions) and the tiles 32 keys
// (f32_flash.cuh, Tile<256>); pmax then has ceil(M / 32) columns.
//
// What it leaves on the table: the float32 retention kernel's limits
// (one CTA of 8 warps per SM, so barriers and shared-memory latency idle
// the FFMA pipes); the diagonal chunk tile of a row tile computes its
// masked part; the visibility pass costs each CTA (M + C) * 128 / G
// position tests.
#include "f32_flash.cuh"

namespace {

using namespace f32flash;

// Q, K, V, P^T (f32_flash.cuh), then the rows' rescale factors,
// denominators and maxima, and (as ints) the tile's key positions,
// double-buffered, and the query positions; the tile flags and the walk
// list follow, (2 n_tiles + 1) ints
template <class K>
constexpr size_t SMEM_FIXED = K::TILE_FLOATS + 3 * K::BR + 2 * K::BK + K::BR;
constexpr int VISIBLE = 1, WHOLE = 2;

template <int DP>
__global__ void __launch_bounds__(NTH, 1)
chunk_f32_kernel(const float *__restrict__ q, const float *__restrict__ k_c,
                 const float *__restrict__ v_c,
                 const float *__restrict__ cache_k,
                 const float *__restrict__ cache_v,
                 const int *__restrict__ cache_pos,
                 const int *__restrict__ chunk_pos, float *__restrict__ out,
                 float *__restrict__ probs, float *__restrict__ pmax, int C,
                 int Hq, int Hkv, int M, int D, int BQ, int window,
                 float scale) {
  using K = Tile<DP>;
  constexpr int BR = K::BR, BK = K::BK, QLD = K::QLD, PLD = K::PLD,
                RI = K::RI, SJ = K::SJ, OC = K::OC;
  extern __shared__ __align__(16) float smem_f[];
  float *sq = smem_f;               // [BR][QLD]
  float *sk0 = sq + BR * QLD;       // [2][BK][QLD]  K, double-buffered
  float *sv = sk0 + 2 * BK * QLD;   // [BK][DP]
  float *sp = sv + BK * DP;         // [BK][PLD]  P^T of the tile
  float *s_alpha = sp + BK * PLD;   // [BR]
  float *s_l = s_alpha + BR;        // [BR]
  float *s_m = s_l + BR;            // [BR]
  int *s_kp0 = reinterpret_cast<int *>(s_m + BR);  // [2][BK] key positions
  int *s_qpos = s_kp0 + 2 * BK;     // [BR]  positions of the CTA's queries
  int *s_flag = s_qpos + BR;        // [n_tiles]  VISIBLE | WHOLE
  const int n_mt = (M + BK - 1) / BK, n_ct = (C + BK - 1) / BK;
  const int n_tiles = n_mt + n_ct;  // cache tiles, then chunk tiles
  int *s_list = s_flag + n_tiles;   // [n_tiles]  visible tiles in order
  int *s_nvis = s_list + n_tiles;   // their count

  const int G = Hq / Hkv;  // BQ chunk positions per CTA (row_plan)
  const int n_qt = (C + BQ - 1) / BQ;
  const int n_bh = gridDim.x / n_qt;
  const int qt = n_qt - 1 - (int)blockIdx.x / n_bh;  // longest rows first
  const int bh = blockIdx.x % n_bh, b = bh / Hkv, kvh = bh % Hkv;
  const int c0 = qt * BQ;
  const int n_pos = min(BQ, C - c0);
  const int n_rows = n_pos * G;  // rows holding a query position
  const bool want_probs = probs != nullptr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float scale2 = scale * LOG2E;
  const int *cpos = cache_pos + (long)bh * M;
  const int *kpos_c = chunk_pos + (long)b * C;

  load_q<K>(sq, q, b, C, c0, Hq, kvh, G, n_rows, D);
  flash::cp_async_commit();

  // which tiles any row sees, and which every row sees whole
  if (tid < BQ) s_qpos[tid] = tid < n_pos ? kpos_c[c0 + tid] : -1;
  for (int t = tid; t < n_tiles; t += NTH) s_flag[t] = WHOLE;
  __syncthreads();
  const bool rows_whole = BQ * G == BR;
  for (int key = tid; key < M + C; key += NTH) {
    const int kp = key < M ? cpos[key] : kpos_c[key - M];
    bool any = false, all = rows_whole;
    for (int p = 0; p < BQ; ++p) {
      const int dist = s_qpos[p] - kp;
      const bool vis = s_qpos[p] >= 0 && kp >= 0 && dist >= 0 &&
                       (window <= 0 || dist < window);
      any |= vis;
      all &= vis;
    }
    const int t = key < M ? key / BK : n_mt + (key - M) / BK;
    if (any) atomicOr(s_flag + t, VISIBLE);
    if (!all) atomicAnd(s_flag + t, ~WHOLE);
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int t = 0; t < n_tiles; ++t) {
      const bool ragged = t < n_mt ? (t + 1) * BK > M : (t - n_mt + 1) * BK > C;
      if (ragged) s_flag[t] &= ~WHOLE;
      if (s_flag[t] & VISIBLE) s_list[n++] = t;
    }
    *s_nvis = n;
  }
  __syncthreads();
  const int n_vis = *s_nvis;

  // tile t's first key row, row stride, key count and positions
  struct Tile {
    long row0, ld;
    int valid;
    const int *pos;
  };
  auto tile = [&](int t) {
    if (t < n_mt) {
      const int m0 = t * BK;
      return Tile{((long)bh * M + m0) * D, (long)D, min(BK, M - m0),
                  cpos + m0};
    }
    const int j0 = (t - n_mt) * BK;
    return Tile{((long)(b * C + j0) * Hkv + kvh) * D, (long)Hkv * D,
                min(BK, C - j0), kpos_c + j0};
  };
  auto load_k = [&](int n) {
    const int t = s_list[n];
    const Tile x = tile(t);
    load_keys<K>(sk0 + (n & 1) * BK * QLD, QLD, (t < n_mt ? cache_k : k_c) + x.row0,
              x.ld, x.valid, D);
    if (tid < BK)
      cp_async4(s_kp0 + (n & 1) * BK + tid, x.pos + (tid < x.valid ? tid : 0),
                tid < x.valid);
  };
  if (n_vis > 0) load_k(0);
  flash::cp_async_commit();             // the first K

  const int srg = warp * 2 + (lane >> 4), skg = lane & 15;
  float m[RI], l[RI], o[RI][OC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) o[i][c] = 0.f;
  }
  // the probability row of row r: probs / pmax [b, kvh * G + r % G, c0 + r / G]
  auto prow = [&](int r) {
    return ((long)b * Hq + kvh * G + r % G) * C + c0 + r / G;
  };

  for (int n = 0; n < n_vis; ++n) {
    const int t = s_list[n];
    const Tile x = tile(t);
    const bool is_cache = t < n_mt;
    const float *sk = sk0 + (n & 1) * BK * QLD;
    const int *s_kp = s_kp0 + (n & 1) * BK;
    flash::cp_async_wait<0>();  // K(n) (and Q)
    // every warp is done with S(n - 1) (K's other buffer) and with
    // P.V(n - 1) (V and P^T)
    __syncthreads();
    load_keys<K>(sv, DP, (is_cache ? cache_v : v_c) + x.row0, x.ld, x.valid, D);
    flash::cp_async_commit();
    if (n + 1 < n_vis) load_k(n + 1);
    flash::cp_async_commit();

    float s[RI][SJ];
    qk<K>(sq, sk, srg, skg, s);

    const bool edge = !(s_flag[t] & WHOLE);
    float alpha[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float xs[SJ];
      unsigned ok = (1u << SJ) - 1;
      if (!edge) {
#pragma unroll
        for (int j = 0; j < SJ; ++j) xs[j] = s[i][j] * scale2;
      } else {
        const int r = srg + 16 * i;
        const int qp = r < n_rows ? s_qpos[r / G] : -1;
        ok = 0u;
#pragma unroll
        for (int j = 0; j < SJ; ++j) {
          const int key = skg + 16 * j;
          const int kp = s_kp[key];
          const int dist = qp - kp;
          const bool vis = qp >= 0 && key < x.valid && kp >= 0 && dist >= 0 &&
                           (window <= 0 || dist < window);
          xs[j] = vis ? s[i][j] * scale2 : NEG_INF;
          ok |= (unsigned)vis << j;
        }
      }
      alpha[i] = softmax_row(xs, ok, s[i], m[i], l[i]);
    }
    store_p<K>(sp, s_alpha, s, alpha, srg, skg);
    if (want_probs && is_cache && skg == 0) {
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = srg + 16 * i;
        if (r < n_rows) pmax[prow(r) * n_mt + t] = m[i];
      }
    }
    flash::cp_async_wait<1>();  // V(n); K(n + 1) may be in flight
    __syncthreads();
    pv<K>(o, sp, sv, s_alpha, srg, skg);
    if (want_probs && is_cache) {  // raw exp2(x - m_tile), rescaled below
      for (int e = tid; e < BR * BK; e += NTH) {
        const int r = e / BK, j = e - r * BK;
        if (r < n_rows && j < x.valid)
          probs[prow(r) * M + t * BK + j] = sp[j * PLD + r];
      }
    }
  }
  flash::cp_async_wait<0>();

  if (skg == 0) {
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      s_l[srg + 16 * i] = l[i];
      s_m[srg + 16 * i] = m[i];
    }
  }
  __syncthreads();
  store_out<K>(out, o, s_l, b, C, c0, Hq, kvh, G, n_rows, D, srg, skg);
  if (want_probs) {
    for (int e = tid; e < n_rows * M; e += NTH) {
      const int r = e / M, key = e - r * M, t = key / BK;
      const long row = prow(r);
      float p = 0.f;
      if (s_flag[t] & VISIBLE)
        p = probs[row * M + key] * exp2f(pmax[row * n_mt + t] - s_m[r]) /
            fmaxf(s_l[r], 1e-30f);
      probs[row * M + key] = p;
    }
  }
}

template <int DP>
cudaError_t launch(const void *q, const void *k_c, const void *v_c,
                   const void *cache_k, const void *cache_v,
                   const void *cache_pos, const void *chunk_pos, void *out,
                   void *probs, void *pmax, int B, int C, int Hq, int Hkv,
                   int M, int D, int bq, int window, cudaStream_t stream) {
  using K = Tile<DP>;
  if (bq * (Hq / Hkv) > K::BR) return cudaErrorInvalidValue;
  const int n_tiles = (M + K::BK - 1) / K::BK + (C + K::BK - 1) / K::BK;
  const size_t smem =
      SMEM_FIXED<K> * sizeof(float) + (2 * n_tiles + 1) * sizeof(int);
  if (smem > 232448) return cudaErrorInvalidValue;
  const int grid = B * Hkv * ((C + bq - 1) / bq);
  if (grid == 0) return cudaSuccess;
  cudaError_t err = flash::allow_smem((const void *)chunk_f32_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  chunk_f32_kernel<DP><<<grid, NTH, smem, stream>>>(
      (const float *)q, (const float *)k_c, (const float *)v_c,
      (const float *)cache_k, (const float *)cache_v, (const int *)cache_pos,
      (const int *)chunk_pos, (float *)out, (float *)probs, (float *)pmax, C,
      Hq, Hkv, M, D, bq, window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// q, k_c, v_c float32 [B, C, H*, D]; cache_k, cache_v [B, Hkv, M, D];
// D <= 256 a multiple of 4 (held as 128 or 256); all contiguous and
// 16-byte aligned; bq chunk positions a CTA (row_plan); probs [B, Hq, C,
// M] and pmax [B, Hq, C, ceil(M / BK)] (BK 64, or 32 at D > 128) or
// both null. Returns a cudaError_t.
extern "C" int chunk_attention_launch(
    const void *q, const void *k_c, const void *v_c, const void *cache_k,
    const void *cache_v, const void *cache_pos, const void *chunk_pos,
    void *out, void *probs, void *pmax, int B, int C, int Hq, int Hkv, int M,
    int D, int bq, int window, void *stream) {
  if (D > 256 || D % 4 != 0 || Hq % Hkv != 0 || bq < 1 ||
      (probs != nullptr && pmax == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (D <= 128)
    return (int)launch<128>(q, k_c, v_c, cache_k, cache_v, cache_pos,
                            chunk_pos, out, probs, pmax, B, C, Hq, Hkv, M, D,
                            bq, window, st);
  return (int)launch<256>(q, k_c, v_c, cache_k, cache_v, cache_pos, chunk_pos,
                          out, probs, pmax, B, C, Hq, Hkv, M, D, bq, window,
                          st);
}
