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
// single-shot prefill runs it causal with no bias. Head dim D <= 256,
// a multiple of 4 (the tile step holds 128 or 256 dims); rows whose
// keys are all masked give zero (the Pallas kernel returns the mean of
// the masked values there; no caller produces such a row).
//
// Bound on the H100: operations. At the main-path shape (B=4, T=2000,
// Hq=32, D=128, causal) the visible pairs need
// 4 * B * Hq * D * T (T + 1) / 2 ~ 131 GFLOP, about 2.0 ms at
// 67 TF/s float32 outside the tensor cores; the 2 * 4 * 2000 * 8 *
// 128 * 4 B = 66 MB of K/V and 262 MB of q and out take about 0.1 ms.
// Full float32 FMAs throughout, no TF32: this route holds the card to
// the CPU within 1e-4.
//
// Design: an SGEMM-style flash kernel on the CUDA cores, its tile step
// in f32_flash.cuh (shared with the float32 chunk kernel). One CTA of
// 256 threads per (lane, kv head, tile of 128 / G query positions)
// serves the G q heads of the kv head together: 128 query rows, row
// r = (position r / G, head r % G), held in shared memory, so each K/V
// tile is staged once for the whole group. Key tiles of 64 are copied
// with 16-byte cp.async: K is double-buffered and the next tile's K
// streams in during the whole of this one, while this tile's V streams
// in during its S, so a tile takes two barriers (Q's 66 KB leave no
// room for a second V buffer). Both products are register-blocked: a
// thread owns an 8 x 4 block of S (rows r, r + 16, ..., keys j,
// j + 16, ...) and an 8 x 8 block of O (8 neighbouring rows, dims
// 4 c .. 4 c + 3 and 64 + 4 c ..), every operand read as a float4 from
// padded rows so that a warp's reads are conflict-free. The online
// softmax stays in registers, in base 2 (exp2f): the 16 threads of a
// row reduce its max and sum with shuffles, and only P^T and the
// rescale factors pass through shared memory to the P.V layout. Key
// tiles outside the causal mask and window are never loaded; tiles
// inside them skip the per-element mask. The heaviest (last) query
// tiles are launched first.
//
// At head dim 256 (recurrentgemma-2b, gemma3-12b) the step holds 256
// dims and the CTA 64 rows (64 / G positions) with key tiles of 32, so
// Q, K, V and P^T fit in 175 KB (f32_flash.cuh, Tile<256>).
//
// What it leaves on the table: one CTA of 8 warps per SM (202 KB of
// shared memory, 220 registers a thread), so a barrier or a
// shared-memory latency idles the FFMA pipes: the kernel runs at about
// half the float32 peak; the K reads take two wavefronts a warp; the
// diagonal tiles compute their masked half.
#include "f32_flash.cuh"

namespace {

using namespace f32flash;

// Q, K, V, P^T (f32_flash.cuh), then the rescale factors and
// denominators of the rows and the tile's log beta, double-buffered
template <class K>
constexpr size_t SMEM_FLOATS = K::TILE_FLOATS + 2 * K::BR + 2 * K::BK;

template <int DP>
__global__ void __launch_bounds__(NTH, 1)
retention_f32_kernel(const float *__restrict__ q, const float *__restrict__ k,
                     const float *__restrict__ v,
                     const float *__restrict__ log_beta,
                     float *__restrict__ out, int Tq, int Tk, int Hq, int Hkv,
                     int D, int causal, int window, int q_offset,
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
  float *s_lb0 = s_l + BR;          // [2][BK]  log beta, with K

  const int G = Hq / Hkv, BQ = BR / G;  // query positions per CTA
  const int n_qt = (Tq + BQ - 1) / BQ;
  const int n_bh = gridDim.x / n_qt;
  const int qt = n_qt - 1 - (int)blockIdx.x / n_bh;  // longest rows first
  const int bh = blockIdx.x % n_bh, b = bh / Hkv, kvh = bh % Hkv;
  const int r0 = qt * BQ;
  const int n_rows = min(BQ, Tq - r0) * G;  // rows holding a query
  const bool use_beta = log_beta != nullptr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the softmax runs in base 2: logits times log2(e), exp2f
  const float scale2 = scale * LOG2E;

  load_q<K>(sq, q, b, Tq, r0, Hq, kvh, G, n_rows, D);

  // the keys the tile's rows can see
  const int q_lo = q_offset + r0, q_hi = q_lo + n_rows / G - 1;
  const int j_end = causal ? min(Tk, q_hi + 1) : Tk;
  const int j_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int t_begin = j_begin / BK;
  const int t_end = j_end > j_begin ? (j_end + BK - 1) / BK : t_begin;
  const long kv_ld = (long)Hkv * D;
  auto kv_row = [&](int j0) { return ((long)(b * Tk + j0) * Hkv + kvh) * D; };

  auto load_k = [&](int t) {
    const int j0 = t * BK;
    load_keys<K>(sk0 + (t & 1) * BK * QLD, QLD, k + kv_row(j0), kv_ld,
              min(BK, Tk - j0), D);
    if (use_beta && tid < BK) {
      const bool ok = j0 + tid < Tk;
      cp_async4(s_lb0 + (t & 1) * BK + tid,
                log_beta + (ok ? (long)(b * Tk + j0 + tid) * Hkv + kvh : 0), ok);
    }
  };
  if (t_begin < t_end) load_k(t_begin);
  flash::cp_async_commit();             // Q and the first K

  // S roles: rows srg + 16 i, keys skg + 16 j. O roles: rows 8 srg + i,
  // dims 4 skg + {0..3} and 64 + 4 skg + {0..3}.
  const int srg = warp * 2 + (lane >> 4), skg = lane & 15;
  float m[RI], l[RI], o[RI][OC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) o[i][c] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * BK;
    const float *sk = sk0 + (t & 1) * BK * QLD;
    const float *s_lb = s_lb0 + (t & 1) * BK;
    flash::cp_async_wait<0>();  // K(t) (and Q)
    // every warp is done with S(t - 1) (K's other buffer) and with
    // P.V(t - 1) (V and P^T): V(t) streams in during S(t), K(t + 1)
    // during the whole tile
    __syncthreads();
    load_keys<K>(sv, DP, v + kv_row(j0), kv_ld, min(BK, Tk - j0), D);
    flash::cp_async_commit();
    if (t + 1 < t_end) load_k(t + 1);
    flash::cp_async_commit();

    float s[RI][SJ];
    qk<K>(sq, sk, srg, skg, s);

    // online softmax in registers; a tile the mask, window and Tk leave
    // whole for every row skips the per-element mask
    const bool edge = use_beta || j0 + BK > Tk ||
                      (causal && j0 + BK - 1 > q_lo) ||
                      (window > 0 && q_hi - j0 >= window);
    float alpha[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float x[SJ];
      unsigned ok = (1u << SJ) - 1;
      if (!edge) {
#pragma unroll
        for (int j = 0; j < SJ; ++j) x[j] = s[i][j] * scale2;
      } else {
        const int r = srg + 16 * i;
        const int qp = q_lo + r / G;
        ok = 0u;
#pragma unroll
        for (int j = 0; j < SJ; ++j) {
          const int key = j0 + skg + 16 * j;
          const int dist = qp - key;
          const bool vis = r < n_rows && key < Tk && (!causal || dist >= 0) &&
                           (window <= 0 || dist < window);
          const float bias = use_beta ? (float)dist * s_lb[skg + 16 * j] : 0.f;
          x[j] = vis ? fmaf(s[i][j], scale2, bias * LOG2E) : NEG_INF;
          ok |= (unsigned)vis << j;
        }
      }
      alpha[i] = softmax_row(x, ok, s[i], m[i], l[i]);
    }
    store_p<K>(sp, s_alpha, s, alpha, srg, skg);
    flash::cp_async_wait<1>();  // V(t); K(t + 1) may be in flight
    __syncthreads();
    pv<K>(o, sp, sv, s_alpha, srg, skg);
  }
  flash::cp_async_wait<0>();

  if (skg == 0) {
#pragma unroll
    for (int i = 0; i < RI; ++i) s_l[srg + 16 * i] = l[i];
  }
  __syncthreads();
  store_out<K>(out, o, s_l, b, Tq, r0, Hq, kvh, G, n_rows, D, srg, skg);
}

template <int DP>
cudaError_t launch(const void *q, const void *k, const void *v,
                   const void *log_beta, void *out, int B, int Tq, int Tk,
                   int Hq, int Hkv, int D, int causal, int window,
                   int q_offset, cudaStream_t stream) {
  using K = Tile<DP>;
  if (Hq / Hkv > K::BR) return cudaErrorInvalidValue;
  const int BQ = K::BR / (Hq / Hkv);
  const int grid = B * Hkv * ((Tq + BQ - 1) / BQ);
  if (grid == 0) return cudaSuccess;
  const size_t smem = SMEM_FLOATS<K> * sizeof(float);
  cudaError_t err =
      flash::allow_smem((const void *)retention_f32_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  retention_f32_kernel<DP><<<grid, NTH, smem, stream>>>(
      (const float *)q, (const float *)k, (const float *)v,
      (const float *)log_beta, (float *)out, Tq, Tk, Hq, Hkv, D, causal,
      window, q_offset, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// q, k, v float32 [B, T*, H*, D], D <= 256 a multiple of 4 (held as 128
// or 256), contiguous, 16-byte aligned; log_beta float32 [B, Tk, Hkv]
// or null. Returns a cudaError_t.
extern "C" int retention_attention_launch(
    const void *q, const void *k, const void *v, const void *log_beta,
    void *out, int B, int Tq, int Tk, int Hq, int Hkv, int D, int causal,
    int window, int q_offset, void *stream) {
  if (D > 256 || D % 4 != 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (D <= 128)
    return (int)launch<128>(q, k, v, log_beta, out, B, Tq, Tk, Hq, Hkv, D,
                            causal, window, q_offset, st);
  return (int)launch<256>(q, k, v, log_beta, out, B, Tq, Tk, Hq, Hkv, D,
                          causal, window, q_offset, st);
}
