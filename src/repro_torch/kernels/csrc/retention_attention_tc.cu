// Retention-gated causal flash attention on Hopper's tensor cores
// (sm_90a), bf16, D = 128.
//
// Replaces the Pallas TPU kernel `retention_attention_pallas`
// (src/repro/kernels/retention_attention.py, body `_flash_kernel`) on
// the bf16 route; float32 keeps retention_attention.cu. Same function:
// attention of q [B, Tq, Hq, D] over k, v [B, Tk, Hkv, D] with GQA, an
// optional causal mask and window from the absolute query position
// q_offset + row, and an optional retention bias (q_pos - i) *
// log_beta_i on the logits of visible keys (log_beta [B, Tk, Hkv]
// float32). A row with no visible key gives exactly 0.
//
// Design (hopper_flash.cuh): one CTA per (lane, q head, 128-row q
// tile), two consumer warpgroups of 64 rows on wgmma, taking turns at
// the tensor cores, one producer thread feeding K/V tiles of 128 keys
// by TMA through a 3-stage mbarrier ring; each warpgroup runs the
// softmax of one tile while the P.V of the one before is in flight.
// The CTA walks only the key tiles its rows can see under the causal
// mask and the window; a warpgroup masks and biases only on tiles that
// cross the diagonal, the window edge or the end of Tk / Tq, or when
// log_beta is given, against two bounds per row (a row sees a
// contiguous run of keys). q tiles launch heaviest (latest) first, so
// the causal triangle's long CTAs start early on the 132 SMs.
//
// Bound on the H100: operations. At the main-path shape (B 4, T 2000,
// Hq 32, Hkv 8, D 128, causal) the visible pairs need
// 4 * B * Hq * D * T (T + 1) / 2 ~ 131 GFLOP, 0.133 ms at 989 TF/s
// bf16; the 66 MB of q, k, v and out take 0.02 ms at 3.35 TB/s.
// What it leaves: each q tile of a GQA group re-reads K/V from L2, each
// CTA pays its own prologue (Q and the first tiles) with one CTA per
// SM, and the diagonal tile is computed whole and masked.
#include "hopper_flash.cuh"

using namespace hf;

// a 3-stage ring: 224 KB of shared memory with Q
constexpr int STAGES = 3;
using KVRing = Ring<STAGES>;

namespace {

// The mask and bias of a warpgroup's tile. Row r sees a contiguous run
// of the tile's columns, so each thread tests its registers' constant
// columns against two bounds per row, and adds the bias one column (two
// rows) at a time: few live registers beside the accumulators.
struct RetentionMask {
  int dist0;       // q_offset + row0 - j0: the distance at (row 0, col 0)
  int rows, cols;  // rows < Tq - row0 and columns < Tk - j0 exist
  int causal, window, Hkv;
  const float *lb;  // log_beta[b, j0:, kvh] (stride Hkv) or null
  __device__ void operator()(float (&s)[64]) const {
    const int c0 = frag_col0();
    int d[2];  // distance at column c0 of the thread's two rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = frag_row() + 8 * r;
      d[r] = dist0 + row - c0;
      // visible columns c0 + c with lo <= c <= hi
      int hi = cols - 1 - c0, lo = -c0;
      if (causal) hi = min(hi, d[r]);
      if (window > 0) lo = max(lo, d[r] - window + 1);
      if (row >= rows) hi = lo - 1;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + e;
          if (c < lo || c > hi) s[4 * j + 2 * r + e] = HF_MINUS_INF;
        }
    }
    if (lb == nullptr) return;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + e;
        const float b =
            c0 + c < cols ? __ldg(lb + (long)(c0 + c) * Hkv) * LOG2E : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r)  // -inf stays -inf
          s[4 * j + 2 * r + e] += (float)(d[r] - c) * b;
      }
  }
};

// Whether every (row, key) pair of rows [row0, row0 + nrows) of a
// warpgroup (nrows == 64) and keys [j0, j0 + BN) is visible with no
// bias, so the tile needs no mask.
__device__ __forceinline__ bool fully_visible(int row0, int nrows, int j0,
                                              int Tk, int causal, int window,
                                              int q_offset, bool bias) {
  const int qa = q_offset + row0, qb = qa + nrows - 1;
  return !bias && nrows == 64 && j0 + BN <= Tk &&
         (!causal || j0 + BN - 1 <= qa) && (window <= 0 || qb - j0 < window);
}

// A consumer warpgroup's tiles: rows [row0, row0 + nrows) of q, key
// tiles t_begin .. t_begin + n - 1.
struct RetentionTiles {
  int n, t_begin, row0, nrows, Tq, Tk, causal, window, q_offset, Hkv;
  const float *lb;
  float scale_log2;
  __device__ int count() const { return n; }
  __device__ void softmax(int it, float (&s)[64], Rows &st,
                          float (&alpha)[2]) const {
    const int j0 = (t_begin + it) * BN;
    // a tile this warpgroup cannot see runs masked: all its p are 0
    const bool masked = !fully_visible(row0, nrows, j0, Tk, causal, window,
                                       q_offset, lb != nullptr);
    const RetentionMask mask{q_offset + row0 - j0, Tq - row0, Tk - j0,
                             causal, window, Hkv,
                             lb != nullptr ? lb + (long)j0 * Hkv : nullptr};
    softmax_step(s, st, alpha, scale_log2, masked, mask, NoHook());
  }
};

__global__ void __launch_bounds__(NTHREADS, 1)
retention_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const float *__restrict__ log_beta,
                    __nv_bfloat16 *__restrict__ out, int B, int Tq, int Tk,
                    int Hq, int Hkv, int causal, int window, int q_offset,
                    float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const KVRing ring = KVRing::carve(smem_raw);
  const int n_qt = (Tq + BM - 1) / BM;
  const int bh = blockIdx.x % (B * Hq);
  const int qt = n_qt - 1 - blockIdx.x / (B * Hq);  // heaviest first
  const int b = bh / Hq, h = bh % Hq, kvh = h / (Hq / Hkv);
  const int r0 = qt * BM, nrows = min(BM, Tq - r0);

  // key tiles the CTA's rows can see
  const int q_lo = q_offset + r0, q_hi = q_lo + nrows - 1;
  const int j_end = causal ? min(Tk, q_hi + 1) : Tk;
  const int j_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int t_begin = j_begin / BN;
  const int n_tiles = max(0, (j_end + BN - 1) / BN - t_begin);

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: Q once, then the ring
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(ring.qbar, Q_BYTES);
      tma_tile(ring.q, Q_BOX, &qmap, ring.qbar, h, r0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        mbar_wait(&ring.empty[s], ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(&ring.full[s], 2 * KV_BYTES);
        const int j0 = (t_begin + it) * BN;
        tma_tile(ring.k(s), KV_BOX, &kmap, &ring.full[s], kvh, j0, b);
        tma_tile(ring.v(s), KV_BOX, &vmap, &ring.full[s], kvh, j0, b);
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int row0 = r0 + 64 * wg;
    const float *lb =
        log_beta != nullptr ? log_beta + (long)b * Tk * Hkv + kvh : nullptr;
    const RetentionTiles tiles{n_tiles, t_begin, row0, min(64, Tq - row0),
                               Tq, Tk, causal, window, q_offset, Hkv, lb,
                               scale_log2};
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    Rows st;
    st.init();
    mbar_wait(ring.qbar, 0);
    consume(ring, ring.q + wg * 64 * 128, wg, tiles, o, st);  // 64 rows x 128 B
    finish_rows(st);
    store_out(o, st, [&](int r) -> __nv_bfloat16 * {
      const int row = row0 + r;
      return row < Tq ? out + (((long)b * Tq + row) * Hq + h) * D : nullptr;
    });
  }
}

}  // namespace

// q, k, v bf16 [B, T*, H*, 128], contiguous, 16-byte aligned; log_beta
// float32 [B, Tk, Hkv] or null. Returns a cudaError_t.
extern "C" int retention_attention_tc_launch(
    const void *q, const void *k, const void *v, const void *log_beta,
    void *out, int B, int Tq, int Tk, int Hq, int Hkv, int causal, int window,
    int q_offset, void *stream) {
  if (Hq % Hkv != 0 || B <= 0 || Tq <= 0 || Tk <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap;
  cudaError_t err;
  if ((err = map_bthd(&qmap, q, B, Tq, Hq, BM)) != cudaSuccess) return (int)err;
  if ((err = map_bthd(&kmap, k, B, Tk, Hkv, BN)) != cudaSuccess) return (int)err;
  if ((err = map_bthd(&vmap, v, B, Tk, Hkv, BN)) != cudaSuccess) return (int)err;
  const size_t smem = KVRing::bytes();
  if ((err = allow_smem((const void *)retention_tc_kernel, smem)) != cudaSuccess)
    return (int)err;
  const int n_qt = (Tq + BM - 1) / BM;
  const float scale_log2 = LOG2E / sqrtf((float)D);
  retention_tc_kernel<<<B * Hq * n_qt, NTHREADS, smem, (cudaStream_t)stream>>>(
      qmap, kmap, vmap, (const float *)log_beta, (__nv_bfloat16 *)out, B, Tq,
      Tk, Hq, Hkv, causal, window, q_offset, scale_log2);
  return (int)cudaGetLastError();
}
