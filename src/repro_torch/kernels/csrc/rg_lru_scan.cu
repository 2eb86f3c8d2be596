// The RG-LRU recurrence of the hybrid family's recurrent blocks
// (Griffin / recurrentgemma), float32, for Hopper (sm_90a):
//
//   h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) * bx_t,
//   a_t = exp(a_log_t),
//
// over a_log, bx [B, T, W] float32 from h0 [B, W]; writes every h_t to
// out [B, T, W]. A step with a_log 0 and bx 0 (a padded chunk step) is
// the identity.
//
// Replaces no TPU kernel: the JAX package computes this
// (src/repro/models/blocks.py, _rg_lru_scan) as one
// lax.associative_scan that XLA compiles, with no Pallas kernel. It is
// written by hand because the plain PyTorch loop over T launches a few
// kernels a step, in every recurrent layer, over every prompt (18
// layers x 2048 steps x ~4 launches for one recurrentgemma-2b prefill).
//
// Bound on the H100: bytes. The function reads a_log and bx and writes
// out once, 12 bytes a (lane, step, channel), and does a handful of
// operations on each: at B 2, T 4096, W 2560 that is 252 MB, 75 us at
// 3.35 TB/s. To stream at that rate the card needs megabytes of loads
// in flight (3.35 TB/s times a microsecond of latency), so the work
// cannot be one thread walking all T steps of a channel: that keeps
// U loads a thread in flight, and B * W threads are too few.
//
// Design: a chunked scan over time. Each step is the affine map
// (a_t, g_t), g_t the gated input, and two maps compose as
// (a1, g1) then (a2, g2) = (a1 a2, a2 g1 + g2). A CTA owns one lane and
// CW channels (CW 32, 16 or 8: scan_plan in kernels/rg_lru.py narrows
// it until the grid fills the card) and walks T in tiles of
// SUBS * U = 128 steps. In a tile, thread (s, c) takes sub-chunk s (U =
// 16 steps) of channel c: it forms the chunk's running composition
// (A_u, B_u) from its first step, in registers, and leaves the whole
// chunk's (A, B) in shared memory; after one barrier, every thread
// walks the SUBS chunk maps of its channel in order from the carry the
// CTA holds in registers (h before the tile), which gives its own
// chunk's carry-in c and the next tile's carry; it writes
// h_u = A_u c + B_u. The loads of the next tile are issued before the
// current one is scanned (two register buffers of 2 x U values), so
// each thread keeps up to 4 U = 64 loads in flight: B * W * 2 KB across
// the card (10 MB at B 2, W 2560), and a warp's load at one step is CW
// neighbouring channels (CW * 4 bytes, whole 32-byte sectors).
//
// Order and rounding: the composition order is fixed by U and SUBS
// alone (a CTA of fewer sub-chunks is launched only where one tile
// covers T, which composes as the full tile would), so two launches on
// the same inputs give the same bits, whatever B, W or CW. Every
// multiply and multiply-add is written with a round-to-nearest
// intrinsic, so the compiler contracts nothing differently in two
// places. A padded step (a = 1, g = 0) leaves (A, B) unchanged exactly
// (A * 1, fma(1, B, 0)), and a chunk's carry out is the same fma as h at
// its last step, so a lane's padded tail repeats h at its last real
// step bit for bit (or h0, with no real step). The order rounds
// differently from the sequential loop and from XLA's associative
// scan, within float32's rounding of a contraction (|a| <= 1).
#include <cuda_runtime.h>

namespace {

constexpr int U = 16;     // steps of a sub-chunk, one thread's run
constexpr int SUBS = 8;   // sub-chunks a tile

__device__ __forceinline__ void gate(float al, float x, float &a, float &g) {
  a = expf(al);
  g = __fmul_rn(sqrtf(fmaxf(__fsub_rn(1.f, __fmul_rn(a, a)), 1e-12f)), x);
}

// a_log and bx of steps t .. t + U - 1 of one channel (0 past T)
__device__ __forceinline__ void load(const float *__restrict__ a_log,
                                     const float *__restrict__ bx, long base,
                                     int t, int T, int W, bool live,
                                     float (&la)[U], float (&lx)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool in = live && t + u < T;
    const long i = base + (long)(t + u) * W;
    la[u] = in ? __ldg(a_log + i) : 0.f;
    lx[u] = in ? __ldg(bx + i) : 0.f;
  }
}

// One tile: thread (s, c) scans steps t .. t + U - 1 (t = tile start +
// s * U) of its channel from the carry h, which it leaves at the tile's
// end.
template <int CW>
__device__ __forceinline__ void scan_tile(const float (&la)[U],
                                          const float (&lx)[U],
                                          float (*agg_a)[CW],
                                          float (*agg_b)[CW], int s, int c,
                                          int n_sub, float &h,
                                          float *__restrict__ out, long base,
                                          int t, int T, int W, bool live) {
  float A[U], Bc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float a = 1.f, g = 0.f;   // past T: the identity
    if (live && t + u < T) gate(la[u], lx[u], a, g);
    A[u] = u ? __fmul_rn(A[u - 1], a) : a;
    Bc[u] = u ? __fmaf_rn(a, Bc[u - 1], g) : g;
  }
  agg_a[s][c] = A[U - 1];
  agg_b[s][c] = Bc[U - 1];
  __syncthreads();
  float cin = h;
  for (int k = 0; k < n_sub; ++k) {
    if (k == s) cin = h;
    h = __fmaf_rn(agg_a[k][c], h, agg_b[k][c]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (live && t + u < T) out[base + (long)(t + u) * W] = __fmaf_rn(A[u], cin, Bc[u]);
}

// grid (ceil(W / CW), B); n_sub * CW threads, thread = s * CW + c. The
// chunk maps are double-buffered in shared memory by tile parity, so one
// barrier a tile keeps a tile's reads before the writes of the tile
// after next.
template <int CW>
__global__ void __launch_bounds__(SUBS * 32, 2)
rg_lru_scan_kernel(const float *__restrict__ a_log, const float *__restrict__ bx,
                   const float *__restrict__ h0, float *__restrict__ out, int T,
                   int W, int n_sub) {
  __shared__ float agg_a[2][SUBS][CW], agg_b[2][SUBS][CW];
  const int c = threadIdx.x % CW, s = threadIdx.x / CW;
  const int w = blockIdx.x * CW + c;
  const bool live = w < W;
  const long base = (long)blockIdx.y * T * W + w;
  float h = live ? h0[(long)blockIdx.y * W + w] : 0.f;
  const int tile = n_sub * U;
  float la0[U], lx0[U], la1[U], lx1[U];
  load(a_log, bx, base, s * U, T, W, live, la0, lx0);
  for (int t0 = 0; t0 < T; t0 += 2 * tile) {
    if (t0 + tile < T)
      load(a_log, bx, base, t0 + tile + s * U, T, W, live, la1, lx1);
    scan_tile<CW>(la0, lx0, agg_a[0], agg_b[0], s, c, n_sub, h, out, base,
                  t0 + s * U, T, W, live);
    if (t0 + tile >= T) break;
    if (t0 + 2 * tile < T)
      load(a_log, bx, base, t0 + 2 * tile + s * U, T, W, live, la0, lx0);
    scan_tile<CW>(la1, lx1, agg_a[1], agg_b[1], s, c, n_sub, h, out, base,
                  t0 + tile + s * U, T, W, live);
  }
}

template <int CW>
void launch(const float *a_log, const float *bx, const float *h0, float *out,
            int B, int T, int W, int n_sub, cudaStream_t stream) {
  const dim3 grid((W + CW - 1) / CW, B);
  rg_lru_scan_kernel<CW><<<grid, n_sub * CW, 0, stream>>>(a_log, bx, h0, out,
                                                          T, W, n_sub);
}

}  // namespace

// a_log, bx, out float32 [B, T, W]; h0 float32 [B, W]; all contiguous.
// cw (channels a CTA: 32, 16 or 8) and n_sub (sub-chunks a tile) come
// from scan_plan; n_sub < SUBS only where one tile covers T, so the
// composition order stays the fixed one. Returns a cudaError_t.
extern "C" int rg_lru_scan_launch(const void *a_log, const void *bx,
                                  const void *h0, void *out, int B, int T,
                                  int W, int cw, int n_sub, void *stream) {
  if (B <= 0 || T <= 0 || W <= 0 || B > 65535 || n_sub < 1 ||
      n_sub > SUBS || (n_sub * cw) % 32 != 0 ||
      (n_sub < SUBS && T > n_sub * U))
    return (int)cudaErrorInvalidValue;
  const float *al = (const float *)a_log, *x = (const float *)bx,
              *h = (const float *)h0;
  float *o = (float *)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (cw) {
    case 32: launch<32>(al, x, h, o, B, T, W, n_sub, st); break;
    case 16: launch<16>(al, x, h, o, B, T, W, n_sub, st); break;
    case 8: launch<8>(al, x, h, o, B, T, W, n_sub, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
