// The Mamba-1 selective scan of the ssm family's mamba blocks
// (falcon-mamba-7b), float32 state, for Hopper (sm_90a):
//
//   h_t[d, n] = exp(dt_t[d] * A[d, n]) * h_{t-1}[d, n]
//               + (dt_t[d] * x_t[d]) * B_t[n],
//   y_t[d]    = sum_n h_t[d, n] * C_t[n],
//
// over dt [B, T, di] float32 (after softplus), x [B, T, di], B_t, C_t
// [B, T, n] (x, B and C in the model dtype: bfloat16 or float32), A
// [di, n] float32 (-exp(A_log)), from h0 [B, di, n] float32; writes
// every y_t to ys [B, T, di] float32 and the last h to h_last
// [B, di, n]. Steps at or past n_valid[b] are the identity (dA 1,
// dBx 0, as the JAX package pads a chunk): h is held, and y_t is still
// h . C_t.
//
// Replaces no TPU kernel: the JAX package runs this recurrence as a
// lax.scan over time in XLA (src/repro/models/blocks.py,
// _mamba_prefill and _mamba_prefill_chunk), with no Pallas kernel. It
// is written by hand because the plain PyTorch loop launches a few
// kernels a step in every layer (64 layers x 2000 steps x ~5 launches
// for one falcon-mamba-7b prefill), and materialises dA and dBx
// [B, T, di, n] float32 (4.2 GB each a layer at B 4, T 2000).
//
// Bound on the H100: the function reads dt, x, B and C once and writes
// ys once (660 MB at B 4, T 2000, di 8192, n 16 in bf16: 0.197 ms at
// 3.35 TB/s), and takes one exponential for each (lane, step, channel,
// state): 1.05e9 of them, 0.25 ms at the SFU's 16 a clock per SM on 132
// SMs at 1.98 GHz. So the exponentials bind before the bytes do, if the
// loads keep enough bytes in flight (3.35 TB/s times a microsecond of
// latency: megabytes across the card).
//
// Design (simple, sequential over T): a thread owns one (lane, channel)
// and SPT = 8 of its n = 16 states in registers; the two threads of a
// channel are neighbouring lanes of one warp and add their partial y_t
// with one shuffle. A CTA of 128 threads holds 64 neighbouring channels
// of one lane and walks T in batches
// of U = 8 steps. Every thread of a CTA reads the same B_t and C_t, so
// the CTA stages a batch's B and C (one contiguous block of each) in
// shared memory, one word a thread; each thread holds only its
// channel's dt and x of a batch in registers. The next batch's loads
// (dt, x, and the B / C words) are issued before the current batch is
// computed: ~3.5 KB a CTA, ~1.8 MB across the 512 CTAs of B 4, di 8192
// (all resident: 92 registers, 5 CTAs an SM). A whole batch is one
// branch-free block, so one step's exponentials (independent of h)
// issue while the sums of the step before complete. Batches of 16
// steps (127 registers, 4 CTAs an SM), 256 or 512 threads a CTA and
// exp2f in place of ex2.approx.ftz each ran slower at B 4, T 2000 or
// B 1, T 2000 (one call, in turns). The chunked composition over time
// that the RG-LRU scan uses (rg_lru_scan.cu) is later work.
//
// Order and rounding: every multiply and multiply-add is written with
// a round-to-nearest intrinsic and the order is fixed, so two launches
// on the same inputs give the same bits. exp(dt a) is taken as
// 2^(dt * (a log2 e)) on the SFU (one op, within 2 ulp). A padded step
// computes its update and keeps the old h by a select, so h is held
// bit for bit. The sum over n is a partial sum per thread (states in
// order) and then the shuffle, which rounds differently from the plain
// version's einsum, within float32 rounding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int STATES = 16;    // n: falcon-mamba-7b's ssm_state
constexpr int SPT = 8;        // states a thread holds
constexpr int THREADS = 128;  // threads a CTA
constexpr int U = 8;          // steps a batch

// SPT values of B_t or C_t as stored: float32 as two float4, bf16 as
// one uint4 (two values a word, the first in the low half)
template <typename T>
struct Raw;
template <>
struct Raw<float> {
  float4 lo, hi;
};
template <>
struct Raw<__nv_bfloat16> {
  uint4 v;
};

__device__ __forceinline__ void unpack(const Raw<float> &r, float (&v)[SPT]) {
  v[0] = r.lo.x; v[1] = r.lo.y; v[2] = r.lo.z; v[3] = r.lo.w;
  v[4] = r.hi.x; v[5] = r.hi.y; v[6] = r.hi.z; v[7] = r.hi.w;
}
__device__ __forceinline__ float bf_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void unpack(const Raw<__nv_bfloat16> &r,
                                       float (&v)[SPT]) {
  v[0] = bf_lo(r.v.x); v[1] = bf_hi(r.v.x); v[2] = bf_lo(r.v.y);
  v[3] = bf_hi(r.v.y); v[4] = bf_lo(r.v.z); v[5] = bf_hi(r.v.z);
  v[6] = bf_lo(r.v.w); v[7] = bf_hi(r.v.w);
}

__device__ __forceinline__ float load_x(const float *p) { return __ldg(p); }
__device__ __forceinline__ float load_x(const __nv_bfloat16 *p) {
  return bf_lo(__ldg(reinterpret_cast<const unsigned short *>(p)));
}

// a batch's B and C of one lane in shared memory: B of its U steps
// (U x STATES values), then C's; TOTAL words (4 bytes each), up to WORDS
// a thread
template <typename T>
struct Stage {
  static constexpr int TOTAL = 2 * U * STATES * (int)sizeof(T) / 4;
  static constexpr int WORDS = (TOTAL + THREADS - 1) / THREADS;
};

// this thread's words of the B / C blocks of steps t0 .. t0 + U - 1
// (0 past T): word k * THREADS + tid (below TOTAL), of B's block then of
// C's
template <typename T>
__device__ __forceinline__ void load_words(unsigned (&w)[Stage<T>::WORDS],
                                           const T *__restrict__ Bm,
                                           const T *__restrict__ Cm, long row,
                                           int t0, int T_) {
  constexpr int HALF = U * STATES * (int)sizeof(T) / 4;  // words of a block
  constexpr int PER_STEP = STATES * (int)sizeof(T) / 4;  // words of a step
  const unsigned *b =
      reinterpret_cast<const unsigned *>(Bm + (row + t0) * STATES);
  const unsigned *c =
      reinterpret_cast<const unsigned *>(Cm + (row + t0) * STATES);
  const int valid = (T_ - t0) * PER_STEP;            // words before T
#pragma unroll
  for (int k = 0; k < Stage<T>::WORDS; ++k) {
    const int i = k * THREADS + (int)threadIdx.x;
    const int j = i < HALF ? i : i - HALF;
    const bool in = Stage<T>::TOTAL % THREADS == 0 || i < Stage<T>::TOTAL;
    w[k] = in && j < valid ? __ldg((i < HALF ? b : c) + j) : 0u;
  }
}

// this thread's channel's dt and x of steps t0 .. t0 + U - 1 (0 past T
// or for a channel past di)
template <typename T>
__device__ __forceinline__ void load_dtx(float (&dtv)[U], float (&xv)[U],
                                         const float *__restrict__ dt,
                                         const T *__restrict__ xs, long row,
                                         int t0, int T_, int DI, int d,
                                         bool live) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool in = live && t0 + u < T_;
    const long i = (row + t0 + u) * DI + d;
    dtv[u] = in ? __ldg(dt + i) : 0.f;
    xv[u] = in ? load_x(xs + i) : 0.f;
  }
}

// 2^x on the SFU: ex2.approx.ftz, within 2 ulp (a result below 2^-126
// flushes to 0, where exp(dt a) decays h to nothing anyway)
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// one step of one thread: its SPT states' h_t (held where the step is a
// padded one, valid false) and its partial y_t over them, in order
__device__ __forceinline__ float scan_step(float dt, float x,
                                           const float (&bb)[SPT],
                                           const float (&c)[SPT], bool valid,
                                           const float (&a2)[SPT],
                                           float (&h)[SPT]) {
  const float dtx = __fmul_rn(dt, x);
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    const float hn = __fmaf_rn(exp2_sfu(__fmul_rn(dt, a2[s])), h[s],
                               __fmul_rn(dtx, bb[s]));
    h[s] = valid ? hn : h[s];
  }
  float y = __fmul_rn(h[0], c[0]);
#pragma unroll
  for (int s = 1; s < SPT; ++s) y = __fmaf_rn(h[s], c[s], y);
  return y;
}

template <int TPC>
__device__ __forceinline__ float channel_sum(float y) {
#pragma unroll
  for (int o = TPC / 2; o > 0; o >>= 1)
    y = __fadd_rn(y, __shfl_xor_sync(0xffffffffu, y, o));
  return y;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
selective_scan_kernel(const float *__restrict__ dt, const T *__restrict__ xs,
                      const T *__restrict__ Bm, const T *__restrict__ Cm,
                      const float *__restrict__ A, const float *__restrict__ h0,
                      const int *__restrict__ n_valid, float *__restrict__ ys,
                      float *__restrict__ h_last, int T_, int DI) {
  constexpr int TPC = STATES / SPT;  // threads a channel
  constexpr int CPB = THREADS / TPC; // channels a CTA
  constexpr int WORDS = Stage<T>::WORDS;
  __shared__ __align__(16) unsigned stage[2][WORDS * THREADS];
  const int q = threadIdx.x % TPC;
  const int d = blockIdx.x * CPB + threadIdx.x / TPC;
  const int b = blockIdx.y;
  const bool live = d < DI;
  const int nv = n_valid[b];
  const long row = (long)b * T_;
  const long st = ((long)b * DI + d) * STATES + q * SPT;
  // exp(dt a) as exp2(dt a log2(e)): one multiply and one SFU op
  float a2[SPT], h[SPT];
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    a2[s] = live ? __fmul_rn(__ldg(A + (long)d * STATES + q * SPT + s),
                             1.4426950408889634f)
                 : 0.f;
    h[s] = live ? __ldg(h0 + st + s) : 0.f;
  }
  const bool writes = live && q == 0;
  float dt_c[U], x_c[U], dt_n[U], x_n[U];
  unsigned w[WORDS];
  load_dtx(dt_c, x_c, dt, xs, row, 0, T_, DI, d, live);
  load_words<T>(w, Bm, Cm, row, 0, T_);
#pragma unroll
  for (int k = 0; k < WORDS; ++k) stage[0][k * THREADS + threadIdx.x] = w[k];
  __syncthreads();
  for (int t0 = 0, buf = 0; t0 < T_; t0 += U, buf ^= 1) {
    // the next batch's loads, in flight while this one is computed
    load_dtx(dt_n, x_n, dt, xs, row, t0 + U, T_, DI, d, live);
    load_words<T>(w, Bm, Cm, row, t0 + U, T_);
    const Raw<T> *bs = reinterpret_cast<const Raw<T> *>(stage[buf]);
    const Raw<T> *cs = bs + U * TPC;
    if (t0 + U <= T_) {   // a whole batch: one branch-free block
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float bb[SPT], c[SPT];
        unpack(bs[u * TPC + q], bb);
        unpack(cs[u * TPC + q], c);
        const float y = channel_sum<TPC>(
            scan_step(dt_c[u], x_c[u], bb, c, t0 + u < nv, a2, h));
        if (writes) ys[(row + t0 + u) * DI + d] = y;
      }
    } else {              // the last T % U steps (T is the same for all)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (t0 + u < T_) {
          float bb[SPT], c[SPT];
          unpack(bs[u * TPC + q], bb);
          unpack(cs[u * TPC + q], c);
          const float y = channel_sum<TPC>(
              scan_step(dt_c[u], x_c[u], bb, c, t0 + u < nv, a2, h));
          if (writes) ys[(row + t0 + u) * DI + d] = y;
        }
      }
    }
    // the other buffer was last read before the previous barrier
#pragma unroll
    for (int k = 0; k < WORDS; ++k)
      stage[buf ^ 1][k * THREADS + threadIdx.x] = w[k];
    __syncthreads();
#pragma unroll
    for (int u = 0; u < U; ++u) {
      dt_c[u] = dt_n[u];
      x_c[u] = x_n[u];
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < SPT; ++s) h_last[st + s] = h[s];
  }
}

template <typename T>
int launch(const void *dt, const void *xs, const void *Bm, const void *Cm,
           const void *A, const void *h0, const void *n_valid, void *ys,
           void *h_last, int B, int T_, int DI, cudaStream_t stream) {
  constexpr int CPB = THREADS / (STATES / SPT);
  const dim3 grid((DI + CPB - 1) / CPB, B);
  selective_scan_kernel<T><<<grid, THREADS, 0, stream>>>(
      (const float *)dt, (const T *)xs, (const T *)Bm, (const T *)Cm,
      (const float *)A, (const float *)h0, (const int *)n_valid, (float *)ys,
      (float *)h_last, T_, DI);
  return (int)cudaGetLastError();
}

}  // namespace

// dt float32 [B, T, DI]; xs [B, T, DI], Bm, Cm [B, T, N] in bfloat16
// (bf16 = 1) or float32 (bf16 = 0); A float32 [DI, N]; h0, h_last
// float32 [B, DI, N]; n_valid int32 [B]; ys float32 [B, T, DI]; all
// contiguous, Bm and Cm 4-byte aligned; N = STATES. Returns a
// cudaError_t.
extern "C" int selective_scan_launch(const void *dt, const void *xs,
                                     const void *Bm, const void *Cm,
                                     const void *A, const void *h0,
                                     const void *n_valid, void *ys,
                                     void *h_last, int B, int T, int DI, int N,
                                     int bf16, void *stream) {
  if (B <= 0 || T <= 0 || DI <= 0 || B > 65535 || N != STATES)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(dt, xs, Bm, Cm, A, h0, n_valid, ys, h_last, B,
                                 T, DI, s);
  return launch<float>(dt, xs, Bm, Cm, A, h0, n_valid, ys, h_last, B, T, DI, s);
}
