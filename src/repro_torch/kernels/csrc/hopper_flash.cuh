// Shared machinery of the two tensor-core flash-attention kernels
// (retention_attention_tc.cu, chunk_attention_tc.cu), for Hopper
// (sm_90a), bf16 only, head dim D = 64, 128 or 256 (a template
// parameter).
//
// A CTA owns BM = 128 query rows of one (lane, q head) and walks its
// key tiles of BN keys x D (BN = 128, or 64 at D = 256; Dims<D>). Three
// warpgroups:
//
//   * warpgroups 0 and 1 consume: each owns 64 query rows, computes
//     S = Q.K^T with wgmma (Q and K from shared memory, float32
//     accumulator), the online softmax in registers, and O += P.V with
//     wgmma (P converted to bf16 in registers as the A operand, V from
//     shared memory as a transposed, MN-major B operand); the softmax
//     of one tile runs while the P.V of the one before is in flight,
//     and the two warpgroups take turns at the tensor cores (consume);
//   * warpgroup 2 produces: one thread of its first warp stages Q once
//     and then every K/V tile through a ring of S buffers with TMA
//     (cp.async.bulk.tensor), each completion reported on a "full"
//     mbarrier; the consumers free a buffer on its "empty" mbarrier.
//     setmaxnreg moves registers from the producer (40) to the
//     consumers (232). (A lone producer warp, 288 threads, hung on the
//     card: setmaxnreg is a warpgroup instruction.)
//
// Shared memory at D = 128: Q 32 KB + S x (K 32 KB + V 32 KB), in
// 128-byte-swizzled tiles: 224 KB of the 227 KB at S = 3 (retention),
// 160 KB at S = 2 (chunk, which keeps positions beside the ring). The
// 128-byte swizzle caps a TMA box at 64 bf16 columns, so a D = 128 tile
// is two boxes [rows][64] one after the other; the wgmma descriptors
// step across them (see desc_kmajor / desc_mnmajor). At D = 64 a tile
// is one box, half the bytes: Q.K^T is 4 k16 steps, P.V an N = 64
// product (32 accumulator registers a thread), and a stage takes 32 KB,
// so the kernels keep 4 stages in the room of 2 (Dims<D>::BOXES).
//
// D = 256 takes tiles of BN = 64 keys. At 128 keys a K + V stage would
// take 128 KB beside Q's 64 KB (one stage in the 227 KB), and S (64
// registers a thread) beside O (128) would not fit a consumer's 232.
// At 64 keys a stage takes 64 KB, so two stages fit beside Q (192 KB),
// S is an N = 64 product of 32 registers, P 16, and the P.V product is
// two N = 128 wgmma a k16 step, over V's boxes 0-1 and 2-3, into the
// two halves of O's 128 registers.
//
// Every masked logit is set to -inf before the max, so its probability
// is exactly 0 even while the row's running max is still NEG_INF (the
// initial -1e30, where exp(s - m) of a finite masked score would be 1);
// nothing relies on a later tile to rescale it away.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace hf {

constexpr int BM = 128;          // query rows per CTA
constexpr int NCONS = 256;       // consumer threads (two warpgroups)
constexpr int NTHREADS = 384;    // + one producer warpgroup
constexpr int BOX_COLS = 64;     // bf16 columns per 128-byte-swizzled box
constexpr uint32_t Q_BOX = BM * BOX_COLS * 2;      // bytes of one Q box

// The sizes that follow from the head dim D (64, 128 or 256): keys per
// tile, S registers a consumer thread, boxes per tile, one K/V box, the
// Q tile and one K or V tile in bytes.
template <int D> struct Dims {
  static_assert(D == 64 || D == 128 || D == 256, "head dim 64, 128 or 256");
  static constexpr int BN = D == 256 ? 64 : 128;
  static constexpr int SN = BN / 2;
  static constexpr int BOXES = D / BOX_COLS;
  static constexpr uint32_t KV_BOX = BN * BOX_COLS * 2;
  static constexpr uint32_t Q_BYTES = BOXES * Q_BOX;
  static constexpr uint32_t KV_BYTES = BOXES * KV_BOX;
};
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 128 x 40 + 256 x 232 <= 64 K
constexpr float NEG_INF_F = -1e30f;
#define HF_MINUS_INF __int_as_float(0xff800000)
constexpr float LOG2E = 1.4426950408889634f;
constexpr int SMEM_MAX = 232448;                   // per block on sm_90

// ------------------------------------------------------------ host side

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap *, CUtensorMapDataType, cuuint32_t, void *,
    const cuuint64_t *, const cuuint64_t *, const cuuint32_t *,
    const cuuint32_t *, CUtensorMapInterleave, CUtensorMapSwizzle,
    CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the
// library needs no -lcuda.
inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void *p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &res);
#endif
    if (err != cudaSuccess || res != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D bf16 tensor map: dims[0] is the contiguous head dim (D), the
// box is (64, box1, box2, box3) with 128-byte swizzle; strides in bytes
// of dims 1..3. Coordinates past a dim are zero-filled by TMA.
inline cudaError_t encode_map(CUtensorMap *map, const void *ptr,
                              const uint64_t dims[4], const uint64_t strides[3],
                              const uint32_t box[4]) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint64_t gdim[4] = {dims[0], dims[1], dims[2], dims[3]};
  cuuint64_t gstride[3] = {strides[0], strides[1], strides[2]};
  cuuint32_t bdim[4] = {box[0], box[1], box[2], box[3]};
  cuuint32_t estride[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void *>(ptr), gdim, gstride, bdim, estride,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The map of a [B, T, H, D] tensor (q, or keys/values laid out by
// token), boxes of `rows` tokens of one head: coordinates (d, h, t, b).
inline cudaError_t map_bthd(CUtensorMap *map, const void *ptr, int B, int T,
                            int H, int D, uint32_t rows) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)T, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)H * D * 2,
                               (uint64_t)T * H * D * 2};
  const uint32_t box[4] = {BOX_COLS, 1, rows, 1};
  return encode_map(map, ptr, dims, strides, box);
}

// The map of a [B, H, M, D] tensor (the slot cache), boxes of `rows`
// slots of one head: coordinates (d, m, h, b).
inline cudaError_t map_bhmd(CUtensorMap *map, const void *ptr, int B, int H,
                            int M, int D, uint32_t rows) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)M, (uint64_t)H, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)M * D * 2,
                               (uint64_t)H * M * D * 2};
  const uint32_t box[4] = {BOX_COLS, rows, 1, 1};
  return encode_map(map, ptr, dims, strides, box);
}

// ------------------------------------------------- barriers and copies

__device__ __forceinline__ uint32_t smem_u32(const void *p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}


__device__ __forceinline__ void mbar_init(uint64_t *bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t *bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t *bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t *bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// ---------------------------------------------------------- shared memory

// The ring of S stages of head dim D in dynamic shared memory, aligned
// to 1024 bytes (the period of the 128-byte swizzle). q, k(s), v(s) are
// shared-space addresses.
template <int S, int D> struct Ring {
  static constexpr uint32_t Q_BYTES = Dims<D>::Q_BYTES;
  static constexpr uint32_t KV_BYTES = Dims<D>::KV_BYTES;
  uint32_t q;
  uint64_t *full, *empty, *qbar;
  uint8_t *extra;  // kernel-specific arrays after the ring

  __device__ uint32_t k(int s) const { return q + Q_BYTES + s * KV_BYTES; }
  __device__ uint32_t v(int s) const { return q + Q_BYTES + (S + s) * KV_BYTES; }
  static constexpr size_t bytes() {
    return 1024 + Q_BYTES + 2 * S * KV_BYTES + (2 * S + 1) * 8;
  }
  static __device__ Ring carve(uint8_t *raw) {
    uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
    uint32_t pad = ((a + 1023u) & ~1023u) - a;
    Ring r;
    r.q = a + pad;
    r.full = reinterpret_cast<uint64_t *>(raw + pad + Q_BYTES + 2 * S * KV_BYTES);
    r.empty = r.full + S;
    r.qbar = r.empty + S;
    r.extra = reinterpret_cast<uint8_t *>(r.qbar + 1);
    return r;
  }
  // one thread: arrivals of full (the producer's expect_tx), empty (one
  // per consumer warp) and the Q barrier
  __device__ void init() const {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], NCONS / 32);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
};

// One 4-D TMA box from global to shared memory, completion on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap *map,
                                         uint64_t *bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}
// A whole tile of head dim D: D / 64 boxes of 64 columns, each
// `box_bytes` after the one before. c1..c3 are the map's other
// coordinates.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, uint32_t box_bytes,
                                         const CUtensorMap *map, uint64_t *bar,
                                         int c1, int c2, int c3) {
#pragma unroll
  for (int i = 0; i < Dims<D>::BOXES; ++i)
    tma_load(dst + i * box_bytes, map, bar, i * BOX_COLS, c1, c2, c3);
}

template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// --------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor of a K-major bf16 operand in
// 128-byte-swizzled rows of 128 bytes: SBO = 1024 bytes between 8-row
// groups, LBO unused (1). Stepping K by 16 inside a 64-column box adds
// 32 bytes to the start address; the next box is `box bytes` further.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// Descriptor of an MN-major (transposed) bf16 operand: rows are K (keys),
// 128 bytes = 64 N-columns each, swizzled; SBO = 1024 bytes between
// 8-row K groups, LBO = `lbo` bytes between the 64-column boxes along N.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma: used before a group is issued and after it is
// waited for, never in between (ptxas then serializes the wgmma).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A * B, A and B bf16 in shared memory (K-major, 128-byte
// swizzle), 64 x 128 float32 accumulator
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A * B as wgmma_ss at N = 64 (S of a 64-key tile at head dim
// 256): 64 x 64 float32 accumulator, 32 registers a thread
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A * B, A bf16 in registers (a[0..3], the m64k16 fragment), B bf16
// in shared memory, MN-major (transposed), 128-byte swizzle
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A * B as wgmma_rs at N = 64 (head dim 64): 64 x 64 float32
// accumulator, 32 registers a thread
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// --------------------------------------------------- fragment indices
//
// Accumulator register i of m64nNk16 for thread t of a warpgroup
// (warp w = t / 32 % 4, lane l): row 16 w + l / 4 + 8 ((i >> 1) & 1),
// column 8 (i >> 2) + 2 (l % 4) + (i & 1). So each thread owns two rows
// (frag_row(), + 8) and their row reductions are over the 4 lanes of a
// quad; register 4 j + 2 r + e is row r, column 8 j + frag_col0() + e.
__device__ __forceinline__ int frag_row() {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
}
__device__ __forceinline__ int frag_col0() { return 2 * (threadIdx.x & 3); }

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t *>(&v);
}

// ----------------------------------------------------- the tile step

// Online-softmax state of a consumer thread's two rows, in log2 units.
struct Rows {
  float m[2];  // running max (NEG_INF_F until a visible key)
  float l[2];  // this thread's share of the running denominator
  __device__ void init() { m[0] = m[1] = NEG_INF_F; l[0] = l[1] = 0.f; }
};

struct NoHook {
  template <int NS>
  __device__ void operator()(const float (&)[NS], const float (&)[2]) const {}
};

template <int KT>
__device__ __forceinline__ void fence_frag(uint32_t (&pa)[KT][4]) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(pa[kk][j])::"memory");
}

// Issue S = Q_wg K^T (D / 16 wgmma of k16 over the head dim: 16 at
// D = 256, 8 at D = 128, 4 at D = 64; N = BN) as one wgmma group.
template <int D>
__device__ __forceinline__ void qk_issue(uint32_t q_wg, uint32_t k_s,
                                         float (&s)[Dims<D>::SN]) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;  // 16 columns = 32 bytes
    wgmma_ss(s, desc_kmajor(q_wg + (kk >> 2) * Q_BOX + off),
             desc_kmajor(k_s + (kk >> 2) * Dims<D>::KV_BOX + off), kk > 0);
  }
  wgmma_commit();
  fence_regs(s);
}

// Issue O += P V (BN / 16 k16 steps over the tile's keys, N = D) as one
// wgmma group; at D = 256 each step is two N = 128 products, over V's
// columns 0-127 into o[0..63] and 128-255 into o[64..127].
template <int D>
__device__ __forceinline__ void pv_issue(float (&o)[D / 2],
                                         uint32_t (&pa)[Dims<D>::BN / 16][4],
                                         uint32_t v_s) {
  constexpr uint32_t box = Dims<D>::KV_BOX;
  fence_frag(pa);
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Dims<D>::BN / 16; ++kk) {
    if constexpr (D == 256) {
      float(&lo)[64] = *reinterpret_cast<float(*)[64]>(&o[0]);
      float(&hi)[64] = *reinterpret_cast<float(*)[64]>(&o[64]);
      wgmma_rs(lo, pa[kk], desc_mnmajor(v_s + kk * 16 * 128, box));
      wgmma_rs(hi, pa[kk], desc_mnmajor(v_s + 2 * box + kk * 16 * 128, box));
    } else {
      wgmma_rs(o, pa[kk], desc_mnmajor(v_s + kk * 16 * 128, box));
    }
  }
  wgmma_commit();
  fence_regs(o);
  fence_frag(pa);
}

template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The online-softmax update of one tile's scores s (NS = BN / 2 a
// thread; in place: on return s holds the probabilities exp2(x -
// m_new)): the scale, then, when masked, mask(s) (sets the invisible
// entries to -inf and adds any bias, in log2 units), the new row max,
// the rescale factor alpha of the rows' earlier sums, the denominators,
// and hook(p, m_new).
template <int NS, class Mask, class Hook>
__device__ __forceinline__ void softmax_step(float (&s)[NS], Rows &st,
                                             float (&alpha)[2],
                                             float scale_log2, bool masked,
                                             const Mask &mask, const Hook &hook) {
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] *= scale_log2;
  // a branch around the whole mask: predicated per element, its
  // instructions would take issue slots on every unmasked tile too
  if (masked) mask(s);
  // row max and sum over the thread's NS / 2 entries of each row in two
  // interleaved chains (register i of row r: (i >> 1) & 1 == r)
  float mx[2][2], sum[2][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) mx[r][0] = mx[r][1] = st.m[r];
#pragma unroll
  for (int i = 0; i < NS; ++i)
    mx[(i >> 1) & 1][(i >> 2) & 1] = fmaxf(mx[(i >> 1) & 1][(i >> 2) & 1], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = quad_max(fmaxf(mx[r][0], mx[r][1]));
    alpha[r] = fast_exp2(st.m[r] - m_new);
    st.m[r] = m_new;
    sum[r][0] = sum[r][1] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = fast_exp2(s[i] - st.m[r]);
    sum[r][(i >> 2) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    st.l[r] = st.l[r] * alpha[r] + (sum[r][0] + sum[r][1]);
  hook(s, st.m);
}

// P as the A fragments of the P.V product: for the k16 step kk, the
// accumulator registers 8 kk .. 8 kk + 7 (columns 16 kk .. 16 kk + 15)
// are, pairwise, the fragment's four bf16x2 registers.
template <int KT>
__device__ __forceinline__ void to_frag(const float (&s)[8 * KT],
                                        uint32_t (&pa)[KT][4]) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pa[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

// A consumer warp's release of a ring stage it has finished reading.
__device__ __forceinline__ void release(uint64_t *empty) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty);
}

// Ping-pong between the two consumer warpgroups (named barriers 1 and
// 2, 256 threads each): a warpgroup issues its wgmma only on its turn
// and then hands the turn over, so one warpgroup's softmax runs while
// the other's products hold the tensor cores. Warpgroup 0 goes first.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(NCONS) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - wg), "n"(NCONS) : "memory");
}

// Warpgroup wg's walk over the CTA's loaded tiles (it = 0 ..
// tiles.count() - 1, stage it % S); both warpgroups walk the same
// tiles, a warpgroup with no valid row included (all its p are 0).
// tiles.softmax(it, s, st, alpha) runs softmax_step with the tile's
// mask.
//
// Inside a warpgroup the loop overlaps the tensor cores with the
// softmax, as FlashAttention 3 does: S of tile it + 1 is issued before
// P.V of tile it, and the softmax of tile it + 1 runs while P.V of tile
// it is in flight; O is rescaled after P.V has landed. The last tile's
// P.V is peeled off the loop, so that the loop body has no branch
// around a wgmma (ptxas serializes wgmma it cannot follow). Each
// warpgroup takes n + 1 turns; warpgroup 1 does not pass its last one,
// so that no arrival is left on a barrier.
template <int S, int D, class Tiles>
__device__ __forceinline__ void consume(const Ring<S, D> &ring, uint32_t q_wg,
                                        int wg, const Tiles &tiles,
                                        float (&o)[D / 2], Rows &st) {
  const int n = tiles.count();
  if (n == 0) return;
  if (wg == 1) turn_pass(1);  // warpgroup 0 first
  float s[Dims<D>::SN];
  uint32_t pa[Dims<D>::BN / 16][4];
  float alpha[2];
  mbar_wait(&ring.full[0], 0);
  turn_wait(wg);
  qk_issue<D>(q_wg, ring.k(0), s);
  turn_pass(wg);
  wgmma_wait<0>();
  fence_regs(s);
  tiles.softmax(0, s, st, alpha);  // o is 0: nothing to rescale
  to_frag(s, pa);
  for (int it = 0; it + 1 < n; ++it) {
    const int stage = it % S, s1 = (it + 1) % S;
    mbar_wait(&ring.full[s1], ((it + 1) / S) & 1);
    turn_wait(wg);
    qk_issue<D>(q_wg, ring.k(s1), s);
    pv_issue<D>(o, pa, ring.v(stage));
    turn_pass(wg);
    wgmma_wait<1>();  // S of tile it + 1 has landed; P.V runs on
    fence_regs(s);
    tiles.softmax(it + 1, s, st, alpha);
    wgmma_wait<0>();
    fence_regs(o);
    release(&ring.empty[stage]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    to_frag(s, pa);
  }
  turn_wait(wg);
  pv_issue<D>(o, pa, ring.v((n - 1) % S));
  if (wg == 0) turn_pass(0);
  wgmma_wait<0>();
  fence_regs(o);
  release(&ring.empty[(n - 1) % S]);
}

// Final row sums (over the quad) of a consumer thread's two rows.
__device__ __forceinline__ void finish_rows(Rows &st) {
  st.l[0] = quad_sum(st.l[0]);
  st.l[1] = quad_sum(st.l[1]);
}

// Write the warpgroup's output rows (N = D columns): row r (of 64) goes
// to out_row(r), or nowhere when it returns null; out = o / max(l,
// 1e-30) in bf16.
template <int N, class OutRow>
__device__ __forceinline__ void store_out(const float (&o)[N], const Rows &st,
                                          const OutRow &out_row) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    __nv_bfloat16 *dst = out_row(frag_row() + 8 * r);
    if (dst == nullptr) continue;
    const float inv = 1.f / fmaxf(st.l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      *reinterpret_cast<__nv_bfloat162 *>(dst + 8 * j + frag_col0()) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

inline cudaError_t allow_smem(const void *fn, size_t bytes) {
  if (bytes > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace hf
