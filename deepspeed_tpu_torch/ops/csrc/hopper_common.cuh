// Hopper (sm_90a) building blocks shared by the tensor-core kernels: TMA
// tensor maps and loads, mbarriers, and warpgroup matrix multiplies
// (wgmma) on 128-byte-swizzled shared-memory tiles.
//
// Tile convention.  A tile is 64 rows of 64 16-bit elements (128 bytes a
// row, 8 KB), stored with the 128-byte swizzle: the 16-byte chunk c of row
// r sits at chunk position c ^ (r % 8).  TMA writes that layout itself
// (CU_TENSOR_MAP_SWIZZLE_128B).  A row of 128 elements (head dim 128) is
// two such tiles side by side, 8 KB apart.  Tiles start on a 1024-byte
// boundary, the swizzle pattern's period.
//
// One wgmma here is m64n64k16 with fp32 accumulators: a warpgroup of 128
// threads multiplies a 64 x 16 slice of A by a 16 x 64 slice of B, A from
// shared memory (K-major) or from registers, B from shared memory
// (K-major, or N-contiguous with the transpose bit).  Each thread holds
// 32 accumulators: for n8 block j (0..7) and e (0..3), acc[4j + e] is row
// 16 * warp + lane / 4 + 8 * (e >> 1), column 8j + 2 * (lane % 4) + (e & 1).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dstt {
namespace hopper {

constexpr int kTileRows = 64;
constexpr int kTileCols = 64;                         // 16-bit elements
constexpr int kTileBytes = kTileRows * kTileCols * 2;  // 8 KB
constexpr int kSwizzleAlign = 1024;

// exp(x) = exp2(x * log2(e)): kernels fold log2(e) into their scale
constexpr float kLog2e = 1.4426950408889634f;

// one [64, D] row tile of 16-bit elements: D / 64 swizzled 64 x 64 tiles
template <int D>
__host__ __device__ constexpr int row_tile_bytes() {
  return (D / 64) * kTileBytes;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first swizzle-period (1024-byte) boundary at or after raw
__device__ __forceinline__ uint8_t* align_smem(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + ((kSwizzleAlign - (a & (kSwizzleAlign - 1))) &
                (kSwizzleAlign - 1));
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the calling thread arrives and the phase also waits for `bytes` of TMA
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase with parity `parity` has completed.  A phase that
// never completes (a load that was never issued) traps after ~2^22 polls,
// far beyond any real tile load, so a fault ends the launch with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 22)) __trap();
  }
}

// --------------------------------------------------------------------- TMA
// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; completion counts on `bar`.  Out-of-range elements arrive as 0.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// order this thread's generic-proxy writes to shared memory before later
// async-proxy reads of it (wgmma operands): each writer fences, then the
// block synchronises, then the products are issued
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one [64, D] row tile (D / 64 boxes of a `make_bshd_map` map) at
// position s0 of (head h, batch row b)
template <int D>
__device__ __forceinline__ void tma_row_tile(uint8_t* dst, const CUtensorMap* map,
                                             uint64_t* bar, int h, int s0, int b) {
#pragma unroll
  for (int t = 0; t < D / 64; ++t)
    tma_load_4d(dst + t * kTileBytes, map, bar, 64 * t, h, s0, b);
}

__device__ __forceinline__ void prefetch_tensor_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ------------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor of a 128-byte-swizzled operand:
// start address, leading / stride byte offsets (16-byte units), layout 1.
// K-major operands (K contiguous): SBO = 1024 (the next 8 rows), LBO
// unused.  MN-major operands (read with the transpose bit): SBO = 1024
// (the next 8 K rows); LBO would step to the next 64 MN columns, which
// these m64n64 products never need, and is set to 1024 as well.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t smem_addr,
                                               uint32_t lbo_bytes) {
  uint64_t d = 0;
  d |= (uint64_t)((smem_addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((1024u >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

__device__ __forceinline__ uint64_t desc_k_major(uint32_t smem_addr) {
  return sw128_desc(smem_addr, 16);
}
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t smem_addr) {
  return sw128_desc(smem_addr, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma (the registers are in flight until wgmma_wait)
__device__ __forceinline__ void fence_acc(float (&acc)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

#define DSTT_WGMMA_ACC32                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

#define DSTT_WGMMA_M64N64K16(TY)                                              \
  asm volatile(                                                               \
      "{\n"                                                                   \
      ".reg .pred p;\n"                                                       \
      "setp.ne.b32 p, %34, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"                            \
      "}\n"                                                                   \
      : DSTT_WGMMA_ACC32                                                      \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))

// d (+)= A . B^T for A (64 x 16) and B (64 x 16), both K-major in shared
// memory; scale_d = 0 ignores the old d.  T is the operands' 16-bit type.
template <typename T>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                uint64_t desc_b, int scale_d);
template <>
__device__ __forceinline__ void wgmma_m64n64k16<__nv_bfloat16>(
    float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  DSTT_WGMMA_M64N64K16("bf16");
}
template <>
__device__ __forceinline__ void wgmma_m64n64k16<__half>(
    float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  DSTT_WGMMA_M64N64K16("f16");
}

#define DSTT_WGMMA_RS_M64N64K16(TY)                                           \
  asm volatile(                                                               \
      "{\n"                                                                   \
      ".reg .pred p;\n"                                                       \
      "setp.ne.b32 p, %37, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"              \
      "}\n"                                                                   \
      : DSTT_WGMMA_ACC32                                                      \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d))

// d (+)= A . B with A (64 x 16) in registers — four packed pairs per
// thread in the A-fragment layout (`acc_to_a`) — and B (16 x 64) in shared
// memory, N-contiguous (MN-major, the transpose bit set).
template <typename T>
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], uint32_t a0,
                                                   uint32_t a1, uint32_t a2,
                                                   uint32_t a3, uint64_t desc_b,
                                                   int scale_d);
template <>
__device__ __forceinline__ void wgmma_rs_m64n64k16<__nv_bfloat16>(
    float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
    uint64_t desc_b, int scale_d) {
  DSTT_WGMMA_RS_M64N64K16("bf16");
}
template <>
__device__ __forceinline__ void wgmma_rs_m64n64k16<__half>(
    float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
    uint64_t desc_b, int scale_d) {
  DSTT_WGMMA_RS_M64N64K16("f16");
}

#undef DSTT_WGMMA_RS_M64N64K16
#undef DSTT_WGMMA_M64N64K16
#undef DSTT_WGMMA_ACC32

// Row-major A [64, K] times B^T for B [64, K] (both K-major, K = 64 * KT
// columns in KT side-by-side swizzled tiles at a_tile / b_tile):
// d = A . B^T, 64 x 64, over K / 16 steps (32 bytes each inside a tile).
template <typename T, int KT>
__device__ __forceinline__ void wgmma_abt(float (&d)[32], uint32_t a_tile,
                                          uint32_t b_tile) {
#pragma unroll
  for (int ks = 0; ks < 4 * KT; ++ks) {
    const uint32_t off = (ks >> 2) * kTileBytes + (ks & 3) * 32;
    wgmma_m64n64k16<T>(d, desc_k_major(a_tile + off),
                       desc_k_major(b_tile + off), ks > 0);
  }
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x 64 fp32 accumulator tile, rounded to T, as the A operand of the
// next product (K = its 64 columns): for K step ks (columns 16ks ..
// 16ks + 15, the n8 blocks 2ks and 2ks + 1), a[4ks .. 4ks + 3] hold
// (row, cols 16ks + c), (row + 8, same), (row, cols 16ks + 8 + c),
// (row + 8, same) with c = 2 * (lane % 4) + {0, 1} — the wgmma A-fragment
// layout, which is the accumulator's own row / column split.
template <typename T>
__device__ __forceinline__ void acc_to_a(const float (&acc)[32],
                                         uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = pack2<T>(acc[2 * i], acc[2 * i + 1]);
}

// d += A . B for A [64, 64] in registers (`acc_to_a`) and B [64 (K),
// 64 (N)] stored N-contiguous (one swizzled tile, read with the transpose
// bit): four steps of 16 K rows (2048 bytes of B each).
template <typename T>
__device__ __forceinline__ void wgmma_rs_ab(float (&d)[32],
                                            const uint32_t (&a)[16],
                                            uint32_t b_tile) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_rs_m64n64k16<T>(d, a[4 * ks], a[4 * ks + 1], a[4 * ks + 2],
                          a[4 * ks + 3], desc_mn_major(b_tile + ks * 2048), 1);
}

// ------------------------------------------------------ host: tensor maps
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint(ByVersion)
// so that the library needs no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess && p != nullptr)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A map over a strided [B, S, H, D] tensor of 16-bit elements (strides in
// elements, unit stride on D) whose box is `box_rows` positions x 64 of D
// for one (head, batch row), 128-byte swizzled: one `tma_load_4d` at
// coordinates (d0, h, s0, b) fills one tile (box_rows = 64) or its rows
// from 128 * (row offset) bytes on (a box of 8, 16 or 32 rows written at
// a multiple of 1024 bytes into a tile keeps the tile's swizzle phase).
// Returns false when the map cannot be encoded (an address or stride TMA
// cannot take).
inline bool make_bshd_map(CUtensorMap* map, const void* ptr, bool fp16, int B,
                          int S, int H, int D, long long sb, long long ss,
                          long long sh, int box_rows = kTileRows) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {kTileCols, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map,
                fp16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                4, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
}  // namespace dstt
