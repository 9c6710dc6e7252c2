// K1 (flash-attention forward), K3 (chunked prefill) and K7 (chunked
// prefill over a paged KV pool) for Hopper.
//
// Replaces three Pallas kernels of the JAX package:
//   K1  deepspeed_tpu/ops/transformer/flash_attention.py  _fwd / _fwd_kernel
//   K3  deepspeed_tpu/ops/transformer/decode_attention.py
//       chunk_prefill_attention / _chunk_prefill_kernel
//   K7  deepspeed_tpu/ops/transformer/paged_attention.py
//       paged_chunk_prefill_attention (its body runs _chunk_prefill_kernel)
// All compute the same thing: rows of q at positions q_off[b] + i attend,
// with an online softmax in fp32, to keys at positions pos < Sk (and, when
// causal, pos <= q_off[b] + i).  K1 reads k/v in the model's [B, S, KVH, D]
// layout (q_off = 0) and may write the per-row LSE; K3 reads the S-major
// cache [B, S_max, KVH*D] -- the same [B, S, KVH, D] view with other
// strides; K7 reads one layer of the page pool [num_pages, page, KVH*D]
// through the block table pages[B, n_virt].  K3 and K7 also take int8-KV
// caches (the JAX kernel's quant mode): int8 payloads with fp32 scales
// [.., S, KVH] per (position, kv head).  One template serves all three:
// the tiles walked, their order and the arithmetic are the same, and only
// where a key row (b, pos) lies differs (attention_common.cuh StridedRows
// / PagedRows), so K7 over the pool is bitwise equal to K3 over the
// gathered view pool[pages] at any page size.  The causal limit keeps K7
// to positions <= starts[b] + C - 1, whose pages the host mapped; no
// table entry past it is read.
//
// What bounds it on an H100: at OPT-1.3B's training shape ([2, 2048, 32,
// 64], causal) the two products cost 4*D flops per (q, k) pair against a
// few bytes per row, so it is bound by tensor-core operations; at the
// serving shapes (S = 256, chunks of 128 over a cache) by the bytes of
// k / v and by latency (K7 at B = 1 is 64 blocks for 132 SMs).  Two
// designs, by input type:
//
// * bf16 / fp16: `wgmma_flash_fwd_kernel`, one warpgroup (128 threads)
//   per 64-row q tile, heads fastest in the grid (one (b, kv head)'s
//   tiles are reused from L2) and the heaviest causal q tiles first.  Both
//   products run on the tensor cores (wgmma m64n64k16, fp32 accumulators,
//   hopper_common.cuh): S = q.k^T reads both tiles K-major from shared
//   memory; P.V takes P straight from the accumulator registers as
//   wgmma's register A operand, rounded to the input type -- which is
//   what JAX does (`p.astype(v.dtype)`), while the running sum takes the
//   unrounded P, as in JAX -- and reads the V tile N-contiguous through
//   the transpose bit.  The online softmax runs in the accumulator layout:
//   a row's 64 columns lie in one lane quad, so its max is two shuffles,
//   and exp is one ex2 of a fused multiply-add (the scale times log2(e)
//   rides it; the LSE is converted back to natural-log units for K4 /
//   K5).  Only tiles that straddle the causal diagonal or a ragged edge
//   are masked.  Per 64 x 64 tile a warpgroup's 4096 exps take the SM's
//   exp units about as long as its two products take the tensor cores, so
//   the design keeps the elementwise phase short and lets other blocks'
//   products fill it: 5 blocks share an SM at D = 64 (4 for int8-KV, 2 at
//   D = 128).  The q tile comes by TMA once; float k / v tiles come by TMA
//   (128-byte swizzled, as the wgmma descriptors read them) into a
//   2-stage mbarrier ring, one tile ahead of the products.  K7's tiles
//   are filled by 64 / r boxes of r = gcd(page, 64) rows (a multiple of
//   8, so every box starts on the swizzle's 1024-byte period) read
//   through the block table from a map over the pool layer viewed as
//   [num_pages, page, KVH, D]; boxes wholly past the causal limit are not
//   issued.  int8-KV tiles are read with 16-byte loads, converted to the
//   input type (exact for |x| <= 127) into the same swizzled layout, the
//   next tile while this tile's S product runs; the k-scale multiplies
//   each score after `scale`, the v-scale each probability before its
//   rounding for P.V, and the running sum takes the raw probability, as
//   the JAX kernel scales its score and probability tiles.  V rows at or
//   past the tile's causal limit (kv_end) are zeroed in shared memory
//   before P.V: a cache or pool row there may hold anything, and 0 * NaN
//   is NaN; their scores are masked by a select, never a product.
// * fp32: `flash_fwd_kernel`, fp32 FMAs on the CUDA cores (wgmma's fp32
//   path is TF32 and would miss the fp32 bar of 1e-4), one block per
//   (64-row q tile, head, batch row), 256 threads as 16 x 16: thread
//   (ty, tx) owns q rows ty*4 .. ty*4+3 and score columns / output dims
//   tx + 16*j; every k tile is staged in padded shared memory (no bank
//   conflicts on column walks), with each key row resolved through the
//   row map on its own and rows past Sk zeroed.  Its int8-KV mode keeps
//   P times the v-scale in fp32 for P.V.
#include <type_traits>

#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace dstt {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

// the int8-KV tiles add the k tile's k- and v-scales
template <int D, bool INT8>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * (size_t)(kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * (kBK + 1)
                                  + (INT8 ? 2 * kBK : 0));
}

// KRows: where key / value row (b, pos) starts in k and v (StridedRows
// for K1 / K3, PagedRows for K7); skh / svh: the head stride within a row.
// C: the K/V element type, T or int8_t; for int8_t, k_scale / v_scale are
// the fp32 scales, row (b, pos) at srows.at(b, pos) (KVH per position).
template <typename T, typename C, int D, typename KRows>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const C* __restrict__ k,
                 const C* __restrict__ v, const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale, T* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ q_offsets,
                 int Sq, int H, int KVH, int Sk,
                 long long sqb, long long sqs, long long sqh,
                 KRows krows, long long skh, KRows vrows, long long svh,
                 KRows srows, long long sob, long long sos, long long soh,
                 int causal, float scale) {
  constexpr bool kInt8 = sizeof(C) == 1;
  constexpr int DP = D + 1;      // padded rows: no bank conflicts on column walks
  constexpr int PP = kBK + 1;
  constexpr int RPT = kBQ / 16;  // q rows per thread
  constexpr int CPT = kBK / 16;  // score columns per thread
  constexpr int DPT = D / 16;    // output dims per thread
  extern __shared__ float smem[];
  float* qs = smem;              // [kBQ, DP]
  float* ks = qs + kBQ * DP;     // [kBK, DP]
  float* vs = ks + kBK * DP;     // [kBK, DP]
  float* ps = vs + kBK * DP;     // [kBQ, PP] probabilities of this k tile
  float* kss = ps + kBQ * PP;    // [kBK] int8-KV k-scales of this k tile
  float* vss = kss + kBK;        // [kBK] and v-scales

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h * KVH / H;   // GQA: the JAX kernel's kv-head map
  const int qoff = q_offsets != nullptr ? q_offsets[b] : 0;
  const int nq = min(kBQ, Sq - q0);
  const T* qb = q + b * sqb + h * sqh;
  const C* kb = k + kvh * skh;
  const C* vb = v + kvh * svh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    qs[r * DP + d] = r < nq ? to_f(qb[(q0 + r) * sqs + d]) : 0.f;
  }
  // causal: the furthest key any row of this tile sees is qoff + q0 + nq - 1
  const int kv_end = causal ? min(Sk, qoff + q0 + nq) : Sk;

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[r][j] = 0.f;
  }

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's ks / vs / ps are consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D, pos = k0 + c;
      const bool ok = pos < Sk;  // zero the ragged tail: garbage * 0 can be NaN
      ks[c * DP + d] = ok ? to_f(kb[krows.at(b, pos) + d]) : 0.f;
      vs[c * DP + d] = ok ? to_f(vb[vrows.at(b, pos) + d]) : 0.f;
    }
    if constexpr (kInt8) {
      for (int c = tid; c < kBK; c += kThreads) {
        const int pos = k0 + c;
        const long long so = srows.at(b, min(pos, Sk - 1)) + kvh;
        kss[c] = pos < Sk ? k_scale[so] : 0.f;
        vss[c] = pos < Sk ? v_scale[so] : 0.f;
      }
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) qv[r] = qs[(ty * RPT + r) * DP + d];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = ks[(tx + 16 * c) * DP + d];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int qi = ty * RPT + r;
      const int qpos = qoff + q0 + qi;
      bool live[CPT];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int pos = k0 + tx + 16 * c;
        live[c] = qi < nq && pos < Sk && (!causal || pos <= qpos);
        float sc = s[r][c] * scale;
        if constexpr (kInt8) sc *= kss[tx + 16 * c];
        s[r][c] = live[c] ? sc : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float p = live[c] ? expf(s[r][c] - m_new) : 0.f;
        ps[qi * PP + tx + 16 * c] = kInt8 ? p * vss[tx + 16 * c] : p;
        sum += p;
      }
      sum = half_warp_sum(sum);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[r][j] *= corr;
    }
    __syncthreads();

    const int nc = min(kBK, kv_end - k0);
    for (int c = 0; c < nc; ++c) {
      float vv[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = vs[c * DP + tx + 16 * j];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float p = ps[(ty * RPT + r) * PP + c];
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[r][j] = fmaf(p, vv[j], acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int qi = ty * RPT + r;
    if (qi >= nq) continue;
    const float safe = l[r] == 0.f ? 1.f : l[r];
    T* ob = o + b * sob + (long long)(q0 + qi) * sos + h * soh;
#pragma unroll
    for (int j = 0; j < DPT; ++j) ob[tx + 16 * j] = from_f<T>(acc[r][j] / safe);
    if (lse != nullptr && tx == 0)
      lse[((long long)b * H + h) * Sq + q0 + qi] = m[r] + logf(safe);
  }
}

template <typename T, typename C, int HD, typename KRows>
void launch_flash(const void* q, const void* k, const void* v,
                  const void* k_scale, const void* v_scale, void* o,
                  void* lse, const void* q_offsets, int B, int Sq, int H,
                  int KVH, int Sk, long long sqb, long long sqs,
                  long long sqh, KRows krows, long long skh, KRows vrows,
                  long long svh, KRows srows, long long sob, long long sos,
                  long long soh, int causal, float scale,
                  cudaStream_t stream) {
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  const size_t smem = flash_smem_bytes<HD, sizeof(C) == 1>();
  cudaFuncSetAttribute(flash_fwd_kernel<T, C, HD, KRows>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  flash_fwd_kernel<T, C, HD, KRows><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const C*)k, (const C*)v, (const float*)k_scale,
      (const float*)v_scale, (T*)o, (float*)lse, (const int*)q_offsets, Sq,
      H, KVH, Sk, sqb, sqs, sqh, krows, skh, vrows, svh, srows, sob, sos, soh,
      causal, scale);
}


// ------------------------------------------------- bf16 / fp16: wgmma + TMA
namespace fwd {
namespace hk = dstt::hopper;

using hk::align_smem;
using hk::kLog2e;
using hk::row_tile_bytes;
using hk::tma_row_tile;

constexpr int kWgThreads = 128;   // one warpgroup
constexpr float kLn2 = 0.6931471805599453f;   // the LSE in natural-log units

// 2^x by one MUFU.EX2 (denormal results flush to 0: far below P's 16-bit
// rounding); exp2f adds a range fix-up around it
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the q tile, 2 stages of k and v tiles, 2 stages of int8-KV k- and
// v-scales, 3 mbarriers; + alignment slack
template <int D>
constexpr size_t wg_smem_bytes() {
  return hk::kSwizzleAlign + 5 * row_tile_bytes<D>() + 4 * 64 * sizeof(float) +
         64;
}

// the 16-byte chunk c (8 elements) of row r of a [64, D] row tile
__device__ __forceinline__ uint4* tile_chunk(uint8_t* tile, int r, int c) {
  return reinterpret_cast<uint4*>(tile + (c >> 3) * hk::kTileBytes + r * 128 +
                                  (((c & 7) ^ (r & 7)) << 4));
}

// rows [r0, 64) of a [64, D] row tile set to 0 (whole rows: the swizzle
// does not matter)
template <int D>
__device__ __forceinline__ void zero_rows(uint8_t* tile, int r0) {
  constexpr int CPR = D / 8;       // 16-byte chunks per row
  for (int i = threadIdx.x; i < (64 - r0) * CPR; i += kWgThreads)
    *tile_chunk(tile, r0 + i / CPR, i % CPR) = make_uint4(0, 0, 0, 0);
}

// byte i of w as a signed integer
__device__ __forceinline__ float i8_at(uint32_t w, int i) {
  return (float)((int32_t)(w << (24 - 8 * i)) >> 24);
}

// 16 int8 payloads (16 consecutive elements 16g .. 16g + 15 of row r)
// converted to T -- exactly -- into their two swizzled chunks
template <typename T>
__device__ __forceinline__ void store_i8(uint8_t* tile, int r, int g, uint4 x) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  uint32_t p[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    p[2 * i] = hk::pack2<T>(i8_at(w[i], 0), i8_at(w[i], 1));
    p[2 * i + 1] = hk::pack2<T>(i8_at(w[i], 2), i8_at(w[i], 3));
  }
  *tile_chunk(tile, r, 2 * g) = make_uint4(p[0], p[1], p[2], p[3]);
  *tile_chunk(tile, r, 2 * g + 1) = make_uint4(p[4], p[5], p[6], p[7]);
}

// An int8-KV k / v tile (positions k0 .. k0 + 63 of kv head kvh) into
// shared memory as T, with its 64 k- and v-scales; rows at or past kv_end
// are neither read nor kept (zeros, and scales 0).  16-byte loads.
template <typename T, int D, typename KRows>
__device__ __forceinline__ void load_i8_tile(
    uint8_t* ks, uint8_t* vs, float* kss, float* vss, const int8_t* k,
    const int8_t* v, const float* k_scale, const float* v_scale,
    const KRows& rows, const KRows& srows, int b, int kvh, int k0,
    int kv_end) {
  constexpr int G = D / 16;        // 16-byte groups of a row
  for (int i = threadIdx.x; i < 64 * G; i += kWgThreads) {
    const int r = i / G, g = i % G, pos = k0 + r;
    uint4 kx = make_uint4(0, 0, 0, 0), vx = kx;
    if (pos < kv_end) {
      const long long off = rows.at(b, pos) + (long long)kvh * D + 16 * g;
      kx = __ldg(reinterpret_cast<const uint4*>(k + off));
      vx = __ldg(reinterpret_cast<const uint4*>(v + off));
    }
    store_i8<T>(ks, r, g, kx);
    store_i8<T>(vs, r, g, vx);
  }
  if (threadIdx.x < 64) {
    const int pos = k0 + threadIdx.x;
    const bool live = pos < kv_end;
    const long long so = srows.at(b, live ? pos : 0) + kvh;
    kss[threadIdx.x] = live ? __ldg(k_scale + so) : 0.f;
    vss[threadIdx.x] = live ? __ldg(v_scale + so) : 0.f;
  }
}

// K7's float tiles: boxes of r rows, box j at virtual row k0 + j*r (within
// one page: r divides the page and 64), only those below kv_end.  K1 /
// K3: one 64-row box per D / 64.
template <int D, typename KRows>
__device__ __forceinline__ void issue_kv(uint8_t* kdst, uint8_t* vdst,
                                         const CUtensorMap* k_map,
                                         const CUtensorMap* v_map,
                                         uint64_t* bar, const KRows& rows,
                                         int box_rows, int b, int kvh, int k0,
                                         int kv_end) {
  constexpr int KT = D / 64;
  if constexpr (std::is_same<KRows, PagedRows>::value) {
    const int r = box_rows;
    const int n = min(64 / r, (kv_end - k0 + r - 1) / r);
    const uint32_t bytes = (uint32_t)(n * r * 128 * KT);
    hk::mbar_arrive_expect_tx(bar, 2 * bytes);
    for (int j = 0; j < n; ++j) {
      const int vr = k0 + j * r;
      const int pg = __ldg(rows.pages + (long long)b * rows.n_virt +
                           vr / rows.page);
      const int row = vr % rows.page;
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        const int off = t * hk::kTileBytes + j * r * 128;
        hk::tma_load_4d(kdst + off, k_map, bar, 64 * t, kvh, row, pg);
        hk::tma_load_4d(vdst + off, v_map, bar, 64 * t, kvh, row, pg);
      }
    }
  } else {
    hk::mbar_arrive_expect_tx(bar, 2 * row_tile_bytes<D>());
    tma_row_tile<D>(kdst, k_map, bar, kvh, k0, b);
    tma_row_tile<D>(vdst, v_map, bar, kvh, k0, b);
  }
}

// One block per (head, batch row, 64-row q tile), heaviest (last) q tiles
// first; loops over the k tiles up to the tile's causal limit.  C: the
// K/V element type, T (tiles by TMA through k_map / v_map) or int8_t
// (payloads k / v and scales through the row maps krows / srows).
// KRows: StridedRows (K1 / K3; unused for float tiles) or PagedRows (K7).
template <typename T, typename C, int D, typename KRows>
__global__ void __launch_bounds__(kWgThreads,
                                  D == 128 ? 2 : (sizeof(C) == 1 ? 4 : 5))
wgmma_flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const C* __restrict__ k, const C* __restrict__ v,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale, T* __restrict__ o,
                       float* __restrict__ lse,
                       const int* __restrict__ q_offsets, int Sq, int H,
                       int KVH, int Sk, KRows krows, KRows srows, int box_rows,
                       long long sob, long long sos, long long soh, int causal,
                       float scale) {
  constexpr bool kInt8 = sizeof(C) == 1;
  constexpr int KT = D / 64;
  constexpr int TB = row_tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align_smem(smem_raw);
  uint8_t* ks = qs + TB;               // 2 stages
  uint8_t* vs = ks + 2 * TB;           // 2 stages
  float* kss = reinterpret_cast<float*>(vs + 2 * TB);   // [2][64] k-scales
  float* vss = kss + 2 * 64;                            // [2][64] v-scales
  uint64_t* bars = reinterpret_cast<uint64_t*>(vss + 2 * 64);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * 64;
  const int kvh = h * KVH / H;         // GQA: the JAX kernel's kv-head map
  const int qoff = q_offsets != nullptr ? q_offsets[b] : 0;
  const int nq = min(64, Sq - q0);
  // causal: the furthest key any row of this tile sees is qoff + q0 + nq - 1
  const int kv_end = causal ? min(Sk, qoff + q0 + nq) : Sk;
  const int n_kt = (kv_end + 63) / 64;

  if (tid == 0) {
    hk::prefetch_tensor_map(&q_map);
    if constexpr (!kInt8) {
      hk::prefetch_tensor_map(&k_map);
      hk::prefetch_tensor_map(&v_map);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) hk::mbar_init(&bars[i], 1);
    hk::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hk::mbar_arrive_expect_tx(&bars[0], TB);
    tma_row_tile<D>(qs, &q_map, &bars[0], h, q0, b);
    if constexpr (!kInt8)
      if (n_kt > 0)
        issue_kv<D>(ks, vs, &k_map, &v_map, &bars[1], krows, box_rows, b, kvh,
                    0, kv_end);
  }
  if constexpr (kInt8) {
    if (n_kt > 0)
      load_i8_tile<T, D>(ks, vs, kss, vss, (const int8_t*)k, (const int8_t*)v,
                         k_scale, v_scale, krows, srows, b, kvh, 0, kv_end);
    hk::fence_proxy_async();
    __syncthreads();
  }

  // this thread's two q rows r0, r0 + 8 of every accumulator; its columns
  // 8j + c0 + {0, 1}
  const int r0 = warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const float scale2 = scale * kLog2e;
  const float sc2 = kInt8 ? 1.f : scale2;   // what turns a score into log2 units
  float m[2] = {kNegInf, kNegInf};     // running max, log2 units
  float l[2] = {0.f, 0.f};             // this thread's part of the running sum
  float acc[KT][32];
#pragma unroll
  for (int t = 0; t < KT; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[t][i] = 0.f;

  hk::mbar_wait(&bars[0], 0);
  for (int it = 0; it < n_kt; ++it) {
    const int st = it & 1;
    const int k0 = it * 64;
    uint8_t* kst = ks + st * TB;
    uint8_t* vst = vs + st * TB;
    if constexpr (!kInt8) {
      // the other stage held tile it - 1, consumed (wgmma waited, block
      // synced) at the end of the last iteration: load tile it + 1 into it
      if (tid == 0 && it + 1 < n_kt)
        issue_kv<D>(ks + (st ^ 1) * TB, vs + (st ^ 1) * TB, &k_map, &v_map,
                    &bars[1 + (st ^ 1)], krows, box_rows, b, kvh, k0 + 64,
                    kv_end);
      hk::mbar_wait(&bars[1 + st], (it >> 1) & 1);
      if (k0 + 64 > kv_end) {          // V rows past the limit: 0, not garbage
        zero_rows<D>(vst, kv_end - k0);
        hk::fence_proxy_async();
        __syncthreads();
      }
    }

    float s[32];
    hk::wgmma_fence();
    hk::wgmma_abt<T, KT>(s, hk::smem_u32(qs), hk::smem_u32(kst));  // S = q.k^T
    hk::wgmma_commit();
    if constexpr (kInt8) {             // the next tile, while S is computed
      if (it + 1 < n_kt)
        load_i8_tile<T, D>(ks + (st ^ 1) * TB, vs + (st ^ 1) * TB,
                           kss + (st ^ 1) * 64, vss + (st ^ 1) * 64,
                           (const int8_t*)k, (const int8_t*)v, k_scale,
                           v_scale, krows, srows, b, kvh, k0 + 64, kv_end);
    }
    hk::wgmma_wait<0>();
    hk::fence_acc(s);

    // scores, masked by a select: raw for float tiles (the scale rides
    // the exponent's multiply-add), times scale and the k-scale for int8
    const bool masked = k0 + 64 > kv_end || nq < 64 ||
                        (causal && k0 + 63 > qoff + q0);
    const float* kscl = kss + st * 64;
    const float* vscl = vss + st * 64;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hf = (i >> 1) & 1;
      const int c = 8 * (i >> 2) + c0 + (i & 1);
      float x = s[i];
      if constexpr (kInt8) x = x * scale2 * kscl[c];
      if (masked) {
        const int r = r0 + 8 * hf, pos = k0 + c;
        const bool live = r < nq && pos < Sk && (!causal || pos <= qoff + q0 + r);
        x = live ? x : kNegInf;
      }
      s[i] = x;
      mx[hf] = fmaxf(mx[hf], x);
    }
    float corr[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      const float m_new = fmaxf(m[hf], mx[hf] * sc2);
      corr[hf] = ex2(m[hf] - m_new);
      m[hf] = m_new;
      l[hf] *= corr[hf];
    }
    // P (unrounded into the running sum), then P (times the v-scale)
    // rounded to T as P.V's register A operand
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hf = (i >> 1) & 1;
      float p = ex2(fmaf(s[i], sc2, -m[hf]));
      if (masked) p = s[i] == kNegInf ? 0.f : p;
      l[hf] += p;
      if constexpr (kInt8) p *= vscl[8 * (i >> 2) + c0 + (i & 1)];
      s[i] = p;
    }
#pragma unroll
    for (int t = 0; t < KT; ++t)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[t][i] *= corr[(i >> 1) & 1];
    uint32_t pa[16];
    hk::acc_to_a<T>(s, pa);
    hk::wgmma_fence();
#pragma unroll
    for (int t = 0; t < KT; ++t)                                  // O += P.V
      hk::wgmma_rs_ab<T>(acc[t], pa, hk::smem_u32(vst) + t * hk::kTileBytes);
    hk::wgmma_commit();
    hk::wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < KT; ++t) hk::fence_acc(acc[t]);
    if constexpr (kInt8) hk::fence_proxy_async();   // the next tile's stores
    __syncthreads();   // every warp is done with stage st
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float lr = l[hf];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int r = r0 + 8 * hf;
    if (r >= nq) continue;
    const float safe = lr == 0.f ? 1.f : lr;
    T* ob = o + b * sob + (long long)(q0 + r) * sos + h * soh;
#pragma unroll
    for (int t = 0; t < KT; ++t)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(ob + 64 * t + 8 * j + c0) = hk::pack2<T>(
            acc[t][4 * j + 2 * hf] / safe, acc[t][4 * j + 2 * hf + 1] / safe);
    if (lse != nullptr && (lane & 3) == 0)
      lse[((long long)b * H + h) * Sq + q0 + r] =
          lr == 0.f ? kNegInf : m[hf] * kLn2 + logf(lr);
  }
}

// The arguments of one 16-bit launch: q / o [B, Sq, H, D] by their
// (b, s, h) strides; k / v (float: by TMA maps, int8: by row maps) and
// the int8-KV scales; lse [B, H, Sq] or null; q_offsets [B] or null.
struct WgArgs {
  const void *q, *k, *v, *k_scale, *v_scale;
  void *o, *lse;
  const void* q_offsets;
  int B, Sq, H, KVH, Sk;
  long long sq[3], so[3];
  int causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename C, int D, typename KRows>
int launch_wg(const WgArgs& a, const CUtensorMap* k_map,
              const CUtensorMap* v_map, KRows krows, KRows srows,
              int box_rows) {
  CUtensorMap q_map;
  if (a.Sk <= 0 ||
      !hk::make_bshd_map(&q_map, a.q, std::is_same<T, __half>::value, a.B,
                         a.Sq, a.H, D, a.sq[0], a.sq[1], a.sq[2]))
    return cudaErrorInvalidValue;
  const size_t smem = wg_smem_bytes<D>();
  auto kernel = wgmma_flash_fwd_kernel<T, C, D, KRows>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  // int8 tiles take no map: the q map stands in for the unused k / v maps
  kernel<<<dim3(a.H, a.B, (a.Sq + 63) / 64), kWgThreads, smem, a.stream>>>(
      q_map, k_map != nullptr ? *k_map : q_map,
      v_map != nullptr ? *v_map : q_map, (const C*)a.k, (const C*)a.v,
      (const float*)a.k_scale, (const float*)a.v_scale, (T*)a.o,
      (float*)a.lse, (const int*)a.q_offsets, a.Sq, a.H, a.KVH, a.Sk, krows,
      srows, box_rows, a.so[0], a.so[1], a.so[2], a.causal, a.scale);
  return (int)cudaGetLastError();
}

// K1 / K3 on float k / v [B, Sk, KVH, D] given by their (b, s, h) strides
template <typename T, int D>
int launch_strided(const WgArgs& a, const long long (&sk)[3],
                   const long long (&sv)[3]) {
  const bool f16 = std::is_same<T, __half>::value;
  CUtensorMap km, vm;
  if (!hk::make_bshd_map(&km, a.k, f16, a.B, a.Sk, a.KVH, D, sk[0], sk[1],
                         sk[2]) ||
      !hk::make_bshd_map(&vm, a.v, f16, a.B, a.Sk, a.KVH, D, sv[0], sv[1],
                         sv[2]))
    return cudaErrorInvalidValue;
  const StridedRows none{0, 0};
  return launch_wg<T, T, D>(a, &km, &vm, none, none, 64);
}

// K7 on a float pool layer [num_pages, page, KVH * D], viewed as
// [num_pages, page, KVH, D] with boxes of box_rows rows
template <typename T, int D>
int launch_paged(const WgArgs& a, const PagedRows& rows, int num_pages,
                 int box_rows) {
  const bool f16 = std::is_same<T, __half>::value;
  const long long row = (long long)a.KVH * D;
  CUtensorMap km, vm;
  if (!hk::make_bshd_map(&km, a.k, f16, num_pages, rows.page, a.KVH, D,
                         rows.page * row, row, D, box_rows) ||
      !hk::make_bshd_map(&vm, a.v, f16, num_pages, rows.page, a.KVH, D,
                         rows.page * row, row, D, box_rows))
    return cudaErrorInvalidValue;
  return launch_wg<T, T, D>(a, &km, &vm, rows, rows, box_rows);
}

}  // namespace fwd

// Calls LAUNCH(T, D) for a 16-bit dtype; returns cudaErrorInvalidValue for
// any other combination.
#define DSTT_DISPATCH_16BIT(dtype, head_dim, LAUNCH)                        \
  do {                                                                      \
    if ((dtype) == dstt::kBFloat16) {                                       \
      if ((head_dim) == 64) { LAUNCH(__nv_bfloat16, 64); }                  \
      else if ((head_dim) == 128) { LAUNCH(__nv_bfloat16, 128); }           \
    } else if ((dtype) == dstt::kFloat16) {                                 \
      if ((head_dim) == 64) { LAUNCH(__half, 64); }                         \
      else if ((head_dim) == 128) { LAUNCH(__half, 128); }                  \
    }                                                                       \
    return cudaErrorInvalidValue;                                           \
  } while (0)

}  // namespace dstt

// Each entry point routes fp32 to the FMA `flash_fwd_kernel` and bf16 /
// fp16 to `wgmma_flash_fwd_kernel`, and returns cudaGetLastError()
// (cudaErrorInvalidValue for what no kernel takes: a head dim other than
// 64 / 128, a 16-bit tensor whose TMA map cannot be encoded -- the
// wrappers check addresses and strides first --, no keys).

// q [B, Sq, H, D], k / v [B, Sk, KVH, D] and o [B, Sq, H, D], each given by
// its (b, s, h) strides in elements with a unit stride on D.  lse: [B, H, Sq]
// fp32 or null.  q_offsets: [B] int32 position of each row's first query
// (K3's chunk starts) or null for 0.
extern "C" int dstt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* q_offsets, int dtype, int B, int Sq, int H, int KVH, int D,
    int Sk, long long sqb, long long sqs, long long sqh, long long skb,
    long long sks, long long skh, long long svb, long long svs, long long svh,
    long long sob, long long sos, long long soh, int causal, float scale,
    void* stream) {
  if (KVH <= 0 || H % KVH != 0) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return cudaSuccess;
  if (dtype == dstt::kFloat32) {
    const dstt::StridedRows krows{skb, sks}, vrows{svb, svs};
    if (D == 64)
      dstt::launch_flash<float, float, 64>(
          q, k, v, nullptr, nullptr, o, lse, q_offsets, B, Sq, H, KVH, Sk, sqb,
          sqs, sqh, krows, skh, vrows, svh, krows, sob, sos, soh, causal,
          scale, (cudaStream_t)stream);
    else if (D == 128)
      dstt::launch_flash<float, float, 128>(
          q, k, v, nullptr, nullptr, o, lse, q_offsets, B, Sq, H, KVH, Sk, sqb,
          sqs, sqh, krows, skh, vrows, svh, krows, sob, sos, soh, causal,
          scale, (cudaStream_t)stream);
    else
      return cudaErrorInvalidValue;
    return (int)cudaGetLastError();
  }
  const dstt::fwd::WgArgs a{q, k, v, nullptr, nullptr, o, lse, q_offsets,
                            B, Sq, H, KVH, Sk, {sqb, sqs, sqh},
                            {sob, sos, soh}, causal, scale,
                            (cudaStream_t)stream};
  const long long sk[3] = {skb, sks, skh}, sv[3] = {svb, svs, svh};
#define DSTT_FLASH_LAUNCH(T, HD) \
  return dstt::fwd::launch_strided<T, HD>(a, sk, sv);
  DSTT_DISPATCH_16BIT(dtype, D, DSTT_FLASH_LAUNCH);
#undef DSTT_FLASH_LAUNCH
}

// K3 on an int8-KV cache.  q and o as for dstt_flash_attention_fwd;
// k_cache / v_cache one layer's contiguous int8 [B, S_max, KVH*D],
// k_scale / v_scale its contiguous fp32 [B, S_max, KVH]; starts [B] int32,
// the position of each row's first query (its chunk was written to the
// cache first).  Causal, no LSE.
extern "C" int dstt_chunk_prefill_int8(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, void* o, const void* starts,
    int dtype, int B, int Sq, int H, int KVH, int D, int S_max,
    long long sqb, long long sqs, long long sqh, long long sob, long long sos,
    long long soh, float scale, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || S_max <= 0) return cudaErrorInvalidValue;
  if (k_scale == nullptr || v_scale == nullptr) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return cudaSuccess;
  const dstt::StridedRows rows{(long long)S_max * KVH * D, (long long)KVH * D};
  const dstt::StridedRows srows{(long long)S_max * KVH, (long long)KVH};
  if (dtype == dstt::kFloat32) {
#define DSTT_CHUNK_INT8_LAUNCH(HD)                                              \
  dstt::launch_flash<float, int8_t, HD>(q, k_cache, v_cache, k_scale, v_scale, \
                                        o, nullptr, starts, B, Sq, H, KVH,     \
                                        S_max, sqb, sqs, sqh, rows, D, rows,   \
                                        D, srows, sob, sos, soh, 1, scale,     \
                                        (cudaStream_t)stream);
    if (D == 64) { DSTT_CHUNK_INT8_LAUNCH(64) }
    else if (D == 128) { DSTT_CHUNK_INT8_LAUNCH(128) }
    else return cudaErrorInvalidValue;
#undef DSTT_CHUNK_INT8_LAUNCH
    return (int)cudaGetLastError();
  }
  const dstt::fwd::WgArgs a{q, k_cache, v_cache, k_scale, v_scale, o,
                            nullptr, starts, B, Sq, H, KVH, S_max,
                            {sqb, sqs, sqh}, {sob, sos, soh}, 1, scale,
                            (cudaStream_t)stream};
#define DSTT_CHUNK_INT8_LAUNCH(T, HD)                                      \
  return dstt::fwd::launch_wg<T, int8_t, HD>(a, nullptr, nullptr, rows, \
                                             srows, 0);
  DSTT_DISPATCH_16BIT(dtype, D, DSTT_CHUNK_INT8_LAUNCH);
#undef DSTT_CHUNK_INT8_LAUNCH
}

// K7.  q [B, Sq, H, D] and o [B, Sq, H, D] given by their (b, s, h)
// strides with a unit stride on D; k_pool / v_pool one layer of the page
// pool, contiguous [num_pages, page, KVH*D], in q's dtype -- or int8 with
// k_scale / v_scale that layer's fp32 [num_pages, page, KVH] (both null
// for a float pool); pages [B, n_virt] int32; starts [B] int32, the
// virtual position of each row's first query (its chunk was written to
// the pool first); box_rows: the rows of one TMA box of a 16-bit float
// pool, a multiple of 8 dividing both 64 and the page (the wrapper's
// `paged_box_rows`).  Causal, no LSE.
extern "C" int dstt_paged_chunk_prefill(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, void* o, const void* starts,
    const void* pages, int dtype, int B, int Sq, int H, int KVH, int D,
    int num_pages, int page, int n_virt, int box_rows, long long sqb,
    long long sqs, long long sqh, long long sob, long long sos, long long soh,
    float scale, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || page <= 0 || n_virt <= 0 || num_pages <= 0)
    return cudaErrorInvalidValue;
  if ((k_scale == nullptr) != (v_scale == nullptr)) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return cudaSuccess;
  const dstt::PagedRows rows{(const int*)pages, n_virt, page,
                             (long long)KVH * D};
  const dstt::PagedRows srows{(const int*)pages, n_virt, page, (long long)KVH};
  if (dtype == dstt::kFloat32) {
#define DSTT_PAGED_CHUNK_LAUNCH(HD)                                              \
  if (k_scale != nullptr)                                                        \
    dstt::launch_flash<float, int8_t, HD>(                                       \
        q, k_pool, v_pool, k_scale, v_scale, o, nullptr, starts, B, Sq, H, KVH,  \
        page * n_virt, sqb, sqs, sqh, rows, D, rows, D, srows, sob, sos, soh, 1, \
        scale, (cudaStream_t)stream);                                            \
  else                                                                           \
    dstt::launch_flash<float, float, HD>(                                        \
        q, k_pool, v_pool, nullptr, nullptr, o, nullptr, starts, B, Sq, H, KVH,  \
        page * n_virt, sqb, sqs, sqh, rows, D, rows, D, srows, sob, sos, soh, 1, \
        scale, (cudaStream_t)stream);
    if (D == 64) { DSTT_PAGED_CHUNK_LAUNCH(64) }
    else if (D == 128) { DSTT_PAGED_CHUNK_LAUNCH(128) }
    else return cudaErrorInvalidValue;
#undef DSTT_PAGED_CHUNK_LAUNCH
    return (int)cudaGetLastError();
  }
  const dstt::fwd::WgArgs a{q, k_pool, v_pool, k_scale, v_scale, o,
                            nullptr, starts, B, Sq, H, KVH, page * n_virt,
                            {sqb, sqs, sqh}, {sob, sos, soh}, 1, scale,
                            (cudaStream_t)stream};
  if (k_scale == nullptr &&
      (box_rows <= 0 || box_rows % 8 != 0 || 64 % box_rows != 0 ||
       page % box_rows != 0))
    return cudaErrorInvalidValue;
#define DSTT_PAGED_CHUNK_LAUNCH(T, HD)                                      \
  if (k_scale != nullptr)                                                   \
    return dstt::fwd::launch_wg<T, int8_t, HD>(a, nullptr, nullptr, rows,   \
                                               srows, 0);                   \
  return dstt::fwd::launch_paged<T, HD>(a, rows, num_pages, box_rows);
  DSTT_DISPATCH_16BIT(dtype, D, DSTT_PAGED_CHUNK_LAUNCH);
#undef DSTT_PAGED_CHUNK_LAUNCH
}

// Dynamic shared memory per block of the kernel a call with this dtype,
// cache type (int8: 1) and head dim launches; -1 when none.
extern "C" int dstt_flash_attention_fwd_smem(int dtype, int int8, int D) {
  if (D != 64 && D != 128) return -1;
  if (dtype == dstt::kFloat32)
    return (int)(int8 ? (D == 64 ? dstt::flash_smem_bytes<64, true>()
                                 : dstt::flash_smem_bytes<128, true>())
                      : (D == 64 ? dstt::flash_smem_bytes<64, false>()
                                 : dstt::flash_smem_bytes<128, false>()));
  return (int)(D == 64 ? dstt::fwd::wg_smem_bytes<64>()
                       : dstt::fwd::wg_smem_bytes<128>());
}
