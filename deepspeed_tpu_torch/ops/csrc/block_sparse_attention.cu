// K8: block-sparse attention forward for Hopper.
//
// Replaces the Pallas kernel of the JAX package
//   deepspeed_tpu/ops/sparse_attention/block_sparse.py
//   _sparse_fwd_pallas / _sparse_fwd_kernel
// which walks a (B*H, nq, A) grid whose kv index comes from the
// scalar-prefetched table idx[h, iq, a] for a < counts[h, iq], with an
// online softmax in fp32, a causal kvpos <= qpos mask inside each block
// when causal, P.V in fp32, and o = acc / l, or 0 where l == 0.
//
// q, k and v are read in the model's [B, S, H, D] layout through strides
// (no transpose); O is written in the input dtype and, when asked, the
// fp32 LSE [B, H, S] in natural-log units (-1e30 for a row no live key
// reaches, whose output is 0).  The scores are (q.k + bias[b, key]) *
// scale in fp32: the optional fp32 bias [B, S] is the key-padding fold
// (the JAX wrapper appends a 0 / -1e4 feature to k, so it enters the dot
// before the scale).  Masked scores are -1e30, never a product.
//
// What bounds it on an H100: at the training path's shape (q/k/v [1, 8192,
// 32, 64] bf16, block 64, <= 6 active blocks a row) the two products are
// 4 * D flops per live (query, key) pair, 16.7 GFLOP (0.017 ms at the bf16
// peak), against 134 MB of q, k, v and o (0.040 ms at 3.35 TB/s): on paper
// it is bound by bytes, and a kv tile that several q tiles walk (the
// sliding window's, the global block's) comes from L2, not from DRAM.  On
// the card it runs at about 2.5x that bound, held by the chain of work a
// warpgroup does per 64 x 64 tile (S, the softmax, P.V, one after the
// other) at the 4 or 5 warpgroups an SM holds; a third ring stage (fewer
// blocks an SM) is slower.  Two designs, by input type:
//
// * bf16 / fp16: `wgmma_sparse_fwd_kernel`, one warpgroup (128 threads)
//   per 64-row q tile of one (batch row, head), the q tiles of a head
//   neighbours in the grid (their window tiles are read from L2).  The
//   walk is a per-tile table at 64-token granularity made on the host
//   from the layout's (idx, counts) (block_sparse.tile_tables): for each
//   q tile, every 64-key tile any of its layout rows reaches, as
//   (key tile << 16 | cells), where bit 4 * rc + cc of `cells` says that
//   the 16 x 16 cell (q rows 16 rc.., keys 16 cc..) holds a live pair.
//   At block 64 that is the layout row itself; at 128 a q tile is half a
//   layout row and each active block gives two key tiles; at 16 and 32 a
//   q tile spans 4 or 2 layout rows and the table is the union of their
//   tiles.  Under the causal mask no key tile past the q tile's last row
//   is listed, and no padded slot (j >= tile_counts) is read.  The q tile
//   comes by TMA once (`hk::make_bshd_map`); k and v tiles (64 x D,
//   128-byte swizzled) and the tile's 64 key biases come by TMA into a
//   2-stage mbarrier ring that runs across layout blocks, filled 2 tiles
//   ahead by one thread that reads each table entry as it issues the
//   tile.  S = q.k^T on wgmma m64n64k16 (fp32 accumulators,
//   both operands K-major in shared memory); the bias, the cell mask,
//   the causal mask and the ragged tail (cells past S are never live) are
//   applied by a select, on tiles that need one only (a warp's rows
//   in a dead cell, or keys past its first row); the online softmax runs
//   in fp32 in the accumulator layout (a row's max and sum are two quad
//   shuffles; exp is one ex2 of a multiply-add that carries scale *
//   log2(e)).  P.V keeps B8's fp32 P: P is split into P_hi = P rounded to
//   the input type and P_lo = (P - P_hi) rounded again, and two
//   register-A products add P_hi.V and P_lo.V (about 16 bits of P, where
//   one rounding keeps 8 in bf16); the running sum takes the unrounded P.
//   The extra product costs about a sixth of the time of a kernel that
//   rounds P once (scripts/k8_variants.py --patch round_p); it is kept
//   for P's precision.  Nothing is read back to the host.
// * fp32: `block_sparse_fwd_kernel`, fp32 FMAs on the CUDA cores (wgmma's
//   fp32 path is TF32 and would miss the fp32 bar of 1e-4): one block of
//   256 threads per q tile of TL = min(block, 64) rows walks its layout
//   row's active blocks (a < counts[h, iq]) in k tiles of TL rows staged
//   in padded shared memory; thread (ty, tx) owns q rows ty*RPT ..
//   +RPT-1, score columns tx + 16*j and output dims tx + 16*j (a row's 16
//   owners form an aligned half-warp, so row max and sum are shuffles).
//   Under the causal mask a k tile whose first key lies past the q tile's
//   last row is skipped.
#include <type_traits>

#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace dstt {

// ----------------------------------------------------------- fp32: FMA
constexpr int kSparseThreads = 256;

// rows of a q tile and of a k tile for a layout block of BLK tokens
template <int BLK>
struct SparseTile {
  static constexpr int kRows = BLK < 64 ? BLK : 64;
};

template <int D, int BLK>
constexpr size_t sparse_smem_bytes() {
  constexpr int TL = SparseTile<BLK>::kRows;
  return sizeof(float) * (size_t)(3 * TL * (D + 1) + TL * (TL + 1));
}

template <typename T, int D, int BLK>
__global__ void __launch_bounds__(kSparseThreads)
block_sparse_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        float* __restrict__ lse,
                        const int* __restrict__ idx,
                        const int* __restrict__ counts,
                        const float* __restrict__ bias, int S, int H, int A,
                        long long sqb, long long sqs, long long sqh,
                        long long skb, long long sks, long long skh,
                        long long svb, long long svs, long long svh,
                        long long sob, long long sos, long long soh,
                        int causal, float scale) {
  constexpr int TL = SparseTile<BLK>::kRows;
  constexpr int DP = D + 1;      // padded rows: no bank conflicts on column walks
  constexpr int PP = TL + 1;
  constexpr int RPT = TL / 16;   // q rows per thread
  constexpr int CPT = TL / 16;   // score columns per thread
  constexpr int DPT = D / 16;    // output dims per thread
  extern __shared__ float smem[];
  float* qs = smem;              // [TL, DP]
  float* ks = qs + TL * DP;      // [TL, DP]
  float* vs = ks + TL * DP;      // [TL, DP]
  float* ps = vs + TL * DP;      // [TL, PP] probabilities of this k tile

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * TL, h = blockIdx.y, b = blockIdx.z;
  const int nb = S / BLK;
  const int iq = q0 / BLK;                       // this tile's layout row
  const long long row = (long long)h * nb + iq;
  const int cnt = __ldg(counts + row);
  const int* row_idx = idx + row * A;
  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;
  const float* bb = bias != nullptr ? bias + (long long)b * S : nullptr;
  const int q_last = q0 + TL - 1;

  for (int i = tid; i < TL * D; i += kSparseThreads) {
    const int r = i / D, d = i % D;
    qs[r * DP + d] = to_f(qb[(q0 + r) * sqs + d]);
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[r][j] = 0.f;
  }

  // one k tile of TL rows at a time, SUBS a layout block
  constexpr int SUBS = BLK / TL;
  for (int t = 0; t < cnt * SUBS; ++t) {
    const int k0 = __ldg(row_idx + t / SUBS) * BLK + (t % SUBS) * TL;
    // ascending blocks: this tile and the rest are all masked
    if (causal && k0 > q_last) break;
    __syncthreads();  // the previous tile's ks / vs / ps are consumed
    for (int i = tid; i < TL * D; i += kSparseThreads) {
      const int c = i / D, d = i % D;
      ks[c * DP + d] = to_f(kb[(k0 + c) * sks + d]);
      vs[c * DP + d] = to_f(vb[(k0 + c) * svs + d]);
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

    float kbias[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      kbias[c] = bb != nullptr ? bb[k0 + tx + 16 * c] : 0.f;

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int qi = ty * RPT + r;
      const int qpos = q0 + qi;
      bool live[CPT];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int pos = k0 + tx + 16 * c;
        live[c] = !causal || pos <= qpos;
        s[r][c] = live[c] ? (s[r][c] + kbias[c]) * scale : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float p = live[c] ? expf(s[r][c] - m_new) : 0.f;
        ps[qi * PP + tx + 16 * c] = p;
        sum += p;
      }
      sum = half_warp_sum(sum);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[r][j] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < TL; ++c) {
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
    // a row with no live key (no active block) has l == 0 and acc == 0
    const float safe = l[r] == 0.f ? 1.f : l[r];
    T* ob = o + b * sob + (long long)(q0 + qi) * sos + h * soh;
#pragma unroll
    for (int j = 0; j < DPT; ++j) ob[tx + 16 * j] = from_f<T>(acc[r][j] / safe);
    if (lse != nullptr && tx == 0)
      lse[((long long)b * H + h) * S + q0 + qi] =
          l[r] == 0.f ? kNegInf : m[r] + logf(l[r]);
  }
}

template <typename T, int HD, int BLK>
void launch_block_sparse(const void* q, const void* k, const void* v, void* o,
                         void* lse, const void* idx, const void* counts,
                         const void* bias, int B, int S, int H, int A,
                         long long sqb, long long sqs, long long sqh,
                         long long skb, long long sks, long long skh,
                         long long svb, long long svs, long long svh,
                         long long sob, long long sos, long long soh,
                         int causal, float scale, cudaStream_t stream) {
  constexpr int TL = SparseTile<BLK>::kRows;
  const dim3 grid(S / TL, H, B);
  const size_t smem = sparse_smem_bytes<HD, BLK>();
  cudaFuncSetAttribute(block_sparse_fwd_kernel<T, HD, BLK>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  block_sparse_fwd_kernel<T, HD, BLK><<<grid, kSparseThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse,
      (const int*)idx, (const int*)counts, (const float*)bias, S, H, A, sqb,
      sqs, sqh, skb, sks, skh, svb, svs, svh, sob, sos, soh, causal, scale);
}

// ------------------------------------------------- bf16 / fp16: wgmma + TMA
namespace sparse {
namespace hk = dstt::hopper;

constexpr int kStages = 2;        // k / v tiles in the ring
constexpr int kBlocksD64 = 5;     // blocks an SM at D 64, bf16
constexpr int kWgThreads = 128;   // one warpgroup
constexpr int kBiasBytes = 64 * sizeof(float);   // one key tile's biases
constexpr float kLn2 = 0.6931471805599453f;     // the LSE in natural-log units

// 2^x by one MUFU.EX2 (denormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the q tile, kStages k and v tiles and key-bias tiles, 1 + kStages
// mbarriers; + alignment slack
template <int D>
constexpr size_t smem_bytes() {
  return hk::kSwizzleAlign + (1 + 2 * kStages) * hk::row_tile_bytes<D>() +
         kStages * kBiasBytes + (1 + kStages) * sizeof(uint64_t);
}

template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t u);
template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}
template <>
__device__ __forceinline__ float2 unpack2<__half>(uint32_t u) {
  return __half22float2(*reinterpret_cast<__half2*>(&u));
}

// P in the accumulator layout as the register A operands of P.V: hi = P
// rounded to T, lo = what hi misses (exact in fp32) rounded to T
template <typename T>
__device__ __forceinline__ void split_to_a(const float (&p)[32],
                                           uint32_t (&hi)[16],
                                           uint32_t (&lo)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    hi[i] = hk::pack2<T>(p[2 * i], p[2 * i + 1]);
    const float2 r = unpack2<T>(hi[i]);
    lo[i] = hk::pack2<T>(p[2 * i] - r.x, p[2 * i + 1] - r.y);
  }
}

// one box of a 2-D tensor map (the key biases) into shared memory
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(hk::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(hk::smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// key tile kt of (head h, batch row b): its k and v row tiles and, with a
// bias, its 64 key biases, all counted on `bar`
template <int D>
__device__ __forceinline__ void issue_tile(uint8_t* kdst, uint8_t* vdst,
                                           float* bdst,
                                           const CUtensorMap* k_map,
                                           const CUtensorMap* v_map,
                                           const CUtensorMap* b_map,
                                           bool has_bias, uint64_t* bar,
                                           int h, int kt, int b) {
  hk::mbar_arrive_expect_tx(
      bar, 2 * hk::row_tile_bytes<D>() + (has_bias ? kBiasBytes : 0));
  hk::tma_row_tile<D>(kdst, k_map, bar, h, 64 * kt, b);
  hk::tma_row_tile<D>(vdst, v_map, bar, h, 64 * kt, b);
  if (has_bias) tma_load_2d(bdst, b_map, bar, 64 * kt, b);
}

// One block per (64-row q tile, head, batch row); walks the q tile's
// tile_counts[h, qt] entries of tiles[h, qt, :].  b_map: the key biases
// [B, S] (BIAS), else unused.  Blocks an SM holds: 2 at D 128; at D 64,
// kBlocksD64 for bf16, 4 for fp16 (its conversions need a few registers
// more, and 96 spill).
template <typename T, int D, bool BIAS>
__global__ void __launch_bounds__(
    kWgThreads, D == 128 ? 2
                         : (std::is_same<T, __half>::value ? 4 : kBlocksD64))
wgmma_sparse_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap b_map,
                        T* __restrict__ o,
                        float* __restrict__ lse, const int* __restrict__ tiles,
                        const int* __restrict__ tile_counts, int S, int H,
                        int TW, long long sob, long long sos, long long soh,
                        int causal, float scale) {
  constexpr int KT = D / 64;
  constexpr int TB = hk::row_tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = hk::align_smem(smem_raw);
  uint8_t* ks = qs + TB;                          // kStages k tiles
  uint8_t* vs = ks + kStages * TB;                // kStages v tiles
  float* bs = reinterpret_cast<float*>(vs + kStages * TB);   // [kStages][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(bs + kStages * 64);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * 64;
  const long long trow = (long long)h * gridDim.x + qt;
  const int n = __ldg(tile_counts + trow);
  const int* ents = tiles + trow * TW;

  if (tid == 0 && n > 0) {
    hk::prefetch_tensor_map(&q_map);
    hk::prefetch_tensor_map(&k_map);
    hk::prefetch_tensor_map(&v_map);
#pragma unroll
    for (int i = 0; i <= kStages; ++i) hk::mbar_init(&bars[i], 1);
    hk::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && n > 0) {
    hk::mbar_arrive_expect_tx(&bars[0], TB);
    hk::tma_row_tile<D>(qs, &q_map, &bars[0], h, q0, b);
    for (int j = 0; j < kStages && j < n; ++j)
      issue_tile<D>(ks + j * TB, vs + j * TB, bs + j * 64, &k_map, &v_map,
                    &b_map, BIAS, &bars[1 + j], h, __ldg(ents + j) >> 16,
                    b);
  }

  // this thread's two q rows r0, r0 + 8 (in the warp's 16-row cell) of
  // every accumulator; its columns 8j + c0 + {0, 1} (in 16-key cell j / 2)
  const int r0 = warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const float sc2 = scale * hk::kLog2e;   // a score in log2 units
  float m[2] = {kNegInf, kNegInf};        // running max, log2 units
  float l[2] = {0.f, 0.f};                // this thread's part of the sum
  float acc[KT][32];
#pragma unroll
  for (int t = 0; t < KT; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[t][i] = 0.f;

  if (n > 0) hk::mbar_wait(&bars[0], 0);
  for (int it = 0; it < n; ++it) {
    const int st = it % kStages;
    const int e = __ldg(ents + it);
    const int k0 = (e >> 16) * 64;
    const int cells = (e >> (4 * warp)) & 0xF;   // this warp's row cell
    uint8_t* kst = ks + st * TB;
    uint8_t* vst = vs + st * TB;
    const float* bst = bs + st * 64;
    hk::mbar_wait(&bars[1 + st], (it / kStages) & 1);

    float s[32];
    hk::wgmma_fence();
    hk::wgmma_abt<T, KT>(s, hk::smem_u32(qs), hk::smem_u32(kst));  // S = q.k^T
    hk::wgmma_commit();
    hk::wgmma_wait<0>();
    hk::fence_acc(s);

    // a dead cell in this warp's rows, or a key past its first row
    const bool masked = cells != 0xF || (causal && k0 + 63 > q0 + 16 * warp);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hf = (i >> 1) & 1;
      const int c = 8 * (i >> 2) + c0 + (i & 1);
      float x = s[i];
      if (BIAS) x += bst[c];
      if (masked) {
        const bool live = ((cells >> (i >> 3)) & 1) &&
                          (!causal || k0 + c <= q0 + r0 + 8 * hf);
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
    // P, unrounded into the running sum and split for P.V
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hf = (i >> 1) & 1;
      float p = ex2(fmaf(s[i], sc2, -m[hf]));
      if (masked) p = s[i] == kNegInf ? 0.f : p;
      l[hf] += p;
      s[i] = p;
    }
#pragma unroll
    for (int t = 0; t < KT; ++t)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[t][i] *= corr[(i >> 1) & 1];
    uint32_t p_hi[16], p_lo[16];
    split_to_a<T>(s, p_hi, p_lo);
    hk::wgmma_fence();
#pragma unroll
    for (int t = 0; t < KT; ++t)                        // O += P_hi.V
      hk::wgmma_rs_ab<T>(acc[t], p_hi, hk::smem_u32(vst) + t * hk::kTileBytes);
#pragma unroll
    for (int t = 0; t < KT; ++t)                        // O += P_lo.V
      hk::wgmma_rs_ab<T>(acc[t], p_lo, hk::smem_u32(vst) + t * hk::kTileBytes);
    hk::wgmma_commit();
    hk::wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < KT; ++t) hk::fence_acc(acc[t]);
    __syncthreads();   // every warp is done with stage st: refill it
    if (tid == 0 && it + kStages < n)
      issue_tile<D>(kst, vst, bs + st * 64, &k_map, &v_map, &b_map, BIAS,
                    &bars[1 + st], h, __ldg(ents + it + kStages) >> 16, b);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float lr = l[hf];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int r = r0 + 8 * hf;
    if (q0 + r >= S) continue;
    const float inv = lr == 0.f ? 0.f : 1.f / lr;   // no live key: 0
    T* ob = o + b * sob + (long long)(q0 + r) * sos + h * soh;
#pragma unroll
    for (int t = 0; t < KT; ++t)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(ob + 64 * t + 8 * j + c0) = hk::pack2<T>(
            acc[t][4 * j + 2 * hf] * inv, acc[t][4 * j + 2 * hf + 1] * inv);
    if (lse != nullptr && (lane & 3) == 0)
      lse[((long long)b * H + h) * S + q0 + r] =
          lr == 0.f ? kNegInf : m[hf] * kLn2 + logf(lr);
  }
}

// A map over the fp32 key biases [B, S] (contiguous) whose box is one key
// tile's 64 biases of one batch row.
inline bool make_bias_map(CUtensorMap* map, const void* bias, int B, int S) {
  hk::EncodeTiledFn encode = hk::encode_tiled_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[1] = {(cuuint64_t)S * sizeof(float)};
  const cuuint32_t box[2] = {64, 1};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(bias), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The arguments of one 16-bit launch (strides in elements, b / s / h).
struct WgArgs {
  const void *q, *k, *v, *tiles, *tile_counts, *bias;
  void *o, *lse;
  int B, S, H, TW;
  long long sq[3], sk[3], sv[3], so[3];
  int causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_wg(const WgArgs& a) {
  const bool f16 = std::is_same<T, __half>::value;
  CUtensorMap qm, km, vm, bm;
  if (!hk::make_bshd_map(&qm, a.q, f16, a.B, a.S, a.H, D, a.sq[0], a.sq[1],
                         a.sq[2]) ||
      !hk::make_bshd_map(&km, a.k, f16, a.B, a.S, a.H, D, a.sk[0], a.sk[1],
                         a.sk[2]) ||
      !hk::make_bshd_map(&vm, a.v, f16, a.B, a.S, a.H, D, a.sv[0], a.sv[1],
                         a.sv[2]))
    return cudaErrorInvalidValue;
  const bool has_bias = a.bias != nullptr;
  if (has_bias && !make_bias_map(&bm, a.bias, a.B, a.S))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<D>();
  auto kernel = has_bias ? wgmma_sparse_fwd_kernel<T, D, true>
                         : wgmma_sparse_fwd_kernel<T, D, false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  // no bias: the q map stands in for the unused bias map
  kernel<<<dim3((a.S + 63) / 64, a.H, a.B), kWgThreads, smem, a.stream>>>(
      qm, km, vm, has_bias ? bm : qm, (T*)a.o, (float*)a.lse,
      (const int*)a.tiles, (const int*)a.tile_counts, a.S, a.H, a.TW,
      a.so[0], a.so[1], a.so[2], a.causal, a.scale);
  return (int)cudaGetLastError();
}

}  // namespace sparse
}  // namespace dstt

// q, k, v and o [B, S, H, D], each given by its (b, s, h) strides in
// elements with a unit stride on D.  lse: fp32 [B, H, S] or null.
// fp32 walks idx [H, S/block, A] / counts [H, S/block]; bf16 / fp16 walk
// tiles [H, ceil(S/64), TW] / tile_counts [H, ceil(S/64)] (contiguous
// int32, block_sparse.device_tables).  bias: an fp32 [B, S] contiguous key
// bias added before the scale, or null.  block: 16, 32, 64 or 128,
// dividing S.  Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// shape, block or type with no instantiation or a tensor TMA cannot map.
extern "C" int dstt_block_sparse_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* idx, const void* counts, const void* tiles,
    const void* tile_counts, const void* bias, int dtype, int B, int S, int H,
    int D, int A, int TW, int block, long long sqb, long long sqs,
    long long sqh, long long skb, long long sks, long long skh, long long svb,
    long long svs, long long svh, long long sob, long long sos, long long soh,
    int causal, float scale, void* stream) {
  if (block <= 0 || S % block != 0 || A <= 0 || TW <= 0)
    return cudaErrorInvalidValue;
  if (block != 16 && block != 32 && block != 64 && block != 128)
    return cudaErrorInvalidValue;
  if (D != 64 && D != 128) return cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  if (dtype == dstt::kFloat32) {
#define DSTT_SPARSE_BLOCK(HD, BLK)                                            \
  dstt::launch_block_sparse<float, HD, BLK>(                                  \
      q, k, v, o, lse, idx, counts, bias, B, S, H, A, sqb, sqs, sqh, skb,     \
      sks, skh, svb, svs, svh, sob, sos, soh, causal, scale,                  \
      (cudaStream_t)stream)
#define DSTT_SPARSE_LAUNCH(HD)                                                \
  switch (block) {                                                            \
    case 16: DSTT_SPARSE_BLOCK(HD, 16); break;                                \
    case 32: DSTT_SPARSE_BLOCK(HD, 32); break;                                \
    case 64: DSTT_SPARSE_BLOCK(HD, 64); break;                                \
    default: DSTT_SPARSE_BLOCK(HD, 128); break;                               \
  }
    if (D == 64) {
      DSTT_SPARSE_LAUNCH(64);
    } else {
      DSTT_SPARSE_LAUNCH(128);
    }
#undef DSTT_SPARSE_LAUNCH
#undef DSTT_SPARSE_BLOCK
    return (int)cudaGetLastError();
  }
  const dstt::sparse::WgArgs a{
      q, k, v, tiles, tile_counts, bias, o, lse, B, S, H, TW,
      {sqb, sqs, sqh}, {skb, sks, skh}, {svb, svs, svh}, {sob, sos, soh},
      causal, scale, (cudaStream_t)stream};
  if (dtype == dstt::kBFloat16)
    return D == 64 ? dstt::sparse::launch_wg<__nv_bfloat16, 64>(a)
                   : dstt::sparse::launch_wg<__nv_bfloat16, 128>(a);
  if (dtype == dstt::kFloat16)
    return D == 64 ? dstt::sparse::launch_wg<__half, 64>(a)
                   : dstt::sparse::launch_wg<__half, 128>(a);
  return cudaErrorInvalidValue;
}

// dtype, D, block -> the dynamic shared memory of the kernel that call
// launches (the FMA kernel's depends on the block, the wgmma kernel's not)
extern "C" int dstt_block_sparse_attention_fwd_smem(int dtype, int D,
                                                    int block) {
  if (dtype == dstt::kFloat32) {
#define DSTT_SPARSE_SMEM(HD)                                                  \
  switch (block) {                                                            \
    case 16: return (int)dstt::sparse_smem_bytes<HD, 16>();                   \
    case 32: return (int)dstt::sparse_smem_bytes<HD, 32>();                   \
    case 64: return (int)dstt::sparse_smem_bytes<HD, 64>();                   \
    default: return (int)dstt::sparse_smem_bytes<HD, 128>();                  \
  }
    if (D == 64) DSTT_SPARSE_SMEM(64);
    DSTT_SPARSE_SMEM(128);
#undef DSTT_SPARSE_SMEM
  }
  return D == 64 ? (int)dstt::sparse::smem_bytes<64>()
                 : (int)dstt::sparse::smem_bytes<128>();
}
