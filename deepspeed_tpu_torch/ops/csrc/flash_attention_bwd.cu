// K4 (flash-attention backward, dQ) and K5 (backward, dK / dV) for Hopper.
//
// Replace the two Pallas backward kernels of the JAX package:
//   K4  deepspeed_tpu/ops/transformer/flash_attention.py  _bwd / _bwd_dq_kernel
//   K5  deepspeed_tpu/ops/transformer/flash_attention.py  _bwd / _bwd_dkv_kernel
// Given the forward's inputs, its per-row LSE (K1 writes it) and
// delta = rowsum(dO * O) (computed by the wrapper in fp32, as JAX computes
// it outside its kernels), both recompute the probabilities tile by tile,
//   P  = exp(scale * q.k - lse)            (0 where masked)
//   dS = P * (dO.v - delta) * scale
// and accumulate in fp32 registers:
//   K4: dQ = sum_k dS . k                   one block per (q tile, head, row)
//   K5: dV = sum_q P^T . dO, dK = sum_q dS^T . q
//                                           one block per (k tile, query head, row)
// K5 writes dK / dV per QUERY head ([B, Sk, H, D]); the wrapper sums each
// GQA group outside the kernel, deterministically, as JAX does.  `scale` is
// the in-kernel scale: 1 when the wrapper folded a power-of-two scale into
// q (then dq's scale comes from autograd through that multiply).
//
// On the TPU the nk / nq grid axis runs in order and carries the
// accumulator in VMEM scratch; here that axis is a loop inside the block
// and the accumulator lives in registers, so no partial sum ever reaches
// device memory and no atomics are needed: every output tile is written by
// exactly one block, and two launches give the same bits.
//
// What bounds it on an H100: at OPT-1.3B training shapes (S = 2048, D = 64)
// each causal (q, k) pair costs 3 (K4) or 4 (K5) products of 2*D flops
// against a few bytes per row, so the kernels are bound by tensor-core
// operations.  Two designs, by input type:
//
// * bf16 / fp16 (the training path): `wgmma_flash_bwd_dq_kernel` and
//   `wgmma_flash_bwd_dkv_kernel`, one warpgroup (128 threads) per 64-row
//   tile.  Every product runs on the tensor cores (wgmma m64n64k16, fp32
//   accumulators, hopper_common.cuh).  S (S^T in K5) and dP (dP^T) read
//   both operands K-major from shared memory.  The second products (dS.k,
//   P^T.dO, dS^T.q) take P / dS straight from the accumulator registers
//   as wgmma's register A operand, rounded to the input type — which is
//   what JAX does (`ds.astype(k.dtype)`, `p.astype(do.dtype)`), so the
//   numerics are the reference's — and read the other side's [64, D]
//   tile as an N-contiguous B through wgmma's transpose bit.  Tiles arrive
//   by TMA (one thread issues each 64 x 64 box of the strided
//   [B, S, H, D] tensors, 128-byte swizzled to match the wgmma
//   descriptors) into a 2-stage ring with one mbarrier per stage: the
//   k / v tiles of K4 and the q / dO tiles of K5 (with their lse / delta,
//   prefetched through registers) load one tile ahead of the products.
//   TMA fills rows past S with zeros, so every product sees zeros, never
//   garbage; the lse / delta of those rows are not loaded, so P is masked
//   to 0 there explicitly (an unmasked exp(0 - 0) is 1).  Causal tiles
//   past the diagonal are never loaded and only tiles that straddle the
//   diagonal or a ragged edge are masked.  The heaviest tiles launch
//   first (K5: low k tiles, K4: high q tiles).
//   What bounds them: a warpgroup runs its exp / mask phase between its
//   products, and one block's 64-row tile gives the tensor cores short
//   bursts (m64n64 products, a wait after each group).  The design hides
//   the elementwise phase three ways: exp is one ex2 of a fused
//   multiply-add (scale and lse times log2(e)); several blocks share an SM
//   (K4 4 at D = 64 by its launch bounds, K5 3, both 2 at D = 128), whose
//   products run while another block's elementwise phase does; and in K4,
//   S and dP are two wgmma groups, so P's exp runs while dP is computed
//   (in K5 that split measured slower on the card: its register budget is
//   tighter).  No producer warp and no ping-pong between warpgroups yet.
// * fp32: `flash_bwd_dq_kernel` and `flash_bwd_dkv_kernel`, fp32 FMAs on
//   the CUDA cores (wgmma's fp32 path is TF32 and would miss the fp32 bar
//   of 1e-4), bound by FMA issue and shared-memory reads; every tile is
//   staged once in padded shared memory (no bank conflicts on column
//   walks).  256 threads as 16 x 16: thread (ty, tx) owns 4 rows of its
//   block's own tile (q rows in K4, k rows in K5) and the 4 columns
//   tx + 16*c of the other side's tile, plus output dims tx + 16*j.  Every
//   ragged edge (S not a multiple of 64) is zeroed in shared memory before
//   the products: an out-of-range row would otherwise multiply garbage by
//   0, which can be NaN.
#include <type_traits>

#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace dstt {
namespace bwd {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int RPT = 4;   // own rows per thread
constexpr int CPT = 4;   // other-side columns per thread

template <int D>
constexpr size_t dq_smem_bytes() {
  // q, dO, k, v tiles (padded rows) + the dS tile
  return sizeof(float) * (size_t)(4 * 64 * (D + 1) + 64 * (64 + 1));
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // k, v, q, dO tiles + the P and dS tiles + lse / delta rows
  return sizeof(float) * (size_t)(4 * 64 * (D + 1) + 2 * 64 * (64 + 1) + 2 * 64);
}

// Stage rows [r0, r0 + 64) of a [S, D] slice (row stride `rs`) into a
// padded shared tile, zeroing rows at or past `n`.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long rs,
                                          int r0, int n) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < 64 * D; i += kThreads) {
    const int r = i / D, d = i % D;
    dst[r * DP + d] = r0 + r < n ? to_f(src[(long long)(r0 + r) * rs + d]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int Sq, int H, int KVH, int Sk,
                    long long sqb, long long sqs, long long sqh,
                    long long skb, long long sks, long long skh,
                    long long svb, long long svs, long long svh,
                    long long sdb, long long sds, long long sdh,
                    long long sgb, long long sgs, long long sgh,
                    int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kBK + 1;
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;              // [kBQ, DP]
  float* os = qs + kBQ * DP;     // [kBQ, DP] dO
  float* ks = os + kBQ * DP;     // [kBK, DP]
  float* vs = ks + kBK * DP;     // [kBK, DP]
  float* dss = vs + kBK * DP;    // [kBQ, PP] dS of this k tile

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h * KVH / H;
  const int nq = min(kBQ, Sq - q0);
  const T* kb = k + b * skb + kvh * skh;
  const T* vb = v + b * svb + kvh * svh;
  load_tile<T, D>(qs, q + b * sqb + h * sqh, sqs, q0, Sq);
  load_tile<T, D>(os, dout + b * sdb + h * sdh, sds, q0, Sq);

  float lr[RPT], dr[RPT];        // lse and delta of own rows (0 past Sq)
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int qi = ty * RPT + r;
    const long long row = ((long long)b * H + h) * Sq + q0 + qi;
    lr[r] = qi < nq ? lse[row] : 0.f;
    dr[r] = qi < nq ? delta[row] : 0.f;
  }
  // causal: the furthest key any row of this tile sees is q0 + nq - 1
  const int kv_end = causal ? min(Sk, q0 + nq) : Sk;

  float acc[RPT][DPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's ks / vs / dss are consumed
    load_tile<T, D>(ks, kb, sks, k0, Sk);
    load_tile<T, D>(vs, vb, svs, k0, Sk);
    __syncthreads();

    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], ov[RPT], kv[CPT], vv[CPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        qv[r] = qs[(ty * RPT + r) * DP + d];
        ov[r] = os[(ty * RPT + r) * DP + d];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        kv[c] = ks[(tx + 16 * c) * DP + d];
        vv[c] = vs[(tx + 16 * c) * DP + d];
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
          dp[r][c] = fmaf(ov[r], vv[c], dp[r][c]);
        }
    }

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int qi = ty * RPT + r;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int pos = k0 + tx + 16 * c;
        const bool live = qi < nq && pos < Sk && (!causal || pos <= q0 + qi);
        const float p = live ? expf(s[r][c] * scale - lr[r]) : 0.f;
        dss[qi * PP + tx + 16 * c] = p * (dp[r][c] - dr[r]) * scale;
      }
    }
    __syncthreads();

    const int nc = min(kBK, kv_end - k0);
    for (int c = 0; c < nc; ++c) {
      float kk[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) kk[j] = ks[c * DP + tx + 16 * j];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float ds = dss[(ty * RPT + r) * PP + c];
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[r][j] = fmaf(ds, kk[j], acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int qi = ty * RPT + r;
    if (qi >= nq) continue;
    T* gb = dq + b * sgb + (long long)(q0 + qi) * sgs + h * sgh;
#pragma unroll
    for (int j = 0; j < DPT; ++j) gb[tx + 16 * j] = from_f<T>(acc[r][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv,
                     int Sq, int H, int KVH, int Sk,
                     long long sqb, long long sqs, long long sqh,
                     long long skb, long long sks, long long skh,
                     long long svb, long long svs, long long svh,
                     long long sdb, long long sds, long long sdh,
                     long long sgb, long long sgs, long long sgh,
                     int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int QP = kBQ + 1;
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;              // [kBK, DP]
  float* vs = ks + kBK * DP;     // [kBK, DP]
  float* qs = vs + kBK * DP;     // [kBQ, DP]
  float* os = qs + kBQ * DP;     // [kBQ, DP] dO
  float* pt = os + kBQ * DP;     // [kBK, QP] P^T of this q tile
  float* dst = pt + kBK * QP;    // [kBK, QP] dS^T of this q tile
  float* ls = dst + kBK * QP;    // [kBQ] lse
  float* dl = ls + kBQ;          // [kBQ] delta

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * kBK, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h * KVH / H;
  const int nk = min(kBK, Sk - k0);
  const T* qb = q + b * sqb + h * sqh;
  const T* ob = dout + b * sdb + h * sdh;
  const float* lb = lse + ((long long)b * H + h) * Sq;
  const float* db = delta + ((long long)b * H + h) * Sq;
  load_tile<T, D>(ks, k + b * skb + kvh * skh, sks, k0, Sk);
  load_tile<T, D>(vs, v + b * svb + kvh * svh, svs, k0, Sk);

  float ak[RPT][DPT], av[RPT][DPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int j = 0; j < DPT; ++j) ak[r][j] = av[r][j] = 0.f;

  // causal: start at the first q tile whose LAST row reaches this k tile's
  // FIRST key (rows before k0 see none of its keys)
  const int q_begin = causal ? (k0 / kBQ) * kBQ : 0;
  for (int q0 = q_begin; q0 < Sq; q0 += kBQ) {
    const int nq = min(kBQ, Sq - q0);
    __syncthreads();  // the previous q tile's qs / os / pt / dst are consumed
    load_tile<T, D>(qs, qb, sqs, q0, Sq);
    load_tile<T, D>(os, ob, sds, q0, Sq);
    for (int i = tid; i < kBQ; i += kThreads) {
      ls[i] = i < nq ? lb[q0 + i] : 0.f;
      dl[i] = i < nq ? db[q0 + i] : 0.f;
    }
    __syncthreads();

    // s[r][c] = k_r . q_c and dp[r][c] = v_r . dO_c for own k rows r and
    // q columns c = tx + 16 * c
    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[RPT], vv[RPT], qv[CPT], ov[CPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        kv[r] = ks[(ty * RPT + r) * DP + d];
        vv[r] = vs[(ty * RPT + r) * DP + d];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        qv[c] = qs[(tx + 16 * c) * DP + d];
        ov[c] = os[(tx + 16 * c) * DP + d];
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          s[r][c] = fmaf(kv[r], qv[c], s[r][c]);
          dp[r][c] = fmaf(vv[r], ov[c], dp[r][c]);
        }
    }

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int kr = ty * RPT + r;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int qc = tx + 16 * c;
        const bool live = kr < nk && qc < nq && (!causal || k0 + kr <= q0 + qc);
        const float p = live ? expf(s[r][c] * scale - ls[qc]) : 0.f;
        pt[kr * QP + qc] = p;
        dst[kr * QP + qc] = p * (dp[r][c] - dl[qc]) * scale;
      }
    }
    __syncthreads();

    for (int c = 0; c < nq; ++c) {
      float oo[DPT], qq[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        oo[j] = os[c * DP + tx + 16 * j];
        qq[j] = qs[c * DP + tx + 16 * j];
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float p = pt[(ty * RPT + r) * QP + c];
        const float ds = dst[(ty * RPT + r) * QP + c];
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          av[r][j] = fmaf(p, oo[j], av[r][j]);
          ak[r][j] = fmaf(ds, qq[j], ak[r][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int kr = ty * RPT + r;
    if (kr >= nk) continue;
    const long long off = b * sgb + (long long)(k0 + kr) * sgs + h * sgh;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      dk[off + tx + 16 * j] = from_f<T>(ak[r][j]);
      dv[off + tx + 16 * j] = from_f<T>(av[r][j]);
    }
  }
}


// ------------------------------------------------- bf16 / fp16: wgmma + TMA
namespace hk = dstt::hopper;

constexpr int kWgThreads = 128;   // one warpgroup

using hk::align_smem;
using hk::row_tile_bytes;
using hk::tma_row_tile;
// P = exp(x) is computed as exp2(x * log2(e)) — one fused multiply-add
// and one ex2 per element; expf's accurate range reduction costs several
// more.  The result differs from expf by a few fp32 ulps, far below the
// 16-bit rounding of P that follows.
using hk::kLog2e;

// both kernels: their own two [64, D] tiles, 2 stages of the other side's
// two, fp32 lse / delta for 2 stages (K5), 3 mbarriers; + alignment slack
template <int D>
constexpr size_t wg_smem_bytes() {
  return hk::kSwizzleAlign + 6 * row_tile_bytes<D>() + 4 * 64 * sizeof(float) +
         64;
}


// K4: one block per (64-row q tile, head, batch row), heaviest (last) q
// tiles first; loops over the k tiles up to the causal limit.
template <typename T, int D>
__global__ void __launch_bounds__(kWgThreads, D == 64 ? 4 : 2)
wgmma_flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dq,
                          int Sq, int H, int KVH, int Sk, long long sgb,
                          long long sgs, long long sgh, int causal,
                          float scale) {
  constexpr int KT = D / 64;
  constexpr int TB = row_tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align_smem(smem_raw);
  uint8_t* os = qs + TB;               // dO
  uint8_t* ks = os + TB;               // 2 stages
  uint8_t* vs = ks + 2 * TB;           // 2 stages
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + 2 * TB);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * 64;
  const int kvh = h * KVH / H;
  const int nq = min(64, Sq - q0);
  const int kv_end = causal ? min(Sk, q0 + nq) : Sk;
  const int n_kt = (kv_end + 63) / 64;

  if (tid == 0) {
    hk::prefetch_tensor_map(&k_map);
    hk::prefetch_tensor_map(&v_map);
#pragma unroll
    for (int i = 0; i < 3; ++i) hk::mbar_init(&bars[i], 1);
    hk::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hk::mbar_arrive_expect_tx(&bars[0], 2 * TB);
    tma_row_tile<D>(qs, &q_map, &bars[0], h, q0, b);
    tma_row_tile<D>(os, &do_map, &bars[0], h, q0, b);
    hk::mbar_arrive_expect_tx(&bars[1], 2 * TB);
    tma_row_tile<D>(ks, &k_map, &bars[1], kvh, 0, b);
    tma_row_tile<D>(vs, &v_map, &bars[1], kvh, 0, b);
  }

  // this thread's two q rows of every accumulator, their lse and delta
  // (0 past Sq: those rows are masked and never written)
  const int r0 = warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const float scale2 = scale * kLog2e;
  float lr[2], dr[2];                  // lse * log2(e), delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + 8 * i;
    const long long row = ((long long)b * H + h) * Sq + q0 + qi;
    lr[i] = qi < nq ? lse[row] * kLog2e : 0.f;
    dr[i] = qi < nq ? delta[row] : 0.f;
  }

  float acc[KT][32];
#pragma unroll
  for (int t = 0; t < KT; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[t][i] = 0.f;

  hk::mbar_wait(&bars[0], 0);
  for (int it = 0; it < n_kt; ++it) {
    const int st = it & 1;
    const int k0 = it * 64;
    // the other stage held tile it - 1, consumed (wgmma waited, block
    // synced) at the end of the last iteration: load tile it + 1 into it
    if (tid == 0 && it + 1 < n_kt) {
      uint64_t* bar = &bars[1 + (st ^ 1)];
      hk::mbar_arrive_expect_tx(bar, 2 * TB);
      tma_row_tile<D>(ks + (st ^ 1) * TB, &k_map, bar, kvh, k0 + 64, b);
      tma_row_tile<D>(vs + (st ^ 1) * TB, &v_map, bar, kvh, k0 + 64, b);
    }
    hk::mbar_wait(&bars[1 + st], (it >> 1) & 1);
    const uint32_t kt = hk::smem_u32(ks + st * TB);

    // S and dP as two wgmma groups: P's exp runs while dP is computed
    float s[32], dp[32];
    hk::wgmma_fence();
    hk::wgmma_abt<T, KT>(s, hk::smem_u32(qs), kt);               // S = q.k^T
    hk::wgmma_commit();
    hk::wgmma_abt<T, KT>(dp, hk::smem_u32(os),
                         hk::smem_u32(vs + st * TB));            // dP = dO.v^T
    hk::wgmma_commit();
    hk::wgmma_wait<1>();
    hk::fence_acc(s);

    // P in place of S (0 where masked)
    const bool masked = k0 + 64 > Sk || nq < 64 || (causal && k0 + 63 > q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = r0 + 8 * ((i >> 1) & 1);
      const int c = 8 * (i >> 2) + c0 + (i & 1);
      float p = exp2f(fmaf(s[i], scale2, -lr[(i >> 1) & 1]));
      if (masked) {
        const bool live = r < nq && k0 + c < Sk && (!causal || k0 + c <= q0 + r);
        p = live ? p : 0.f;
      }
      s[i] = p;
    }
    hk::wgmma_wait<0>();
    hk::fence_acc(dp);
    // dS = P * (dP - delta) * scale, in place of dP
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dp[i] = s[i] * (dp[i] - dr[(i >> 1) & 1]) * scale;
    uint32_t ds[16];                   // dS rounded to T, as JAX rounds it
    hk::acc_to_a<T>(dp, ds);

    hk::wgmma_fence();
#pragma unroll
    for (int t = 0; t < KT; ++t)                                  // dQ += dS.k
      hk::wgmma_rs_ab<T>(acc[t], ds, kt + t * hk::kTileBytes);
    hk::wgmma_commit();
    hk::wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < KT; ++t) hk::fence_acc(acc[t]);
    __syncthreads();   // every warp is done with stage st
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + 8 * hf;
    if (r >= nq) continue;
    T* gb = dq + b * sgb + (long long)(q0 + r) * sgs + h * sgh;
#pragma unroll
    for (int t = 0; t < KT; ++t)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(gb + 64 * t + 8 * j + c0) = hk::pack2<T>(
            acc[t][4 * j + 2 * hf], acc[t][4 * j + 2 * hf + 1]);
  }
}

// K5: one block per (64-row k tile, query head, batch row), low k tiles
// (the most q tiles) first; loops over the q tiles from the causal start.
template <typename T, int D>
__global__ void __launch_bounds__(kWgThreads, 1)
wgmma_flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dk, T* __restrict__ dv, int Sq,
                           int H, int KVH, int Sk, long long sgb,
                           long long sgs, long long sgh, int causal,
                           float scale) {
  constexpr int KT = D / 64;
  constexpr int TB = row_tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align_smem(smem_raw);
  uint8_t* vs = ks + TB;
  uint8_t* qs = vs + TB;               // 2 stages
  uint8_t* os = qs + 2 * TB;           // 2 stages of dO
  float* ls = reinterpret_cast<float*>(os + 2 * TB);   // [2][64] lse
  float* dl = ls + 2 * 64;                              // [2][64] delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(dl + 2 * 64);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * 64;
  const int kvh = h * KVH / H;
  const int nk = min(64, Sk - k0);
  // causal: start at the first q tile whose last row reaches this k
  // tile's first key (rows before k0 see none of its keys)
  const int qt_begin = causal ? k0 / 64 : 0;
  const int n_it = max((Sq + 63) / 64 - qt_begin, 0);
  const float* lb = lse + ((long long)b * H + h) * Sq;
  const float* db = delta + ((long long)b * H + h) * Sq;

  if (tid == 0) {
    hk::prefetch_tensor_map(&q_map);
    hk::prefetch_tensor_map(&do_map);
#pragma unroll
    for (int i = 0; i < 3; ++i) hk::mbar_init(&bars[i], 1);
    hk::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hk::mbar_arrive_expect_tx(&bars[0], 2 * TB);
    tma_row_tile<D>(ks, &k_map, &bars[0], kvh, k0, b);
    tma_row_tile<D>(vs, &v_map, &bars[0], kvh, k0, b);
    if (n_it > 0) {
      hk::mbar_arrive_expect_tx(&bars[1], 2 * TB);
      tma_row_tile<D>(qs, &q_map, &bars[1], h, qt_begin * 64, b);
      tma_row_tile<D>(os, &do_map, &bars[1], h, qt_begin * 64, b);
    }
  }
  const float scale2 = scale * kLog2e;
  if (tid < 64) {                      // stage 0's lse / delta (0 past Sq)
    const int qi = qt_begin * 64 + tid;
    ls[tid] = qi < Sq ? lb[qi] : 0.f;
    dl[tid] = qi < Sq ? db[qi] : 0.f;
  }

  const int r0 = warp * 16 + (lane >> 2);   // this thread's k rows r0, r0 + 8
  const int c0 = 2 * (lane & 3);
  float ak[KT][32], av[KT][32];
#pragma unroll
  for (int t = 0; t < KT; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) ak[t][i] = av[t][i] = 0.f;

  hk::mbar_wait(&bars[0], 0);
  __syncthreads();                     // stage 0's lse / delta are stored
  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    const int q0 = (qt_begin + it) * 64;
    const int nq = min(64, Sq - q0);
    // prefetch tile it + 1 into the other stage (tile it - 1's, consumed)
    float nl = 0.f, nd = 0.f;
    if (it + 1 < n_it) {
      if (tid == 0) {
        uint64_t* bar = &bars[1 + (st ^ 1)];
        hk::mbar_arrive_expect_tx(bar, 2 * TB);
        tma_row_tile<D>(qs + (st ^ 1) * TB, &q_map, bar, h, q0 + 64, b);
        tma_row_tile<D>(os + (st ^ 1) * TB, &do_map, bar, h, q0 + 64, b);
      }
      if (tid < 64 && q0 + 64 + tid < Sq) {
        nl = lb[q0 + 64 + tid];
        nd = db[q0 + 64 + tid];
      }
    }
    hk::mbar_wait(&bars[1 + st], (it >> 1) & 1);
    const uint32_t qt = hk::smem_u32(qs + st * TB);
    const uint32_t ot = hk::smem_u32(os + st * TB);

    float s[32], dp[32];
    hk::wgmma_fence();
    hk::wgmma_abt<T, KT>(s, hk::smem_u32(ks), qt);     // S^T  = k . q^T
    hk::wgmma_abt<T, KT>(dp, hk::smem_u32(vs), ot);    // dP^T = v . dO^T
    hk::wgmma_commit();
    hk::wgmma_wait<0>();
    hk::fence_acc(s);
    hk::fence_acc(dp);

    // P^T in place of S^T (0 where masked), dS^T in place of dP^T
    const float* lst = ls + st * 64;
    const float* dlt = dl + st * 64;
    const bool masked = nq < 64 || k0 + 64 > Sk || (causal && k0 + 63 > q0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + c0;         // q columns c, c + 1
      const float2 lq = *reinterpret_cast<const float2*>(lst + c);
      const float2 dq2 = *reinterpret_cast<const float2*>(dlt + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const int r = r0 + 8 * (e >> 1);
        float p = exp2f(fmaf(s[i], scale2, -((e & 1) ? lq.y : lq.x) * kLog2e));
        if (masked) {
          const int q = c + (e & 1);
          const bool live = r < nk && q < nq && (!causal || k0 + r <= q0 + q);
          p = live ? p : 0.f;
        }
        s[i] = p;
        dp[i] = p * (dp[i] - ((e & 1) ? dq2.y : dq2.x)) * scale;
      }
    }
    // P^T and dS^T rounded to T, as JAX rounds P and dS
    uint32_t pa[16], da[16];
    hk::acc_to_a<T>(s, pa);
    hk::acc_to_a<T>(dp, da);
    hk::wgmma_fence();
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      hk::wgmma_rs_ab<T>(av[t], pa, ot + t * hk::kTileBytes);   // dV += P^T.dO
      hk::wgmma_rs_ab<T>(ak[t], da, qt + t * hk::kTileBytes);   // dK += dS^T.q
    }
    hk::wgmma_commit();
    hk::wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      hk::fence_acc(av[t]);
      hk::fence_acc(ak[t]);
    }
    if (tid < 64) {                    // tile it + 1's lse / delta
      ls[(st ^ 1) * 64 + tid] = nl;
      dl[(st ^ 1) * 64 + tid] = nd;
    }
    __syncthreads();   // stage st is consumed; the next lse / delta stored
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + 8 * hf;
    if (r >= nk) continue;
    const long long off = b * sgb + (long long)(k0 + r) * sgs + h * sgh;
#pragma unroll
    for (int t = 0; t < KT; ++t)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * t + 8 * j + c0;
        *reinterpret_cast<uint32_t*>(dk + off + d) = hk::pack2<T>(
            ak[t][4 * j + 2 * hf], ak[t][4 * j + 2 * hf + 1]);
        *reinterpret_cast<uint32_t*>(dv + off + d) = hk::pack2<T>(
            av[t][4 * j + 2 * hf], av[t][4 * j + 2 * hf + 1]);
      }
  }
}

// ------------------------------------------------------------ launchers
// The arguments of both entry points: q / dO [B, Sq, H, D], k / v
// [B, Sk, KVH, D], each by its (b, s, h) strides in elements with a unit
// stride on D; lse and delta [B, H, Sq] fp32, contiguous; the outputs by
// their strides sg.
struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, Sq, H, KVH, D, Sk;
  long long sq[3], sk[3], sv[3], sd[3], sg[3];
  int causal;
  float scale;
  cudaStream_t stream;
};

// the TMA maps of q, k, v and dO; false when one cannot be encoded (an
// address or a stride TMA cannot take: the wrapper checks them first)
template <typename T>
bool make_maps(const BwdArgs& a, CUtensorMap (&m)[4]) {
  const bool f16 = std::is_same<T, __half>::value;
  return hk::make_bshd_map(&m[0], a.q, f16, a.B, a.Sq, a.H, a.D, a.sq[0],
                           a.sq[1], a.sq[2]) &&
         hk::make_bshd_map(&m[1], a.k, f16, a.B, a.Sk, a.KVH, a.D, a.sk[0],
                           a.sk[1], a.sk[2]) &&
         hk::make_bshd_map(&m[2], a.v, f16, a.B, a.Sk, a.KVH, a.D, a.sv[0],
                           a.sv[1], a.sv[2]) &&
         hk::make_bshd_map(&m[3], a.dout, f16, a.B, a.Sq, a.H, a.D, a.sd[0],
                           a.sd[1], a.sd[2]);
}

template <typename T, int D>
int launch_dq(const BwdArgs& a, void* dq) {
  const int nqt = (a.Sq + kBQ - 1) / kBQ;
  if constexpr (std::is_same<T, float>::value) {
    const size_t smem = dq_smem_bytes<D>();
    cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    flash_bwd_dq_kernel<T, D><<<dim3(nqt, a.H, a.B), kThreads, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
        a.delta, (T*)dq, a.Sq, a.H, a.KVH, a.Sk, a.sq[0], a.sq[1], a.sq[2],
        a.sk[0], a.sk[1], a.sk[2], a.sv[0], a.sv[1], a.sv[2], a.sd[0], a.sd[1],
        a.sd[2], a.sg[0], a.sg[1], a.sg[2], a.causal, a.scale);
  } else {
    CUtensorMap m[4];
    if (a.Sk == 0 || !make_maps<T>(a, m)) return cudaErrorInvalidValue;
    const size_t smem = wg_smem_bytes<D>();
    cudaFuncSetAttribute(wgmma_flash_bwd_dq_kernel<T, D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    wgmma_flash_bwd_dq_kernel<T, D>
        <<<dim3(a.H, a.B, nqt), kWgThreads, smem, a.stream>>>(
            m[0], m[1], m[2], m[3], a.lse, a.delta, (T*)dq, a.Sq, a.H, a.KVH,
            a.Sk, a.sg[0], a.sg[1], a.sg[2], a.causal, a.scale);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const BwdArgs& a, void* dk, void* dv) {
  const int nkt = (a.Sk + kBK - 1) / kBK;
  if constexpr (std::is_same<T, float>::value) {
    const size_t smem = dkv_smem_bytes<D>();
    cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    flash_bwd_dkv_kernel<T, D><<<dim3(nkt, a.H, a.B), kThreads, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
        a.delta, (T*)dk, (T*)dv, a.Sq, a.H, a.KVH, a.Sk, a.sq[0], a.sq[1],
        a.sq[2], a.sk[0], a.sk[1], a.sk[2], a.sv[0], a.sv[1], a.sv[2], a.sd[0],
        a.sd[1], a.sd[2], a.sg[0], a.sg[1], a.sg[2], a.causal, a.scale);
  } else {
    CUtensorMap m[4];
    if (!make_maps<T>(a, m)) return cudaErrorInvalidValue;
    const size_t smem = wg_smem_bytes<D>();
    cudaFuncSetAttribute(wgmma_flash_bwd_dkv_kernel<T, D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    wgmma_flash_bwd_dkv_kernel<T, D>
        <<<dim3(a.H, a.B, nkt), kWgThreads, smem, a.stream>>>(
            m[0], m[1], m[2], m[3], a.lse, a.delta, (T*)dk, (T*)dv, a.Sq, a.H,
            a.KVH, a.Sk, a.sg[0], a.sg[1], a.sg[2], a.causal, a.scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace bwd
}  // namespace dstt

// Both entry points take the arguments of `BwdArgs` in its order (the
// strides of q, k, v, dO and the outputs as 15 (b, s, h) triples), route
// fp32 to the FMA kernels and bf16 / fp16 to the wgmma kernels, and return
// cudaGetLastError() (cudaErrorInvalidValue for what no kernel takes: a
// head dim other than 64 / 128, a TMA map that cannot be encoded, no keys).

// dq [B, Sq, H, D] by its (b, s, h) strides.
extern "C" int dstt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int dtype, int B, int Sq,
    int H, int KVH, int D, int Sk, long long sqb, long long sqs, long long sqh,
    long long skb, long long sks, long long skh, long long svb, long long svs,
    long long svh, long long sdb, long long sds, long long sdh, long long sgb,
    long long sgs, long long sgh, int causal, float scale, void* stream) {
  if (KVH <= 0 || H % KVH != 0) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return cudaSuccess;
  const dstt::bwd::BwdArgs a{q, k, v, dout, (const float*)lse,
                             (const float*)delta, B, Sq, H, KVH, D, Sk,
                             {sqb, sqs, sqh}, {skb, sks, skh}, {svb, svs, svh},
                             {sdb, sds, sdh}, {sgb, sgs, sgh}, causal, scale,
                             (cudaStream_t)stream};
#define DSTT_DQ_LAUNCH(T, HD) return dstt::bwd::launch_dq<T, HD>(a, dq);
  DSTT_DISPATCH(dtype, D, DSTT_DQ_LAUNCH);
#undef DSTT_DQ_LAUNCH
  return cudaErrorInvalidValue;
}

// dk / dv [B, Sk, H, D] per query head, both by the (b, s, h) strides sg*.
extern "C" int dstt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int dtype, int B,
    int Sq, int H, int KVH, int D, int Sk, long long sqb, long long sqs,
    long long sqh, long long skb, long long sks, long long skh, long long svb,
    long long svs, long long svh, long long sdb, long long sds, long long sdh,
    long long sgb, long long sgs, long long sgh, int causal, float scale,
    void* stream) {
  if (KVH <= 0 || H % KVH != 0) return cudaErrorInvalidValue;
  if (B == 0 || Sk == 0 || H == 0) return cudaSuccess;
  const dstt::bwd::BwdArgs a{q, k, v, dout, (const float*)lse,
                             (const float*)delta, B, Sq, H, KVH, D, Sk,
                             {sqb, sqs, sqh}, {skb, sks, skh}, {svb, svs, svh},
                             {sdb, sds, sdh}, {sgb, sgs, sgh}, causal, scale,
                             (cudaStream_t)stream};
#define DSTT_DKV_LAUNCH(T, HD) return dstt::bwd::launch_dkv<T, HD>(a, dk, dv);
  DSTT_DISPATCH(dtype, D, DSTT_DKV_LAUNCH);
#undef DSTT_DKV_LAUNCH
  return cudaErrorInvalidValue;
}

// Dynamic shared memory per block of the kernel that a call with this
// dtype and head dim launches (kernel 0: dq, 1: dk / dv); -1 when none.
extern "C" int dstt_flash_attention_bwd_smem(int kernel, int dtype, int D) {
  if (D != 64 && D != 128) return -1;
  const bool f32 = dtype == dstt::kFloat32;
  if (kernel == 0)
    return (int)(f32 ? (D == 64 ? dstt::bwd::dq_smem_bytes<64>()
                                : dstt::bwd::dq_smem_bytes<128>())
                     : (D == 64 ? dstt::bwd::wg_smem_bytes<64>()
                                : dstt::bwd::wg_smem_bytes<128>()));
  return (int)(f32 ? (D == 64 ? dstt::bwd::dkv_smem_bytes<64>()
                              : dstt::bwd::dkv_smem_bytes<128>())
                   : (D == 64 ? dstt::bwd::wg_smem_bytes<64>()
                              : dstt::bwd::wg_smem_bytes<128>()));
}
