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
// device memory and no atomics are needed: the result is deterministic.
//
// What bounds it on an H100: at OPT-1.3B training shapes (S = 2048, D = 64)
// each causal (q, k) pair costs 3 (K4) or 4 (K5) products of 2*D flops
// against a few bytes per row, so a tensor-core kernel would be bound by
// operations.  These first kernels compute the products with fp32 FMAs on
// the CUDA cores (like K1) and are bound by them and by shared-memory
// reads; every tile is staged once in padded shared memory (no bank
// conflicts on column walks), causal tiles past the diagonal are skipped,
// and no S x S matrix reaches device memory.  wgmma / TMA are later work.
//
// 256 threads as 16 x 16.  Thread (ty, tx) owns 4 rows of its block's own
// tile (q rows in K4, k rows in K5) and the 4 columns tx + 16*c of the
// other side's tile, plus output dims tx + 16*j.  Every ragged edge (S not
// a multiple of 64) is zeroed in shared memory before the products: an
// out-of-range row would otherwise multiply garbage by 0, which can be NaN.
#include "attention_common.cuh"

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

}  // namespace bwd
}  // namespace dstt

// Shared arguments of both entry points: q / dO [B, Sq, H, D], k / v
// [B, Sk, KVH, D], each by its (b, s, h) strides in elements with a unit
// stride on D; lse and delta [B, H, Sq] fp32, contiguous.  Each returns
// cudaGetLastError().

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
  const dim3 grid((Sq + dstt::bwd::kBQ - 1) / dstt::bwd::kBQ, H, B);
#define DSTT_DQ_LAUNCH(T, HD)                                                    \
  {                                                                              \
    const size_t smem = dstt::bwd::dq_smem_bytes<HD>();                          \
    cudaFuncSetAttribute(dstt::bwd::flash_bwd_dq_kernel<T, HD>,                  \
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);\
    dstt::bwd::flash_bwd_dq_kernel<T, HD><<<grid, dstt::bwd::kThreads, smem,     \
                                           (cudaStream_t)stream>>>(              \
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout,                   \
        (const float*)lse, (const float*)delta, (T*)dq, Sq, H, KVH, Sk, sqb,     \
        sqs, sqh, skb, sks, skh, svb, svs, svh, sdb, sds, sdh, sgb, sgs, sgh,    \
        causal, scale);                                                          \
  }
  DSTT_DISPATCH(dtype, D, DSTT_DQ_LAUNCH);
#undef DSTT_DQ_LAUNCH
  return (int)cudaGetLastError();
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
  const dim3 grid((Sk + dstt::bwd::kBK - 1) / dstt::bwd::kBK, H, B);
#define DSTT_DKV_LAUNCH(T, HD)                                                   \
  {                                                                              \
    const size_t smem = dstt::bwd::dkv_smem_bytes<HD>();                         \
    cudaFuncSetAttribute(dstt::bwd::flash_bwd_dkv_kernel<T, HD>,                 \
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);\
    dstt::bwd::flash_bwd_dkv_kernel<T, HD><<<grid, dstt::bwd::kThreads, smem,    \
                                            (cudaStream_t)stream>>>(             \
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout,                   \
        (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, Sq, H, KVH, Sk,  \
        sqb, sqs, sqh, skb, sks, skh, svb, svs, svh, sdb, sds, sdh, sgb, sgs,    \
        sgh, causal, scale);                                                     \
  }
  DSTT_DISPATCH(dtype, D, DSTT_DKV_LAUNCH);
#undef DSTT_DKV_LAUNCH
  return (int)cudaGetLastError();
}
