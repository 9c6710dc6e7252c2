// K1 (flash-attention forward) and K3 (chunked prefill) for Hopper.
//
// Replaces two Pallas kernels of the JAX package:
//   K1  deepspeed_tpu/ops/transformer/flash_attention.py  _fwd / _fwd_kernel
//   K3  deepspeed_tpu/ops/transformer/decode_attention.py
//       chunk_prefill_attention / _chunk_prefill_kernel
// Both compute the same thing: rows of q at positions q_off[b] + i attend,
// with an online softmax in fp32, to keys at positions pos < Sk (and, when
// causal, pos <= q_off[b] + i).  K1 reads k/v in the model's [B, S, KVH, D]
// layout (q_off = 0); K3 reads the S-major cache [B, S_max, KVH*D] -- the
// same [B, S, KVH, D] view with other strides -- so one template serves
// both, addressed through the strides the wrapper passes.
//
// What bounds it on an H100: at OPT-1.3B prefill shapes (S = 256, D = 64)
// the work is ~2*S*D flops per score against ~D bytes per key row read, so
// a tensor-core kernel would be memory-bound; this first kernel computes
// the products with fp32 FMAs on the CUDA cores and is bound by them
// instead.  The design keeps every score tile in shared memory and walks
// k tiles only up to the causal limit of its q tile, so no S x S matrix
// reaches device memory.  wgmma / TMA / warp specialisation are later work.
//
// One block per (64-row q tile, head, batch row), 256 threads as 16 x 16:
// thread (ty, tx) owns q rows ty*4 .. ty*4+3; for those rows it computes
// score columns tx + 16*j and output dims tx + 16*j.  A row's 16 owners
// form an aligned half-warp, so row max and row sum are shuffles.
#include "attention_common.cuh"

namespace dstt {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

template <int D>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * (size_t)(kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ q_offsets,
                 int Sq, int H, int KVH, int Sk,
                 long long sqb, long long sqs, long long sqh,
                 long long skb, long long sks, long long skh,
                 long long svb, long long svs, long long svh,
                 long long sob, long long sos, long long soh,
                 int causal, float scale) {
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

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h * KVH / H;   // GQA: the JAX kernel's kv-head map
  const int qoff = q_offsets != nullptr ? q_offsets[b] : 0;
  const int nq = min(kBQ, Sq - q0);
  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + kvh * skh;
  const T* vb = v + b * svb + kvh * svh;

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
      ks[c * DP + d] = ok ? to_f(kb[pos * sks + d]) : 0.f;
      vs[c * DP + d] = ok ? to_f(vb[pos * svs + d]) : 0.f;
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
        s[r][c] = live[c] ? s[r][c] * scale : kNegInf;
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

}  // namespace dstt

// q [B, Sq, H, D], k / v [B, Sk, KVH, D] and o [B, Sq, H, D], each given by
// its (b, s, h) strides in elements with a unit stride on D.  lse: [B, H, Sq]
// fp32 or null.  q_offsets: [B] int32 position of each row's first query
// (K3's chunk starts) or null for 0.  Returns cudaGetLastError().
extern "C" int dstt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* q_offsets, int dtype, int B, int Sq, int H, int KVH, int D,
    int Sk, long long sqb, long long sqs, long long sqh, long long skb,
    long long sks, long long skh, long long svb, long long svs, long long svh,
    long long sob, long long sos, long long soh, int causal, float scale,
    void* stream) {
  if (KVH <= 0 || H % KVH != 0) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return cudaSuccess;
  const dim3 grid((Sq + dstt::kBQ - 1) / dstt::kBQ, H, B);
#define DSTT_FLASH_LAUNCH(T, HD)                                                 \
  {                                                                              \
    const size_t smem = dstt::flash_smem_bytes<HD>();                            \
    cudaFuncSetAttribute(dstt::flash_fwd_kernel<T, HD>,                          \
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);\
    dstt::flash_fwd_kernel<T, HD><<<grid, dstt::kThreads, smem,                  \
                                    (cudaStream_t)stream>>>(                     \
        (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse,               \
        (const int*)q_offsets, Sq, H, KVH, Sk, sqb, sqs, sqh, skb, sks, skh,     \
        svb, svs, svh, sob, sos, soh, causal, scale);                            \
  }
  DSTT_DISPATCH(dtype, D, DSTT_FLASH_LAUNCH);
#undef DSTT_FLASH_LAUNCH
  return (int)cudaGetLastError();
}
