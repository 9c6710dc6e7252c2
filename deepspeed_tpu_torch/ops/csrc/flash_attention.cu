// K1 (flash-attention forward), K3 (chunked prefill) and K7 (chunked
// prefill over a paged KV pool) for Hopper.
//
// Replaces three Pallas kernels of the JAX package:
//   K1  deepspeed_tpu/ops/transformer/flash_attention.py  _fwd / _fwd_kernel
//   K3  deepspeed_tpu/ops/transformer/decode_attention.py
//       chunk_prefill_attention / _chunk_prefill_kernel
//   K7  deepspeed_tpu/ops/transformer/paged_attention.py
//       paged_chunk_prefill_attention (its body runs _chunk_prefill_kernel)
// K3 and K7 also take int8-KV caches (the JAX kernel's quant mode): int8
// payloads with fp32 scales [.., S, KVH] per (position, kv head), read
// through the same row map with KVH elements per position.  A k tile's
// payloads load as int8 (a quarter of fp32's bytes, half of bf16's) and sit
// in shared memory as floats beside the tile's scales; the k-scale
// multiplies each score after `scale`, the v-scale each probability before
// the PV product, and the running sum takes the raw probability, as the
// JAX kernel scales its score and probability tiles.  (The JAX kernel also
// rounds P times the v-scale to the cache's compute dtype before PV; this
// kernel keeps P in fp32, as it does for float caches.)
// All compute the same thing: rows of q at positions q_off[b] + i attend,
// with an online softmax in fp32, to keys at positions pos < Sk (and, when
// causal, pos <= q_off[b] + i).  K1 reads k/v in the model's [B, S, KVH, D]
// layout (q_off = 0); K3 reads the S-major cache [B, S_max, KVH*D] -- the
// same [B, S, KVH, D] view with other strides; K7 reads one layer of the
// page pool [num_pages, page, KVH*D] through the block table pages[B,
// n_virt].  One template serves all three: where key row (b, pos) lies is
// a row map (attention_common.cuh StridedRows / PagedRows), and nothing
// else differs, so K7 over the pool is bitwise equal to K3 over the
// gathered view pool[pages] at any page size (a page need not divide the
// 64-row k tile: each key row is resolved on its own).  The causal limit
// keeps K7 to positions <= starts[b] + C - 1, whose pages the host mapped.
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
  const dstt::StridedRows krows{skb, sks}, vrows{svb, svs};
#define DSTT_FLASH_LAUNCH(T, HD)                                                 \
  dstt::launch_flash<T, T, HD>(q, k, v, nullptr, nullptr, o, lse, q_offsets, B,  \
                               Sq, H, KVH, Sk, sqb, sqs, sqh, krows, skh, vrows, \
                               svh, krows, sob, sos, soh, causal, scale,         \
                               (cudaStream_t)stream);
  DSTT_DISPATCH(dtype, D, DSTT_FLASH_LAUNCH);
#undef DSTT_FLASH_LAUNCH
  return (int)cudaGetLastError();
}

// K3 on an int8-KV cache.  q and o as for dstt_flash_attention_fwd;
// k_cache / v_cache one layer's contiguous int8 [B, S_max, KVH*D],
// k_scale / v_scale its contiguous fp32 [B, S_max, KVH]; starts [B] int32,
// the position of each row's first query (its chunk was written to the
// cache first).  Causal, no LSE.  Returns cudaGetLastError().
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
#define DSTT_CHUNK_INT8_LAUNCH(T, HD)                                            \
  dstt::launch_flash<T, int8_t, HD>(q, k_cache, v_cache, k_scale, v_scale, o,    \
                                    nullptr, starts, B, Sq, H, KVH, S_max, sqb,  \
                                    sqs, sqh, rows, D, rows, D, srows, sob, sos, \
                                    soh, 1, scale, (cudaStream_t)stream);
  DSTT_DISPATCH(dtype, D, DSTT_CHUNK_INT8_LAUNCH);
#undef DSTT_CHUNK_INT8_LAUNCH
  return (int)cudaGetLastError();
}

// K7.  q [B, Sq, H, D] and o [B, Sq, H, D] given by their (b, s, h)
// strides with a unit stride on D; k_pool / v_pool one layer of the page
// pool, contiguous [num_pages, page, KVH*D], in q's dtype -- or int8 with
// k_scale / v_scale that layer's fp32 [num_pages, page, KVH] (both null
// for a float pool); pages [B, n_virt] int32; starts [B] int32, the
// virtual position of each row's first query (its chunk was written to
// the pool first).  Causal, no LSE.  Returns cudaGetLastError().
extern "C" int dstt_paged_chunk_prefill(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, void* o, const void* starts,
    const void* pages, int dtype, int B, int Sq, int H, int KVH, int D,
    int page, int n_virt, long long sqb, long long sqs, long long sqh,
    long long sob, long long sos, long long soh, float scale, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || page <= 0 || n_virt <= 0)
    return cudaErrorInvalidValue;
  if ((k_scale == nullptr) != (v_scale == nullptr)) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return cudaSuccess;
  const dstt::PagedRows rows{(const int*)pages, n_virt, page,
                             (long long)KVH * D};
  const dstt::PagedRows srows{(const int*)pages, n_virt, page, (long long)KVH};
#define DSTT_PAGED_CHUNK_LAUNCH(T, HD)                                           \
  if (k_scale != nullptr)                                                        \
    dstt::launch_flash<T, int8_t, HD>(                                           \
        q, k_pool, v_pool, k_scale, v_scale, o, nullptr, starts, B, Sq, H, KVH,  \
        page * n_virt, sqb, sqs, sqh, rows, D, rows, D, srows, sob, sos, soh, 1, \
        scale, (cudaStream_t)stream);                                            \
  else                                                                           \
    dstt::launch_flash<T, T, HD>(                                                \
        q, k_pool, v_pool, nullptr, nullptr, o, nullptr, starts, B, Sq, H, KVH,  \
        page * n_virt, sqb, sqs, sqh, rows, D, rows, D, srows, sob, sos, soh, 1, \
        scale, (cudaStream_t)stream);
  DSTT_DISPATCH(dtype, D, DSTT_PAGED_CHUNK_LAUNCH);
#undef DSTT_PAGED_CHUNK_LAUNCH
  return (int)cudaGetLastError();
}
