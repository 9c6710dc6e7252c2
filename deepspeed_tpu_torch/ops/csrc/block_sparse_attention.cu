// K8: block-sparse attention forward for Hopper.
//
// Replaces the Pallas kernel of the JAX package
//   deepspeed_tpu/ops/sparse_attention/block_sparse.py
//   _sparse_fwd_pallas / _sparse_fwd_kernel
// which walks a (B*H, nq, A) grid whose kv index comes from the
// scalar-prefetched table idx[h, iq, a] for a < counts[h, iq], with an
// online softmax in fp32, a causal kvpos <= qpos mask inside each block
// when causal, and o = acc / l, or 0 where l == 0.
//
// Here one thread block owns one q tile of TL = min(block, 64) rows of one
// (batch row, head) and walks its block-row's active kv blocks itself in a
// loop (a < counts[h, iq]; padded table slots are never read), each block
// in k tiles of TL rows.  q, k and v are read in the model's [B, S, H, D]
// layout through strides (no transpose); O is written in the input dtype.
// The scores are (q.k + bias[b, key]) * scale in fp32: the scale is
// applied in the kernel, as the Pallas kernel does, and the optional fp32
// bias [B, S] is the key-padding fold (the JAX wrapper appends a
// 0 / -1e4 feature to k, so it enters the dot before the scale).  Masked
// scores are -1e30; a row that no live key reaches keeps l == 0 and is
// written as 0.  Under the causal mask a k tile whose first key lies past
// the q tile's last row is skipped: every score in it is masked.
//
// What bounds it on an H100: at the main path's shape (q/k/v [1, 8192,
// 32, 64], block 64, <= 6 active blocks per row) the work is ~4 * 64
// flops per (query, active key) pair against 64 bf16 elements read per
// key row, ~34 flops per byte, so a tensor-core kernel would be
// memory-bound; this first kernel computes the products with fp32 FMAs on
// the CUDA cores (K1's tile body, kBQ = kBK = 64 at block 64) and is
// bound by them instead.  Every score tile stays in shared memory; no
// [bq, A*bk] slab reaches device memory.  wgmma / TMA are later work.
//
// 256 threads as 16 x 16: thread (ty, tx) owns q rows ty*RPT .. +RPT-1;
// for those rows it computes score columns tx + 16*j and output dims
// tx + 16*j.  A row's 16 owners form an aligned half-warp, so row max and
// row sum are shuffles.
#include "attention_common.cuh"

namespace dstt {

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

  for (int a = 0; a < cnt; ++a) {
    const int kblk = __ldg(row_idx + a);
    for (int sub = 0; sub < BLK; sub += TL) {
      const int k0 = kblk * BLK + sub;
      if (causal && k0 > q_last) break;  // this tile and the rest: all masked
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
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int qi = ty * RPT + r;
    // a row with no live key (no active block) has l == 0 and acc == 0
    const float safe = l[r] == 0.f ? 1.f : l[r];
    T* ob = o + b * sob + (long long)(q0 + qi) * sos + h * soh;
#pragma unroll
    for (int j = 0; j < DPT; ++j) ob[tx + 16 * j] = from_f<T>(acc[r][j] / safe);
  }
}

template <typename T, int HD, int BLK>
void launch_block_sparse(const void* q, const void* k, const void* v, void* o,
                         const void* idx, const void* counts,
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
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (const int*)idx,
      (const int*)counts, (const float*)bias, S, H, A, sqb, sqs, sqh, skb,
      sks, skh, svb, svs, svh, sob, sos, soh, causal, scale);
}

}  // namespace dstt

// q, k, v and o [B, S, H, D], each given by its (b, s, h) strides in
// elements with a unit stride on D.  idx [H, S/block, A] and counts
// [H, S/block]: contiguous int32 (block_sparse.layout_tables).  bias: an
// fp32 [B, S] contiguous key bias added before the scale, or null.  block:
// 16, 32, 64 or 128, dividing S.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape or block with no instantiation.
extern "C" int dstt_block_sparse_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const void* idx,
    const void* counts, const void* bias, int dtype, int B, int S, int H,
    int D, int A, int block, long long sqb, long long sqs, long long sqh,
    long long skb, long long sks, long long skh, long long svb, long long svs,
    long long svh, long long sob, long long sos, long long soh, int causal,
    float scale, void* stream) {
  if (block <= 0 || S % block != 0 || A <= 0) return cudaErrorInvalidValue;
  if (block != 16 && block != 32 && block != 64 && block != 128)
    return cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
#define DSTT_SPARSE_BLOCK(T, HD, BLK)                                          \
  dstt::launch_block_sparse<T, HD, BLK>(q, k, v, o, idx, counts, bias, B, S,   \
                                        H, A, sqb, sqs, sqh, skb, sks, skh,    \
                                        svb, svs, svh, sob, sos, soh, causal,  \
                                        scale, (cudaStream_t)stream)
#define DSTT_SPARSE_LAUNCH(T, HD)                                              \
  switch (block) {                                                             \
    case 16: DSTT_SPARSE_BLOCK(T, HD, 16); break;                              \
    case 32: DSTT_SPARSE_BLOCK(T, HD, 32); break;                              \
    case 64: DSTT_SPARSE_BLOCK(T, HD, 64); break;                              \
    default: DSTT_SPARSE_BLOCK(T, HD, 128); break;                             \
  }
  DSTT_DISPATCH(dtype, D, DSTT_SPARSE_LAUNCH);
#undef DSTT_SPARSE_LAUNCH
#undef DSTT_SPARSE_BLOCK
  return (int)cudaGetLastError();
}
