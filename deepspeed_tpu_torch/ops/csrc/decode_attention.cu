// K2: single-token decode attention with the fused cache write, for Hopper.
//
// Replaces the Pallas kernel deepspeed_tpu/ops/transformer/
// decode_attention.py  decode_attention / _decode_kernel  (bf16 / fp16 /
// fp32 caches; its int8-KV, sliding-window and int8-matmul modes are not
// ported yet).  One query row per head attends to cache positions
// pos < lengths[b] of the S-major cache [B, S_max, KVH*D].  With new_k /
// new_v given, the kernel first writes this step's row at position
// max(lengths[b] - 1, 0) in place -- the zero-length clamp of the JAX
// kernel -- and then attends over the cache that now holds it, which is
// the unfused JAX order (write, then attend).
//
// What bounds it on an H100: the cache stream.  Each step reads
// 2 * lengths[b] * KVH * D elements per layer and does ~4 flops per
// element, far below the card's flop-per-byte ridge, so the kernel is
// memory-bound, and at decode's short rows (a few hundred positions) the
// latency of each row's loads matters as much as the bandwidth.  The
// design reads every live cache row of its kv head exactly once, never
// touches rows past lengths[b], keeps several rows' loads in flight per
// warp and has no barrier inside the position loop; the cache write is D
// elements per kv head, done by the block that owns those columns, so no
// other block can race it.
//
// One block per (kv head, batch row) serves that kv head's G = H / KVH
// query heads with 8 warps.  Warp w takes positions w*U .. w*U+U-1, then
// the next 8*U, and so on; lane l holds dims l*DPL .. l*DPL+DPL-1 of a row
// (DPL = D / 32), so a row is one coalesced warp load and a score is a
// warp-shuffle sum.  Each warp keeps an online softmax (max, sum, output)
// per query head in registers; the 8 warps' states merge through shared
// memory at the end.
#include "attention_common.cuh"

namespace dstt {

constexpr int kDecWarps = 8;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kRowsPerWarp = 4;  // rows in flight per warp (U)

template <int BYTES> struct VecOf;
template <> struct VecOf<4> { using type = unsigned int; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<16> { using type = uint4; };

// N consecutive elements at p (aligned to N * sizeof(T)) as floats
template <typename T, int N>
__device__ __forceinline__ void load_floats(const T* p, float (&out)[N]) {
  using V = typename VecOf<N * sizeof(T)>::type;
  const V v = *reinterpret_cast<const V*>(p);
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f(e[i]);
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kDecThreads)
decode_kernel(const T* __restrict__ q, T* k_cache, T* v_cache,
              const int* __restrict__ lengths, const T* __restrict__ new_k,
              const T* __restrict__ new_v, T* __restrict__ out, int KVH,
              int S_max, float scale) {
  constexpr int DPL = D / 32;      // dims per lane
  constexpr int U = kRowsPerWarp;
  const int kvh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int H = KVH * G;
  const long long row = (long long)KVH * D;  // elements per cache position
  // k_cache / v_cache are written below and read back: no __restrict__,
  // no read-only loads on them
  T* kb = k_cache + (long long)b * S_max * row + kvh * D;
  T* vb = v_cache + (long long)b * S_max * row + kvh * D;
  const int len = min(max(lengths[b], 0), S_max);

  if (new_k != nullptr) {
    const int w = min(max(lengths[b] - 1, 0), S_max - 1);
    const T* nk = new_k + ((long long)b * KVH + kvh) * D;
    const T* nv = new_v + ((long long)b * KVH + kvh) * D;
    for (int d = tid; d < D; d += kDecThreads) {
      kb[w * row + d] = nk[d];
      vb[w * row + d] = nv[d];
    }
    // the block's global writes are visible to all its threads after this
    __syncthreads();
  }

  // this lane's slice of each query head, pre-scaled
  float qv[G][DPL];
  const T* qb = q + ((long long)b * H + kvh * G) * D + lane * DPL;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_floats<T, DPL>(qb + g * D, qv[g]);
#pragma unroll
    for (int j = 0; j < DPL; ++j) qv[g][j] *= scale;
  }

  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[g][j] = 0.f;
  }

  for (int t0 = warp * U; t0 < len; t0 += kDecWarps * U) {
    float kr[U][DPL], vr[U][DPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < len) {
        const long long off = (long long)(t0 + u) * row + lane * DPL;
        load_floats<T, DPL>(kb + off, kr[u]);
        load_floats<T, DPL>(vb + off, vr[u]);
      } else {
#pragma unroll
        for (int j = 0; j < DPL; ++j) kr[u][j] = vr[u][j] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[U];
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < DPL; ++j) part = fmaf(qv[g][j], kr[u][j], part);
        s[u] = t0 + u < len ? warp_sum(part) : kNegInf;
        mx = fmaxf(mx, s[u]);
      }
      const float corr = expf(m[g] - mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[g][j] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = t0 + u < len ? expf(s[u] - mx) : 0.f;
        psum += p;
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[g][j] = fmaf(p, vr[u][j], acc[g][j]);
      }
      l[g] = l[g] * corr + psum;
      m[g] = mx;
    }
  }

  // merge the warps' softmax states
  __shared__ float sm_m[kDecWarps][G], sm_l[kDecWarps][G];
  __shared__ float sm_acc[kDecWarps][G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int j = 0; j < DPL; ++j) sm_acc[warp][g][lane * DPL + j] = acc[g][j];
  }
  __syncthreads();
  T* ob = out + ((long long)b * H + kvh * G) * D;
  for (int i = tid; i < G * D; i += kDecThreads) {
    const int g = i / D, d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      lsum = fmaf(sm_l[w][g], c, lsum);
      o = fmaf(sm_acc[w][g][d], c, o);
    }
    ob[i] = from_f<T>(o / (lsum == 0.f ? 1.f : lsum));
  }
}

}  // namespace dstt

// q [B, H, D] and out [B, H, D] contiguous; k_cache / v_cache one layer's
// contiguous [B, S_max, KVH*D], 16-byte aligned; lengths [B] int32 on the
// device, counting this step's token; new_k / new_v [B, KVH, D]
// contiguous, or both null for the unfused call.  G = H / KVH must be 1,
// 2, 4 or 8.  Returns cudaGetLastError().
extern "C" int dstt_decode_attention(const void* q, void* k_cache,
                                     void* v_cache, const void* lengths,
                                     const void* new_k, const void* new_v,
                                     void* out, int dtype, int B, int H,
                                     int KVH, int D, int S_max, float scale,
                                     void* stream) {
  if (KVH <= 0 || H % KVH != 0 || S_max <= 0) return cudaErrorInvalidValue;
  if ((new_k == nullptr) != (new_v == nullptr)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int G = H / KVH;
  const dim3 grid(KVH, B);
#define DSTT_DECODE_G(T, HD, GG)                                               \
  dstt::decode_kernel<T, HD, GG><<<grid, dstt::kDecThreads, 0,                 \
                                   (cudaStream_t)stream>>>(                    \
      (const T*)q, (T*)k_cache, (T*)v_cache, (const int*)lengths,              \
      (const T*)new_k, (const T*)new_v, (T*)out, KVH, S_max, scale)
#define DSTT_DECODE_LAUNCH(T, HD)                                              \
  {                                                                            \
    if (G == 1) DSTT_DECODE_G(T, HD, 1);                                       \
    else if (G == 2) DSTT_DECODE_G(T, HD, 2);                                  \
    else if (G == 4) DSTT_DECODE_G(T, HD, 4);                                  \
    else if (G == 8) DSTT_DECODE_G(T, HD, 8);                                  \
    else return cudaErrorInvalidValue;                                         \
  }
  DSTT_DISPATCH(dtype, D, DSTT_DECODE_LAUNCH);
#undef DSTT_DECODE_LAUNCH
#undef DSTT_DECODE_G
  return (int)cudaGetLastError();
}
