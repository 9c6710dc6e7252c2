// K2 (single-token decode attention with the fused cache write) and K6
// (the same over a paged KV pool), for Hopper, on bf16 / fp16 / fp32
// caches and on int8-KV caches, plus their int8 x int8 mode.
//
// Replace two Pallas kernels of the JAX package:
//   K2  deepspeed_tpu/ops/transformer/decode_attention.py
//       decode_attention / _decode_kernel  (float and int8-KV caches, the
//       fused write, the int8-matmul mode and the sliding window)
//   K6  deepspeed_tpu/ops/transformer/paged_attention.py
//       paged_decode_attention  (its body runs _decode_kernel unchanged)
// One query row per head attends to cache positions pos < lengths[b] --
// with a sliding window (window > 0; GPT-Neo's local layers) only to
// lengths[b] - window <= pos < lengths[b].  The window moves the first
// position of the loops, nothing else: the kernel never reads a row (or,
// for K6, a table entry) below the window, so a windowed step reads
// O(window) rows, as the JAX kernel's index maps pin the blocks below
// the window to its first block.  K2
// reads the S-major cache [B, S_max, KVH*D]; K6 reads one layer of the
// page pool [num_pages, page, KVH*D] through the block table pages[B,
// n_virt] (attention_common.cuh PagedRows).  The kernel body is one
// template over that row map, so with the same warp / position schedule K6
// over the pool is bitwise equal to K2 over the gathered view pool[pages].
// With new_k / new_v given, the kernel first writes this step's row at
// virtual position max(lengths[b] - 1, 0) in place -- the zero-length
// clamp of the JAX kernel; through the table for K6 -- and then attends
// over the cache that now holds it, which is the unfused JAX order (write,
// then attend).  The fresh row lies inside any window of at least one
// position.
//
// int8-KV (the cache type C = int8_t): payloads int8 with fp32 scales
// [.., S_max, KVH] per (position, kv head), read through the same row map
// with KVH elements per position.  The k-scale multiplies each score, the
// v-scale each probability before the PV product (the running sum takes
// the raw probability), as the JAX kernel applies them to its score and
// probability tiles.  The fused write quantizes the fresh row in the block
// that owns its kv head: s = max|x| / 127, safe = s == 0 ? 1 : s, payload
// rintf(x / safe) clamped to +-127, scale safe.  The JAX fused kernel
// substitutes the dequantized fresh row into the step's own scores instead
// of reading it back: the same values up to fp32 rounding.
//
// What bounds it on an H100: the cache stream.  Each step reads
// 2 * lengths[b] * KVH * D elements per layer and does ~4 flops per
// element, far below the card's flop-per-byte ridge, so the kernel is
// memory-bound, and at decode's short rows (a few hundred positions) the
// latency of each row's loads matters as much as the bandwidth.  The
// design reads every live cache row of its kv head exactly once, never
// touches rows past lengths[b] (so K6 never reads a table entry past the
// live pages), keeps several rows' loads in flight per warp and has no
// barrier inside the position loop; the cache write is D elements per kv
// head, done by the block that owns those columns, so no other block can
// race it.  K6 adds one table read per position (cached in L1).
//
// One block per (kv head, batch row) serves that kv head's G = H / KVH
// query heads with 8 warps.  Warp w takes positions w*U .. w*U+U-1, then
// the next 8*U, and so on; lane l holds dims l*DPL .. l*DPL+DPL-1 of a row
// (DPL = D / 32), so a row is one coalesced warp load and a score is a
// warp-shuffle sum.  Each warp keeps an online softmax (max, sum, output)
// per query head in registers; the 8 warps' states merge through shared
// memory at the end.
//
// The int8 x int8 mode (decode_i8mm_kernel; unfused, as in JAX) quantizes
// q per head and, per head and KV block, the probabilities folded with the
// v-scales, and computes both products on integers (__dp4a, exact).  That
// rounding of P depends on the blocking and the block order, so this
// kernel walks the positions in the JAX kernel's blocks (block_k positions,
// min(512, S_max) for K2 and the page for K6), in order: a block's scores
// go to shared memory, one warp per head turns them into the block's
// softmax update and quantized P, and all threads sum P.V.  With a window
// it starts at the block holding lengths[b] - window (the JAX kernel skips
// every block wholly below it) and leaves that block's rows below the
// window out of every loop (JAX masks them to P = 0).
#include "attention_common.cuh"

namespace dstt {

constexpr int kDecWarps = 8;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kRowsPerWarp = 4;  // rows in flight per warp (U)
constexpr int kMaxBlockK = 512;  // the int8 x int8 mode's longest KV block

template <int BYTES> struct VecOf;
template <> struct VecOf<2> { using type = unsigned short; };
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

// Rows: where position t of batch row b starts (StridedRows for K2's
// [B, S_max, KVH*D] cache, PagedRows for K6); srows: the same map over the
// int8-KV scales (KVH per position; unused for float caches); S_max: the
// positions a row can hold (n_virt * page for K6).  T: q / out / new row
// type; C: the cache type, T or int8_t.
template <typename T, typename C, int D, int G, typename Rows>
__global__ void __launch_bounds__(kDecThreads)
decode_kernel(const T* __restrict__ q, C* k_cache, C* v_cache, float* k_scale,
              float* v_scale, const int* __restrict__ lengths,
              const T* __restrict__ new_k, const T* __restrict__ new_v,
              T* __restrict__ out, int KVH, int S_max, int window, Rows rows,
              Rows srows, float scale) {
  constexpr bool kInt8 = sizeof(C) == 1;
  constexpr int DPL = D / 32;      // dims per lane
  constexpr int U = kRowsPerWarp;
  const int kvh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int H = KVH * G;
  // caches and scales are written below and read back: no __restrict__,
  // no read-only loads on them
  C* kb = k_cache + kvh * D;
  C* vb = v_cache + kvh * D;
  const int len = min(max(lengths[b], 0), S_max);
  // the first live position: the window's, or 0
  const int lo = window > 0 ? max(len - window, 0) : 0;

  if (new_k != nullptr) {
    const int w = min(max(lengths[b] - 1, 0), S_max - 1);
    const long long wo = rows.at(b, w);
    const T* nk = new_k + ((long long)b * KVH + kvh) * D;
    const T* nv = new_v + ((long long)b * KVH + kvh) * D;
    if constexpr (kInt8) {
      // warp 0 quantizes the K row, warp 1 the V row
      if (warp < 2) {
        const T* src = warp == 0 ? nk : nv;
        C* dst = (warp == 0 ? kb : vb) + wo;
        float x[DPL], amax = 0.f;
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          x[j] = to_f(src[lane * DPL + j]);
          amax = fmaxf(amax, fabsf(x[j]));
        }
        const float s = warp_max(amax) / 127.0f;
        const float safe = s == 0.f ? 1.f : s;
#pragma unroll
        for (int j = 0; j < DPL; ++j) dst[lane * DPL + j] = quant_i8(x[j], safe);
        if (lane == 0) (warp == 0 ? k_scale : v_scale)[srows.at(b, w) + kvh] = safe;
      }
    } else {
      for (int d = tid; d < D; d += kDecThreads) {
        kb[wo + d] = nk[d];
        vb[wo + d] = nv[d];
      }
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

  for (int t0 = lo + warp * U; t0 < len; t0 += kDecWarps * U) {
    float kr[U][DPL], vr[U][DPL], ksc[U], vsc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < len) {
        const long long off = rows.at(b, t0 + u) + lane * DPL;
        load_floats<C, DPL>(kb + off, kr[u]);
        load_floats<C, DPL>(vb + off, vr[u]);
        if constexpr (kInt8) {
          const long long so = srows.at(b, t0 + u) + kvh;
          ksc[u] = k_scale[so];
          vsc[u] = v_scale[so];
        }
      } else {
#pragma unroll
        for (int j = 0; j < DPL; ++j) kr[u][j] = vr[u][j] = 0.f;
        ksc[u] = vsc[u] = 0.f;
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
        float sc = warp_sum(part);
        if constexpr (kInt8) sc *= ksc[u];
        s[u] = t0 + u < len ? sc : kNegInf;
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
        float pv = p;
        if constexpr (kInt8) pv *= vsc[u];
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[g][j] = fmaf(pv, vr[u][j], acc[g][j]);
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

// The int8 x int8 decode (JAX decode_int8_matmuls) over int8-KV caches:
// blocks of block_k positions in order.  Per block: scores = the integer
// dot of q_i8 and k_i8 times (qs * scale) times the k-scale; per head the
// block's max updates the running max m, p = exp(s - m), the running sum
// takes p, and pv = p * v-scale is quantized as rintf(pv / rsafe) with
// rmax = max(pv) / 127 (rsafe = rmax, or 1 where rmax is 0); the integer
// P.V of that times rmax joins acc * exp(m_old - m).  Integer sums are
// exact in any order, so the only order-dependent float sum is each
// block's sum of p (a lane-strided partial sum, then the warp tree).
template <typename T, int D, int G, typename Rows>
__global__ void __launch_bounds__(kDecThreads)
decode_i8mm_kernel(const T* __restrict__ q, const int8_t* __restrict__ k_cache,
                   const int8_t* __restrict__ v_cache,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ lengths, T* __restrict__ out,
                   int KVH, int S_max, int block_k, int window, Rows rows,
                   Rows srows, float scale) {
  constexpr int W = D / 4;                 // int32 words per row of one head
  constexpr int R = kDecThreads / W;       // position groups of the PV sum
  static_assert(D % 32 == 0 && kDecThreads % W == 0, "head dim");
  const int kvh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int H = KVH * G;
  __shared__ __align__(16) int8_t q8[G][D];  // q quantized per head
  __shared__ float qsc[G];                   // its scale times `scale`
  __shared__ float sc[G][kMaxBlockK];        // scores, then P * v-scale
  __shared__ int pq[G][kMaxBlockK];          // P quantized
  __shared__ int oi[G][D];                   // the block's integer P.V
  __shared__ float acc[G][D];
  __shared__ float m_s[G], l_s[G], corr_s[G], rmax_s[G];
  const int len = min(max(lengths[b], 0), S_max);
  // the window's first position (may be negative), and the first block
  // that reaches it
  const int lo = window > 0 ? len - window : 0;
  const int first = max(lo, 0) / block_k * block_k;

  if (warp < G) {  // warp g quantizes head g of q
    constexpr int DPL = D / 32;
    const T* qh = q + ((long long)b * H + kvh * G + warp) * D + lane * DPL;
    float x[DPL], amax = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      x[j] = to_f(qh[j]);
      amax = fmaxf(amax, fabsf(x[j]));
    }
    float qs = warp_max(amax) / 127.0f;
    qs = qs == 0.f ? 1.f : qs;
#pragma unroll
    for (int j = 0; j < DPL; ++j) q8[warp][lane * DPL + j] = quant_i8(x[j], qs);
    if (lane == 0) {
      qsc[warp] = qs * scale;
      m_s[warp] = kNegInf;
      l_s[warp] = 0.f;
    }
  }
  for (int i = tid; i < G * D; i += kDecThreads) acc[i / D][i % D] = 0.f;
  __syncthreads();

  const int8_t* kb = k_cache + kvh * D;
  const int8_t* vb = v_cache + kvh * D;
  for (int t0 = first; t0 < len; t0 += block_k) {
    const int n = min(block_k, len - t0);
    // the block's rows below the window take no part: every loop below
    // starts at t_lo (their P is 0 in JAX, so no sum, max or product
    // changes)
    const int t_lo = max(lo - t0, 0);
    // scores, one position per thread: the row's D bytes as int4 loads
    for (int t = t_lo + tid; t < n; t += kDecThreads) {
      const int4* kr = reinterpret_cast<const int4*>(kb + rows.at(b, t0 + t));
      int kw[W];
#pragma unroll
      for (int w = 0; w < W / 4; ++w) {
        const int4 x = kr[w];
        kw[4 * w] = x.x;
        kw[4 * w + 1] = x.y;
        kw[4 * w + 2] = x.z;
        kw[4 * w + 3] = x.w;
      }
      const float ks = k_scale[srows.at(b, t0 + t) + kvh];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int* qw = reinterpret_cast<const int*>(q8[g]);
        int dot = 0;
#pragma unroll
        for (int w = 0; w < W; ++w) dot = __dp4a(kw[w], qw[w], dot);
        sc[g][t] = (float)dot * qsc[g] * ks;
      }
    }
    for (int i = tid; i < G * D; i += kDecThreads) oi[i / D][i % D] = 0;
    __syncthreads();

    if (warp < G) {  // warp g: head g's softmax update and quantized P
      const int g = warp;
      float mx = kNegInf;
      for (int t = t_lo + lane; t < n; t += 32) mx = fmaxf(mx, sc[g][t]);
      const float m_new = fmaxf(m_s[g], warp_max(mx));
      float psum = 0.f, pmax = 0.f;
      for (int t = t_lo + lane; t < n; t += 32) {
        const float p = expf(sc[g][t] - m_new);
        psum += p;
        const float pv = p * v_scale[srows.at(b, t0 + t) + kvh];
        sc[g][t] = pv;
        pmax = fmaxf(pmax, pv);
      }
      psum = warp_sum(psum);
      const float rmax = warp_max(pmax) / 127.0f;
      const float rsafe = rmax == 0.f ? 1.f : rmax;
      for (int t = t_lo + lane; t < n; t += 32)
        pq[g][t] = quant_i8(sc[g][t], rsafe);
      if (lane == 0) {
        const float corr = expf(m_s[g] - m_new);
        l_s[g] = l_s[g] * corr + psum;
        m_s[g] = m_new;
        corr_s[g] = corr;
        rmax_s[g] = rmax;
      }
    }
    __syncthreads();

    {  // P.V on integers: thread (r, word) sums positions r, r + R, ...
      const int word = tid % W, r = tid / W;
      int o[G][4];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[g][i] = 0;
      for (int t = t_lo + r; t < n; t += R) {
        const int vw = reinterpret_cast<const int*>(
            vb + rows.at(b, t0 + t))[word];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int p = pq[g][t];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            o[g][i] += p * (int)(int8_t)(vw >> (8 * i));
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i) atomicAdd(&oi[g][4 * word + i], o[g][i]);
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kDecThreads) {
      const int g = i / D, d = i % D;
      acc[g][d] = acc[g][d] * corr_s[g] + (float)oi[g][d] * rmax_s[g];
    }
    __syncthreads();
  }

  T* ob = out + ((long long)b * H + kvh * G) * D;
  for (int i = tid; i < G * D; i += kDecThreads) {
    const int g = i / D, d = i % D;
    ob[i] = from_f<T>(acc[g][d] / (l_s[g] == 0.f ? 1.f : l_s[g]));
  }
}

template <typename T, typename C, int HD, typename Rows>
int launch_decode(const void* q, void* k, void* v, void* ks, void* vs,
                  const void* lengths, const void* new_k, const void* new_v,
                  void* out, int B, int H, int KVH, int S_max, int window,
                  Rows rows, Rows srows, float scale, cudaStream_t stream) {
  const dim3 grid(KVH, B);
#define DSTT_DECODE_G(GG)                                                      \
  decode_kernel<T, C, HD, GG, Rows><<<grid, kDecThreads, 0, stream>>>(        \
      (const T*)q, (C*)k, (C*)v, (float*)ks, (float*)vs, (const int*)lengths,  \
      (const T*)new_k, (const T*)new_v, (T*)out, KVH, S_max, window, rows,     \
      srows, scale)
  switch (H / KVH) {
    case 1: DSTT_DECODE_G(1); break;
    case 2: DSTT_DECODE_G(2); break;
    case 4: DSTT_DECODE_G(4); break;
    case 8: DSTT_DECODE_G(8); break;
    default: return cudaErrorInvalidValue;
  }
#undef DSTT_DECODE_G
  return cudaSuccess;
}

template <typename T, int HD, typename Rows>
int launch_decode_i8mm(const void* q, const void* k, const void* v,
                       const void* ks, const void* vs, const void* lengths,
                       void* out, int B, int H, int KVH, int S_max,
                       int block_k, int window, Rows rows, Rows srows,
                       float scale, cudaStream_t stream) {
  const dim3 grid(KVH, B);
#define DSTT_I8MM_G(GG)                                                        \
  decode_i8mm_kernel<T, HD, GG, Rows><<<grid, kDecThreads, 0, stream>>>(      \
      (const T*)q, (const int8_t*)k, (const int8_t*)v, (const float*)ks,       \
      (const float*)vs, (const int*)lengths, (T*)out, KVH, S_max, block_k,     \
      window, rows, srows, scale)
  switch (H / KVH) {
    case 1: DSTT_I8MM_G(1); break;
    case 2: DSTT_I8MM_G(2); break;
    case 4: DSTT_I8MM_G(4); break;
    case 8: DSTT_I8MM_G(8); break;
    default: return cudaErrorInvalidValue;
  }
#undef DSTT_I8MM_G
  return cudaSuccess;
}

}  // namespace dstt

// q [B, H, D] and out [B, H, D] contiguous; k_cache / v_cache one layer's
// contiguous [B, S_max, KVH*D], 16-byte aligned, in q's dtype -- or int8
// with k_scale / v_scale that layer's contiguous fp32 [B, S_max, KVH]
// (both null for a float cache); lengths [B] int32 on the device, counting
// this step's token; new_k / new_v [B, KVH, D] contiguous in q's dtype, or
// both null for the unfused call; window the sliding window's positions,
// <= 0 for none.  G = H / KVH must be 1, 2, 4 or 8.  Returns
// cudaGetLastError().
extern "C" int dstt_decode_attention(const void* q, void* k_cache,
                                     void* v_cache, void* k_scale,
                                     void* v_scale, const void* lengths,
                                     const void* new_k, const void* new_v,
                                     void* out, int dtype, int B, int H,
                                     int KVH, int D, int S_max, int window,
                                     float scale, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || S_max <= 0) return cudaErrorInvalidValue;
  if ((new_k == nullptr) != (new_v == nullptr)) return cudaErrorInvalidValue;
  if ((k_scale == nullptr) != (v_scale == nullptr)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const dstt::StridedRows rows{(long long)S_max * KVH * D, (long long)KVH * D};
  const dstt::StridedRows srows{(long long)S_max * KVH, (long long)KVH};
#define DSTT_DECODE_LAUNCH(T, HD)                                              \
  {                                                                            \
    const int e = k_scale != nullptr                                           \
        ? dstt::launch_decode<T, int8_t, HD>(                                  \
              q, k_cache, v_cache, k_scale, v_scale, lengths, new_k, new_v,    \
              out, B, H, KVH, S_max, window, rows, srows, scale,               \
              (cudaStream_t)stream)                                            \
        : dstt::launch_decode<T, T, HD>(                                       \
              q, k_cache, v_cache, k_scale, v_scale, lengths, new_k, new_v,    \
              out, B, H, KVH, S_max, window, rows, srows, scale,               \
              (cudaStream_t)stream);                                           \
    if (e != cudaSuccess) return e;                                            \
  }
  DSTT_DISPATCH(dtype, D, DSTT_DECODE_LAUNCH);
#undef DSTT_DECODE_LAUNCH
  return (int)cudaGetLastError();
}

// K6.  k_pool / v_pool: one layer of the page pool, contiguous
// [num_pages, page, KVH*D], 16-byte aligned, in q's dtype -- or int8 with
// k_scale / v_scale that layer's fp32 [num_pages, page, KVH] (both null
// for a float pool); pages [B, n_virt] int32 on the device (dead lanes
// point at the trash page 0); lengths, new_k / new_v, q, out and window as
// for dstt_decode_attention.  page is any positive size.  Returns
// cudaGetLastError().
extern "C" int dstt_paged_decode_attention(
    const void* q, void* k_pool, void* v_pool, void* k_scale, void* v_scale,
    const void* lengths, const void* pages, const void* new_k,
    const void* new_v, void* out, int dtype, int B, int H, int KVH, int D,
    int page, int n_virt, int window, float scale, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || page <= 0 || n_virt <= 0)
    return cudaErrorInvalidValue;
  if ((new_k == nullptr) != (new_v == nullptr)) return cudaErrorInvalidValue;
  if ((k_scale == nullptr) != (v_scale == nullptr)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const dstt::PagedRows rows{(const int*)pages, n_virt, page,
                             (long long)KVH * D};
  const dstt::PagedRows srows{(const int*)pages, n_virt, page, (long long)KVH};
#define DSTT_PAGED_DECODE_LAUNCH(T, HD)                                        \
  {                                                                            \
    const int e = k_scale != nullptr                                           \
        ? dstt::launch_decode<T, int8_t, HD>(                                  \
              q, k_pool, v_pool, k_scale, v_scale, lengths, new_k, new_v, out, \
              B, H, KVH, page * n_virt, window, rows, srows, scale,            \
              (cudaStream_t)stream)                                            \
        : dstt::launch_decode<T, T, HD>(                                       \
              q, k_pool, v_pool, k_scale, v_scale, lengths, new_k, new_v, out, \
              B, H, KVH, page * n_virt, window, rows, srows, scale,            \
              (cudaStream_t)stream);                                           \
    if (e != cudaSuccess) return e;                                            \
  }
  DSTT_DISPATCH(dtype, D, DSTT_PAGED_DECODE_LAUNCH);
#undef DSTT_PAGED_DECODE_LAUNCH
  return (int)cudaGetLastError();
}

// K2's int8 x int8 mode: int8 caches and fp32 scales as for
// dstt_decode_attention (required), no fused write; block_k the KV block
// of P's quantization, 1 .. 512 (the JAX kernel's min(block_k, S_max));
// window as for dstt_decode_attention.
extern "C" int dstt_decode_attention_i8mm(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* lengths, void* out,
    int dtype, int B, int H, int KVH, int D, int S_max, int block_k,
    int window, float scale, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || S_max <= 0) return cudaErrorInvalidValue;
  if (k_scale == nullptr || v_scale == nullptr) return cudaErrorInvalidValue;
  if (block_k <= 0 || block_k > dstt::kMaxBlockK) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const dstt::StridedRows rows{(long long)S_max * KVH * D, (long long)KVH * D};
  const dstt::StridedRows srows{(long long)S_max * KVH, (long long)KVH};
#define DSTT_I8MM_LAUNCH(T, HD)                                                \
  {                                                                            \
    const int e = dstt::launch_decode_i8mm<T, HD>(                             \
        q, k_cache, v_cache, k_scale, v_scale, lengths, out, B, H, KVH, S_max, \
        block_k, window, rows, srows, scale, (cudaStream_t)stream);            \
    if (e != cudaSuccess) return e;                                            \
  }
  DSTT_DISPATCH(dtype, D, DSTT_I8MM_LAUNCH);
#undef DSTT_I8MM_LAUNCH
  return (int)cudaGetLastError();
}

// K6's int8 x int8 mode: the pool, scales and table as for
// dstt_paged_decode_attention (int8, scales required), no fused write;
// block_k the KV block of P's quantization in virtual positions, 1 .. 512
// (the page, as the JAX paged kernel; a windowed layer's gathered-view
// route takes min(512, page * n_virt)); window as for
// dstt_decode_attention.
extern "C" int dstt_paged_decode_attention_i8mm(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* lengths,
    const void* pages, void* out, int dtype, int B, int H, int KVH, int D,
    int page, int n_virt, int block_k, int window, float scale,
    void* stream) {
  if (KVH <= 0 || H % KVH != 0 || page <= 0 || n_virt <= 0)
    return cudaErrorInvalidValue;
  if (k_scale == nullptr || v_scale == nullptr) return cudaErrorInvalidValue;
  if (block_k <= 0 || block_k > dstt::kMaxBlockK) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const dstt::PagedRows rows{(const int*)pages, n_virt, page,
                             (long long)KVH * D};
  const dstt::PagedRows srows{(const int*)pages, n_virt, page, (long long)KVH};
#define DSTT_PAGED_I8MM_LAUNCH(T, HD)                                          \
  {                                                                            \
    const int e = dstt::launch_decode_i8mm<T, HD>(                             \
        q, k_pool, v_pool, k_scale, v_scale, lengths, out, B, H, KVH,          \
        page * n_virt, block_k, window, rows, srows, scale,                    \
        (cudaStream_t)stream);                                                 \
    if (e != cudaSuccess) return e;                                            \
  }
  DSTT_DISPATCH(dtype, D, DSTT_PAGED_I8MM_LAUNCH);
#undef DSTT_PAGED_I8MM_LAUNCH
  return (int)cudaGetLastError();
}
