// Shared helpers of the attention kernels: element-type conversions, the
// int8 row quantizer of the int8-KV caches and the dtype / head-dim
// dispatch of the C entry points.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dstt {

// the JAX kernels' masked-score value (flash_attention.py NEG_INF)
constexpr float kNegInf = -1e30f;

enum DType { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}
// an int8 cache payload (the int8-KV mode): the integer as a float, exact
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t x) {
  return (float)x;
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// reduce over the 16 lanes of an aligned half-warp
__device__ __forceinline__ float half_warp_max(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The int8 payload of x against a per-(position, kv-head) scale, as the
// JAX package stores int8-KV rows: round half to even (rintf, as jnp.round)
// of x / safe with IEEE division, clamped to +-127.
__device__ __forceinline__ int8_t quant_i8(float x, float safe) {
  return (int8_t)fminf(fmaxf(rintf(x / safe), -127.f), 127.f);
}

// Where a kernel finds the K/V row of position `pos` of batch row b: an
// element offset from the cache pointer it was given.  The attention
// bodies are templates over this map, and the map is the only thing a
// paged cache changes; the arithmetic on the rows they find is the same.

// The int8-KV scales [B | num_pages, S | page, KVH] take the same map with
// KVH elements per position.

// A strided [B, S, ...] cache: row (b, pos) at b*sb + pos*ss.
struct StridedRows {
  static constexpr bool kPaged = false;
  struct Cursor {};  // PagedRows' table walk; a strided map needs none
  long long sb, ss;
  __device__ __forceinline__ long long at(int b, int pos) const {
    return b * sb + pos * ss;
  }
};

// One layer of a page pool [num_pages, page, row] addressed through a
// block table pages[B, n_virt]: virtual position pos of row b lies on
// pool page pages[b, pos / page] at in-page row pos % page (the JAX
// package's paged layout, deepspeed_tpu/ops/transformer/paged_attention.py).
// Callers read only positions below a row's live length, whose table
// entries the host has mapped.
struct PagedRows {
  static constexpr bool kPaged = true;
  const int* pages;
  int n_virt, page;
  long long row;  // elements per position: KVH * D
  __device__ __forceinline__ long long at(int b, int pos) const {
    const int pg = __ldg(pages + (long long)b * n_virt + pos / page);
    return ((long long)pg * page + pos % page) * row;
  }
  // A walk over positions pos, pos + step, ...: the virtual page and the
  // row in it, advanced without a division per step.  key_at reads the
  // table entry (the map's one dependent load, so a kernel can issue it
  // early); at_cursor finds the row from it.
  struct Cursor {
    int vpg, inp, dq, dr;
  };
  __device__ __forceinline__ Cursor cursor(int pos, int step) const {
    return {pos / page, pos % page, step / page, step % page};
  }
  __device__ __forceinline__ int key_at(int b, const Cursor& c) const {
    return __ldg(pages + (long long)b * n_virt + c.vpg);
  }
  __device__ __forceinline__ long long at_cursor(int pg, const Cursor& c) const {
    return ((long long)pg * page + c.inp) * row;
  }
  // the pool row (page * page_size + in-page row) at_cursor finds, as an
  // int: at_cursor is this times `row`
  __device__ __forceinline__ int pool_row(int pg, const Cursor& c) const {
    return pg * page + c.inp;
  }
  __device__ __forceinline__ void advance(Cursor& c) const {
    c.vpg += c.dq;
    c.inp += c.dr;
    if (c.inp >= page) {
      c.inp -= page;
      ++c.vpg;
    }
  }
};

}  // namespace dstt

// Calls LAUNCH(T, D) with the element type and head dim of the call;
// returns cudaErrorInvalidValue for a combination with no instantiation.
#define DSTT_DISPATCH(dtype, head_dim, LAUNCH)                              \
  do {                                                                      \
    if ((dtype) == dstt::kFloat32) {                                        \
      if ((head_dim) == 64) { LAUNCH(float, 64); }                          \
      else if ((head_dim) == 128) { LAUNCH(float, 128); }                   \
      else return cudaErrorInvalidValue;                                    \
    } else if ((dtype) == dstt::kBFloat16) {                                \
      if ((head_dim) == 64) { LAUNCH(__nv_bfloat16, 64); }                  \
      else if ((head_dim) == 128) { LAUNCH(__nv_bfloat16, 128); }           \
      else return cudaErrorInvalidValue;                                    \
    } else if ((dtype) == dstt::kFloat16) {                                 \
      if ((head_dim) == 64) { LAUNCH(__half, 64); }                         \
      else if ((head_dim) == 128) { LAUNCH(__half, 128); }                  \
      else return cudaErrorInvalidValue;                                    \
    } else {                                                                \
      return cudaErrorInvalidValue;                                         \
    }                                                                       \
  } while (0)
