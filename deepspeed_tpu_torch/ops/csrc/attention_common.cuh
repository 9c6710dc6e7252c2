// Shared helpers of the attention kernels: element-type conversions and
// the dtype / head-dim dispatch of the C entry points.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

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
