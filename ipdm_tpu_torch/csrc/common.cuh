// Shared helpers of the port's CUDA kernels: float <-> storage-type casts
// and the bf16 operand rounding.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ipdm {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// v rounded to bf16 (nearest even) and back: the value a bf16 matmul
// operand carries
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

}  // namespace ipdm
