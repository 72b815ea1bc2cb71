// Shared helpers for the psalm_tpu_torch kernels: element-type conversion
// and the dtype codes the Python wrappers pass across the C interface.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace psalm {

// Must match psalm_tpu_torch/ops/_build.py::DTYPE_CODES.
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Sum of v over the 32 lanes of a warp, returned to every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace psalm
