// Shared helpers of the port's kernels: fp32 <-> storage-type conversion by
// intrinsics, the dtype codes the Python wrappers pass, and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace mtp {

// dtype codes passed by the wrappers (DTYPE_CODES in kernels/_build.py)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The same over each half-warp: the 16 threads of one row of a 16×16 block.
__device__ __forceinline__ float half_warp_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [row0, row0 + n) of the row-major (·, D) src, as `rows` fp32 rows of
// stride D + 1 in dst (column walks hit distinct banks), zero past n; the
// kThreads threads of the block share the copy.  The source offset is
// 64-bit.
template <int kThreads, typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int row0, int n,
                                           int rows, int D) {
  const int Dp = D + 1;
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * Dp + c] = r < n ? to_f32(src[(static_cast<long long>(row0) + r) * D + c]) : 0.f;
  }
}

// Raise a kernel's dynamic shared-memory limit when it needs more than the
// 48 KB default; returns the CUDA error of the attribute call.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace mtp
