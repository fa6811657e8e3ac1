// Shared helpers for the hand-written Hopper kernels of p2p_bridge_tpu_torch.
//
// Every entry point has a plain C interface (bound from Python with ctypes):
// pointers and the stream arrive as void*, it launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() so the wrapper can raise.
// Kernels that take bf16 data are templates on the element type; an entry
// point's `bf16` flag picks float or __nv_bfloat16. Arithmetic is in f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define P2PB_API extern "C" __attribute__((visibility("default")))

namespace p2pb {

using bf16 = __nv_bfloat16;

// (dx*dx + dy*dy) + dz*dz with every product and sum rounded on its own:
// no FMA contraction, so a point on the radius (or FPS tie) boundary is
// classified exactly as the plain PyTorch version classifies it.
__device__ __forceinline__ float sqdist3(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// f32 -> element type, rounding to nearest even as torch's .to() does
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

}  // namespace p2pb
