// Shared helpers for the hand-written Hopper kernels of p2p_bridge_tpu_torch.
//
// Every entry point has a plain C interface (bound from Python with ctypes):
// pointers and the stream arrive as void*, it launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() so the wrapper can raise.
// A launching entry takes the card's index and the stream last and runs under
// P2PB_ON_DEVICE(device).
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

// Makes `device` the runtime's current device for the guard's scope and the
// previous one current again after it; when it already is current (the usual
// case) this costs one cudaGetDevice.
struct DeviceGuard {
  int prev = -1, err = 0;
  explicit DeviceGuard(int device) {
    int cur = 0;
    err = (int)cudaGetDevice(&cur);
    if (!err && cur != device) {
      err = (int)cudaSetDevice(device);
      if (!err) prev = cur;
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace p2pb

#define P2PB_ON_DEVICE(device)              \
  p2pb::DeviceGuard p2pb_device_(device);   \
  if (p2pb_device_.err) return p2pb_device_.err
