// Shared helpers for the hand-written Hopper kernels of p2p_bridge_tpu_torch.
//
// Every entry point has a plain C interface (bound from Python with ctypes):
// pointers and the stream arrive as void*, it launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() so the wrapper can raise.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define P2PB_API extern "C" __attribute__((visibility("default")))

namespace p2pb {

// (dx*dx + dy*dy) + dz*dz with every product and sum rounded on its own:
// no FMA contraction, so a point on the radius (or FPS tie) boundary is
// classified exactly as the plain PyTorch version classifies it.
__device__ __forceinline__ float sqdist3(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

}  // namespace p2pb
