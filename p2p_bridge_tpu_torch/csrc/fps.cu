// K5: furthest point sampling, [B, N, 3] f32 -> [B, M] int32.
//
// Replaces p2p_bridge_tpu/ops/pallas/fps_kernel.py:furthest_point_sample_pallas
// (_fps_kernel batched, _fps_kernel_single for large N).
//
// Semantics (p2p_bridge_tpu/ops/fps.py:_furthest_point_sample_xla): the first
// index is 0, the running point-to-set distance starts at FLT_MAX, and every
// iteration takes the argmax with ties to the lowest index.
//
// What bounds it on the H100: the M-1 iterations are serially dependent, so a
// cloud cannot be split across iterations; each iteration is a pass over N
// distances plus a block-wide argmax, i.e. latency (two barriers and a
// reduction) at patch size and on-chip bandwidth at N = 149,504.
// Design: one block per cloud. Distances live in shared memory when N * 4 B
// fits (and the coordinates too when N * 16 B fits); otherwise in a global
// scratch row that stays resident in the 50 MB L2. The argmax is a warp
// shuffle reduction followed by one warp over the per-warp winners.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kSmemBudget = 200 * 1024;

__device__ __forceinline__ void take_max(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void fps_kernel(const float* __restrict__ pts, int N, int M,
                           float* __restrict__ gdist, int dist_in_smem,
                           int pts_in_smem, int32_t* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int s_last;

  const int b = blockIdx.x;
  const float* p = pts + (size_t)b * N * 3;
  float* dist = dist_in_smem ? smem + (pts_in_smem ? 3 * N : 0)
                             : gdist + (size_t)b * N;
  const float* P = pts_in_smem ? smem : p;
  int32_t* o = out + (size_t)b * M;

  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    if (pts_in_smem) {
      smem[3 * i] = p[3 * i];
      smem[3 * i + 1] = p[3 * i + 1];
      smem[3 * i + 2] = p[3 * i + 2];
    }
    dist[i] = FLT_MAX;
  }
  if (threadIdx.x == 0) {
    o[0] = 0;
    s_last = 0;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int j = 1; j < M; ++j) {
    const int last = s_last;
    const float lx = P[3 * last], ly = P[3 * last + 1], lz = P[3 * last + 2];
    float bv = -1.0f;
    int bi = 0x7fffffff;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      const float d =
          p2pb::sqdist3(P[3 * i] - lx, P[3 * i + 1] - ly, P[3 * i + 2] - lz);
      const float dd = fminf(dist[i], d);
      dist[i] = dd;
      if (dd > bv) {  // i grows, so strict > keeps the lowest index
        bv = dd;
        bi = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      take_max(bv, bi, ov, oi);
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? red_v[lane] : -1.0f;
      bi = lane < nwarps ? red_i[lane] : 0x7fffffff;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        take_max(bv, bi, ov, oi);
      }
      if (lane == 0) {
        s_last = bi;
        o[j] = bi;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Bytes of global scratch the caller must pass for this shape (0: none).
P2PB_API long long p2pb_fps_scratch_bytes(int B, int N) {
  return (long long)N * 4 <= kSmemBudget ? 0 : (long long)B * N * 4;
}

P2PB_API int p2pb_fps(const void* pts, int B, int N, int M, void* scratch,
                      void* out, int device, void* stream) {
  P2PB_ON_DEVICE(device);
  const int pts_in_smem = (long long)N * 16 <= kSmemBudget;
  const int dist_in_smem = (long long)N * 4 <= kSmemBudget;
  const size_t smem = (pts_in_smem ? (size_t)N * 16
                                   : (dist_in_smem ? (size_t)N * 4 : 0));
  cudaFuncSetAttribute(fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemBudget);
  const int threads = N <= 4096 ? 512 : 1024;
  fps_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)pts, N, M, (float*)scratch, dist_in_smem, pts_in_smem,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

P2PB_API const char* p2pb_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
