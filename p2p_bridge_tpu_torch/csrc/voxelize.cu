// K2: average voxelization (forward), features [B, N, C] f32 and integer
// voxel coordinates [B, N, 3] -> grid [B, r^3, C] f32 of per-voxel means.
//
// Replaces p2p_bridge_tpu/ops/pallas/voxelize_kernel.py:
// avg_voxelize_scatter_pallas (_scatter_kernel). The backward row gather
// (gather_rows_pallas) serves training and is not ported here.
//
// Semantics (p2p_bridge_tpu/ops/voxelize.py, exact path): flat index
// x*r^2 + y*r + z, per-voxel sum and count, output sum / max(count, 1).
//
// What bounds it on the H100: it is a scatter, so memory traffic and atomic
// throughput; the grid at r = 32, C = 64, B = 73 is 0.6 GB.
// Design: two launches. The first has one thread per (point, channel), so a
// warp adds 32 consecutive channels of one point into one grid row (the
// atomics of a warp hit consecutive addresses), and channel 0 also counts the
// point. The second divides in place by max(count, 1). f32 atomics make the
// order of the sum change from run to run, so comparisons carry a tolerance.
#include "common.cuh"

namespace {

__global__ void scatter_kernel(const float* __restrict__ feat,
                               const int32_t* __restrict__ vox, int N, int C,
                               int r, long long total, float* __restrict__ sum,
                               float* __restrict__ cnt) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long n = t / C;  // point over all clouds
  const int c = (int)(t - n * C);
  const long long b = n / N;
  const int32_t* v = vox + 3 * n;
  const long long row = b * r * r * r + ((long long)v[0] * r + v[1]) * r + v[2];
  atomicAdd(sum + row * C + c, feat[t]);
  if (c == 0) atomicAdd(cnt + row, 1.0f);
}

__global__ void divide_kernel(float* __restrict__ sum,
                              const float* __restrict__ cnt, int C,
                              long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  sum[t] = sum[t] / fmaxf(cnt[t / C], 1.0f);
}

}  // namespace

// out [B, r^3, C] and cnt [B, r^3] must be zeroed by the caller.
P2PB_API int p2pb_avg_voxelize(const void* feat, const void* vox, int B, int N,
                               int C, int r, void* out, void* cnt,
                               void* stream) {
  const int threads = 256;
  const long long pts = (long long)B * N * C;
  scatter_kernel<<<(unsigned)((pts + threads - 1) / threads), threads, 0,
                   (cudaStream_t)stream>>>(
      (const float*)feat, (const int32_t*)vox, N, C, r, pts, (float*)out,
      (float*)cnt);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const long long cells = (long long)B * r * r * r * C;
  divide_kernel<<<(unsigned)((cells + threads - 1) / threads), threads, 0,
                  (cudaStream_t)stream>>>((float*)out, (const float*)cnt, C,
                                          cells);
  return (int)cudaGetLastError();
}
