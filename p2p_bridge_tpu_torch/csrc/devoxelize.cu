// K3: trilinear devoxelization. Grid [B, r, r, r, C] T (f32 or bf16) and
// continuous voxel coordinates [B, N, 3] f32 in [0, r-1] -> [B, N, C] T,
// and optionally the per-channel grid mean [B, C] f32 (the squeeze-excite
// pooling).
//
// Replaces p2p_bridge_tpu/ops/pallas/devox_kernel.py:
// trilinear_devoxelize_pallas (_devox_kernel), with the semantics of
// p2p_bridge_tpu/ops/devoxelize.py: per axis the low corner is floor(c) with
// weight 1 - frac, and the high corner floor(c) + 1 with weight frac only
// when frac > 0 (the CUDA corner rule). Corner weights are f32 products
// (wx * wy) * wz; the sum is f32 and is stored in T. The Pallas kernel
// rounds the xy weights to bf16 for its one-hot MXU contraction; this kernel
// does not.
//
// What bounds it on the H100: memory. Per point it reads at most 8 grid rows
// of C elements and writes one; the mean reads the whole grid once. A
// PVDS_PUNet forward at 73 patches moves a few hundred MB through it.
// Design: the TPU's one-hot matrix product is a way round the TPU's slow
// row gathers and is not ported. Here one warp serves one point, lanes over
// channels, so each corner row is one coalesced read and the output row one
// coalesced write; a corner whose weight is 0 is not read. Products and sums
// are rounded one by one (__fmul_rn / __fadd_rn) in the plain version's
// order, so f32 results match it bit for bit. The mean is deterministic with
// no atomics: blocks of (cloud, channel chunk, voxel segment) sum in double
// into partials, and a second pass adds the segments in order.
#include "common.cuh"

namespace {

constexpr int SEG = 4096;  // voxels per mean partial

template <typename T>
__global__ void devox_kernel(const T* __restrict__ grid,
                             const float* __restrict__ coords, int B, int N,
                             int r, int C, T* __restrict__ out) {
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= (long long)B * N) return;  // uniform across the warp
  const int b = (int)(w / N);

  int lo[3], step[3];
  float wlo[3], whi[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float c = coords[3 * w + d];
    const float f = floorf(c);
    const float frac = __fsub_rn(c, f);
    lo[d] = (int)f;
    step[d] = frac > 0.0f ? 1 : 0;
    wlo[d] = __fsub_rn(1.0f, frac);
    whi[d] = step[d] ? frac : 0.0f;
  }

  // corners in the plain version's order: x outer, z inner
  const T* rows[8];
  float wts[8];
  const T* gb = grid + (size_t)b * r * r * r * C;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int cx = k >> 2, cy = (k >> 1) & 1, cz = k & 1;
    const int ix = lo[0] + (cx ? step[0] : 0);
    const int iy = lo[1] + (cy ? step[1] : 0);
    const int iz = lo[2] + (cz ? step[2] : 0);
    wts[k] = __fmul_rn(__fmul_rn(cx ? whi[0] : wlo[0], cy ? whi[1] : wlo[1]),
                       cz ? whi[2] : wlo[2]);
    rows[k] = gb + ((size_t)(ix * r + iy) * r + iz) * C;
  }

  T* o = out + (size_t)w * C;
  for (int c = lane; c < C; c += 32) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (wts[k] != 0.0f)
        acc = __fadd_rn(acc, __fmul_rn(wts[k], p2pb::to_f32(rows[k][c])));
    o[c] = p2pb::from_f32<T>(acc);
  }
}

// grid (ceil(C / 32), segments, B), block (32, 8): partial sums in double
template <typename T>
__global__ void mean_partial_kernel(const T* __restrict__ grid, int V, int C,
                                    double* __restrict__ partials) {
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int seg = blockIdx.y, b = blockIdx.z;
  const int v0 = seg * SEG, v1 = min(V, v0 + SEG);
  double s = 0.0;
  if (c < C) {
    const T* g = grid + (size_t)b * V * C + c;
    for (int v = v0 + threadIdx.y; v < v1; v += 8)
      s += (double)p2pb::to_f32(g[(size_t)v * C]);
  }
  __shared__ double part[8][33];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    double t = 0.0;
    for (int i = 0; i < 8; ++i) t += part[i][threadIdx.x];
    partials[((size_t)b * gridDim.y + seg) * C + c] = t;
  }
}

__global__ void mean_final_kernel(const double* __restrict__ partials, int B,
                                  int segments, int V, int C,
                                  float* __restrict__ mean) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * C) return;
  const int b = t / C, c = t - b * C;
  double s = 0.0;
  for (int i = 0; i < segments; ++i)
    s += partials[((size_t)b * segments + i) * C + c];
  mean[t] = (float)(s / V);
}

int num_segments(int r) { return (r * r * r + SEG - 1) / SEG; }

template <typename T>
int devoxelize(const void* grid, const void* coords, int B, int N, int r,
               int C, void* out, void* mean, void* scratch, cudaStream_t s) {
  const int threads = 256;  // 8 points per block
  const long long warps = (long long)B * N;
  devox_kernel<T><<<(unsigned)((warps * 32 + threads - 1) / threads), threads,
                    0, s>>>((const T*)grid, (const float*)coords, B, N, r, C,
                            (T*)out);
  int err = (int)cudaGetLastError();
  if (err || !mean) return err;
  const int V = r * r * r, segs = num_segments(r);
  mean_partial_kernel<T><<<dim3((C + 31) / 32, segs, B), dim3(32, 8), 0, s>>>(
      (const T*)grid, V, C, (double*)scratch);
  err = (int)cudaGetLastError();
  if (err) return err;
  mean_final_kernel<<<(B * C + 255) / 256, 256, 0, s>>>(
      (const double*)scratch, B, segs, V, C, (float*)mean);
  return (int)cudaGetLastError();
}

}  // namespace

// Scratch for the mean's partials (0 without the mean).
P2PB_API long long p2pb_devoxelize_scratch_bytes(int B, int r, int C) {
  return (long long)B * num_segments(r) * C * 8;
}

// grid and out are bf16 when bf16 = 1, else f32; mean (f32 [B, C]) may be
// null, and then scratch is not used.
P2PB_API int p2pb_trilinear_devoxelize(const void* grid, const void* coords,
                                       int B, int N, int r, int C, int bf16,
                                       void* out, void* mean, void* scratch,
                                       int device, void* stream) {
  P2PB_ON_DEVICE(device);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return devoxelize<p2pb::bf16>(grid, coords, B, N, r, C, out, mean, scratch,
                                  s);
  return devoxelize<float>(grid, coords, B, N, r, C, out, mean, scratch, s);
}
