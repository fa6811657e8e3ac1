// K1: 3x3x3 SAME voxel convolution + bias, then GroupNorm with a shared [C]
// or per-cloud [B, C] affine, then an optional swish.
// x [B, R, R, R, Cin] f32, w [3, 3, 3, Cin, Cout] f32 -> y [B, R, R, R, Cout].
//
// Replaces p2p_bridge_tpu/ops/pallas/wconv3d_kernel.py:wconv3d_gn_pallas
// (_conv_fwd, _kernel), with the math of
// p2p_bridge_tpu/ops/pallas/conv3d_kernel.py:_ref_conv and _apply_gn_xla:
// per (cloud, group) statistics over all voxels, variance E[y^2] - m^2.
// It serves every PVConv shape (Cin 35..256, Cout 32..256, r 8..32).
//
// What bounds it on the H100: FLOPs. A PVDS_PUNet forward at 73 patches runs
// about 3.2 TFLOP of these convolutions; this kernel uses the f32 CUDA cores
// (67 TFLOP/s peak), not the tensor cores. The GroupNorm statistics span the
// whole grid of a cloud, i.e. many blocks.
// Design: an implicit GEMM, M = output voxels of one cloud, N = Cout,
// K = 27 * Cin ordered (dx, dy, dz, ci) like the weight. A block computes a
// 64 x 64 tile with 256 threads holding 4 x 4 accumulators each; per K step of
// 16 it stages the gathered input (zero outside the grid: SAME padding) and
// the weight slice in shared memory. The tile never spans two clouds.
// Phase 1 writes y = conv + bias and, per block, one deterministic (sum,
// sum of squares) partial per (cloud, group) - no atomics. Phase 2 reduces the
// partials in double, then normalises y in place, applies the affine and the
// swish. wgmma/TMA and fusing the statistics into phase 1 are later work.
#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
    conv_tile_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, int R, int Cin, int Cout,
                     int groups, float* __restrict__ y,
                     double* __restrict__ partials) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ int vx[BM], vy[BM], vz[BM];
  __shared__ int kdx[BK], kdy[BK], kdz[BK], kci[BK];
  __shared__ float cs[16][BN], cs2[16][BN];

  const int mt = blockIdx.x, nt = blockIdx.y, b = blockIdx.z;
  const int V = R * R * R;
  const int K = 27 * Cin;
  const int m0 = mt * BM, n0 = nt * BN;
  const int tid = threadIdx.x;
  const int tm = tid / 16, tn = tid % 16;
  const float* xb = x + (size_t)b * V * Cin;

  if (tid < BM) {
    const int v = m0 + tid;
    if (v < V) {
      vx[tid] = v / (R * R);
      vy[tid] = (v / R) % R;
      vz[tid] = v % R;
    } else {
      vx[tid] = -4;  // every tap lands outside the grid
      vy[tid] = -4;
      vz[tid] = -4;
    }
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    if (tid < BK) {
      const int k = k0 + tid;
      if (k < K) {
        const int tap = k / Cin;
        kci[tid] = k - tap * Cin;
        kdx[tid] = tap / 9 - 1;
        kdy[tid] = (tap / 3) % 3 - 1;
        kdz[tid] = tap % 3 - 1;
      } else {
        kci[tid] = 0;
        kdx[tid] = -(1 << 20);  // out of the grid: contributes zero
        kdy[tid] = 0;
        kdz[tid] = 0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = tid; e < BM * BK; e += NT) {
      const int kk = e % BK, m = e / BK;
      const int sx = vx[m] + kdx[kk], sy = vy[m] + kdy[kk],
                sz = vz[m] + kdz[kk];
      float val = 0.0f;
      if (sx >= 0 && sx < R && sy >= 0 && sy < R && sz >= 0 && sz < R)
        val = xb[((size_t)(sx * R + sy) * R + sz) * Cin + kci[kk]];
      As[kk][m] = val;
    }
#pragma unroll
    for (int e = tid; e < BK * BN; e += NT) {
      const int nn = e % BN, kk = e / BN;
      const int k = k0 + kk, n = n0 + nn;
      Bs[kk][nn] = (k < K && n < Cout) ? w[(size_t)k * Cout + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][tm * 4]);
      const float4 bb = *reinterpret_cast<const float4*>(&Bs[kk][tn * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* yb = y + (size_t)b * V * Cout;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tn * 4 + j;
    float s = 0.0f, s2 = 0.0f;
    if (n < Cout) {
      const float bn = bias[n];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + tm * 4 + i;
        if (m < V) {
          const float val = acc[i][j] + bn;
          yb[(size_t)m * Cout + n] = val;
          s += val;
          s2 += val * val;
        }
      }
    }
    cs[tm][tn * 4 + j] = s;
    cs2[tm][tn * 4 + j] = s2;
  }
  __syncthreads();

  // one deterministic partial per (cloud, group) for this block; groups the
  // tile does not touch get zeros so phase 2 can sum every slot
  const int gs = Cout / groups;
  const int T = gridDim.x * gridDim.y;
  const int tile = mt * gridDim.y + nt;
  for (int g = tid; g < groups; g += NT) {
    const int lo = max(n0, g * gs), hi = min(min(n0 + BN, (g + 1) * gs), Cout);
    double s = 0.0, s2 = 0.0;
    for (int r = 0; r < 16; ++r)
      for (int n = lo; n < hi; ++n) {
        s += (double)cs[r][n - n0];
        s2 += (double)cs2[r][n - n0];
      }
    double* pp = partials + (((size_t)b * groups + g) * T + tile) * 2;
    pp[0] = s;
    pp[1] = s2;
  }
}

__global__ void gn_stats_kernel(const double* __restrict__ partials, int BG,
                                int T, double count, float eps,
                                float* __restrict__ stats) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= BG) return;
  const double* pp = partials + (size_t)t * T * 2;
  double s = 0.0, s2 = 0.0;
  for (int i = 0; i < T; ++i) {
    s += pp[2 * i];
    s2 += pp[2 * i + 1];
  }
  const double m = s / count;
  const double v = s2 / count - m * m;
  stats[2 * t] = (float)m;
  stats[2 * t + 1] = (float)(1.0 / sqrt(v + (double)eps));
}

__global__ void gn_apply_kernel(float* __restrict__ y,
                                const float* __restrict__ stats,
                                const float* __restrict__ gamma,
                                const float* __restrict__ beta,
                                int affine_stride, int V, int C, int groups,
                                int act, long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int c = (int)(t % C);
  const int b = (int)(t / ((long long)V * C));
  const int g = c / (C / groups);
  const float* st = stats + 2 * ((size_t)b * groups + g);
  float v = (y[t] - st[0]) * st[1];
  v = v * gamma[(size_t)b * affine_stride + c] +
      beta[(size_t)b * affine_stride + c];
  if (act) v = v * (1.0f / (1.0f + expf(-v)));
  y[t] = v;
}

int num_m_tiles(int R) { return (R * R * R + BM - 1) / BM; }
int num_n_tiles(int Cout) { return (Cout + BN - 1) / BN; }

}  // namespace

// Scratch the caller passes: the partials (double) and then the statistics.
P2PB_API long long p2pb_conv3d_gn_scratch_bytes(int B, int R, int Cout,
                                                int groups) {
  const long long T = (long long)num_m_tiles(R) * num_n_tiles(Cout);
  return (long long)B * groups * T * 2 * 8 + (long long)B * groups * 2 * 4;
}

// gamma/beta hold [C] (affine_per_cloud = 0) or [B, C] (= 1).
P2PB_API int p2pb_conv3d_gn(const void* x, const void* w, const void* bias,
                            const void* gamma, const void* beta,
                            int affine_per_cloud, int B, int R, int Cin,
                            int Cout, int groups, float eps, int act, void* y,
                            void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int mtiles = num_m_tiles(R), ntiles = num_n_tiles(Cout);
  const int T = mtiles * ntiles;
  double* partials = (double*)scratch;
  float* stats = (float*)(partials + (size_t)B * groups * T * 2);
  dim3 grid(mtiles, ntiles, B);
  conv_tile_kernel<<<grid, NT, 0, s>>>((const float*)x, (const float*)w,
                                       (const float*)bias, R, Cin, Cout,
                                       groups, (float*)y, partials);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int V = R * R * R;
  const int BG = B * groups;
  gn_stats_kernel<<<(BG + 127) / 128, 128, 0, s>>>(
      partials, BG, T, (double)V * (Cout / groups), eps, stats);
  err = (int)cudaGetLastError();
  if (err) return err;
  const long long total = (long long)B * V * Cout;
  gn_apply_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      (float*)y, stats, (const float*)gamma, (const float*)beta,
      affine_per_cloud ? Cout : 0, V, Cout, groups, act, total);
  return (int)cudaGetLastError();
}
