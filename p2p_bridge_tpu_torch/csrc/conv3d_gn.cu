// K1: 3x3x3 SAME voxel convolution + bias, then GroupNorm with a shared [C]
// or per-cloud [B, C] affine, then an optional swish.
// x [B, R, R, R, Cin] T, w [3, 3, 3, Cin, Cout] T -> y [B, R, R, R, Cout] T,
// T f32 or bf16; bias, gamma and beta f32.
//
// Replaces p2p_bridge_tpu/ops/pallas/wconv3d_kernel.py:wconv3d_gn_pallas
// (_conv_fwd, _kernel), with the math of
// p2p_bridge_tpu/ops/pallas/conv3d_kernel.py:_ref_conv and _apply_gn_xla:
// per (cloud, group) statistics over all voxels, variance E[y^2] - m^2.
// It serves every PVConv shape (Cin 35..256, Cout 32..256, r 8..32).
//
// What bounds it on the H100: FLOPs. A PVDS_PUNet forward at 73 patches runs
// about 3.2 TFLOP of these convolutions: 48 ms at the 67 TFLOP/s of the f32
// CUDA cores, 3.2 ms at the 989 TFLOP/s of the bf16 tensor cores. The
// GroupNorm statistics span the whole grid of a cloud, i.e. many blocks.
// Design: an implicit GEMM, M = output voxels of one cloud, N = Cout,
// K = 27 * Cin ordered (dx, dy, dz, ci) like the weight. A block computes a
// 64 x 64 tile and never spans two clouds; per K step it stages the gathered
// input (zero outside the grid: SAME padding) and the weight slice in shared
// memory.
//  * f32 (conv_tile_kernel): 256 threads with 4 x 4 f32 FMA accumulators,
//    K steps of 16.
//  * bf16 (conv_mma_kernel): 4 warps of 32 x 32 each on the tensor cores
//    (mma.sync m16n8k16, bf16 in, f32 accumulate), K steps of 32; where Cin
//    is a multiple of 32 a K step is one tap and the input rows load as
//    16-byte vectors; weight rows always do (Cout a multiple of 8).
// Phase 1 writes the f32 y = conv + bias and, per block, one deterministic
// (sum, sum of squares) partial per (cloud, group) - no atomics - so the
// statistics come from the f32 values before any bf16 rounding, as the TPU
// epilogue takes them. Phase 2 reduces the partials in double; phase 3
// normalises, applies the affine and the swish in f32 and stores T: in
// place for f32, from an f32 scratch grid into the bf16 output for bf16.
// A pipelined wgmma/TMA main loop and fusing the statistics into phase 1
// are later work.
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
  const int tiles = gridDim.x * gridDim.y;
  const int tile = mt * gridDim.y + nt;
  for (int g = tid; g < groups; g += NT) {
    const int lo = max(n0, g * gs), hi = min(min(n0 + BN, (g + 1) * gs), Cout);
    double s = 0.0, s2 = 0.0;
    for (int r = 0; r < 16; ++r)
      for (int n = lo; n < hi; ++n) {
        s += (double)cs[r][n - n0];
        s2 += (double)cs2[r][n - n0];
      }
    double* pp = partials + (((size_t)b * groups + g) * tiles + tile) * 2;
    pp[0] = s;
    pp[1] = s2;
  }
}


// ---- bf16: tensor cores ----------------------------------------------------
constexpr int TBK = 32;        // K step
constexpr int TNT = 128;       // 4 warps, 2 x 2 over the 64 x 64 tile
constexpr int LDS = TBK + 8;   // padded shared row (80 bytes, 16-byte aligned)

// D += A (16 x 16, row-major) * B (16 x 8, k-major per column), bf16 in,
// f32 accumulate. Fragments per lane (g = lane / 4, t = lane % 4): a holds
// A[g][2t..], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]; b holds
// B[2t..][g], B[2t+8..][g]; d holds D[g][2t, 2t+1], D[g+8][2t, 2t+1].
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_pair(const p2pb::bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(TNT)
    conv_mma_kernel(const p2pb::bf16* __restrict__ x,
                    const p2pb::bf16* __restrict__ w,
                    const float* __restrict__ bias, int R, int Cin, int Cout,
                    int groups, float* __restrict__ y,
                    double* __restrict__ partials) {
  using p2pb::bf16;
  __shared__ __align__(16) bf16 As[BM][LDS];  // [voxel][k]
  __shared__ __align__(16) bf16 Bs[BN][LDS];  // [out channel][k]
  __shared__ int vx[BM], vy[BM], vz[BM];
  __shared__ int kdx[TBK], kdy[TBK], kdz[TBK], kci[TBK];
  __shared__ float cs[2][BN], cs2[2][BN];

  const int mt = blockIdx.x, nt = blockIdx.y, b = blockIdx.z;
  const int V = R * R * R;
  const int K = 27 * Cin;
  const int m0 = mt * BM, n0 = nt * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const bf16* xb = x + (size_t)b * V * Cin;
  const bf16 zero = p2pb::from_f32<bf16>(0.0f);
  const bool vec_a = Cin % TBK == 0;  // a K step is one tap

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
  __syncthreads();

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += TBK) {
    if (vec_a) {
      const int tap = k0 / Cin, ci0 = k0 - tap * Cin;
      const int dx = tap / 9 - 1, dy = (tap / 3) % 3 - 1, dz = tap % 3 - 1;
      for (int e = tid; e < BM * (TBK / 8); e += TNT) {
        const int m = e / (TBK / 8), c = (e % (TBK / 8)) * 8;
        const int sx = vx[m] + dx, sy = vy[m] + dy, sz = vz[m] + dz;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (sx >= 0 && sx < R && sy >= 0 && sy < R && sz >= 0 && sz < R)
          v = *reinterpret_cast<const uint4*>(
              xb + ((size_t)(sx * R + sy) * R + sz) * Cin + ci0 + c);
        *reinterpret_cast<uint4*>(&As[m][c]) = v;
      }
    } else {
      // ragged Cin (35): decode the step's 32 taps once, then gather
      if (tid < TBK) {
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
      for (int e = tid; e < BM * TBK; e += TNT) {
        const int kk = e % TBK, m = e / TBK;
        const int sx = vx[m] + kdx[kk], sy = vy[m] + kdy[kk], sz = vz[m] + kdz[kk];
        bf16 v = zero;
        if (sx >= 0 && sx < R && sy >= 0 && sy < R && sz >= 0 && sz < R)
          v = xb[((size_t)(sx * R + sy) * R + sz) * Cin + kci[kk]];
        As[m][kk] = v;
      }
    }
    // weight rows as 16-byte vectors of 8 output channels (Cout % 8 == 0)
    for (int e = tid; e < TBK * (BN / 8); e += TNT) {
      const int kk = e / (BN / 8), nn = (e % (BN / 8)) * 8;
      const int k = k0 + kk, n = n0 + nn;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k < K && n < Cout)
        v = *reinterpret_cast<const uint4*>(w + (size_t)k * Cout + n);
      const bf16* h = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) Bs[nn + i][kk] = h[i];
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < TBK; ks += 16) {
      uint32_t a[2][4], bq[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 32 + i * 16 + g;
        a[i][0] = ld_pair(&As[r][ks + 2 * t]);
        a[i][1] = ld_pair(&As[r + 8][ks + 2 * t]);
        a[i][2] = ld_pair(&As[r][ks + 2 * t + 8]);
        a[i][3] = ld_pair(&As[r + 8][ks + 2 * t + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn * 32 + j * 8 + g;
        bq[j][0] = ld_pair(&Bs[c][ks + 2 * t]);
        bq[j][1] = ld_pair(&Bs[c][ks + 2 * t + 8]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], bq[j]);
    }
    __syncthreads();
  }

  // y = acc + bias, and the column sums of this warp's 32 rows; the 8 lanes
  // of one t hold the same columns, so three xor-shuffles over g sum them
  float* yb = y + (size_t)b * V * Cout;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int nl = wn * 32 + j * 8 + 2 * t + h, n = n0 + nl;
      float s = 0.0f, s2 = 0.0f;
      if (n < Cout) {
        const float bn = bias[n];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = m0 + wm * 32 + i * 16 + g + 8 * half;
            if (m < V) {
              const float val = acc[i][j][2 * half + h] + bn;
              yb[(size_t)m * Cout + n] = val;
              s += val;
              s2 += val * val;
            }
          }
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      if (g == 0) {
        cs[wm][nl] = s;
        cs2[wm][nl] = s2;
      }
    }
  __syncthreads();

  const int gs = Cout / groups;
  const int tiles = gridDim.x * gridDim.y;
  const int tile = mt * gridDim.y + nt;
  for (int gi = tid; gi < groups; gi += TNT) {
    const int lo = max(n0, gi * gs), hi = min(min(n0 + BN, (gi + 1) * gs), Cout);
    double s = 0.0, s2 = 0.0;
    for (int r = 0; r < 2; ++r)
      for (int n = lo; n < hi; ++n) {
        s += (double)cs[r][n - n0];
        s2 += (double)cs2[r][n - n0];
      }
    double* pp = partials + (((size_t)b * groups + gi) * tiles + tile) * 2;
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

// src and dst alias for f32 (in place); blockIdx.y is the cloud
template <typename T>
__global__ void gn_apply_kernel(const float* src, T* dst,
                                const float* __restrict__ stats,
                                const float* __restrict__ gamma,
                                const float* __restrict__ beta,
                                int affine_stride, int VC, int C, int groups,
                                int act) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= VC) return;
  const int b = blockIdx.y;
  const size_t i = (size_t)b * VC + t;
  const int c = t % C;
  const int g = c / (C / groups);
  const float* st = stats + 2 * ((size_t)b * groups + g);
  float v = (src[i] - st[0]) * st[1];
  v = v * gamma[(size_t)b * affine_stride + c] +
      beta[(size_t)b * affine_stride + c];
  if (act) v = v * (1.0f / (1.0f + expf(-v)));
  dst[i] = p2pb::from_f32<T>(v);
}

int num_m_tiles(int R) { return (R * R * R + BM - 1) / BM; }
int num_n_tiles(int Cout) { return (Cout + BN - 1) / BN; }

// Scratch the caller passes: the partials (double), the statistics and, for
// bf16, the f32 pre-norm grid at a 256-byte aligned offset.
long long f32_grid_offset(int B, int R, int Cout, int groups) {
  const long long T = (long long)num_m_tiles(R) * num_n_tiles(Cout);
  const long long bytes =
      (long long)B * groups * T * 2 * 8 + (long long)B * groups * 2 * 4;
  return (bytes + 255) / 256 * 256;
}

template <typename T>
int conv3d_gn(const void* x, const void* w, const void* bias,
              const void* gamma, const void* beta, int affine_per_cloud, int B,
              int R, int Cin, int Cout, int groups, float eps, int act,
              void* y, void* scratch, cudaStream_t s) {
  const int mtiles = num_m_tiles(R), ntiles = num_n_tiles(Cout);
  const int Tn = mtiles * ntiles;
  double* partials = (double*)scratch;
  float* stats = (float*)(partials + (size_t)B * groups * Tn * 2);
  float* yf = sizeof(T) == 4
                  ? (float*)y
                  : (float*)((char*)scratch +
                             f32_grid_offset(B, R, Cout, groups));
  dim3 grid(mtiles, ntiles, B);
  if (sizeof(T) == 4)
    conv_tile_kernel<<<grid, NT, 0, s>>>((const float*)x, (const float*)w,
                                         (const float*)bias, R, Cin, Cout,
                                         groups, yf, partials);
  else
    conv_mma_kernel<<<grid, TNT, 0, s>>>((const p2pb::bf16*)x,
                                         (const p2pb::bf16*)w,
                                         (const float*)bias, R, Cin, Cout,
                                         groups, yf, partials);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int V = R * R * R;
  const int BG = B * groups;
  gn_stats_kernel<<<(BG + 127) / 128, 128, 0, s>>>(
      partials, BG, Tn, (double)V * (Cout / groups), eps, stats);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int VC = V * Cout;
  gn_apply_kernel<T><<<dim3((VC + 255) / 256, B), 256, 0, s>>>(
      yf, (T*)y, stats, (const float*)gamma, (const float*)beta,
      affine_per_cloud ? Cout : 0, VC, Cout, groups, act);
  return (int)cudaGetLastError();
}

}  // namespace

P2PB_API long long p2pb_conv3d_gn_scratch_bytes(int B, int R, int Cout,
                                                int groups, int bf16) {
  const long long off = f32_grid_offset(B, R, Cout, groups);
  return bf16 ? off + (long long)B * R * R * R * Cout * 4 : off;
}

// gamma/beta hold [C] (affine_per_cloud = 0) or [B, C] (= 1); x, w and y
// are bf16 when bf16 = 1, else f32.
P2PB_API int p2pb_conv3d_gn(const void* x, const void* w, const void* bias,
                            const void* gamma, const void* beta,
                            int affine_per_cloud, int B, int R, int Cin,
                            int Cout, int groups, float eps, int act, int bf16,
                            void* y, void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return conv3d_gn<p2pb::bf16>(x, w, bias, gamma, beta, affine_per_cloud, B,
                                 R, Cin, Cout, groups, eps, act, y, scratch, s);
  return conv3d_gn<float>(x, w, bias, gamma, beta, affine_per_cloud, B, R, Cin,
                          Cout, groups, eps, act, y, scratch, s);
}
