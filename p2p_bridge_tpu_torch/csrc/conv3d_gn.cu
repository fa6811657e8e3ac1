// K1: 3x3x3 SAME voxel convolution + bias, then GroupNorm with a shared [C]
// or per-cloud [B, C] affine, then an optional swish.
// x [B, R, R, R, Cin] T, w [3, 3, 3, Cin, Cout] T -> y [B, R, R, R, Cout] T,
// T f32 or bf16; bias, gamma and beta f32.
//
// Replaces p2p_bridge_tpu/ops/pallas/wconv3d_kernel.py:wconv3d_gn_pallas
// (_conv_fwd, _kernel), with the math of
// p2p_bridge_tpu/ops/pallas/conv3d_kernel.py:_ref_conv and _apply_gn_xla:
// per (cloud, group) statistics over all voxels from the f32 accumulator,
// variance E[y^2] - m^2. It serves every PVConv shape of the shipped
// configs (Cin 35..512, Cout 32..512, r 8..32).
//
// What bounds it on the H100: operations. A PVDS_PUNet forward at 73
// patches runs 3.2 TFLOP of these convolutions: 3.2 ms at the 989 TFLOP/s of
// the bf16 tensor cores, 48 ms at the 67 TFLOP/s of the f32 CUDA cores. The
// GroupNorm statistics span the whole grid of a cloud, i.e. many blocks.
// Both paths are an implicit GEMM per cloud: M = voxels, N = Cout,
// K = 27 * Cin ordered (dx, dy, dz, ci) like the weight; a tile never spans
// two clouds.
//
// bf16 (conv_wgmma_kernel), the path PVDS_PUNet runs as shipped:
//  * a tile is 128 or 256 consecutive voxels of one cloud x N channels,
//    N the widest of 256, 128, 64, 32 that divides Cout (N = Cout up to
//    256: no idle lane; Cout = 512 takes two tiles of 256), a box of the 5-D
//    input: (1, 1, 4, 32) at r = 32, (1, 1, 8, 16) at r = 16, (1, 2, 8, 8) at
//    r = 8 for 128 voxels. The A operand of tap (dx, dy, dz) is that box
//    shifted by the tap. TMA loads it in tiled mode (signed coordinates,
//    out-of-bounds elements zero-filled), so SAME padding costs no masks
//    and no thread time; and it loads the box once with a one-voxel halo
//    in y, whose three row ranges (whole 8-row swizzle groups apart) are
//    the A tiles of the three dy taps: half or less of the A traffic of
//    one box per tap. The wrapper pads Cin to a multiple of 32 with zero channels
//    (TMA wants 16-byte rows; 35 -> 64) and passes the weight as
//    [dx, dz, dy, Cout, Cin], so the K-major B tiles of the three dy taps
//    of a k-chunk are one more TMA box (K-major like A: both operands take
//    one descriptor form, for a per-call copy of the small weight);
//  * a ring of stages (that input box + three weight tiles, k-chunks of 64
//    channels where they fit, else 32, rows swizzled by their width) in
//    dynamic shared memory with a full and an empty mbarrier each. One
//    producer thread keeps the TMA loads in flight; two consumer
//    warpgroups issue wgmma.mma_async m64nNk16 (bf16 in, f32 accumulate)
//    from shared memory, each on one or two 64-row blocks: two independent
//    accumulator chains keep the tensor cores busier than one where the
//    registers allow it (N <= 128) and the card still gets four tiles a
//    block; they keep one group of MMAs in flight and hand a stage back
//    when the MMAs reading it are done;
//  * persistent blocks, one per block slot of the card, walk the tiles
//    cloud-major (the blocks in flight share a cloud's input in L2), and
//    the ring runs on across tiles, so a tile's epilogue overlaps the next
//    one's loads;
//  * epilogue: bias added in f32; each tile's (sum, sum of squares) per
//    slot of N / 8 channels from the f32 registers (shuffles, then a fixed
//    order over the eight warps), one deterministic partial per (cloud,
//    slot, tile), no atomics; a GroupNorm group is one or more whole
//    slots; the pre-norm grid stored in bf16 straight into the output,
//    as the TPU kernel stages it in the compute dtype.
// f32 (conv_tile_kernel): 64 x 64 tiles of 256 threads with 4 x 4 f32 FMA
// accumulators, K steps of 16, the f32 pre-norm grid written in place.
// Then gn_stats_kernel reduces the partials in double and the apply pass
// normalises, applies the affine and the swish in f32 and stores T, in
// place (the bf16 pass with 16-byte vectors of 8 channels).
#include "common.cuh"
#include "hopper.cuh"

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



// ---- bf16: TMA + wgmma -----------------------------------------------------
constexpr int WTHREADS = 2 * 128 + 32;  // two consumer warpgroups + a producer warp
constexpr int MAX_STAGES = 8;
constexpr int SLOTS = 8;                // GroupNorm partials a tile: N / 8 channels each
constexpr int MAX_DEVICES = 16;         // cards whose launch state is cached

template <int N, int CK, int MB>
__global__ void __launch_bounds__(WTHREADS, N <= 64 && MB == 1 ? 2 : 1)
    conv_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const float* __restrict__ bias, int B, int R, int Cin,
                      int Cout, int zb, int yb, int stages, p2pb::bf16* __restrict__ y,
                      double* __restrict__ partials) {
  using namespace p2pb;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  __shared__ float red[8][SLOTS][2];

  // the swizzled tiles want 1024-byte aligned stages
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // a stage: the input box with a y halo, [x][y - 1 .. y + yb][z][CK], and
  // the [N, CK] weight slices of the three dy taps
  constexpr int BM = 128 * MB;  // voxels of a tile: MB row blocks of 64 a warpgroup
  constexpr int ROW = CK * 2;   // bytes of one row of a tile
  const int a_bytes = BM / yb * (yb + 2) * ROW, b_bytes = N * ROW;
  uint8_t* As = smem;
  uint8_t* Bs = smem + stages * a_bytes;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int T = R * R * R / BM;  // voxel tiles of a cloud
  const int CT = Cout / N;       // channel tiles, the fastest in the walk
  const int chunks = Cin / CK, steps = 9 * chunks;  // (dx, dz, k-chunk)

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // persistent: block i takes tiles i, i + gridDim.x, ... (cloud-major, so
  // the blocks in flight share a cloud's input in L2, and the channel tiles
  // of one voxel tile its input box); the ring runs on across tiles, so the
  // next tile's loads overlap this one's epilogue
  if (warp == 8) {
    // producer: one thread walks the K steps, up to `stages` ahead
    if (lane == 0) {
      int k = 0;
      for (int tl = blockIdx.x; tl < B * T * CT; tl += gridDim.x) {
        const int b = tl / (T * CT), v0 = (tl / CT - b * T) * BM, n0 = (tl % CT) * N;
        const int x0 = v0 / (R * R), y0 = (v0 / R) % R, z0 = v0 % R;
        for (int st = 0; st < steps; ++st, ++k) {
          const int s = k % stages;
          mbar_wait(&empty[s], ((k / stages) & 1) ^ 1);
          const int dxz = st / chunks, ci0 = (st - dxz * chunks) * CK;
          mbar_arrive_expect_tx(&full[s], a_bytes + 3 * b_bytes);
          tma_load_5d(As + s * a_bytes, &xmap, &full[s], ci0, z0 + dxz % 3 - 1, y0 - 1,
                      x0 + dxz / 3 - 1, b);
          tma_load_4d(Bs + s * 3 * b_bytes, &wmap, &full[s], ci0, n0, 0, dxz);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg computes the row blocks MB wg + c (c < MB) of
  // 64 rows each, with an accumulator chain each. A block lies in one x
  // plane: (z', y', x') of its first row give where it starts in the halo
  // box for dy = -1; dy = 0 and +1 start zb rows on
  const int wg = warp >> 2;
  int halo[MB];
#pragma unroll
  for (int c = 0; c < MB; ++c) {
    const int m = 64 * (MB * wg + c);
    halo[c] = m % zb + zb * ((m / zb) % yb + (yb + 2) * (m / (zb * yb)));
  }
  int k = 0;
  for (int tl = blockIdx.x; tl < B * T * CT; tl += gridDim.x) {
    const int b = tl / (T * CT), tile = tl / CT - b * T, nt = tl % CT;
    float acc[MB][N / 2];
#pragma unroll
    for (int c = 0; c < MB; ++c)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[c][i] = 0.0f;
    for (int st = 0; st < steps; ++st, ++k) {
      const int s = k % stages;
      mbar_wait(&full[s], (k / stages) & 1);
      const uint8_t* a = As + s * a_bytes;
      const uint8_t* bq = Bs + s * 3 * b_bytes;
      wgmma_fence();
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const uint64_t db = wgmma_desc(bq + dy * b_bytes, ROW);
#pragma unroll
        for (int kk = 0; kk < CK / 16; ++kk)
#pragma unroll
          for (int c = 0; c < MB; ++c)
            Wgmma<N>::run(acc[c], wgmma_desc(a + (halo[c] + dy * zb) * ROW, ROW) + 2 * kk,
                          db + 2 * kk);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the MMAs of the step before are done: free its stage
      if (st > 0 && lane == 0) mbar_arrive(&empty[(k - 1) % stages]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < MB; ++c) wgmma_fence_regs(acc[c]);
    if (lane == 0) mbar_arrive(&empty[(k - 1) % stages]);

    // epilogue: y = acc + bias in f32; bf16 store; per-slot sums. Lane
    // (g8, t) holds rows g8 and g8 + 8 of its warp's 16, columns 8j + 2t, +1.
    constexpr int GS = N / SLOTS;                  // channels per slot
    constexpr int NSLOT = GS >= 8 ? SLOTS : N / 8;  // slots a lane touches
    const int g8 = lane >> 2, t = lane & 3;
    bf16* yt = y + ((size_t)b * R * R * R + (size_t)tile * BM) * Cout + nt * N;
    const float* bt = bias + nt * N;
    float s1[NSLOT], s2[NSLOT];
#pragma unroll
    for (int i = 0; i < NSLOT; ++i) s1[i] = s2[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < MB; ++c) {
      const int row = 64 * (MB * wg + c) + (warp & 3) * 16 + g8;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float b0 = __ldg(bt + col), b1 = __ldg(bt + col + 1);
        const int sl = GS >= 8 ? j / (GS / 8) : j;  // GS = 4: slot 2j + t / 2
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v0 = acc[c][4 * j + 2 * h] + b0, v1 = acc[c][4 * j + 2 * h + 1] + b1;
          s1[sl] += v0 + v1;
          s2[sl] += v0 * v0 + v1 * v1;
          *reinterpret_cast<__nv_bfloat162*>(yt + (size_t)(row + 8 * h) * Cout + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    // sum over the warp's rows (lane bits 2-4) and the lanes of one slot
    // (bit 0, and bit 1 unless GS = 4 splits a column block in two slots)
#pragma unroll
    for (int i = 0; i < NSLOT; ++i) {
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        if (GS < 8 && o == 2) continue;
        s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], o);
        s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], o);
      }
    }
    if (GS >= 8 ? lane == 0 : (lane == 0 || lane == 2)) {
#pragma unroll
      for (int i = 0; i < NSLOT; ++i) {
        const int g = GS >= 8 ? i : 2 * i + (lane >> 1);
        red[warp][g][0] = s1[i];
        red[warp][g][1] = s2[i];
      }
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the two consumer warpgroups
    if (tid < SLOTS) {
      double s = 0.0, q = 0.0;
      for (int w = 0; w < 8; ++w) {
        s += (double)red[w][tid][0];
        q += (double)red[w][tid][1];
      }
      // [cloud][slot of the cloud][tile]: a group's partials are contiguous
      double* pp = partials + (((size_t)b * SLOTS * CT + nt * SLOTS + tid) * T + tile) * 2;
      pp[0] = s;
      pp[1] = q;
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // red is free again
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

__device__ __forceinline__ float normalise(float v, const float* st, float g,
                                           float be, int act) {
  v = (v - st[0]) * st[1];
  v = v * g + be;
  return act ? v * (1.0f / (1.0f + expf(-v))) : v;
}

// f32, in place; blockIdx.y is the cloud
__global__ void gn_apply_kernel(float* y, const float* __restrict__ stats,
                                const float* __restrict__ gamma,
                                const float* __restrict__ beta,
                                int affine_stride, int VC, int C, int groups,
                                int act) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= VC) return;
  const int b = blockIdx.y;
  const size_t i = (size_t)b * VC + t;
  const int c = t % C;
  const size_t a = (size_t)b * affine_stride + c;
  y[i] = normalise(y[i], stats + 2 * ((size_t)b * groups + c / (C / groups)),
                   gamma[a], beta[a], act);
}

// bf16, in place, 8 channels (16 bytes) a thread; C % 8 == 0
__global__ void gn_apply_bf16_kernel(p2pb::bf16* y, const float* __restrict__ stats,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ beta,
                                     int affine_stride, int VC8, int C, int groups,
                                     int act) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= VC8) return;
  const int b = blockIdx.y;
  uint4* p = reinterpret_cast<uint4*>(y) + (size_t)b * VC8 + t;
  uint4 v = *p;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
  const int c0 = (t * 8) % C, gs = C / groups;
  const float* st = stats + 2 * (size_t)b * groups;
  const float* ga = gamma + (size_t)b * affine_stride;
  const float* be = beta + (size_t)b * affine_stride;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    const int c = c0 + 2 * i;
    h[i] = __floats2bfloat162_rn(
        normalise(f.x, st + 2 * (c / gs), ga[c], be[c], act),
        normalise(f.y, st + 2 * ((c + 1) / gs), ga[c + 1], be[c + 1], act));
  }
  *p = v;
}

// ---- host ------------------------------------------------------------------
// the bf16 kernel's channel tile: the widest of 256, 128, 64, 32 that divides Cout
int n_tile(int Cout) {
  int n = 256;
  while (n > 32 && Cout % n) n /= 2;
  return n;
}

// partials of one (cloud, group): the bf16 kernel writes one per voxel tile
// and slot of N / 8 channels (the most: 128-voxel tiles), the f32 kernel one
// per 64 x 64 block
int partials_per_group(int R, int Cout, int groups, int bf16) {
  if (bf16) return Cout / groups / (n_tile(Cout) / SLOTS) * (R * R * R / 128);
  return ((R * R * R + BM - 1) / BM) * ((Cout + BN - 1) / BN);
}

// scratch: the partials (double), then the statistics (f32)
long long scratch_bytes(int B, int R, int Cout, int groups, int bf16) {
  return (long long)B * groups * partials_per_group(R, Cout, groups, bf16) * 2 * 8 +
         (long long)B * groups * 2 * 4;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// bf16 tile of `rank` dims (innermost first), zero fill out of bounds,
// swizzled by the inner box row (64 or 128 bytes: k-chunks of 32 or 64)
bool tensor_map(CUtensorMap* map, const void* base, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides,
                const cuuint32_t* box) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUtensorMapSwizzle sw =
      box[0] == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
             dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the 128 MB voxels of a tile as a box: z fastest, then y, then x
struct Box {
  int zb, yb, xb;
  Box(int R, int bm) : zb(R < bm ? R : bm), yb(R < bm / zb ? R : bm / zb), xb(bm / (zb * yb)) {}
  int halo_rows() const { return zb * (yb + 2) * xb; }  // with a y halo
};

// shared memory of one block: two blocks an SM for N <= 64 with MB = 1
int smem_budget(int N, int MB) { return (N <= 64 && MB == 1 ? 110 : 225) * 1024; }

int stage_bytes(int R, int N, int CK, int MB) {
  return (Box(R, 128 * MB).halo_rows() + 3 * N) * CK * 2;
}

// SMs of the current card, read once per card
int current_card(int* dev, int* sms) {
  static int sms_of[MAX_DEVICES];
  int err = (int)cudaGetDevice(dev);
  if (err) return err;
  if (*dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!sms_of[*dev])
    err = (int)cudaDeviceGetAttribute(&sms_of[*dev], cudaDevAttrMultiProcessorCount, *dev);
  *sms = sms_of[*dev];
  return err;
}

template <int N, int CK, int MB>
int launch_wgmma(const void* x, const void* wt, const float* bias, int B, int R, int Cin,
                 int Cout, int dev, int sms, p2pb::bf16* y, double* partials,
                 cudaStream_t s) {
  const Box box(R, 128 * MB);
  const int stage = stage_bytes(R, N, CK, MB);
  int stages = smem_budget(N, MB) / stage;
  stages = stages > MAX_STAGES ? MAX_STAGES : stages;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[5] = {(cuuint64_t)Cin, (cuuint64_t)R, (cuuint64_t)R,
                               (cuuint64_t)R, (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)Cin * 2;
  const cuuint64_t xstrides[4] = {row, row * R, row * R * R, row * R * R * R};
  const cuuint32_t xbox[5] = {CK, (cuuint32_t)box.zb, (cuuint32_t)box.yb + 2,
                              (cuuint32_t)box.xb, 1};
  // w [dx, dz][dy][Cout][Cin]: one box holds the three dy slices of a chunk
  // for the N channels of a tile
  const cuuint64_t wdims[4] = {(cuuint64_t)Cin, (cuuint64_t)Cout, 3, 9};
  const cuuint64_t wstrides[3] = {row, row * Cout, row * Cout * 3};
  const cuuint32_t wbox[4] = {CK, (cuuint32_t)N, 3, 1};
  if (!tensor_map(&xmap, x, 5, xdims, xstrides, xbox) ||
      !tensor_map(&wmap, wt, 4, wdims, wstrides, wbox))
    return (int)cudaErrorInvalidValue;
  const int smem = stages * stage + 1024;
  auto kernel = conv_wgmma_kernel<N, CK, MB>;
  // once per card: the shared-memory limit (the budget), and the blocks an
  // SM holds at each R (R sets the stage size, so the shared memory)
  static bool limit_set[MAX_DEVICES];
  static int per_sm_at[MAX_DEVICES][32];
  int err = 0;
  if (!limit_set[dev]) {
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    smem_budget(N, MB) + 1024);
    if (err) return err;
    limit_set[dev] = true;
  }
  int& per_sm = per_sm_at[dev][__builtin_ctz(R)];
  if (!per_sm)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WTHREADS, smem);
  if (err) return err;
  // one persistent block for each block slot of the card
  const int tiles = B * (R * R * R / (128 * MB)) * (Cout / N);
  const int grid = tiles < sms * per_sm ? tiles : sms * per_sm;
  kernel<<<grid, WTHREADS, smem, s>>>(xmap, wmap, bias, B, R, Cin, Cout, box.zb, box.yb,
                                      stages, y, partials);
  return (int)cudaGetLastError();
}

// Row blocks: two a warpgroup (256-voxel tiles, two accumulator chains)
// where N <= 128 and the card still gets four tiles a block slot, else one.
// k-chunks: 64 channels where Cin allows and three stages fit in the
// block's shared memory, else 32.
template <int N>
int launch_n(const void* x, const void* wt, const float* bias, int B, int R, int Cin,
             int Cout, p2pb::bf16* y, double* partials, int* tiles, cudaStream_t s) {
  int dev = 0, sms = 0;
  const int err = current_card(&dev, &sms);
  if (err) return err;
  const int MB = N <= 128 && B * (R * R * R / 256) * (Cout / N) >= 4 * sms ? 2 : 1;
  *tiles = R * R * R / (128 * MB);
  const int CK = Cin % 64 == 0 && smem_budget(N, MB) / stage_bytes(R, N, 64, MB) >= 3 ? 64 : 32;
#define P2PB_LAUNCH(ck, mb) \
  if (CK == ck && MB == mb) \
    return launch_wgmma<N, ck, mb>(x, wt, bias, B, R, Cin, Cout, dev, sms, y, partials, s);
  P2PB_LAUNCH(64, 1) P2PB_LAUNCH(32, 1)
  if constexpr (N <= 128) { P2PB_LAUNCH(64, 2) P2PB_LAUNCH(32, 2) }
#undef P2PB_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

P2PB_API long long p2pb_conv3d_gn_scratch_bytes(int B, int R, int Cout,
                                                int groups, int bf16) {
  return scratch_bytes(B, R, Cout, groups, bf16);
}

// gamma/beta hold [C] (affine_per_cloud = 0) or [B, C] (= 1).
// f32 (bf16 = 0): x [B, R, R, R, Cin], w [3, 3, 3, Cin, Cout] (DHWIO).
// bf16 (bf16 = 1): x [B, R, R, R, Cin] with Cin % 32 == 0, w [3 (dx),
// 3 (dz), 3 (dy), Cout, Cin] (the DHWIO weight with dy and dz swapped and
// every tap transposed: K-major B tiles), Cout % 32 == 0, a group of
// whole slots (Cout / groups a multiple of n_tile(Cout) / 8), R a power
// of two >= 8; x and w 16-byte aligned.
P2PB_API int p2pb_conv3d_gn(const void* x, const void* w, const void* bias,
                            const void* gamma, const void* beta,
                            int affine_per_cloud, int B, int R, int Cin,
                            int Cout, int groups, float eps, int act, int bf16,
                            void* y, void* scratch, int device, void* stream) {
  P2PB_ON_DEVICE(device);
  cudaStream_t s = (cudaStream_t)stream;
  int T = partials_per_group(R, Cout, groups, bf16);  // the bf16 kernel may use fewer
  double* partials = (double*)scratch;
  float* stats = (float*)(partials + (size_t)B * groups * T * 2);
  int err;
  if (bf16) {
    const int n = n_tile(Cout);
    if (Cout % 32 || Cout % groups || (Cout / groups) % (n / SLOTS) || R < 8 || (R & (R - 1)))
      return (int)cudaErrorInvalidValue;
    p2pb::bf16* yb = (p2pb::bf16*)y;
    const float* bs = (const float*)bias;
    int tiles = 0;  // voxel tiles of a cloud
    switch (n) {
      case 32: err = launch_n<32>(x, w, bs, B, R, Cin, Cout, yb, partials, &tiles, s); break;
      case 64: err = launch_n<64>(x, w, bs, B, R, Cin, Cout, yb, partials, &tiles, s); break;
      case 128: err = launch_n<128>(x, w, bs, B, R, Cin, Cout, yb, partials, &tiles, s); break;
      default: err = launch_n<256>(x, w, bs, B, R, Cin, Cout, yb, partials, &tiles, s); break;
    }
    T = Cout / groups / (n / SLOTS) * tiles;  // slots of a group x voxel tiles
  } else {
    conv_tile_kernel<<<dim3((R * R * R + BM - 1) / BM, (Cout + BN - 1) / BN, B), NT, 0, s>>>(
        (const float*)x, (const float*)w, (const float*)bias, R, Cin, Cout, groups,
        (float*)y, partials);
    err = (int)cudaGetLastError();
  }
  if (err) return err;
  const int V = R * R * R;
  const int BG = B * groups;
  gn_stats_kernel<<<(BG + 127) / 128, 128, 0, s>>>(
      partials, BG, T, (double)V * (Cout / groups), eps, stats);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int stride = affine_per_cloud ? Cout : 0;
  if (bf16) {
    const int VC8 = V * Cout / 8;
    gn_apply_bf16_kernel<<<dim3((VC8 + 255) / 256, B), 256, 0, s>>>(
        (p2pb::bf16*)y, stats, (const float*)gamma, (const float*)beta, stride, VC8,
        Cout, groups, act);
  } else {
    const int VC = V * Cout;
    gn_apply_kernel<<<dim3((VC + 255) / 256, B), 256, 0, s>>>(
        (float*)y, stats, (const float*)gamma, (const float*)beta, stride, VC, Cout,
        groups, act);
  }
  return (int)cudaGetLastError();
}
