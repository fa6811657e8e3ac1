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
// What bounds it on the H100: memory, and the mean is almost all of it: it
// reads every voxel of the grid (about 0.7 GB over the eight grids of a
// PVDS_PUNet forward at 73 patches in bf16), while the gather reads at most
// 8 rows a point and writes one.
// Design: one launch, two kinds of block.
//  - The mean: S blocks per cloud, S the grid's bytes a cloud over 128 KB as
//    a power of two from 1 to 32 (small grids take few blocks, so that a
//    block's fixed costs stay small against its reads; large ones many, so
//    that the card's last wave stays short). Thread (voxel lane vl, channel
//    group g) reads the 16-byte vectors of channels [g * VEC, g * VEC + VEC)
//    of voxels vl, vl + VL, vl + 2 VL, ... (VL voxel lanes a cloud,
//    consecutive threads on consecutive 16 bytes), eight loads in flight.
//    It adds f32 values one at a time into one double per channel, and bf16
//    values in runs of 4 of its voxels, summed in f32 in order and then
//    added to the double (a quarter of the f32-to-double conversions, which
//    otherwise hold bf16 below the memory rate). A block then adds its voxel
//    lanes' partials in ascending lane order and writes its sums to
//    scratch; the last block of the cloud to finish (an integer ticket
//    counter per cloud, which that block resets to 0 for the next call, and
//    __threadfence) adds the blocks' sums in block order and divides by r^3
//    in double: a fixed order, no float atomics, and ops/devoxelize.py
//    grid_mean_fixed_order adds in the same order on the CPU, bit for bit.
//  - The gather: one (point, 16-byte vector) task a lane, 32 / P points a
//    warp for P vectors a row (8 points at C = 32 bf16, 1 at C = 256). The
//    point's first lane computes its corner setup once (3 coordinate loads,
//    8 weights, 8 row offsets) and hands it to the point's other lanes by
//    shuffle; then each lane issues its 8 corner loads at once and adds
//    them. A warp makes 4 passes over consecutive points and loads the next
//    pass's coordinates before this pass's corners, so that the two loads'
//    latencies overlap. A corner whose weight is 0 is not read. Products and sums are
//    rounded one by one (__fmul_rn / __fadd_rn) in the plain version's
//    order, x outer and z inner, so f32 results match it bit for bit.
// A cloud's blocks are consecutive in the grid, its S mean blocks first:
// the card runs a few clouds at a time, and a cloud's gather reads the rows
// its mean streams while they are in L2. A row width that 16 bytes do not
// divide takes the same code with one element a vector.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;          // every block
constexpr int kMaxMeanBlocks = 32;     // the mean's blocks per cloud, at most
constexpr int kMeanBlockBytes = 131072;  // and at least this much of the grid each
constexpr int kMeanLoads = 8;          // vector loads in flight per thread in the mean
constexpr int kRun = 4;                // bf16 values a thread adds in f32 before double
constexpr int kGatherPasses = 4;       // passes a gather warp makes over its points

// The mean's blocks per cloud: the grid's bytes a cloud over 128 KB, as a
// power of two from 1 to 32 (ops/devoxelize.py mean_blocks).
__host__ __device__ inline int mean_blocks(long long cloud_bytes) {
  int s = 1;
  while (s < kMaxMeanBlocks && (long long)(2 * s) * kMeanBlockBytes <= cloud_bytes) s *= 2;
  return s;
}

constexpr unsigned kAll = 0xffffffffu;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// The mean's layout for C channels of VEC elements a vector: G channel
// groups, GT of them side by side in a block (a thread takes groups
// g, g + GT, ...), VLc voxel lanes a block.
struct MeanLayout {
  int G, GT, VLc;
  __host__ __device__ MeanLayout(int C, int vec) {
    G = C / vec;
    GT = G < kThreads ? G : kThreads;
    VLc = kThreads / GT;
  }
};

// Block k of the S of the mean of cloud b. Scratch: the blocks' sums
// [B][S][C] double; tickets: one int a cloud, 0 between calls.
template <typename T, int VEC>
__device__ void grid_mean(const T* __restrict__ grid, int b, int k, int S, int V, int C,
                          double* __restrict__ scratch, int* __restrict__ tickets,
                          float* __restrict__ mean, double* part) {
  // bf16 values are added kRun at a time in f32 (one run of a thread's
  // voxels in order), f32 values one at a time, into the double
  constexpr int R = sizeof(T) == 2 ? kRun : 1;
  static_assert(kMeanLoads % R == 0, "runs are whole");
  const MeanLayout lay(C, VEC);
  const int tid = threadIdx.x, vl_local = tid / lay.GT;
  const int VL = S * lay.VLc;
  const T* gb = grid + (size_t)b * V * C;
  if (vl_local < lay.VLc) {
    const int vl = k * lay.VLc + vl_local;
    for (int g = tid % lay.GT; g < lay.G; g += lay.GT) {
      double acc[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = 0.0;
      const T* col = gb + g * VEC;
      for (int v0 = vl; v0 < V; v0 += kMeanLoads * VL) {
        Pack<T, VEC> x[kMeanLoads];
#pragma unroll
        for (int u = 0; u < kMeanLoads; ++u) {
          const int v = v0 + u * VL;
          if (v < V) {
            x[u] = *reinterpret_cast<const Pack<T, VEC>*>(col + (size_t)v * C);
          } else {
#pragma unroll
            for (int j = 0; j < VEC; ++j) x[u].v[j] = p2pb::from_f32<T>(0.0f);
          }
        }
#pragma unroll
        for (int u = 0; u < kMeanLoads; u += R) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            float run = p2pb::to_f32(x[u].v[j]);
#pragma unroll
            for (int e = 1; e < R; ++e) run = __fadd_rn(run, p2pb::to_f32(x[u + e].v[j]));
            acc[j] += (double)run;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) part[vl_local * C + g * VEC + j] = acc[j];
    }
  }
  __syncthreads();
  // the block's sum of each channel over its voxel lanes, ascending
  double* sums = scratch + (size_t)b * S * C;
  for (int c = tid; c < C; c += kThreads) {
    double s = 0.0;
    for (int l = 0; l < lay.VLc; ++l) s += part[l * C + c];
    sums[k * C + c] = s;
  }
  __threadfence();  // the sums reach the card before the ticket is taken
  __syncthreads();
  __shared__ int last;
  if (tid == 0) last = atomicAdd(&tickets[b], 1) == S - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int c = tid; c < C; c += kThreads) {
    double s = 0.0;
    for (int i = 0; i < S; ++i) s += __ldcg(sums + i * C + c);
    mean[(size_t)b * C + c] = (float)(s / V);
  }
  if (tid == 0) tickets[b] = 0;  // ready for the next call
}

// Points a gather warp serves a pass: 32 / P for P vectors a row (one
// (point, vector) task a lane), at least 1.
__host__ __device__ inline int warp_points(int P) { return P <= 32 ? 32 / P : 1; }

// Gather block `blk` of cloud b: 8 warps, each kGatherPasses passes of
// warp_points(P) consecutive points of the cloud.
template <typename T, int VEC>
__device__ void gather(const T* __restrict__ grid, const float* __restrict__ coords, int b,
                       int N, int r, int C, int blk, T* __restrict__ out) {
  const int P = C / VEC;  // vectors a row
  const int PPW = warp_points(P);
  const int lane = threadIdx.x & 31;
  const long long end = (long long)(b + 1) * N;  // the cloud's last point + 1
  const int warp = blk * (kThreads / 32) + (threadIdx.x >> 5);
  const long long pw = (long long)b * N + (long long)warp * PPW * kGatherPasses;
  // lane (i * P + q) serves vector q of the pass's point i; where P > 32 the
  // warp serves one point, 32 vectors at a time
  const int i = P <= 32 ? lane / P : 0;
  const int lead = P <= 32 ? i * P : 0;  // the lane that sets the point up
  const bool lane_used = i < PPW;
  const size_t cloud_elems = (size_t)r * r * r * C;

  // the lead lane loads its next point's coordinates one pass ahead
  float xyz[3] = {0.0f, 0.0f, 0.0f};
  if (lane == lead && lane_used && pw + i < end) {
#pragma unroll
    for (int d = 0; d < 3; ++d) xyz[d] = coords[3 * (pw + i) + d];
  }
  for (int pass = 0; pass < kGatherPasses; ++pass) {
    const long long first = pw + (long long)pass * PPW;
    if (first >= end) return;  // uniform across the warp
    const long long p = first + i;
    const bool active = lane_used && p < end;
    float here[3] = {xyz[0], xyz[1], xyz[2]};
    if (lane == lead && lane_used && pass + 1 < kGatherPasses && p + PPW < end) {
#pragma unroll
      for (int d = 0; d < 3; ++d) xyz[d] = coords[3 * (p + PPW) + d];
    }

    // corner setup, once a point, by its lead lane: corners x outer, z inner
    float w[8];
    int off[8];
    if (lane == lead) {
      int lo[3], step[3];
      float wlo[3], whi[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float f = floorf(here[d]);
        const float frac = __fsub_rn(here[d], f);
        lo[d] = (int)f;
        step[d] = frac > 0.0f ? 1 : 0;
        wlo[d] = __fsub_rn(1.0f, frac);
        whi[d] = step[d] ? frac : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int cx = k >> 2, cy = (k >> 1) & 1, cz = k & 1;
        const int ix = lo[0] + (cx ? step[0] : 0);
        const int iy = lo[1] + (cy ? step[1] : 0);
        const int iz = lo[2] + (cz ? step[2] : 0);
        w[k] = __fmul_rn(__fmul_rn(cx ? whi[0] : wlo[0], cy ? whi[1] : wlo[1]),
                         cz ? whi[2] : wlo[2]);
        off[k] = ((ix * r + iy) * r + iz) * C;
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      w[k] = __shfl_sync(kAll, w[k], lead);
      off[k] = __shfl_sync(kAll, off[k], lead);
    }
    if (active) {  // the whole warp meets again at the next pass's shuffles
      const T* g = grid + (size_t)b * cloud_elems;
      for (int q = P <= 32 ? lane - lead : lane; q < P; q += 32) {
        Pack<T, VEC> x[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)  // every corner's load in flight at once
          if (w[k] != 0.0f)
            x[k] = *reinterpret_cast<const Pack<T, VEC>*>(g + off[k] + q * VEC);
        float acc[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (w[k] != 0.0f) {
#pragma unroll
            for (int j = 0; j < VEC; ++j)
              acc[j] = __fadd_rn(acc[j], __fmul_rn(w[k], p2pb::to_f32(x[k].v[j])));
          }
        }
        Pack<T, VEC> y;
#pragma unroll
        for (int j = 0; j < VEC; ++j) y.v[j] = p2pb::from_f32<T>(acc[j]);
        *reinterpret_cast<Pack<T, VEC>*>(out + (size_t)p * C + q * VEC) = y;
      }
    }
  }
}

// Blocks by cloud: S mean blocks, then G gather blocks, so that a cloud's
// gather reads its grid while the mean streams it (through L2)
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
    devox_kernel(const T* __restrict__ grid, const float* __restrict__ coords, int N, int r,
                 int C, int S, int G, T* __restrict__ out, float* __restrict__ mean,
                 double* __restrict__ scratch, int* __restrict__ tickets) {
  extern __shared__ __align__(16) double part[];
  const int b = blockIdx.x / (S + G), j = blockIdx.x - b * (S + G);
  if (j < S) {
    grid_mean<T, VEC>(grid, b, j, S, r * r * r, C, scratch, tickets, mean, part);
    return;
  }
  gather<T, VEC>(grid, coords, b, N, r, C, j - S, out);
}

template <typename T, int VEC>
int devoxelize(const void* grid, const void* coords, int B, int N, int r, int C, void* out,
               void* mean, void* scratch, void* tickets, cudaStream_t s) {
  const int per_block = (kThreads / 32) * warp_points(C / VEC) * kGatherPasses;
  const int G = (N + per_block - 1) / per_block;
  const MeanLayout lay(C, VEC);
  const int S = mean ? mean_blocks((long long)r * r * r * C * sizeof(T)) : 0;
  devox_kernel<T, VEC><<<B * (S + G), kThreads, mean ? lay.VLc * C * 8 : 0, s>>>(
      (const T*)grid, (const float*)coords, N, r, C, S, G, (T*)out, (float*)mean,
      (double*)scratch, (int*)tickets);
  return (int)cudaGetLastError();
}

}  // namespace

// grid and out are bf16 when bf16 = 1, else f32; mean (f32 [B, C]) may be
// null, and then scratch and tickets are not used; scratch holds the mean
// blocks' sums, B * mean_blocks * C doubles, and tickets B ints that are 0
// (and are 0 again when the call has run: calls that share them run one
// after another).
// Takes B, N >= 1, 1 <= C <= 2048 and r^3 * C < 2^31
// (ops/devoxelize.py check_devoxelize_shape); grid, out and mean 16-byte
// aligned.
P2PB_API int p2pb_trilinear_devoxelize(const void* grid, const void* coords, int B, int N,
                                       int r, int C, int bf16, void* out, void* mean,
                                       void* scratch, void* tickets, int device,
                                       void* stream) {
  P2PB_ON_DEVICE(device);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return C % 8 ? devoxelize<p2pb::bf16, 1>(grid, coords, B, N, r, C, out, mean, scratch,
                                             tickets, s)
                 : devoxelize<p2pb::bf16, 8>(grid, coords, B, N, r, C, out, mean, scratch,
                                             tickets, s);
  return C % 4 ? devoxelize<float, 1>(grid, coords, B, N, r, C, out, mean, scratch, tickets, s)
               : devoxelize<float, 4>(grid, coords, B, N, r, C, out, mean, scratch, tickets, s);
}
