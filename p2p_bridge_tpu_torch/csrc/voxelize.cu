// K2: average voxelization (forward), features [B, N, C] T (f32 or bf16)
// and integer voxel coordinates [B, N, 3] -> grid [B, r^3, C] T of
// per-voxel means and counts [B, r^3] f32. K2b (below): its backward.
//
// K2 replaces p2p_bridge_tpu/ops/pallas/voxelize_kernel.py:
// avg_voxelize_scatter_pallas (_scatter_kernel).
//
// Semantics (p2p_bridge_tpu/ops/voxelize.py, exact path): flat index
// x*r^2 + y*r + z, per-voxel f32 sum and count, output sum / max(count, 1)
// stored in the feature type. Each voxel's points are summed in ascending
// point index, in f32, from 0, and the divide is IEEE (no fast-math): the
// order and arithmetic of the plain version's scatter_add_ on the CPU, so
// the grid is bit-equal to it and the same from run to run.
//
// What bounds it on the H100: bytes. It must read the features and the
// coordinates once and write the grid once, and at r = 32 the grid is 16x
// the features (a 2048-point patch fills a few hundred of 32,768 voxels),
// so the grid's stores, most of them zeros, set the time.
// Design: two launches, no float atomics and no scratch grid.
//  - bucket_kernel, one block per cloud: the cloud's keys voxel << 12 |
//    point go to shared memory, a bitonic sort orders them by voxel and,
//    within a voxel, by point; an integer histogram and a scan give each
//    voxel's first slot. It writes the sorted point order [B, N] and the
//    segment starts [B, r^3 + 1] (integer work: deterministic).
//  - rows_kernel, one thread per 16 bytes of the grid: it reads its row's
//    segment, sums the rows of that segment's points in sorted order,
//    divides once, rounds once and stores 16 bytes; the thread holding a
//    row's channel 0 also stores its count. An empty row costs 8 bytes of
//    starts and a 16-byte store of zeros. Where C * sizeof(T) is not a
//    multiple of 16 (C = 35, 67) a thread's 16 bytes may span two rows: it
//    reads the feature elements one by one and still stores one vector.
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int POINT_BITS = 12;  // keys voxel << 12 | point: N <= 4096
constexpr int MAX_RES = 32;
constexpr int BUCKET_SMEM = ((1 << POINT_BITS) + MAX_RES * MAX_RES * MAX_RES) * 4;
constexpr int ROW_THREADS = 256;
constexpr int MAX_DEVICES = 16;  // cards whose shared-memory limit is set

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// out[e0 .. e1) = res[0 .. e1 - e0): one 16-byte store unless the flat
// array ends inside the vector (the unrolled tail keeps res in registers)
template <typename T, int VEC>
__device__ __forceinline__ void store(T* out, int e0, int e1, const Pack<T, VEC>& res) {
  if (e1 - e0 == VEC) {
    *reinterpret_cast<Pack<T, VEC>*>(out + e0) = res;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (e0 + k < e1) out[e0 + k] = res.v[k];
  }
}

// Shared memory: keys [P] (P = N rounded up to a power of two), then the
// per-voxel counts, scanned in place into starts [r^3]. blockDim.x is a
// multiple of 32, at most 1024.
__global__ void __launch_bounds__(1024)
    bucket_kernel(const int32_t* __restrict__ vox, int N, int r, int P,
                  int32_t* __restrict__ order, int32_t* __restrict__ start) {
  extern __shared__ int32_t smem[];
  __shared__ int warp_sums[32];
  int32_t* keys = smem;
  int32_t* slot = smem + P;
  const int R3 = r * r * r;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, warps = nt >> 5;
  const long long b = blockIdx.x;
  for (int v = tid; v < R3; v += nt) slot[v] = 0;
  __syncthreads();
  const int32_t* xyz = vox + b * N * 3;
  for (int n = tid; n < P; n += nt) {
    if (n < N) {
      const int v = (xyz[3 * n] * r + xyz[3 * n + 1]) * r + xyz[3 * n + 2];
      keys[n] = v << POINT_BITS | n;
      atomicAdd(&slot[v], 1);
    } else {
      keys[n] = INT_MAX;  // padding sorts last
    }
  }
  __syncthreads();
  // bitonic sort, ascending; the keys are distinct
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < P / 2; i += nt) {
        const int lo = (i & ~(j - 1)) * 2 + (i & (j - 1));  // bit j clear
        const int a = keys[lo], c = keys[lo + j];
        if ((a > c) == ((lo & k) == 0)) {
          keys[lo] = c;
          keys[lo + j] = a;
        }
      }
      __syncthreads();
    }
  }
  // exclusive scan of the counts: each warp scans a contiguous span of
  // voxels 32 at a time, then the span totals are scanned
  const int span = (R3 + warps - 1) / warps;
  const int first = warp * span, last = min(first + span, R3);
  int carry = 0;
  for (int base = first; base < last; base += 32) {
    const int v = base + lane;
    const int c = v < last ? slot[v] : 0;
    int x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (v < last) slot[v] = carry + x - c;
    carry += __shfl_sync(0xffffffffu, x, 31);
  }
  if (lane == 0) warp_sums[warp] = carry;
  __syncthreads();
  if (warp == 0) {
    const int c = lane < warps ? warp_sums[lane] : 0;
    int x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    warp_sums[lane] = x - c;
  }
  __syncthreads();
  int32_t* st = start + b * (R3 + 1);
  for (int v = first + lane; v < last; v += 32) st[v] = slot[v] + warp_sums[warp];
  if (tid == 0) st[R3] = N;
  int32_t* ord = order + b * N;
  for (int i = tid; i < N; i += nt) ord[i] = keys[i] & ((1 << POINT_BITS) - 1);
}

// out[b, e] for the VEC elements e = e0 .. e0 + VEC - 1 of cloud b's flat
// grid [R3 * C] (those inside it): the mean of each element's row. ALIGNED
// (C % VEC == 0): one row, read as vectors. Otherwise every row the elements
// touch, read element by element. Offsets inside a cloud are 32-bit.
template <typename T, int VEC, bool ALIGNED>
__global__ void __launch_bounds__(ROW_THREADS)
    rows_kernel(const T* __restrict__ feat, const int32_t* __restrict__ order,
                const int32_t* __restrict__ start, int N, int R3, int C,
                float* __restrict__ cnt, T* __restrict__ out) {
  const int elems = R3 * C;
  const int e0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (e0 >= elems) return;
  const int e1 = min(e0 + VEC, elems);
  const size_t b = blockIdx.y;
  feat += b * N * C;
  order += b * N;
  start += b * (R3 + 1);
  Pack<T, VEC> res;
  for (int row = e0 / C; row * C < e1; ++row) {
    const int lo = row * C, hi = lo + C;  // the row's elements
    const int s = start[row], e = start[row + 1];
    if (lo >= e0) cnt[b * R3 + row] = (float)(e - s);  // this thread holds channel 0
    if (s == e) {  // empty: 0 / max(0, 1)
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        if (ALIGNED || (e0 + k >= lo && e0 + k < hi)) res.v[k] = p2pb::from_f32<T>(0.0f);
      continue;
    }
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
    for (int p = s; p < e; ++p) {
      const int off = (order[p] - row) * C + e0;  // element e0 + k at feat[off + k]
      if (ALIGNED) {
        const Pack<T, VEC> in = *reinterpret_cast<const Pack<T, VEC>*>(feat + off);
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += p2pb::to_f32(in.v[k]);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          if (e0 + k >= lo && e0 + k < hi) acc[k] += p2pb::to_f32(feat[off + k]);
      }
    }
    const float den = (float)(e - s);
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (ALIGNED || (e0 + k >= lo && e0 + k < hi))
        res.v[k] = p2pb::from_f32<T>(acc[k] / den);
  }
  store(out + b * R3 * C, e0, e1, res);
}

template <typename T>
int avg_voxelize(const void* feat, const void* vox, int B, int N, int C, int r,
                 void* cnt, void* out, void* tables, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const int R3 = r * r * r;
  int P = 1;
  while (P < N) P <<= 1;
  const int threads = P / 2 < 64 ? 64 : (P / 2 > 1024 ? 1024 : P / 2);
  const int smem = (P + R3) * 4;
  static bool limit_set[MAX_DEVICES];  // once per card
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err && dev >= MAX_DEVICES) err = (int)cudaErrorInvalidDevice;
  if (!err && !limit_set[dev]) {
    err = (int)cudaFuncSetAttribute(bucket_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, BUCKET_SMEM);
    limit_set[dev] = !err;
  }
  if (err) return err;
  int32_t* order = (int32_t*)tables;
  int32_t* start = order + (size_t)B * N;
  bucket_kernel<<<B, threads, smem, s>>>((const int32_t*)vox, N, r, P, order, start);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int vectors = (R3 * C + VEC - 1) / VEC;  // of one cloud
  const dim3 grid((vectors + ROW_THREADS - 1) / ROW_THREADS, B);
  if (C % VEC == 0)
    rows_kernel<T, VEC, true><<<grid, ROW_THREADS, 0, s>>>(
        (const T*)feat, order, start, N, R3, C, (float*)cnt, (T*)out);
  else
    rows_kernel<T, VEC, false><<<grid, ROW_THREADS, 0, s>>>(
        (const T*)feat, order, start, N, R3, C, (float*)cnt, (T*)out);
  return (int)cudaGetLastError();
}

// K2b: the backward of K2. grad_grid [B, r^3, C] T, flat voxel indices
// [B, N] int32 and the forward's counts [B, r^3] f32 -> grad_features
// [B, N, C] T, each element f32(g[idx[n]]) / max(cnt[idx[n]], 1) rounded
// once to T.
//
// Replaces p2p_bridge_tpu/ops/pallas/voxelize_kernel.py: gather_rows_pallas
// (_gather_kernel) and the divide of p2p_bridge_tpu/ops/voxelize.py
// (_avp_bwd), with the semantics of the CUDA backward the JAX package
// follows (grad / count gathered back to each point).
//
// What bounds it on the H100: bytes. It reads one grid row and writes one
// output row per point (plus 8 bytes of index and count); no arithmetic to
// speak of. Design: the TPU gathers rows from a VMEM-resident grid in a
// serial loop over points. Here every thread owns 16 bytes of the output,
// so a row is read and written by neighbouring threads as coalesced 16-byte
// vectors; where C * sizeof(T) is not a multiple of 16 a thread's 16 bytes
// may span two points' rows, which it reads element by element and still
// stores as one vector. The counts are the forward's, kept by the wrapper,
// not recounted. The divide is IEEE f32 (no fast-math), the plain version's
// arithmetic, so results are bit-equal to it.
template <typename T, int VEC, bool ALIGNED>
__global__ void gather_divide_kernel(const T* __restrict__ g,
                                     const int32_t* __restrict__ idx,
                                     const float* __restrict__ cnt, int N,
                                     int R3, int C, T* __restrict__ out) {
  const int elems = N * C;  // of cloud b's output
  const int e0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (e0 >= elems) return;
  const int e1 = min(e0 + VEC, elems);
  const size_t b = blockIdx.y;
  g += b * R3 * C;
  idx += b * N;
  cnt += b * R3;
  Pack<T, VEC> res;
  for (int point = e0 / C; point * C < e1; ++point) {
    const int lo = point * C, hi = lo + C;
    const int row = idx[point];
    const float den = fmaxf(cnt[row], 1.0f);
    const int off = (row - point) * C + e0;  // element e0 + k at g[off + k]
    if (ALIGNED) {
      const Pack<T, VEC> in = *reinterpret_cast<const Pack<T, VEC>*>(g + off);
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        res.v[k] = p2pb::from_f32<T>(p2pb::to_f32(in.v[k]) / den);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        if (e0 + k >= lo && e0 + k < hi)
          res.v[k] = p2pb::from_f32<T>(p2pb::to_f32(g[off + k]) / den);
    }
  }
  store(out + b * N * C, e0, e1, res);
}

template <typename T>
int avg_voxelize_backward(const void* g, const void* idx, const void* cnt,
                          int B, int N, int R3, int C, void* out,
                          cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const int threads = 256;
  const int vectors = (N * C + VEC - 1) / VEC;  // of one cloud
  const dim3 grid((vectors + threads - 1) / threads, B);
  if (C % VEC == 0)
    gather_divide_kernel<T, VEC, true><<<grid, threads, 0, s>>>(
        (const T*)g, (const int32_t*)idx, (const float*)cnt, N, R3, C, (T*)out);
  else
    gather_divide_kernel<T, VEC, false><<<grid, threads, 0, s>>>(
        (const T*)g, (const int32_t*)idx, (const float*)cnt, N, R3, C, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// K2b. g [B, R3, C] T, idx [B, N] int32 in [0, R3), cnt [B, R3] f32,
// out [B, N, C] T; g and out 16-byte aligned; B < 65536 and R3 * C,
// N * C below 2^31.
P2PB_API int p2pb_avg_voxelize_backward(const void* g, const void* idx,
                                        const void* cnt, int B, int N, int R3,
                                        int C, int bf16, void* out, int device,
                                        void* stream) {
  P2PB_ON_DEVICE(device);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return avg_voxelize_backward<p2pb::bf16>(g, idx, cnt, B, N, R3, C, out, s);
  return avg_voxelize_backward<float>(g, idx, cnt, B, N, R3, C, out, s);
}

// K2. feat [B, N, C] T and out [B, r^3, C] T 16-byte aligned, vox [B, N, 3]
// int32 in [0, r), cnt [B, r^3] f32, tables int32 scratch of
// B * (N + r^3 + 1) elements; 1 <= N <= 4096 and r <= 32 (the block's shared
// memory holds the keys and the counts), B < 65536, r^3 * C below 2^31.
P2PB_API int p2pb_avg_voxelize(const void* feat, const void* vox, int B, int N,
                               int C, int r, int bf16, void* cnt, void* out,
                               void* tables, int device, void* stream) {
  P2PB_ON_DEVICE(device);
  if (N < 1 || N > (1 << POINT_BITS) || r < 1 || r > MAX_RES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return avg_voxelize<p2pb::bf16>(feat, vox, B, N, C, r, cnt, out, tables, s);
  return avg_voxelize<float>(feat, vox, B, N, C, r, cnt, out, tables, s);
}
