// K2: average voxelization (forward), features [B, N, C] T (f32 or bf16)
// and integer voxel coordinates [B, N, 3] -> grid [B, r^3, C] T of
// per-voxel means. K2b (below): its backward.
//
// K2 replaces p2p_bridge_tpu/ops/pallas/voxelize_kernel.py:
// avg_voxelize_scatter_pallas (_scatter_kernel).
//
// Semantics (p2p_bridge_tpu/ops/voxelize.py, exact path): flat index
// x*r^2 + y*r + z, per-voxel f32 sum and count, output sum / max(count, 1)
// stored in the feature type.
//
// What bounds it on the H100: it is a scatter, so memory traffic and atomic
// throughput; the grid at r = 32, C = 64, B = 73 is 0.6 GB in f32.
// Design: two launches. The first has one thread per (point, channel), so a
// warp adds 32 consecutive channels of one point into one f32 grid row (the
// atomics of a warp hit consecutive addresses), and channel 0 also counts the
// point. The second divides by max(count, 1) and stores T: in place for f32,
// into the bf16 grid for bf16. f32 atomics make the order of the sum change
// from run to run, so comparisons carry a tolerance. Indices are 32-bit (the
// wrapper checks the sizes). The divide pass reads and writes the whole
// dense grid, so it, not the scatter, takes most of the time.
#include "common.cuh"

namespace {

template <typename T>
__global__ void scatter_kernel(const T* __restrict__ feat,
                               const int32_t* __restrict__ vox, int N, int C,
                               int r, int total, float* __restrict__ sum,
                               float* __restrict__ cnt) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int n = t / C;  // point over all clouds
  const int c = t - n * C;
  const int b = n / N;
  const int32_t* v = vox + 3 * n;
  const int row = (b * r + v[0]) * r * r + v[1] * r + v[2];
  atomicAdd(sum + (size_t)row * C + c, p2pb::to_f32(feat[t]));
  if (c == 0) atomicAdd(cnt + row, 1.0f);
}

// sum and out alias for f32 (in place)
template <typename T>
__global__ void divide_kernel(const float* sum, const float* __restrict__ cnt,
                              int C, int total, T* out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  out[t] = p2pb::from_f32<T>(sum[t] / fmaxf(cnt[t / C], 1.0f));
}

template <typename T>
int avg_voxelize(const void* feat, const void* vox, int B, int N, int C, int r,
                 void* sum, void* cnt, void* out, cudaStream_t s) {
  const int threads = 256;
  const int pts = B * N * C;
  scatter_kernel<T><<<(pts + threads - 1) / threads, threads, 0, s>>>(
      (const T*)feat, (const int32_t*)vox, N, C, r, pts, (float*)sum,
      (float*)cnt);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int cells = B * r * r * r * C;
  divide_kernel<T><<<(cells + threads - 1) / threads, threads, 0, s>>>(
      (const float*)sum, (const float*)cnt, C, cells, (T*)out);
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
// serial loop over points. Here every thread owns VEC consecutive channels
// of one point (16 bytes when C * sizeof(T) is a multiple of 16, else one
// element), so a row is read and written by neighbouring threads as
// coalesced 16-byte vectors. The counts are the forward's, kept by the
// wrapper, not recounted. The divide is IEEE f32 (no fast-math), the plain
// version's arithmetic, so results are bit-equal to it.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void gather_divide_kernel(const T* __restrict__ g,
                                     const int32_t* __restrict__ idx,
                                     const float* __restrict__ cnt, int N,
                                     int R3, int C, long long total,
                                     T* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int per_row = C / VEC;
  const long long point = t / per_row;  // over all clouds
  const int j = (int)(t - point * per_row);
  const long long b = point / N;
  const long long row = b * R3 + idx[point];
  const float den = fmaxf(cnt[row], 1.0f);
  const Pack<T, VEC> in =
      *reinterpret_cast<const Pack<T, VEC>*>(g + row * C + (long long)j * VEC);
  Pack<T, VEC> res;
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    res.v[k] = p2pb::from_f32<T>(p2pb::to_f32(in.v[k]) / den);
  *reinterpret_cast<Pack<T, VEC>*>(out + point * C + (long long)j * VEC) = res;
}

template <typename T>
int avg_voxelize_backward(const void* g, const void* idx, const void* cnt,
                          int B, int N, int R3, int C, void* out,
                          cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const int threads = 256;
  const bool vec = C % VEC == 0;
  const long long total = (long long)B * N * (vec ? C / VEC : C);
  const long long blocks = (total + threads - 1) / threads;
  if (vec)
    gather_divide_kernel<T, VEC><<<blocks, threads, 0, s>>>(
        (const T*)g, (const int32_t*)idx, (const float*)cnt, N, R3, C, total,
        (T*)out);
  else
    gather_divide_kernel<T, 1><<<blocks, threads, 0, s>>>(
        (const T*)g, (const int32_t*)idx, (const float*)cnt, N, R3, C, total,
        (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// K2b. g [B, R3, C] T, idx [B, N] int32 in [0, R3), cnt [B, R3] f32,
// out [B, N, C] T; every pointer 16-byte aligned.
P2PB_API int p2pb_avg_voxelize_backward(const void* g, const void* idx,
                                        const void* cnt, int B, int N, int R3,
                                        int C, int bf16, void* out,
                                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return avg_voxelize_backward<p2pb::bf16>(g, idx, cnt, B, N, R3, C, out, s);
  return avg_voxelize_backward<float>(g, idx, cnt, B, N, R3, C, out, s);
}

// sum [B, r^3, C] f32 and cnt [B, r^3] f32 must be zeroed by the caller; for
// f32 (bf16 = 0) out is sum itself, for bf16 a separate [B, r^3, C] grid.
// B * N * C and B * r^3 * C must stay below 2^31.
P2PB_API int p2pb_avg_voxelize(const void* feat, const void* vox, int B, int N,
                               int C, int r, int bf16, void* sum, void* cnt,
                               void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return avg_voxelize<p2pb::bf16>(feat, vox, B, N, C, r, sum, cnt, out, s);
  return avg_voxelize<float>(feat, vox, B, N, C, r, sum, cnt, out, s);
}
