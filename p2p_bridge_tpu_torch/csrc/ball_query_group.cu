// K4: fused ball query + group, centres [B, M, 3] f32, points [B, N, 3] f32,
// rows [B, N, C] T (f32 or bf16) -> gathered [B, M, K, C] T and idx
// [B, M, K] int32. The distance test is f32 whatever T is; the gathered
// rows are bit copies.
//
// Replaces p2p_bridge_tpu/ops/pallas/neighborhood_kernel.py:
// ball_query_group_pallas (_bqg_kernel).
//
// Semantics (p2p_bridge_tpu/ops/ball_query.py): for each centre, the first K
// points in index order with d2 < radius^2, d2 from per-coordinate squares;
// slots past the hit count repeat the first hit; a centre with no hit gets
// index 0 everywhere. The rows of those indices are then copied out.
//
// What bounds it on the H100: the scan reads points until K hits are found
// (up to all N for a sparse ball), and the copy writes K * C elements per centre;
// both are memory traffic, the copy being the larger at sa0 (C = 35, K = 32).
// Design: one warp per centre. The warp tests 32 consecutive points at once
// (a coalesced 384-byte read), forms the hit mask with __ballot_sync, ranks
// each hit with __popc of the lower lanes' bits (which keeps index order),
// and stops once K hits are found. The same warp then copies the K rows with
// consecutive lanes on consecutive channels. d2 is computed without FMA
// contraction (common.cuh) so boundary points agree with the plain version.
#include "common.cuh"

namespace {

template <typename T>
__global__ void ball_query_group_kernel(
    const float* __restrict__ centers, const float* __restrict__ points,
    const T* __restrict__ rows, int B, int M, int N, int C, int K,
    float r2, T* __restrict__ out, int32_t* __restrict__ idx_out) {
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= (long long)B * M) return;  // uniform across the warp
  const int b = (int)(w / M);

  const float cx = centers[3 * w], cy = centers[3 * w + 1],
              cz = centers[3 * w + 2];
  const float* p = points + (size_t)b * N * 3;
  int32_t* io = idx_out + (size_t)w * K;

  int cnt = 0;
  int first = 0;
  for (int base = 0; base < N && cnt < K; base += 32) {
    const int i = base + lane;
    bool hit = false;
    if (i < N) {
      hit = p2pb::sqdist3(cx - p[3 * i], cy - p[3 * i + 1],
                          cz - p[3 * i + 2]) < r2;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (mask) {
      if (cnt == 0) first = base + __ffs(mask) - 1;
      const int rank = cnt + __popc(mask & ((1u << lane) - 1u));
      if (hit && rank < K) io[rank] = i;
      cnt += __popc(mask);
    }
  }
  if (cnt > K) cnt = K;
  for (int k = cnt + lane; k < K; k += 32) io[k] = first;
  __syncwarp();

  const T* src = rows + (size_t)b * N * C;
  T* o = out + (size_t)w * K * C;
  for (int k = 0; k < K; ++k) {
    const T* row = src + (size_t)io[k] * C;
    for (int c = lane; c < C; c += 32) o[(size_t)k * C + c] = row[c];
  }
}

template <typename T>
int ball_query_group(const void* centers, const void* points, const void* rows,
                     int B, int M, int N, int C, int K, float r2, void* out,
                     void* idx, cudaStream_t s) {
  const int threads = 256;  // 8 centres per block
  const long long warps = (long long)B * M;
  const int blocks = (int)((warps * 32 + threads - 1) / threads);
  ball_query_group_kernel<T><<<blocks, threads, 0, s>>>(
      (const float*)centers, (const float*)points, (const T*)rows, B, M, N, C,
      K, r2, (T*)out, (int32_t*)idx);
  return (int)cudaGetLastError();
}

}  // namespace

// rows and out are bf16 when bf16 = 1, else f32
P2PB_API int p2pb_ball_query_group(const void* centers, const void* points,
                                   const void* rows, int B, int M, int N,
                                   int C, int K, float r2, int bf16, void* out,
                                   void* idx, int device, void* stream) {
  P2PB_ON_DEVICE(device);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return ball_query_group<p2pb::bf16>(centers, points, rows, B, M, N, C, K,
                                        r2, out, idx, s);
  return ball_query_group<float>(centers, points, rows, B, M, N, C, K, r2, out,
                                 idx, s);
}
