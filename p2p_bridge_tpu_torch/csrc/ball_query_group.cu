// K4: fused ball query + group. Centres [B, M, 3] f32 and points [B, N, 3]
// f32 select, for each centre, K point indices idx [B, M, K] int32; the
// kernel then writes the rows of those indices as [B, M, K, W] T (f32 or
// bf16), in one of two forms:
//  - p2pb_ball_query_group: rows [B, N, C] T copied as they are (W = C);
//  - p2pb_ball_query_group_rel, the set-abstraction module's grouped tensor:
//    grouped[b, m, k] = [round_T(round_T(p) - round_T(c)) | features[idx]]
//    (W = 3 + C) from the point p = points[b, idx], the centre c and the
//    features [B, N, C] T: what the module's composition (rows =
//    [coords | features], gather, subtract the centre, concatenate) gives,
//    since PyTorch's subtraction of two T values rounds their f32
//    difference once.
// The distance test is f32 whatever T is; feature values are bit copies.
//
// Replaces p2p_bridge_tpu/ops/pallas/neighborhood_kernel.py:
// ball_query_group_pallas (_bqg_kernel), and for the _rel entry the
// subtraction and concatenations around it in p2p_bridge_tpu/models/pvcnn.py
// PointNetSAModule.
//
// Semantics (p2p_bridge_tpu/ops/ball_query.py): for each centre, the first K
// points in index order with d2 < radius^2, d2 from per-coordinate squares;
// slots past the hit count repeat the first hit; a centre with no hit gets
// index 0 everywhere.
//
// What bounds it on the H100: the write of K * W elements a centre (bytes),
// and at sa0 (2048 points, radius 0.1: a handful of hits, so every point is
// tested) the distance tests' instructions: 76.5 million at B = 73.
// Design: a block of 8 warps serves 64 consecutive centres of one cloud.
//  - The block copies the cloud's coordinates to shared memory as x, y and
//    z arrays, 512 points at a time (padded to a multiple of 4 with points
//    that never hit), and stops once every one of its centres has K hits:
//    a dense patch reads one chunk, a sparse one all of them.
//  - The scan: warps 0 and 1, one lane a centre. All lanes test the same 4
//    points a step, read as three 16-byte vectors that shared memory
//    broadcasts to the warp (3 reads serve 128 tests), and each lane
//    appends its hits in index order to its centre's slots in shared memory
//    until it has K; every 32 points the warp stops once each lane has K.
//    d2 is computed without FMA contraction (common.cuh) so boundary points
//    agree with the plain version.
//  - The copy as a flat stream: the block's centres own K * W contiguous
//    output elements each. A warp takes spans of 32 * VEC of them (VEC = 16
//    bytes of T), reads them lane by lane (consecutive lanes on consecutive
//    positions, so the feature reads coalesce), walking (slot, column)
//    without branches, with the loads of 2 spans in flight at once, turns
//    each span in shared memory into one 16-byte vector a lane and stores
//    that: every lane works on every pass and the stores coalesce whatever
//    W is (W is odd on the main path: 35, 67, 131, 323). Where
//    K * W * sizeof(T) is not a multiple of 16 the stream is written element
//    by element. For the _rel entry the block first computes each (centre,
//    slot)'s 3 relative coordinates once into shared memory, which the
//    stream reads for the coordinate columns. The indices never go back
//    through global memory.
//  - The coarse stages have few centres (8 a cloud at sa3), so few blocks
//    with long streams: where the grid offers fewer than 4 blocks an SM,
//    each block's stream is split over up to 16 blocks, each of which
//    repeats the block's (then small) scan.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCentres = 64;  // centres a block: one a lane of warps 0 and 1
constexpr int kChunk = 512;   // points a block stages in shared memory at a time
constexpr int kMaxNeighbors = 128;
constexpr int kSpans = 2;  // spans a warp has in flight in the stream
// the most shared memory a block takes (smem_bytes at K = 128, f32)
constexpr int kMaxSmem = (kChunk * 3 + kCentres * (kMaxNeighbors + 3)) * 4 + kThreads * 16 +
                         kCentres * kMaxNeighbors * 12;
constexpr int kFill = 4;  // blocks an SM the grid should offer at least
constexpr int MAX_DEVICES = 16;  // cards whose shared-memory limit is set
constexpr unsigned kAll = 0xffffffffu;
constexpr float kFar = 3.0e38f;  // a padding point: its d2 overflows to inf

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// Shared memory: a chunk of the cloud's x, y, z [3][kChunk] f32; slots
// [64][K] int32; the centres rounded to T [64][3] f32; the stream's
// staging, 16 bytes a thread; for _rel, the relative coordinates [64][K][3]
// T.
template <typename T, bool REL>
__global__ void __launch_bounds__(kThreads)
    ball_query_group_kernel(const float* __restrict__ centers, const float* __restrict__ points,
                            const T* __restrict__ rows, int M, int N, int C, int K, float r2,
                            T* __restrict__ out, int32_t* __restrict__ idx_out) {
  extern __shared__ __align__(16) float xyz[];
  int32_t* slots = reinterpret_cast<int32_t*>(xyz + 3 * kChunk);
  float* cen = reinterpret_cast<float*>(slots + kCentres * K);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, b = blockIdx.y;
  const int m0 = blockIdx.x * kCentres, nc = min(kCentres, M - m0);
  const float* p = points + (size_t)b * N * 3;

  // the scanning lanes: one a centre, in warps 0 and 1
  const int ci = warp * 32 + lane;
  const bool scans = warp < kCentres / 32, active = scans && ci < nc;
  float cx = 0.0f, cy = 0.0f, cz = 0.0f;
  if (active) {
    const float* c = centers + ((size_t)b * M + m0 + ci) * 3;
    cx = c[0];
    cy = c[1];
    cz = c[2];
    cen[3 * ci] = p2pb::to_f32(p2pb::from_f32<T>(cx));
    cen[3 * ci + 1] = p2pb::to_f32(p2pb::from_f32<T>(cy));
    cen[3 * ci + 2] = p2pb::to_f32(p2pb::from_f32<T>(cz));
  }
  int cnt = active ? 0 : K;  // an idle lane has its K already
  int32_t* s = slots + (active ? ci : 0) * K;
  // chunk by chunk until every centre of the block has K hits or the cloud
  // ends (a dense patch stops after its first chunk)
  for (int base = 0; base < N; base += kChunk) {
    const int n = min(kChunk, N - base), n4 = (n + 3) & ~3;
    for (int i = tid; i < n4; i += kThreads) {
      const bool in = i < n;
      const float* q = p + 3 * (size_t)(base + i);
      xyz[i] = in ? q[0] : kFar;
      xyz[kChunk + i] = in ? q[1] : kFar;
      xyz[2 * kChunk + i] = in ? q[2] : kFar;
    }
    __syncthreads();
    if (scans) {
#pragma unroll 4
      for (int i = 0; i < n4; i += 4) {
        if ((i & 31) == 0 && !__any_sync(kAll, cnt < K)) break;
        const float4 x = *reinterpret_cast<const float4*>(xyz + i);
        const float4 y = *reinterpret_cast<const float4*>(xyz + kChunk + i);
        const float4 z = *reinterpret_cast<const float4*>(xyz + 2 * kChunk + i);
        const bool h0 = p2pb::sqdist3(cx - x.x, cy - y.x, cz - z.x) < r2;
        const bool h1 = p2pb::sqdist3(cx - x.y, cy - y.y, cz - z.y) < r2;
        const bool h2 = p2pb::sqdist3(cx - x.z, cy - y.z, cz - z.z) < r2;
        const bool h3 = p2pb::sqdist3(cx - x.w, cy - y.w, cz - z.w) < r2;
        if (h0 | h1 | h2 | h3) {
          const int g = base + i;
          if (h0 && cnt < K) s[cnt] = g;
          cnt += h0;
          if (h1 && cnt < K) s[cnt] = g + 1;
          cnt += h1;
          if (h2 && cnt < K) s[cnt] = g + 2;
          cnt += h2;
          if (h3 && cnt < K) s[cnt] = g + 3;
          cnt += h3;
        }
      }
    }
    if (!__syncthreads_or(cnt < K)) break;  // also the barrier before the next chunk
  }
  if (active) {  // slots past the hits repeat the first; no hit: index 0
    const int hits = min(cnt, K);
    const int32_t first = hits ? s[0] : 0;
    for (int k = hits; k < K; ++k) s[k] = first;
  }
  __syncthreads();

  // _rel: each (centre, slot)'s round_T(round_T(p) - round_T(centre)), once
  T* stage = reinterpret_cast<T*>(cen + kCentres * 3);
  T* relv = stage + kThreads * 16 / sizeof(T);
  if (REL) {
    const float inv_k = 1.0f / K;
#pragma unroll 4
    for (int t = tid; t < nc * K * 3; t += kThreads) {
      const int r = (int)(((float)t + 0.5f) * (1.0f / 3.0f)), d = t - 3 * r;  // t / 3
      const int c = (int)(((float)r + 0.5f) * inv_k);                        // r / K
      const float pc = p2pb::to_f32(p2pb::from_f32<T>(p[3 * slots[r] + d]));
      relv[t] = p2pb::from_f32<T>(__fsub_rn(pc, cen[3 * c + d]));
    }
    __syncthreads();
  }

  const size_t first_row = ((size_t)b * M + m0) * K;  // the block's first (centre, slot)
  if (blockIdx.z == 0)
    for (int k = tid; k < nc * K; k += kThreads) idx_out[first_row + k] = slots[k];

  const int W = REL ? C + 3 : C;
  const int L = nc * K * W;  // below 2^31 (check_ball_query_shape)
  T* o = out + first_row * W;
  const T* src = rows + (size_t)b * N * C;
  const int last_slot = nc * K - 1;
  // element (slot r of the block, column c), without branches: a coordinate
  // column still loads a (valid) feature, a feature column still reads a
  // coordinate, and a position past the end reads the last slot
  auto element = [&](int r, int c) -> T {
    r = min(r, last_slot);
    const int row = slots[r];
    if (!REL) return src[(size_t)row * C + c];
    const bool rel = c < 3;
    const T f = src[(size_t)row * C + (rel ? 0 : c - 3)];
    const T v = relv[3 * r + (rel ? c : 0)];
    return rel ? v : f;
  };
  constexpr int VEC = 16 / sizeof(T);
  const int dr = 32 / W, dc = 32 - dr * W;  // a step of 32 positions
  if ((K * W) % VEC == 0) {
    // a warp's span: 32 * VEC positions, read lane by lane (consecutive
    // lanes on consecutive positions), turned in shared memory into one
    // 16-byte vector a lane, and stored; kSpans spans' loads in flight
    T* warp_stage = stage + warp * 32 * VEC;
    const int span = 32 * VEC, stride = gridDim.z * kWarps * span;
    for (int j0 = (blockIdx.z * kWarps + warp) * span; j0 < L; j0 += kSpans * stride) {
      T v[kSpans][VEC];
#pragma unroll
      for (int t = 0; t < kSpans; ++t) {
        const int j = j0 + t * stride + lane;
        int r = j / W, c = j - r * W;
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          v[t][u] = element(r, c);
          c += dc;
          r += dr;
          const bool next = c >= W;
          c = next ? c - W : c;
          r += next;
        }
      }
#pragma unroll
      for (int t = 0; t < kSpans; ++t) {
#pragma unroll
        for (int u = 0; u < VEC; ++u) warp_stage[u * 32 + lane] = v[t][u];
        __syncwarp();
        const Pack<T, VEC> y =
            *reinterpret_cast<const Pack<T, VEC>*>(warp_stage + lane * VEC);
        const int j = j0 + t * stride + lane * VEC;
        if (j < L) *reinterpret_cast<Pack<T, VEC>*>(o + j) = y;
        __syncwarp();
      }
    }
  } else {
    for (int j = blockIdx.z * kThreads + tid; j < L; j += gridDim.z * kThreads) {
      const int r = j / W;
      o[j] = element(r, j - r * W);
    }
  }
}

int smem_bytes(int K, int rel_bytes) {
  return (kChunk * 3 + kCentres * (K + 3)) * 4 + kThreads * 16 + kCentres * K * 3 * rel_bytes;
}

template <typename T, bool REL>
int ball_query_group(const void* centers, const void* points, const void* rows, int B, int M,
                     int N, int C, int K, float r2, void* out, void* idx, int device,
                     cudaStream_t s) {
  auto kernel = ball_query_group_kernel<T, REL>;
  static int sms[MAX_DEVICES];  // once per card: room for the largest K, the SM count
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!sms[device]) {
    int err =
        (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (!err)
      err = (int)cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err) return err;
  }
  // few centres (the coarse stages) leave the card idle: split each block's
  // stream over up to 16 blocks, each repeating its (then small) scan
  const int blocks = (M + kCentres - 1) / kCentres * B;
  const int splits = std::min(16, std::max(1, (kFill * sms[device] + blocks - 1) / blocks));
  const dim3 grid((M + kCentres - 1) / kCentres, B, splits);
  const int rel_bytes = REL ? (int)sizeof(T) : 0;
  kernel<<<grid, kThreads, smem_bytes(K, rel_bytes), s>>>(
      (const float*)centers, (const float*)points, (const T*)rows, M, N, C, K, r2, (T*)out,
      (int32_t*)idx);
  return (int)cudaGetLastError();
}

}  // namespace

// rows and out are bf16 when bf16 = 1, else f32; out [B, M, K, C]. Takes
// 1 <= B < 65536, 1 <= K <= 128 and 64 * K * (C + 3) < 2^31
// (ops/ball_query.py check_ball_query_shape).
P2PB_API int p2pb_ball_query_group(const void* centers, const void* points, const void* rows,
                                   int B, int M, int N, int C, int K, float r2, int bf16,
                                   void* out, void* idx, int device, void* stream) {
  P2PB_ON_DEVICE(device);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return ball_query_group<p2pb::bf16, false>(centers, points, rows, B, M, N, C, K, r2, out,
                                               idx, device, s);
  return ball_query_group<float, false>(centers, points, rows, B, M, N, C, K, r2, out, idx,
                                        device, s);
}

// features and out are bf16 when bf16 = 1, else f32; out [B, M, K, 3 + C]:
// the centre-relative coordinates in T, then the features.
P2PB_API int p2pb_ball_query_group_rel(const void* centers, const void* points,
                                       const void* features, int B, int M, int N, int C, int K,
                                       float r2, int bf16, void* out, void* idx, int device,
                                       void* stream) {
  P2PB_ON_DEVICE(device);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return ball_query_group<p2pb::bf16, true>(centers, points, features, B, M, N, C, K, r2, out,
                                              idx, device, s);
  return ball_query_group<float, true>(centers, points, features, B, M, N, C, K, r2, out, idx,
                                       device, s);
}
