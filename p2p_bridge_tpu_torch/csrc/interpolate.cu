// K6: 3-nearest-neighbour inverse-distance interpolation. Fine points
// [B, N, 3] f32, coarse centres [B, M, 3] f32 and coarse features [B, M, C]
// T (f32 or bf16) -> [B, N, C] T, with the weights [B, N, 3] f32 and the
// indices [B, N, 3] int32 beside it unless their pointers are null (the
// model's forward needs only the sum).
//
// Replaces p2p_bridge_tpu/ops/pallas/interp_kernel.py:
// three_nn_interpolate_pallas (_interp_kernel), with the semantics of
// p2p_bridge_tpu/ops/interpolate.py: the 3 nearest centres by squared
// distance from per-coordinate squares, ties to the lowest index; squared
// distances clamped to [1e-10, 1e10]; w_i = d_j d_k / (d0 d1 + d0 d2 + d1 d2);
// fewer than 3 centres leave index 0 at distance 1e10. The sum is f32, in
// the order w0 f0 + w1 f1 + w2 f2, and is stored in T.
//
// What bounds it on the H100: bytes by count (the [B, N, C] output is the
// largest traffic), but two costs the byte bound does not see: the scan
// (B N M distance tests of about 10 instructions, 76.5 million at the
// 2048 <- 512 stage at B = 73) and the three row reads, which come from
// L2 at three times the output's bytes.
// Design: the TPU kernel builds a dense [TN, M] weight matrix for the MXU;
// that is a way round the TPU's slow gathers and is not ported. Here one
// launch runs a block per tile of a cloud's fine points in two phases.
//   The scan: the centres are staged as float4 (x, y, z, 0) in shared
//   memory, 512 at a time, so a test costs one 16-byte broadcast load; a
//   thread scans for one point (2 and 4 points a thread, so that a load
//   serves several, measured slower on the H100); each point's centres
//   are split into S contiguous ranges over S lanes (S by shape,
//   split_lanes: the fewest that give the grid kWaves blocks per SM; the
//   lane index is split-major, so up to S = 4 the lanes of a quarter warp
//   read one centre). A lane keeps a running top 3 in index order (strict
//   <: the earlier of equal distances), and the lanes' lists are merged
//   with shuffles in the order of (d2, index). That order is total, so the merge
//   gives exactly the serial scan's indices, whatever S is.
//   The gather: the tile's weights and indices pass through shared memory;
//   each lane takes (point, 16-byte vector) tasks, issues the three rows'
//   loads of kInFlight tasks before it computes any of them, and writes
//   16-byte stores; a C that is not a multiple of 16 bytes takes a scalar
//   path.
// Distances and weights are rounded op by op (__fmul_rn / __fadd_rn /
// __fdiv_rn), so FMA contraction cannot move a near tie and the weights
// match the plain version bit for bit.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;   // threads a block, and fine points a block at S = 1
constexpr int kChunk = 512;     // centres staged per pass (float4: 8 KB)
constexpr int kMaxSplit = 32;   // lanes that can share one point's scan
constexpr int kWaves = 4;       // blocks per SM the split aims for
constexpr int kInFlight = 2;    // gather tasks a lane loads before it computes
constexpr int MAX_DEVICES = 16;  // cards whose SM count is cached

// a running top 3, sorted by (d2, index)
struct Near {
  float d[3];
  int i[3];
};

__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// (d, m) into the list of a lane that sees centres in ascending index:
// m is above every index held, so strict < is the (d2, index) order
__device__ __forceinline__ void push_scanned(Near& t, float d, int m) {
  if (d < t.d[1]) {
    t.d[2] = t.d[1];
    t.i[2] = t.i[1];
    if (d < t.d[0]) {
      t.d[1] = t.d[0];
      t.i[1] = t.i[0];
      t.d[0] = d;
      t.i[0] = m;
    } else {
      t.d[1] = d;
      t.i[1] = m;
    }
  } else {
    t.d[2] = d;
    t.i[2] = m;
  }
}

// (d, m) from another lane's list: any index, so the full order
__device__ __forceinline__ void push_merged(Near& t, float d, int m) {
  if (!before(d, m, t.d[2], t.i[2])) return;
  if (before(d, m, t.d[1], t.i[1])) {
    t.d[2] = t.d[1];
    t.i[2] = t.i[1];
    if (before(d, m, t.d[0], t.i[0])) {
      t.d[1] = t.d[0];
      t.i[1] = t.i[0];
      t.d[0] = d;
      t.i[0] = m;
    } else {
      t.d[1] = d;
      t.i[1] = m;
    }
  } else {
    t.d[2] = d;
    t.i[2] = m;
  }
}

// 16 bytes of T as floats, and back (round to nearest even)
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    f[2 * q] = __uint_as_float(w[q] << 16);
    f[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * q], f[2 * q + 1]);
    w[q] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the tile's weighted rows, one (point, 16-byte vector) task a lane at a
// time; kInFlight tasks' row loads are issued before any is computed
template <typename T>
__device__ __forceinline__ void gather_vectors(const T* __restrict__ fb, T* __restrict__ ob,
                                               int count, int C, float (*sw)[3],
                                               int (*si)[3]) {
  constexpr int E = 16 / sizeof(T);
  const int V = C / E;  // vectors a row
  int p = threadIdx.x / V, v = threadIdx.x % V;
  const int dp = kThreads / V, dv = kThreads % V;
  while (p < count) {
    uint4 r[kInFlight][3];
    int tp[kInFlight], tv[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      tp[u] = p;
      tv[u] = v;
      if (p < count) {
#pragma unroll
        for (int q = 0; q < 3; ++q)
          r[u][q] = __ldg(reinterpret_cast<const uint4*>(fb + (size_t)si[p][q] * C) + v);
      }
      v += dv;
      p += dp;
      if (v >= V) {
        v -= V;
        ++p;
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (tp[u] >= count) break;
      const float w0 = sw[tp[u]][0], w1 = sw[tp[u]][1], w2 = sw[tp[u]][2];
      float f0[E], f1[E], f2[E], acc[E];
      unpack(r[u][0], f0);
      unpack(r[u][1], f1);
      unpack(r[u][2], f2);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        acc[e] = __fmul_rn(w0, f0[e]);
        acc[e] = __fadd_rn(acc[e], __fmul_rn(w1, f1[e]));
        acc[e] = __fadd_rn(acc[e], __fmul_rn(w2, f2[e]));
      }
      reinterpret_cast<uint4*>(ob + (size_t)tp[u] * C)[tv[u]] = pack(acc);
    }
  }
}

// any C (or rows not on 16 bytes): one (point, channel) task a lane
template <typename T>
__device__ __forceinline__ void gather_scalars(const T* __restrict__ fb, T* __restrict__ ob,
                                               int count, int C, float (*sw)[3],
                                               int (*si)[3]) {
  for (int t = threadIdx.x; t < count * C; t += kThreads) {
    const int p = t / C, c = t - p * C;
    float acc = __fmul_rn(sw[p][0], p2pb::to_f32(fb[(size_t)si[p][0] * C + c]));
    acc = __fadd_rn(acc, __fmul_rn(sw[p][1], p2pb::to_f32(fb[(size_t)si[p][1] * C + c])));
    acc = __fadd_rn(acc, __fmul_rn(sw[p][2], p2pb::to_f32(fb[(size_t)si[p][2] * C + c])));
    ob[(size_t)p * C + c] = p2pb::from_f32<T>(acc);
  }
}

// grid (ceil(N / tile), B), tile = kThreads / S fine points; S a power of
// two up to kMaxSplit; vec: rows on 16 bytes, C a multiple of 16
// bytes
template <typename T>
__global__ void __launch_bounds__(kThreads)
    three_nn_interp_kernel(const float* __restrict__ points, const float* __restrict__ centers,
                           const T* __restrict__ features, int N, int M, int C, int S, int vec,
                           T* __restrict__ out, float* __restrict__ w_out,
                           int32_t* __restrict__ idx_out) {
  __shared__ float4 sc[kChunk];
  __shared__ float sw[kThreads][3];
  __shared__ int si[kThreads][3];
  const int b = blockIdx.y;
  const int G = 32 / S;  // points a warp scans for
  const int tile = kThreads / S;
  const int n0 = blockIdx.x * tile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = lane / G, g = lane - s * G;  // split-major
  const int local = warp * G + g;            // the lane's point in the tile
  const int n = n0 + local;

  // a point past the end repeats the last
  const float* p = points + ((size_t)b * N + min(n, N - 1)) * 3;
  const float px = p[0], py = p[1], pz = p[2];
  Near t;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    t.d[q] = INFINITY;
    t.i[q] = 0;
  }

  const float* cb = centers + (size_t)b * M * 3;
  for (int m0 = 0; m0 < M; m0 += kChunk) {
    const int cnt = min(kChunk, M - m0);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      const float* c = cb + 3 * (m0 + j);
      sc[j] = make_float4(c[0], c[1], c[2], 0.0f);
    }
    __syncthreads();
    const int len = (cnt + S - 1) / S;
    const int lo = min(cnt, s * len), hi = min(cnt, lo + len);
    for (int j = lo; j < hi; ++j) {
      const float4 c = sc[j];
      const float d = p2pb::sqdist3(px - c.x, py - c.y, pz - c.z);
      if (d < t.d[2]) push_scanned(t, d, m0 + j);
    }
  }
  // the S lanes of a point exchange lists: after log2 S steps each holds
  // the first 3 of their union in (d2, index) order
  for (int off = G; off < 32; off <<= 1) {
    float od[3];
    int oi[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      od[q] = __shfl_xor_sync(0xffffffffu, t.d[q], off);
      oi[q] = __shfl_xor_sync(0xffffffffu, t.i[q], off);
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) push_merged(t, od[q], oi[q]);
  }

  if (s == 0 && n < N) {
    const float d0 = fminf(fmaxf(t.d[0], 1e-10f), 1e10f);
    const float d1 = fminf(fmaxf(t.d[1], 1e-10f), 1e10f);
    const float d2 = fminf(fmaxf(t.d[2], 1e-10f), 1e10f);
    const float denom = __fadd_rn(__fadd_rn(__fmul_rn(d0, d1), __fmul_rn(d0, d2)),
                                  __fmul_rn(d1, d2));
    const float w[3] = {__fdiv_rn(__fmul_rn(d1, d2), denom),
                        __fdiv_rn(__fmul_rn(d0, d2), denom),
                        __fdiv_rn(__fmul_rn(d0, d1), denom)};
    const size_t o = ((size_t)b * N + n) * 3;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      sw[local][q] = w[q];
      si[local][q] = t.i[q];
      if (w_out) {
        w_out[o + q] = w[q];
        idx_out[o + q] = t.i[q];
      }
    }
  }
  __syncthreads();

  const int count = min(tile, N - n0);
  const T* fb = features + (size_t)b * M * C;
  T* ob = out + ((size_t)b * N + n0) * C;
  if (vec)
    gather_vectors<T>(fb, ob, count, C, sw, si);
  else
    gather_scalars<T>(fb, ob, count, C, sw, si);
}

// The fewest lanes a point (a power of two up to kMaxSplit) that give the
// grid kWaves blocks per SM; a block holds kThreads / S points.
int split_lanes(int B, int N, int sms) {
  int S = 1;
  while (S < kMaxSplit &&
         (long long)B * ((N + kThreads / S - 1) / (kThreads / S)) < (long long)kWaves * sms)
    S *= 2;
  return S;
}

template <typename T>
int interpolate(const void* points, const void* centers, const void* features, int B, int N,
                int M, int C, void* out, void* w, void* idx, int device, cudaStream_t s) {
  static int sms[MAX_DEVICES];  // once per card
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!sms[device]) {
    const int err =
        (int)cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err) return err;
  }
  const int S = split_lanes(B, N, sms[device]);
  const int tile = kThreads / S;
  const int vec = C % (16 / (int)sizeof(T)) == 0 &&
                  (((uintptr_t)features | (uintptr_t)out) & 15) == 0;
  const dim3 grid((N + tile - 1) / tile, B);
  three_nn_interp_kernel<T><<<grid, kThreads, 0, s>>>(
      (const float*)points, (const float*)centers, (const T*)features, N, M, C, S, vec,
      (T*)out, (float*)w, (int32_t*)idx);
  return (int)cudaGetLastError();
}

}  // namespace

// features and out are bf16 when bf16 = 1, else f32; 1 <= B < 65536, M >= 1
P2PB_API int p2pb_three_nn_interpolate(const void* points, const void* centers,
                                       const void* features, int B, int N,
                                       int M, int C, int bf16, void* out,
                                       void* w, void* idx, int device,
                                       void* stream) {
  P2PB_ON_DEVICE(device);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return interpolate<p2pb::bf16>(points, centers, features, B, N, M, C, out, w, idx, device,
                                   s);
  return interpolate<float>(points, centers, features, B, N, M, C, out, w, idx, device, s);
}
