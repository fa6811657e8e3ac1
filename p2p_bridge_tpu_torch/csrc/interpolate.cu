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
// fewer than 3 centres leave index 0 at distance 1e10. The sum is f32 and is
// stored in T.
//
// What bounds it on the H100: memory, barely. Per fine point it scans all M
// centres (8 flops each, M <= 512 on the main path) and then reads 3 rows of
// C and writes one; the [B, N, C] output is the largest traffic.
// Design: the TPU kernel builds a dense [TN, M] weight matrix for the MXU;
// that is a way round the TPU's slow gathers and is not ported. Here a block
// stages up to 512 centres of one cloud at a time in shared memory (6 KB)
// and gives each thread one fine point, which keeps a running top 3 in
// registers while it scans in index order; the strict < keeps the earlier
// of two equal distances, which is the lowest-index tie rule of the Pallas
// kernel's iota-min. Distances and weights are rounded op by op
// (__fmul_rn / __fadd_rn / __fdiv_rn), so FMA contraction cannot move a near
// tie and the weights match the plain version bit for bit. Then each warp
// writes the weighted rows of the block's points, lanes over channels.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int TILE = 128;   // fine points per block
constexpr int CHUNK = 512;  // centres staged per pass

template <typename T>
__global__ void __launch_bounds__(TILE)
    three_nn_interp_kernel(const float* __restrict__ points,
                           const float* __restrict__ centers,
                           const T* __restrict__ features, int N, int M, int C,
                           T* __restrict__ out, float* __restrict__ w_out,
                           int32_t* __restrict__ idx_out) {
  __shared__ float cx[CHUNK], cy[CHUNK], cz[CHUNK];
  __shared__ float sw[TILE][3];
  __shared__ int si[TILE][3];
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * TILE;
  const int n = n0 + threadIdx.x;
  const bool live = n < N;

  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (live) {
    const float* p = points + ((size_t)b * N + n) * 3;
    px = p[0];
    py = p[1];
    pz = p[2];
  }
  float d0 = INFINITY, d1 = INFINITY, d2 = INFINITY;
  int i0 = 0, i1 = 0, i2 = 0;
  const float* cb = centers + (size_t)b * M * 3;
  for (int m0 = 0; m0 < M; m0 += CHUNK) {
    const int cnt = min(CHUNK, M - m0);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += TILE) {
      cx[j] = cb[3 * (m0 + j)];
      cy[j] = cb[3 * (m0 + j) + 1];
      cz[j] = cb[3 * (m0 + j) + 2];
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < cnt; ++j) {
        const float d = p2pb::sqdist3(px - cx[j], py - cy[j], pz - cz[j]);
        if (d < d2) {
          const int m = m0 + j;
          if (d < d1) {
            d2 = d1;
            i2 = i1;
            if (d < d0) {
              d1 = d0;
              i1 = i0;
              d0 = d;
              i0 = m;
            } else {
              d1 = d;
              i1 = m;
            }
          } else {
            d2 = d;
            i2 = m;
          }
        }
      }
    }
  }

  if (live) {
    d0 = fminf(fmaxf(d0, 1e-10f), 1e10f);
    d1 = fminf(fmaxf(d1, 1e-10f), 1e10f);
    d2 = fminf(fmaxf(d2, 1e-10f), 1e10f);
    const float denom = __fadd_rn(__fadd_rn(__fmul_rn(d0, d1), __fmul_rn(d0, d2)),
                                  __fmul_rn(d1, d2));
    const float w[3] = {__fdiv_rn(__fmul_rn(d1, d2), denom),
                        __fdiv_rn(__fmul_rn(d0, d2), denom),
                        __fdiv_rn(__fmul_rn(d0, d1), denom)};
    const int id[3] = {i0, i1, i2};
    const size_t o = ((size_t)b * N + n) * 3;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      sw[threadIdx.x][k] = w[k];
      si[threadIdx.x][k] = id[k];
      if (w_out) {
        w_out[o + k] = w[k];
        idx_out[o + k] = id[k];
      }
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int count = min(TILE, N - n0);
  const T* fb = features + (size_t)b * M * C;
  for (int p = warp; p < count; p += TILE / 32) {
    const T* f0 = fb + (size_t)si[p][0] * C;
    const T* f1 = fb + (size_t)si[p][1] * C;
    const T* f2 = fb + (size_t)si[p][2] * C;
    const float w0 = sw[p][0], w1 = sw[p][1], w2 = sw[p][2];
    T* o = out + ((size_t)b * N + n0 + p) * C;
    for (int c = lane; c < C; c += 32) {
      float acc = __fmul_rn(w0, p2pb::to_f32(f0[c]));
      acc = __fadd_rn(acc, __fmul_rn(w1, p2pb::to_f32(f1[c])));
      acc = __fadd_rn(acc, __fmul_rn(w2, p2pb::to_f32(f2[c])));
      o[c] = p2pb::from_f32<T>(acc);
    }
  }
}

template <typename T>
int interpolate(const void* points, const void* centers, const void* features,
                int B, int N, int M, int C, void* out, void* w, void* idx,
                cudaStream_t s) {
  dim3 grid((N + TILE - 1) / TILE, B);
  three_nn_interp_kernel<T><<<grid, TILE, 0, s>>>(
      (const float*)points, (const float*)centers, (const T*)features, N, M, C,
      (T*)out, (float*)w, (int32_t*)idx);
  return (int)cudaGetLastError();
}

}  // namespace

// features and out are bf16 when bf16 = 1, else f32
P2PB_API int p2pb_three_nn_interpolate(const void* points, const void* centers,
                                       const void* features, int B, int N,
                                       int M, int C, int bf16, void* out,
                                       void* w, void* idx, int device,
                                       void* stream) {
  P2PB_ON_DEVICE(device);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return interpolate<p2pb::bf16>(points, centers, features, B, N, M, C, out,
                                   w, idx, s);
  return interpolate<float>(points, centers, features, B, N, M, C, out, w, idx,
                            s);
}
