// scatter_rows: the deterministic backward scatter of K3, K4 and K6. For
// each cloud b, each destination row v of out [B, R, C] T (f32 or bf16) is
// the f32 sum, in ascending entry index e, of term(e) over the entries
// whose destination is v, rounded once to T; a row with no entry is 0:
//   K4 (GATHER): g [B, E, C] the gathered rows' gradient, dest idx[b, e],
//       term g[e];
//   K6 (INTERP): g [B, S, C] the points' gradient, E = 3S, dest idx[b, e],
//       term w[b, e] * g[e / 3];
//   K3 (DEVOX):  g [B, S, C] the points' gradient, E = 8S, entry
//       e = corner * S + point (corners x outer, z inner), dest and weights
//       from the point's coordinates by the forward's corner rule, term
//       (wx * wy) * (wz * g[point]).
//
// Replaces no Pallas kernel: the JAX package computes these backwards in
// XLA (p2p_bridge_tpu/ops/devoxelize.py _devox_bwd and _devox_mean_bwd,
// ops/fused_group.py _fused_tpu_bwd, ops/interpolate.py
// _nn_interp_fused_bwd), deterministic on a TPU. Here they replace
// index_add_, whose float atomics on the card add in a varying order.
//
// Semantics: the plain versions' (ops/devoxelize.py, ops/ball_query.py,
// ops/interpolate.py): index_add_ on the CPU adds the entries one after
// another in entry order, from 0, in f32, and K3's adds the 8 corners one
// call after another. Every product and sum here is rounded on its own
// (__fmul_rn, __fadd_rn: no FMA contracts them), so the output is bit-equal
// to the plain version run on the CPU and the same from run to run.
//
// What bounds it on the H100: bytes. It reads each source row once per
// destination it feeds and writes every output row once; at r = 32 most of
// K3's 32,768 voxel rows are empty, so zero stores set much of the time.
// Design: two launches, no float atomics and no zeroed scratch.
//  - scatter_sort_kernel, one block per cloud: the keys dest << ebits | e go
//    to shared memory (up to 2^15 keys, 128 KB), a bitonic sort orders them
//    (the keys are distinct, so its instability does not matter), and a
//    binary search per destination gives each row's first slot. It writes
//    the sorted entry order [B, E] and the segment starts [B, R + 1].
//  - scatter_rows_kernel, one thread per 16 bytes of the output: it sums its
//    row's segment in sorted order (K3's weights recomputed from the coordinates)
//    and stores 16 bytes; where C * sizeof(T) is not a multiple of 16
//    (C = 35, 67) a thread's 16 bytes may span two rows, which it reads
//    element by element.
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int MAX_ENTRIES = 1 << 15;  // keys dest << ebits | entry: 15 + 15 bits
constexpr int MAX_ROWS = 1 << 15;
constexpr int SORT_SMEM = MAX_ENTRIES * 4;
constexpr int ROW_THREADS = 256;
constexpr int MAX_DEVICES = 16;  // cards whose shared-memory limit is set

enum Mode { GATHER = 0, INTERP = 1, DEVOX = 2 };

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// K3's corner rule on one axis: the low corner floor(v) with weight
// 1 - frac; the high corner floor(v) + 1 with weight frac when frac > 0,
// else floor(v) with weight 0 (ops/devoxelize.py _corners)
__device__ __forceinline__ void corner_axis(float v, int high, int& i, float& w) {
  const float lo = floorf(v);
  const float frac = __fsub_rn(v, lo);
  i = (int)lo;
  if (!high) {
    w = __fsub_rn(1.0f, frac);
  } else if (frac > 0.0f) {
    i += 1;
    w = frac;
  } else {
    w = 0.0f;
  }
}

// corner c (bits x, y, z: x outer) of the point at xyz: its flat voxel row
// and its three weights
__device__ __forceinline__ int corner(const float* xyz, int c, int r, float& wx,
                                      float& wy, float& wz) {
  int ix, iy, iz;
  corner_axis(xyz[0], (c >> 2) & 1, ix, wx);
  corner_axis(xyz[1], (c >> 1) & 1, iy, wy);
  corner_axis(xyz[2], c & 1, iz, wz);
  return (ix * r + iy) * r + iz;
}

// Shared memory: keys [P], P = E rounded up to a power of two. blockDim.x
// is a multiple of 32, at most 1024.
__global__ void __launch_bounds__(1024)
    scatter_sort_kernel(const int32_t* __restrict__ idx, const float* __restrict__ coords,
                        int mode, int S, int E, int R, int r, int ebits, int P,
                        int32_t* __restrict__ order, int32_t* __restrict__ start) {
  extern __shared__ int32_t keys[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long b = blockIdx.x;
  for (int e = tid; e < P; e += nt) {
    int key = INT_MAX;  // padding sorts last
    if (e < E) {
      int dest;
      if (mode == DEVOX) {
        const int c = e / S, n = e - c * S;
        float wx, wy, wz;
        dest = corner(coords + (b * S + n) * 3, c, r, wx, wy, wz);
      } else {
        dest = idx[b * E + e];
      }
      key = dest << ebits | e;
    }
    keys[e] = key;
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
  int32_t* ord = order + b * E;
  for (int i = tid; i < E; i += nt) ord[i] = keys[i] & ((1 << ebits) - 1);
  // row v's segment starts at the first key >= v << ebits (v = R: at E)
  int32_t* st = start + b * (R + 1);
  for (int v = tid; v <= R; v += nt) {
    const int target = v << ebits;
    int lo = 0, hi = E;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (keys[mid] < target) lo = mid + 1;
      else hi = mid;
    }
    st[v] = lo;
  }
}

// out[b, e] for the VEC elements e = e0 .. e0 + VEC - 1 of cloud b's flat
// output [R * C] (those inside it). ALIGNED (C % VEC == 0): one row, its
// source rows read as vectors; otherwise every row the elements touch, read
// element by element. Offsets inside a cloud are 32-bit.
template <typename T, int VEC, bool ALIGNED, int MODE>
__global__ void __launch_bounds__(ROW_THREADS)
    scatter_rows_kernel(const T* __restrict__ g, const float* __restrict__ w,
                        const float* __restrict__ coords, const int32_t* __restrict__ order,
                        const int32_t* __restrict__ start, int S, int E, int R, int C,
                        int r, T* __restrict__ out) {
  const int elems = R * C;
  const int e0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (e0 >= elems) return;
  const int e1 = min(e0 + VEC, elems);
  const size_t b = blockIdx.y;
  g += b * S * C;
  order += b * E;
  start += b * (R + 1);
  if (MODE == INTERP) w += b * E;
  if (MODE == DEVOX) coords += b * S * 3;
  Pack<T, VEC> res;
  for (int row = e0 / C; row * C < e1; ++row) {
    const int lo = row * C, hi = lo + C;  // the row's elements
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
    for (int p = start[row], end = start[row + 1]; p < end; ++p) {
      const int ent = order[p];
      int src = ent;  // GATHER: the entry's own row
      float a = 1.0f, f = 1.0f;  // term = a * (f * g), each product rounded
      if (MODE == INTERP) {
        src = ent / 3;
        f = w[ent];
      } else if (MODE == DEVOX) {
        const int c = ent / S;
        src = ent - c * S;
        float wx, wy;
        corner(coords + src * 3, c, r, wx, wy, f);
        a = __fmul_rn(wx, wy);
      }
      const int off = (src - row) * C + e0;  // element e0 + k at g[off + k]
      float v[VEC];
      if (ALIGNED) {
        const Pack<T, VEC> in = *reinterpret_cast<const Pack<T, VEC>*>(g + off);
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = p2pb::to_f32(in.v[k]);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          v[k] = (e0 + k >= lo && e0 + k < hi) ? p2pb::to_f32(g[off + k]) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float term = v[k];
        if (MODE == INTERP) term = __fmul_rn(f, term);
        if (MODE == DEVOX) term = __fmul_rn(a, __fmul_rn(f, term));
        acc[k] = __fadd_rn(acc[k], term);
      }
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (ALIGNED || (e0 + k >= lo && e0 + k < hi)) res.v[k] = p2pb::from_f32<T>(acc[k]);
  }
  T* o = out + b * R * C;
  if (e1 - e0 == VEC) {
    *reinterpret_cast<Pack<T, VEC>*>(o + e0) = res;
  } else {  // the flat array ends inside the vector
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (e0 + k < e1) o[e0 + k] = res.v[k];
  }
}

template <typename T, int MODE>
void launch_rows(dim3 grid, cudaStream_t s, bool aligned, const void* g, const void* w,
                 const void* coords, const int32_t* order, const int32_t* start, int S,
                 int E, int R, int C, int r, void* out) {
  constexpr int VEC = 16 / sizeof(T);
  if (aligned)
    scatter_rows_kernel<T, VEC, true, MODE><<<grid, ROW_THREADS, 0, s>>>(
        (const T*)g, (const float*)w, (const float*)coords, order, start, S, E, R, C, r,
        (T*)out);
  else
    scatter_rows_kernel<T, VEC, false, MODE><<<grid, ROW_THREADS, 0, s>>>(
        (const T*)g, (const float*)w, (const float*)coords, order, start, S, E, R, C, r,
        (T*)out);
}

template <typename T>
int scatter_rows(const void* g, const void* idx, const void* w, const void* coords,
                 int mode, int B, int S, int E, int R, int C, int r, void* out,
                 void* tables, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  int P = 1, ebits = 0;
  while (P < E) {
    P <<= 1;
    ++ebits;
  }
  const int threads = P / 2 < 64 ? 64 : (P / 2 > 1024 ? 1024 : P / 2);
  static bool limit_set[MAX_DEVICES];  // once per card
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err && dev >= MAX_DEVICES) err = (int)cudaErrorInvalidDevice;
  if (!err && !limit_set[dev]) {
    err = (int)cudaFuncSetAttribute(scatter_sort_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, SORT_SMEM);
    limit_set[dev] = !err;
  }
  if (err) return err;
  int32_t* order = (int32_t*)tables;
  int32_t* start = order + (size_t)B * E;
  scatter_sort_kernel<<<B, threads, P * 4, s>>>((const int32_t*)idx, (const float*)coords,
                                                mode, S, E, R, r, ebits, P, order, start);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int vectors = (R * C + VEC - 1) / VEC;  // of one cloud
  const dim3 grid((vectors + ROW_THREADS - 1) / ROW_THREADS, B);
  const bool aligned = C % VEC == 0;
  if (mode == GATHER)
    launch_rows<T, GATHER>(grid, s, aligned, g, w, coords, order, start, S, E, R, C, r, out);
  else if (mode == INTERP)
    launch_rows<T, INTERP>(grid, s, aligned, g, w, coords, order, start, S, E, R, C, r, out);
  else
    launch_rows<T, DEVOX>(grid, s, aligned, g, w, coords, order, start, S, E, R, C, r, out);
  return (int)cudaGetLastError();
}

}  // namespace

// g [B, S, C] T and out [B, R, C] T 16-byte aligned; mode 0 (K4): idx
// [B, E] int32 in [0, R), E = S; mode 1 (K6): idx and w [B, E] int32 and
// f32, E = 3S; mode 2 (K3): coords [B, S, 3] f32 in [0, r - 1], E = 8S,
// R = r^3; tables int32 scratch of B * (E + R + 1) elements; 1 <= E, R <=
// 2^15, B < 65536, S * C and R * C below 2^31.
P2PB_API int p2pb_scatter_rows(const void* g, const void* idx, const void* w,
                               const void* coords, int mode, int B, int S, int E, int R,
                               int C, int r, int bf16, void* out, void* tables,
                               int device, void* stream) {
  P2PB_ON_DEVICE(device);
  if (mode < GATHER || mode > DEVOX || E < 1 || E > MAX_ENTRIES || R < 1 || R > MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return scatter_rows<p2pb::bf16>(g, idx, w, coords, mode, B, S, E, R, C, r, out, tables, s);
  return scatter_rows<float>(g, idx, w, coords, mode, B, S, E, R, C, r, out, tables, s);
}
