// GroupNorm of channels-last point features with its affine and an optional
// swish, rounded once: x [B, L, C] T -> y [B, L, C] U (T, U f32 or bf16;
// L the product of every axis between the cloud and the channels), gamma
// and beta f32, shared [C] or per cloud [B, C] (AdaGN's modulation folded
// in, as K1's epilogue takes it).
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm, AdaGN's
// modulation and swish to XLA, which fuses them into the producing and
// consuming ops (p2p_bridge_tpu/models/modules.py GroupNorm, AdaGN,
// SharedMLP). In eager PyTorch the same math is some 16 launches over an
// f32 copy; this is two launches that move the data three times.
// Statistics per (cloud, group) over every row, in double from the values
// of x: mean and E[x^2] - mean^2 clamped at 0 (group_norm.cuh, shared with
// K1's epilogue); then per value (v - mean) * rstd, the affine and swish in
// f32, stored in U.
//
// What bounds it on the H100: bytes. A call reads x twice (the statistics,
// then the normalisation; the second read comes from L2 where x fits) and
// writes y once, a few operations a byte.
// Design: every block takes one chunk of rows of one cloud (grid (S, B));
// a thread owns one column of VEC channels (16 bytes of x, or the widest
// power of two below that divides C) and walks the chunk's rows RP = 256 /
// (C / VEC) apart, so its loads are 16-byte and a warp's contiguous. Each
// kernel takes its own S, at most kMaxChunks and no more than a cloud's
// passes of RP rows: the fewest whose B * S blocks fill 90% of their waves
// of the card's resident block slots (SMs x the kernel's occupancy; a grid
// one block past a wave would take twice its time), else the best filler.
//  * point_gn_partials_kernel: each thread sums its values and squares in
//    double; the block's sums per group are added in a fixed order (a
//    warp a group, lanes strided over the group's (row, channel) entries,
//    then a shuffle tree) and stored as one partial per (cloud, group,
//    chunk). No atomics: two runs give the same bits.
//  * point_gn_apply_kernel: each block first reduces its cloud's partials
//    to the groups' mean and rstd (gn_moments, every block in the same
//    order), then normalises its chunk (its own chunking).
#include "common.cuh"
#include "group_norm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunks = 32;    // partials a (cloud, group): the wrapper's scratch
constexpr int kMaxGroups = 1024;  // groups whose statistics a block holds
constexpr int MAX_DEVICES = 16;   // cards whose SM count and occupancies are cached

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    point_gn_partials_kernel(const T* __restrict__ x, int L, int C, int groups, int rows,
                             double* __restrict__ partials) {
  __shared__ double red[kThreads * VEC * 2];  // [row of the pass][channel][sum, square]
  const int CV = C / VEC, RP = kThreads / CV;
  const int tid = threadIdx.x, r0 = tid / CV, col = tid % CV;
  const int b = blockIdx.y, s = blockIdx.x;
  const int lo = s * rows, hi = min(L, lo + rows);
  if (r0 < RP) {
    double sum[VEC], sq[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) sum[i] = sq[i] = 0.0;
    const Vec<T, VEC>* xv = reinterpret_cast<const Vec<T, VEC>*>(x + (size_t)b * L * C) + col;
#pragma unroll 4
    for (int r = lo + r0; r < hi; r += RP) {
      const Vec<T, VEC> v = xv[(size_t)r * CV];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const double f = (double)p2pb::to_f32(v.v[i]);
        sum[i] += f;
        sq[i] += f * f;  // exact: f has at most 24 significant bits
      }
    }
    double* mine = red + (size_t)tid * VEC * 2;  // row r0, channels col * VEC ...
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mine[2 * i] = sum[i];
      mine[2 * i + 1] = sq[i];
    }
  }
  __syncthreads();
  const int gs = C / groups, n = RP * gs, warp = tid / 32, lane = tid % 32;
  for (int g = warp; g < groups; g += kThreads / 32) {
    double s1 = 0.0, s2 = 0.0;
    for (int e = lane; e < n; e += 32) {
      const double* p = red + ((size_t)(e / gs) * C + g * gs + e % gs) * 2;
      s1 += p[0];
      s2 += p[1];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    if (lane == 0) {
      // [cloud][group][chunk]: a group's partials are contiguous, as K1's
      double* pp = partials + (((size_t)b * groups + g) * gridDim.x + s) * 2;
      pp[0] = s1;
      pp[1] = s2;
    }
  }
}

template <typename T, typename U, int VEC>
__global__ void __launch_bounds__(kThreads)
    point_gn_apply_kernel(const T* __restrict__ x, const double* __restrict__ partials,
                          int S, const float* __restrict__ gamma,
                          const float* __restrict__ beta, int affine_stride, int L, int C,
                          int groups, int rows, float eps, int act, U* __restrict__ y) {
  __shared__ float2 st[kMaxGroups];  // (mean, rstd) of each group of the cloud
  const int b = blockIdx.y, gs = C / groups;
  const double count = (double)L * gs;
  for (int g = threadIdx.x; g < groups; g += kThreads)
    st[g] = p2pb::gn_moments(partials + ((size_t)b * groups + g) * S * 2, S, count, eps);
  __syncthreads();
  const int CV = C / VEC, RP = kThreads / CV;
  const int tid = threadIdx.x, r0 = tid / CV, col = tid % CV;
  if (r0 >= RP) return;
  const int c0 = col * VEC;
  const float* ga = gamma + (size_t)b * affine_stride + c0;
  const float* be = beta + (size_t)b * affine_stride + c0;
  float mean[VEC], rstd[VEC], g[VEC], bb[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float2 m = st[(c0 + i) / gs];
    mean[i] = m.x;
    rstd[i] = m.y;
    g[i] = ga[i];
    bb[i] = be[i];
  }
  const int lo = blockIdx.x * rows, hi = min(L, lo + rows);
  const Vec<T, VEC>* xv = reinterpret_cast<const Vec<T, VEC>*>(x + (size_t)b * L * C) + col;
  Vec<U, VEC>* yv = reinterpret_cast<Vec<U, VEC>*>(y + (size_t)b * L * C) + col;
#pragma unroll 4
  for (int r = lo + r0; r < hi; r += RP) {
    const Vec<T, VEC> v = xv[(size_t)r * CV];
    Vec<U, VEC> o;
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      o.v[i] = p2pb::from_f32<U>(
          p2pb::gn_normalise(p2pb::to_f32(v.v[i]), mean[i], rstd[i], g[i], bb[i], act));
    yv[(size_t)r * CV] = o;
  }
}

struct Args {
  const void* x;
  const float* gamma;
  const float* beta;
  int affine_stride, B, L, C, groups;
  float eps;
  int act;
  void* y;
  double* partials;
  int device, sms;
  cudaStream_t stream;
};

// chunks a cloud: of S in [1, min(kMaxChunks, passes)], the fewest whose
// B * S blocks fill 90% of their waves of `slots` resident blocks, else the
// one that fills them best
int chunks(int B, int passes, int slots) {
  int best = 1;
  long long best_used = 0, best_slots = 1;  // the best's blocks / its waves' slots
  for (int s = 1; s <= min(kMaxChunks, max(passes, 1)); ++s) {
    const long long blocks = (long long)B * s;
    const long long waves = (blocks + slots - 1) / slots;
    if (10 * blocks >= 9 * waves * slots) return s;
    if (blocks * best_slots > best_used * waves * slots) {
      best = s;
      best_used = blocks;
      best_slots = waves * slots;
    }
  }
  return best;
}

// resident blocks of `kernel` on the card: SMs x its occupancy, once per card
template <typename K>
int slots(K kernel, const Args& a, int* cache) {
  if (!cache[a.device]) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0) || n < 1) n = 1;
    cache[a.device] = n * a.sms;
  }
  return cache[a.device];
}

template <typename T, typename U, int VEC>
int launch(const Args& a) {
  static int partial_slots[MAX_DEVICES], apply_slots[MAX_DEVICES];
  const auto partials_k = point_gn_partials_kernel<T, VEC>;
  const auto apply_k = point_gn_apply_kernel<T, U, VEC>;
  const int RP = kThreads / (a.C / VEC), passes = (a.L + RP - 1) / RP;
  const int S = chunks(a.B, passes, slots(partials_k, a, partial_slots));
  const int rows = (a.L + S - 1) / S;
  partials_k<<<dim3(S, a.B), kThreads, 0, a.stream>>>((const T*)a.x, a.L, a.C, a.groups, rows,
                                                      a.partials);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int S2 = chunks(a.B, passes, slots(apply_k, a, apply_slots));
  apply_k<<<dim3(S2, a.B), kThreads, 0, a.stream>>>(
      (const T*)a.x, a.partials, S, a.gamma, a.beta, a.affine_stride, a.L, a.C, a.groups,
      (a.L + S2 - 1) / S2, a.eps, a.act, (U*)a.y);
  return (int)cudaGetLastError();
}

// the widest vector of at most VEC channels that divides C
template <typename T, typename U, int VEC>
int launch_widest(const Args& a) {
  if constexpr (VEC > 1) {
    if (a.C % VEC) return launch_widest<T, U, VEC / 2>(a);
  }
  if (a.C / VEC > kThreads) return (int)cudaErrorInvalidValue;
  return launch<T, U, VEC>(a);
}

template <typename T>
int launch_out(const Args& a, int out_bf16) {
  constexpr int WIDE = 16 / sizeof(T);
  return out_bf16 ? launch_widest<T, p2pb::bf16, WIDE>(a) : launch_widest<T, float, WIDE>(a);
}

}  // namespace

// x [B, L, C] (in_bf16: bf16, else f32), 16-byte aligned; gamma / beta f32
// [C] (affine_stride = 0) or [B, C] with rows affine_stride >= C floats
// apart (a column slice of a wider table); y [B, L, C] (out_bf16: bf16,
// else f32); scratch B * groups * 32 (sum, square) pairs of double.
// C % groups == 0, groups <= 1024, C / VEC <= 256 for the widest VEC of at
// most 16 bytes that divides C, 1 <= B <= 65535, L >= 1.
P2PB_API int p2pb_group_norm_act(const void* x, const void* gamma, const void* beta,
                                 int affine_stride, int B, int L, int C, int groups,
                                 float eps, int act, int in_bf16, int out_bf16, void* y,
                                 void* scratch, int device, void* stream) {
  P2PB_ON_DEVICE(device);
  static int sms[MAX_DEVICES];
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!sms[device]) {
    const int err = (int)cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                                                device);
    if (err) return err;
  }
  if (groups < 1 || groups > kMaxGroups || C % groups || B < 1 || B > 65535 || L < 1 ||
      (affine_stride && affine_stride < C))
    return (int)cudaErrorInvalidValue;
  const Args a{x, (const float*)gamma, (const float*)beta, affine_stride, B, L, C,
               groups, eps, act, y, (double*)scratch, device, sms[device],
               (cudaStream_t)stream};
  return in_bf16 ? launch_out<p2pb::bf16>(a, out_bf16) : launch_out<float>(a, out_bf16);
}
