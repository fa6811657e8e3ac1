// K5: furthest point sampling, [B, N, 3] f32 -> [B, M] int32, by two
// kernels: fps_kernel (one block per cloud) for the backbone's SA stages and
// the bucketed recombination (many clouds of at most a few thousand points),
// and fps_cluster_kernel (one 16-CTA thread block cluster per cloud) for
// large N, the exact recombination (149,504 -> 50,000) and the seeding.
//
// Replaces p2p_bridge_tpu/ops/pallas/fps_kernel.py:furthest_point_sample_pallas
// (_fps_kernel batched; _fps_kernel_single, which the JAX package takes for
// N >= 16384, by fps_cluster_kernel).
//
// Semantics (p2p_bridge_tpu/ops/fps.py:_furthest_point_sample_xla): the first
// index is 0, the running point-to-set distance starts at FLT_MAX, and every
// iteration takes the argmax with ties to the lowest index.
//
// What bounds it on the H100: the M-1 iterations are serially dependent, so a
// cloud cannot be split across iterations; each iteration is a pass over N
// distances plus an argmax over all of them, i.e. latency (barriers and
// reductions) at patch size and on-chip bandwidth at N = 149,504.
// fps_kernel: one block per cloud. Distances live in shared memory when
// N * 4 B fits (and the coordinates too when N * 16 B fits); otherwise in a
// global scratch row that stays resident in the 50 MB L2. The argmax is a
// warp shuffle reduction followed by one warp over the per-warp winners.
// fps_cluster_kernel: see below.
#include <cfloat>
#include <climits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kSmemBudget = 200 * 1024;

__device__ __forceinline__ void take_max(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void fps_kernel(const float* __restrict__ pts, int N, int M,
                           float* __restrict__ gdist, int dist_in_smem,
                           int pts_in_smem, int32_t* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int s_last;

  const int b = blockIdx.x;
  const float* p = pts + (size_t)b * N * 3;
  float* dist = dist_in_smem ? smem + (pts_in_smem ? 3 * N : 0)
                             : gdist + (size_t)b * N;
  const float* P = pts_in_smem ? smem : p;
  int32_t* o = out + (size_t)b * M;

  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    if (pts_in_smem) {
      smem[3 * i] = p[3 * i];
      smem[3 * i + 1] = p[3 * i + 1];
      smem[3 * i + 2] = p[3 * i + 2];
    }
    dist[i] = FLT_MAX;
  }
  if (threadIdx.x == 0) {
    o[0] = 0;
    s_last = 0;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int j = 1; j < M; ++j) {
    const int last = s_last;
    const float lx = P[3 * last], ly = P[3 * last + 1], lz = P[3 * last + 2];
    float bv = -1.0f;
    int bi = 0x7fffffff;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      const float d =
          p2pb::sqdist3(P[3 * i] - lx, P[3 * i + 1] - ly, P[3 * i + 2] - lz);
      const float dd = fminf(dist[i], d);
      dist[i] = dd;
      if (dd > bv) {  // i grows, so strict > keeps the lowest index
        bv = dd;
        bi = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      take_max(bv, bi, ov, oi);
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? red_v[lane] : -1.0f;
      bi = lane < nwarps ? red_i[lane] : 0x7fffffff;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        take_max(bv, bi, ov, oi);
      }
      if (lane == 0) {
        s_last = bi;
        o[j] = bi;
      }
    }
    __syncthreads();
  }
}

// fps_cluster_kernel: one cluster of 16 CTAs per cloud, 512 threads each. CTA
// rank c owns the contiguous points [c * chunk, (c + 1) * chunk), chunk =
// ceil(N / 16): 9,344 at N = 149,504. Its thread t holds local points
// t + k * 512, k < PPT, coordinates and running distance in registers for
// all M iterations, and a copy of their coordinates in shared memory (12 *
// PPT * 512 bytes) for the winner's lookup; points past PPT * 512 (N above
// 163,840) keep their distance in a global scratch row and read their
// coordinates from global memory. Each iteration:
//  - one pass over the thread's points (strict >, so its lowest index wins);
//  - the argmax of the warp, then of the CTA's 16 warps (warp 0), each as
//    two redux.sync: the largest distance (its bits: distances are >= 0, so
//    their bits order as the values), then the lowest index among the
//    lanes holding it;
//  - warp 0's lanes c < 16 push the CTA's winner (distance, x, y, z,
//    index: 20 bytes) into slot [rank] of CTA c's inbox with st.async, which
//    also counts its bytes on CTA c's mbarrier;
//  - every CTA waits on its own mbarrier for the 16 winners (320 bytes) and
//    every warp reduces them with the same two redux.sync, so all 16 CTAs
//    agree on the winner, whose coordinates come with it. Rank 0 writes
//    out[j].
// Inboxes and mbarriers are double-buffered by iteration parity. A CTA
// pushes iteration j + 2's winner into inbox [j & 1] only after it has the
// 16 winners of iteration j + 1, among them the receiver's, which the
// receiver sends after every one of its warps has read inbox [j & 1] at
// iteration j (the __syncthreads of its CTA argmax lies between), so no
// slot is overwritten while it is read and no mbarrier phase is skipped.
// An iteration's floor is the pass, some 10 FP32 operations a point on one
// SM's 128 lanes (about 0.4 us at 9,344 points), plus the latency of the
// reductions and of one remote store.
constexpr int kCluster = 16;
constexpr int kClusterThreads = 512;
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kMaxPPT = 20;  // registers: 4 * 20 of a 512-thread block's 128
constexpr int kWinnerBytes = 20;  // distance, x, y, z, index
constexpr int MAX_DEVICES = 16;  // cards whose attributes are set
constexpr unsigned kAll = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;  // the index of no point: loses every tie

// The argmax of (distance bits v, index i) over the warp's lanes, ties to
// the lowest index; every lane gets it.
__device__ __forceinline__ void argmax(unsigned& v, unsigned& i) {
  const unsigned best = __reduce_max_sync(kAll, v);
  i = __reduce_min_sync(kAll, v == best ? i : kNone);
  v = best;
}

template <int PPT>
__global__ void __launch_bounds__(kClusterThreads, 1)
    fps_cluster_kernel(const float* __restrict__ pts, int N, int M, int chunk,
                       float* __restrict__ spill, int spill_per_cta,
                       int32_t* __restrict__ out) {
  constexpr int HELD = PPT * kClusterThreads;  // points held in registers
  extern __shared__ float held_xyz[];  // x [HELD], y [HELD], z [HELD]
  __shared__ unsigned red_v[kClusterWarps], red_i[kClusterWarps];
  __shared__ float4 inbox_v[2][kCluster];  // distance, x, y, z of each CTA's winner
  __shared__ unsigned inbox_i[2][kCluster];  // its index in the cloud
  __shared__ uint64_t full[2];  // the 16 winners of an iteration have landed

  const int rank = (int)p2pb::cluster_ctarank();
  const int b = blockIdx.x / kCluster;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* p = pts + (size_t)b * N * 3;
  const int lo = rank * chunk;
  const int count = max(0, min(chunk, N - lo));
  float* sx = held_xyz;
  float* sy = held_xyz + HELD;
  float* sz = held_xyz + 2 * HELD;
  float* sd = spill + ((size_t)b * kCluster + rank) * spill_per_cta;  // [count - HELD]

  float px[PPT], py[PPT], pz[PPT], pd[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int li = k * kClusterThreads + t;
    if (li < count) {
      const float* q = p + (size_t)(lo + li) * 3;
      px[k] = q[0];
      py[k] = q[1];
      pz[k] = q[2];
      pd[k] = FLT_MAX;
      sx[li] = px[k];
      sy[li] = py[k];
      sz[li] = pz[k];
    } else {  // padding: a distance below every real one never wins
      px[k] = py[k] = pz[k] = 0.0f;
      pd[k] = -1.0f;
    }
  }
  for (int li = HELD + t; li < count; li += kClusterThreads) sd[li - HELD] = FLT_MAX;
  float lx = p[0], ly = p[1], lz = p[2];
  if (t == 0) {
    if (rank == 0) out[(size_t)b * M] = 0;
    p2pb::mbar_init(&full[0], 1);
    p2pb::mbar_init(&full[1], 1);
    p2pb::fence_mbar_init_cluster();
  }
  __syncthreads();
  p2pb::cluster_sync();  // every CTA's mbarriers are ready before the first push

  for (int j = 1; j < M; ++j) {
    const int buf = j & 1;
    if (t == 0) p2pb::mbar_arrive_expect_tx(&full[buf], kCluster * kWinnerBytes);
    float bv = -1.0f;
    int bi = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const float dd = fminf(pd[k], p2pb::sqdist3(px[k] - lx, py[k] - ly, pz[k] - lz));
      pd[k] = dd;
      if (dd > bv) {  // local indices grow with k, so strict > keeps the lowest
        bv = dd;
        bi = k * kClusterThreads + t;
      }
    }
    for (int li = HELD + t; li < count; li += kClusterThreads) {
      const float* q = p + (size_t)(lo + li) * 3;
      const float dd = fminf(sd[li - HELD], p2pb::sqdist3(q[0] - lx, q[1] - ly, q[2] - lz));
      sd[li - HELD] = dd;
      if (dd > bv) {
        bv = dd;
        bi = li;
      }
    }
    // a thread without points offers distance bits 0 and no index
    unsigned v = bv >= 0.0f ? __float_as_uint(bv) : 0u;
    unsigned i = bv >= 0.0f ? (unsigned)bi : kNone;
    argmax(v, i);
    if (lane == 0) {
      red_v[warp] = v;
      red_i[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < kClusterWarps ? red_v[lane] : 0u;
      i = lane < kClusterWarps ? red_i[lane] : kNone;
      argmax(v, i);
      float x = 0.0f, y = 0.0f, z = 0.0f;  // the CTA winner's coordinates
      if (i < (unsigned)HELD) {
        x = sx[i];
        y = sy[i];
        z = sz[i];
      } else if (i < (unsigned)count) {
        const float* q = p + (size_t)(lo + i) * 3;
        x = q[0];
        y = q[1];
        z = q[2];
      }
      if (lane < kCluster) {
        const uint32_t bar = p2pb::cluster_map(&full[buf], lane);
        p2pb::st_async_f4(p2pb::cluster_map(&inbox_v[buf][rank], lane),
                          make_float4(__uint_as_float(v), x, y, z), bar);
        p2pb::st_async_u32(p2pb::cluster_map(&inbox_i[buf][rank], lane),
                           i == kNone ? kNone : lo + i, bar);
      }
    }
    // the phase of full[buf] that iteration j completes: its ((j - 1) / 2)th
    p2pb::mbar_wait(&full[buf], ((j - 1) >> 1) & 1);
    const unsigned sent = lane < kCluster ? inbox_i[buf][lane] : kNone;
    v = lane < kCluster ? __float_as_uint(inbox_v[buf][lane].x) : 0u;
    i = sent;
    argmax(v, i);
    const float4 w = inbox_v[buf][__ffs(__ballot_sync(kAll, sent == i)) - 1];
    lx = w.y;
    ly = w.z;
    lz = w.w;
    if (rank == 0 && t == 0) out[(size_t)b * M + j] = (int32_t)i;
  }
  p2pb::cluster_sync();  // no CTA exits while another may still push to it
}

// The cluster kernel's points per thread for N: the fewest of 2, 4, 8, 12,
// 16 and 20 that hold a CTA's chunk, else 20 and a spill row.
int cluster_ppt(int N) {
  const int chunk = (N + kCluster - 1) / kCluster;
  const int need = (chunk + kClusterThreads - 1) / kClusterThreads;
  constexpr int kFewer[] = {2, 4, 8, 12, 16};
  for (int ppt : kFewer)
    if (need <= ppt) return ppt;
  return kMaxPPT;
}

// Sets the kernel's attributes and checks that a cluster of 16 with its
// shared memory can be resident, once per card; then launches it.
template <int PPT>
int launch_cluster(const float* pts, int B, int N, int M, float* spill, int32_t* out,
                   cudaStream_t stream) {
  static bool ready[MAX_DEVICES];
  auto kernel = fps_cluster_kernel<PPT>;
  const int chunk = (N + kCluster - 1) / kCluster;
  const int spill_per_cta =
      chunk > PPT * kClusterThreads ? chunk - PPT * kClusterThreads : 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * kCluster);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = (size_t)12 * PPT * kClusterThreads;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err && dev >= MAX_DEVICES) err = (int)cudaErrorInvalidDevice;
  if (!err && !ready[dev]) {
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (!err)
      err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)cfg.dynamicSmemBytes);
    int clusters = 0;
    if (!err) err = (int)cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &cfg);
    // a cluster that cannot be resident would never run: refuse the launch
    if (!err && clusters < 1) err = (int)cudaErrorLaunchOutOfResources;
    ready[dev] = !err;
  }
  if (err) return err;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, pts, N, M, chunk, spill, spill_per_cta, out);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of global scratch the caller must pass for this shape (0: none).
P2PB_API long long p2pb_fps_scratch_bytes(int B, int N) {
  return (long long)N * 4 <= kSmemBudget ? 0 : (long long)B * N * 4;
}

P2PB_API int p2pb_fps(const void* pts, int B, int N, int M, void* scratch,
                      void* out, int device, void* stream) {
  P2PB_ON_DEVICE(device);
  const int pts_in_smem = (long long)N * 16 <= kSmemBudget;
  const int dist_in_smem = (long long)N * 4 <= kSmemBudget;
  const size_t smem = (pts_in_smem ? (size_t)N * 16
                                   : (dist_in_smem ? (size_t)N * 4 : 0));
  cudaFuncSetAttribute(fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemBudget);
  const int threads = N <= 4096 ? 512 : 1024;
  fps_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)pts, N, M, (float*)scratch, dist_in_smem, pts_in_smem,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

// Bytes of global scratch the cluster kernel needs for this shape (0: none):
// the distances of the points past the registers, N above 163,840.
P2PB_API long long p2pb_fps_cluster_scratch_bytes(int B, int N) {
  const long long chunk = (N + kCluster - 1) / kCluster;
  const long long spill = chunk - (long long)cluster_ppt(N) * kClusterThreads;
  return spill > 0 ? (long long)B * kCluster * spill * 4 : 0;
}

// pts [B, N, 3] f32, out [B, M] int32, 1 <= M <= N, 16 * B blocks at most
// 2^31 - 1; scratch as p2pb_fps_cluster_scratch_bytes says. Returns
// cudaErrorLaunchOutOfResources where a 16-CTA cluster cannot be resident.
P2PB_API int p2pb_fps_cluster(const void* pts, int B, int N, int M, void* scratch,
                              void* out, int device, void* stream) {
  P2PB_ON_DEVICE(device);
  const float* p = (const float*)pts;
  float* sd = (float*)scratch;
  int32_t* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (cluster_ppt(N)) {
    case 2: return launch_cluster<2>(p, B, N, M, sd, o, s);
    case 4: return launch_cluster<4>(p, B, N, M, sd, o, s);
    case 8: return launch_cluster<8>(p, B, N, M, sd, o, s);
    case 12: return launch_cluster<12>(p, B, N, M, sd, o, s);
    case 16: return launch_cluster<16>(p, B, N, M, sd, o, s);
    default: return launch_cluster<kMaxPPT>(p, B, N, M, sd, o, s);
  }
}

P2PB_API const char* p2pb_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
