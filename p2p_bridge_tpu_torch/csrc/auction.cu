// K7: auction assignment from coordinates. xyz1 [B, N, 3] and xyz2
// [B, M, 3] f32; each value d2[n, m] is computed in the kernel in the
// expanded form of ops/common.py pairwise_sqdist_ordered, one fixed order of
// rounded operations: a2 = (ax ax + ay ay) + az az, b2 likewise, cross =
// (ax bx + ay by) + az bz, d2 = max((a2 - 2 cross) + b2, 0), so no [B, N, M]
// matrix is built.
// -> assign [B, N] int32 (object of each point) and dist [B, N] f32
// (d2[n, assign[n]]), plus per cloud the rounds run, the bidder rows
// scanned and the points left to the greedy fallback.
//
// Replaces p2p_bridge_tpu/ops/pallas/auction_kernel.py: auction_emd_pallas
// (_auction_kernel), with the semantics of the XLA formulation the JAX
// package pins it to (p2p_bridge_tpu/metrics/emd_auction.py:
// _auction_emd_xla), step for step and in the same f32 operations:
//   value = -d2 - price; the first-occurrence argmax v1 of each unowned
//   point's row; v2 the max of the row with that entry set to -1e30;
//   bid = (v1 - v2) + eps; per object the highest bid wins, ties to the
//   lowest point index; its price rises by the bid; its previous owner is
//   evicted and the winner takes it; rounds stop once every point owns an
//   object or after `iters` rounds; a point still unowned then takes the
//   first-occurrence argmax of its row at the final prices.
//
// What bounds it on the H100: operations (11 f32 operations a value, for
// every value of every bidder row and fallback row; with the two shared
// loads and the running top 2 the scan issues about 20 instructions a
// value). Design: the TPU keeps a
// cloud's [N, M] matrix in VMEM and makes masked [N, M] passes per round;
// that is not carried over. Here a thread-block cluster of CL CTAs serves
// one cloud (CL by cluster_size: the largest power of two up to 8 with
// B CL <= SMs and CL <= M; 4 at B = 32 on 132 SMs). The objects are split
// over the CTAs: each owns its objects' owners and awards them. Every CTA
// keeps a replica of all M prices, of every point's object, of the list of
// the cloud's bidders (the same in every CTA), a bid key for every object,
// and the objects and points as float4 (x, y, z, b2 or a2): about 150 KB at
// N = M = 2048, so a row is computed from shared memory. A round of the cluster:
//   bid: each CTA takes an equal slice of the list; with few bidders each
//     row is split over G warps (G * slice <= 32) whose shares one warp
//     merges, else a warp takes whole rows; a warp scans with two running
//     (best, first occurrence; second) pairs a lane, merged by shuffles;
//     the bid goes into this CTA's key of the object with a 64-bit
//     atomicMax of (order-preserving bits of bid) << 32 | (N - 1 - point),
//     "highest bid, then lowest index" whatever the order of arrival; then
//     each bid-on key goes to the owner's inbox slot of this CTA (a remote
//     store);
//   cluster barrier;
//   award: each CTA takes the max of its inbox slots for each of its
//     objects, so the kernel is deterministic; it pushes each changed price,
//     win and eviction, and the evicted points, into every CTA, and its
//     counts of owned objects and evictions;
//   cluster barrier; every CTA sums the counts (the unowned count decides
//     the next round) and builds the next list the same way: this round's
//     bidders still unowned, in order (a block-wide ballot and prefix),
//     then the evicted points CTA by CTA.
// Once at most kTailBidders points are unowned (on a training batch after
// the first few rounds, with about 27 bidders a round to go), the two
// cluster barriers, the inboxes and the ordered list cost more than the
// bids (32 timed fastest of 16, 32 and 64 on the H100): CTA 0 rebuilds
// every object's owner from its replicas and runs the rest alone, its
// other CTAs exit. A round alone: the bids, then the first bidder of each
// object (the one that clears its key) awards it, and the evicted points
// and the bidders still unowned are appended to the next list; two block
// barriers. A round with 27 bidders scans 27 rows, and no
// list pass is longer than the list. Bids stay in each CTA's own keys
// because the native 64-bit red/atom .max on another CTA's shared memory
// loses updates on the H100 when several CTAs race on one word
// (measured: most repetitions lose one); local keys need no remote atomic.
// Arithmetic uses __fmul_rn / __fadd_rn / __fsub_rn, so every value is the
// plain version's to the bit and the assignment is equal, not close.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kTailBidders = 32;  // from this many unowned points one CTA goes on alone
constexpr int kStaticBytes = 1024;  // the kernel's static shared memory, rounded up
constexpr float NEG = -1e30f;
constexpr int MAX_DEVICES = 16;  // cards whose launch state is cached

__device__ __forceinline__ unsigned int ordered(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned int u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// running best (first occurrence) and second value of one lane's share of
// a row, elements seen in ascending index order; second starts at NEG, the
// value the XLA formulation puts at the best entry before its max
struct Top2 {
  float best, second;
  int idx;
};

__device__ __forceinline__ void push(Top2& t, float v, int m) {
  t.idx = v > t.best ? m : t.idx;
  t.second = fmaxf(t.second, fminf(v, t.best));  // the smaller of the two
  t.best = fmaxf(t.best, v);
}

// no element yet: loses to every real one and leaves its second as it is
__device__ __forceinline__ Top2 no_element() {
  return Top2{-__int_as_float(0x7f800000), NEG, 0x7fffffff};  // -inf
}

// the top 2 of the union of two shares of a row (either order)
__device__ __forceinline__ Top2 combine(Top2 t, Top2 o) {
  if (o.best > t.best || (o.best == t.best && o.idx < t.idx)) {
    o.second = fmaxf(o.second, t.best);
    return o;
  }
  t.second = fmaxf(t.second, o.best);
  return t;
}

__device__ __forceinline__ Top2 warp_merge(Top2 t) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Top2 o;
    o.best = __shfl_xor_sync(0xffffffffu, t.best, off);
    o.second = __shfl_xor_sync(0xffffffffu, t.second, off);
    o.idx = __shfl_xor_sync(0xffffffffu, t.idx, off);
    t = combine(t, o);
  }
  return t;
}

// d2 of a point (x, y, z, a2) and an object (x, y, z, b2) in the order of
// pairwise_sqdist_ordered
__device__ __forceinline__ float expanded_sqdist(const float4& a, const float4& o) {
  const float cross =
      __fadd_rn(__fadd_rn(__fmul_rn(a.x, o.x), __fmul_rn(a.y, o.y)), __fmul_rn(a.z, o.z));
  return fmaxf(__fadd_rn(__fsub_rn(a.w, __fmul_rn(2.0f, cross)), o.w), 0.0f);
}

// (x, y, z, x x + y y + z z) of a point
__device__ __forceinline__ float4 with_sqnorm(const float* p) {
  const float x = p[0], y = p[1], z = p[2];
  return make_float4(x, y, z, p2pb::sqdist3(x, y, z));
}

// A cloud's rows, from the points and objects in shared memory. scan(p,
// ...) returns the top 2 of value = -d2 - price over row p's elements
// [lo, hi) in the warp: each lane keeps two running top 2 (elements lo +
// lane + 64 k and those 32 further), so that two dependency chains
// interleave.
struct Rows {
  const float4* pts;  // shared: (x, y, z, a2) of every point
  const float4* obj;  // shared: (x, y, z, b2) of every object
  int M;
  __device__ __forceinline__ Top2 scan(int p, const float* price, int lane, int lo,
                                       int hi) const {
    const float4 a = pts[p];
    Top2 t0 = no_element(), t1 = no_element();
    int m = lo + lane;
#pragma unroll 2
    for (; m + 32 < hi; m += 64) {
      push(t0, __fsub_rn(-expanded_sqdist(a, obj[m]), price[m]), m);
      push(t1, __fsub_rn(-expanded_sqdist(a, obj[m + 32]), price[m + 32]), m + 32);
    }
    if (m < hi) push(t0, __fsub_rn(-expanded_sqdist(a, obj[m]), price[m]), m);
    return warp_merge(combine(t0, t1));
  }
  __device__ __forceinline__ float dist(int p, int m) const {
    return expanded_sqdist(pts[p], obj[m]);
  }
};

// One bid: (order-preserving bits of the bid) << 32 | (N - 1 - p) maxed on
// this CTA's key of the object, "highest bid, then lowest point".
__device__ __forceinline__ void place_bid(unsigned long long* keys, int* obj, const Top2& t, int p,
                                          int N, float eps) {
  const float bid = __fadd_rn(__fsub_rn(t.best, t.second), eps);
  atomicMax(keys + t.idx, ((unsigned long long)ordered(bid) << 32) | (unsigned)(N - 1 - p));
  *obj = t.idx;
}

// Dynamic shared memory of one CTA, in this order: objects float4 x M,
// points float4 x N, price f32 x M (on 16 bytes), keys
// u64 x M (on 16 bytes), inbox u64 x CL Mc, owner int x M, evicted int x
// CL Mc, assign int x N, two bidder lists int x N, the bidders' objects
// int x N.
__host__ __device__ inline long long keys_offset(int N, int M) {
  return (16ll * (M + N) + 4ll * M + 15) / 16 * 16;
}

__host__ __device__ inline long long smem_bytes(int N, int M, int CL) {
  const long long Mc = (M + CL - 1) / CL;
  return keys_offset(N, M) + 12ll * M + 12ll * CL * Mc + 16ll * N;
}

// The entries x of src[0, n) with keep(x) into dst, in order (every CTA of
// the cluster gets the same list); returns their count to every thread.
// One block barrier per kThreads entries: each warp takes its offset from
// the warps' counts itself; sums [2][kWarps] alternates between chunks.
template <typename Keep>
__device__ __forceinline__ int compact(const int* src, int n, int* dst, Keep keep, int* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int total = 0;
  for (int base = 0, c = 0; base < n; base += kThreads, c ^= kWarps) {
    const int i = base + threadIdx.x;
    const bool k = i < n && keep(src[i]);
    const unsigned ballot = __ballot_sync(0xffffffffu, k);
    if (lane == 0) sums[c + warp] = __popc(ballot);
    __syncthreads();
    const int v = lane < kWarps ? sums[c + lane] : 0;  // warp `lane`'s count
    int inc = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += o;
    }
    const int offset = __shfl_sync(0xffffffffu, inc - v, warp);
    if (k) dst[total + offset + __popc(ballot & ((1u << lane) - 1))] = src[i];
    total += __shfl_sync(0xffffffffu, inc, 31);
  }
  return total;
}

// grid B * CL CTAs in clusters of CL
__global__ void __launch_bounds__(kThreads)
    auction_kernel(const float* __restrict__ xyz1, const float* __restrict__ xyz2, int N,
                   int M, float eps, int iters, int32_t* __restrict__ assign_out,
                   float* __restrict__ dist_out, int32_t* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int owned_here, evicted_here;  // this CTA's owned objects, this round's evictions
  __shared__ int owned[kMaxCluster], evicted_by[kMaxCluster];  // pushed by every CTA
  __shared__ int sums[2 * kWarps];
  __shared__ int count[2];          // the tail's list lengths
  __shared__ Top2 partial[kWarps];  // shares of split rows
  const int CL = (int)p2pb::cluster_nctarank();
  const int rank = (int)p2pb::cluster_ctarank();
  const int b = blockIdx.x / CL;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Mc = (M + CL - 1) / CL, o0 = rank * Mc, oc = max(0, min(M - o0, Mc));

  float4* obj = reinterpret_cast<float4*>(smem);
  float4* pts = obj + M;
  float* price = reinterpret_cast<float*>(pts + N);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem + keys_offset(N, M));
  unsigned long long* inbox = keys + M;  // [CL][Mc]: each CTA's highest bid on my objects
  int* owner = reinterpret_cast<int*>(inbox + CL * Mc);
  int* evicted = owner + M;  // [CL][Mc]: the points each CTA evicted this round
  int* assign = evicted + CL * Mc;
  int* list[2] = {assign + N, assign + 2 * N};  // the cloud's bidders, the same in every CTA
  int* bid_obj = assign + 3 * N;  // the object each of this CTA's bidders bid on

  const Rows rows{pts, obj, M};
  const float* cb = xyz2 + (size_t)b * M * 3;
  for (int m = tid; m < M; m += kThreads) obj[m] = with_sqnorm(cb + 3 * m);
  const float* pb = xyz1 + (size_t)b * N * 3;
  for (int n = tid; n < N; n += kThreads) pts[n] = with_sqnorm(pb + 3 * n);
  for (int m = tid; m < M; m += kThreads) {
    price[m] = 0.0f;
    keys[m] = 0ull;
    owner[m] = N;
  }
  for (int j = tid; j < CL * Mc; j += kThreads) inbox[j] = 0ull;
  for (int n = tid; n < N; n += kThreads) {
    assign[n] = -1;
    list[0][n] = n;
  }
  if (tid == 0) {
    owned_here = evicted_here = 0;
    count[0] = count[1] = 0;
  }
  p2pb::cluster_sync();  // every CTA is initialised before any remote access

  // The bids of bidders[0, n) into this CTA's keys, the objects into
  // bid_obj; with few bidders each row is split over G warps.
  auto bid = [&](const int* bidders, int n) {
    int G = 1;
    while (2 * G <= kWarps && 2 * G * n <= kWarps) G *= 2;
    if (G == 1) {
      for (int k = warp; k < n; k += kWarps) {
        const Top2 t = rows.scan(bidders[k], price, lane, 0, M);
        if (lane == 0) place_bid(keys, bid_obj + k, t, bidders[k], N, eps);
      }
    } else {
      const int chunk = (M + G - 1) / G;
      const int k = warp / G, lo = min(M, (warp % G) * chunk);
      if (k < n) {
        const Top2 t = rows.scan(bidders[k], price, lane, lo, min(M, lo + chunk));
        if (lane == 0) partial[warp] = t;
      }
      __syncthreads();
      if (warp < n) {  // warp k merges its bidder's G shares
        const Top2 t = warp_merge(lane < G ? partial[warp * G + lane] : no_element());
        if (lane == 0) place_bid(keys, bid_obj + warp, t, bidders[warp], N, eps);
      }
    }
    __syncthreads();
  };

  int round = 0, unowned = N, nb = N, bid_rows = 0;  // nb: the list's length
  // the cluster's rounds, while many points are unowned
  while (CL > 1 && round < iters && unowned > kTailBidders) {
    const int cur = round & 1;
    bid_rows += nb;
    const int share = (nb + CL - 1) / CL, s0 = min(nb, rank * share);
    const int ns = min(nb, s0 + share) - s0;  // this CTA's slice of the list
    bid(list[cur] + s0, ns);
    // each object's highest bid in this CTA goes to its owner's inbox (the
    // first of the object's bidders here takes the key and clears it)
    for (int k = tid; k < ns; k += kThreads) {
      const int m = bid_obj[k], q = m / Mc;
      const unsigned long long key = atomicExch(keys + m, 0ull);
      if (key) p2pb::st_cluster_u64(p2pb::cluster_map(inbox + rank * Mc + (m - q * Mc), q), key);
    }
    p2pb::cluster_sync();  // every bid has landed in its owner's inbox
    int newly_owned = 0;
    for (int j = tid; j < oc; j += kThreads) {
      const int m = o0 + j;
      unsigned long long key = 0ull;  // the highest bid on m in any CTA
      for (int q = 0; q < CL; ++q) {
        const unsigned long long k = inbox[q * Mc + j];
        if (k) {
          key = k > key ? k : key;
          inbox[q * Mc + j] = 0ull;
        }
      }
      if (key == 0ull) continue;
      const int winner = N - 1 - (int)(key & 0xffffffffull);
      const float new_price = __fadd_rn(price[m], unordered((unsigned)(key >> 32)));
      const int old = owner[m];
      owner[m] = winner;
      const int e = old < N ? atomicAdd(&evicted_here, 1) : 0;
      for (int q = 0; q < CL; ++q) {  // into every CTA's replicas
        p2pb::st_cluster_f32(p2pb::cluster_map(price + m, q), new_price);
        p2pb::st_cluster_s32(p2pb::cluster_map(assign + winner, q), m);
        if (old < N) {  // evicted; it bid on no object this round
          p2pb::st_cluster_s32(p2pb::cluster_map(assign + old, q), -1);
          p2pb::st_cluster_s32(p2pb::cluster_map(evicted + rank * Mc + e, q), old);
        }
      }
      if (old == N) ++newly_owned;
    }
    if (newly_owned) atomicAdd(&owned_here, newly_owned);
    __syncthreads();
    if (tid < CL) {
      p2pb::st_cluster_s32(p2pb::cluster_map(owned + rank, tid), owned_here);
      p2pb::st_cluster_s32(p2pb::cluster_map(evicted_by + rank, tid), evicted_here);
    }
    p2pb::cluster_sync();  // prices, assignments, evictions and counts everywhere
    if (tid == 0) evicted_here = 0;  // read above, before the barrier
    int total = 0;
    for (int q = 0; q < CL; ++q) total += owned[q];
    unowned = N - total;
    // the next list: this round's bidders that won nothing, then the
    // evicted points CTA by CTA
    int* next = list[cur ^ 1];
    int n = compact(list[cur], nb, next, [&](int p) { return assign[p] < 0; }, sums);
    for (int q = 0; q < CL; ++q) {
      for (int e = tid; e < evicted_by[q]; e += kThreads) next[n + e] = evicted[q * Mc + e];
      n += evicted_by[q];
    }
    nb = n;
    __syncthreads();
    ++round;
  }

  // the tail: CTA 0 goes on alone with every object (the whole auction where
  // a cloud has one CTA); the others are done, and no remote access to them
  // is pending, since the last barrier saw every one
  const bool alone = CL == 1 || (round < iters && unowned > 0);
  if (alone && rank != 0) return;
  if (alone && CL > 1) {
    for (int m = tid; m < M; m += kThreads) owner[m] = N;
    __syncthreads();
    for (int n = tid; n < N; n += kThreads)
      if (assign[n] >= 0) owner[assign[n]] = n;
  }
  while (alone && round < iters && nb > 0) {
    const int cur = round & 1;
    if (tid == 0) count[cur ^ 1] = 0;  // this round appends to it (last read two rounds ago)
    bid_rows += nb;
    bid(list[cur], nb);
    // the first of an object's bidders awards it; the evicted points and
    // then the bidders that won nothing form the next list
    int* next = list[cur ^ 1];
    for (int k = tid; k < nb; k += kThreads) {
      const int m = bid_obj[k];
      const unsigned long long key = atomicExch(keys + m, 0ull);
      if (key == 0ull) continue;
      const int winner = N - 1 - (int)(key & 0xffffffffull);
      price[m] = __fadd_rn(price[m], unordered((unsigned)(key >> 32)));
      const int old = owner[m];
      owner[m] = winner;
      assign[winner] = m;
      if (old < N) {  // evicted; it bid on no object this round
        assign[old] = -1;
        next[atomicAdd(&count[cur ^ 1], 1)] = old;
      }
    }
    __syncthreads();
    for (int k = tid; k < nb; k += kThreads) {
      const int p = list[cur][k];
      if (assign[p] < 0) next[atomicAdd(&count[cur ^ 1], 1)] = p;
    }
    __syncthreads();
    nb = count[cur ^ 1];
    ++round;
  }

  // leftovers (the list after the last round): the first-occurrence argmax
  // at the final prices
  const int CLe = alone ? 1 : CL;  // the CTAs still here
  const int share = (nb + CLe - 1) / CLe, s0 = min(nb, rank * share);
  const int* left = list[round & 1];
  for (int k = s0 + warp; k < min(nb, s0 + share); k += kWarps) {
    const int p = left[k];
    const int a = rows.scan(p, price, lane, 0, M).idx;
    if (lane == 0) {
      assign_out[(size_t)b * N + p] = a;
      dist_out[(size_t)b * N + p] = rows.dist(p, a);
    }
  }
  // the points that own an object: this CTA's share of the cloud
  const int Nc = (N + CLe - 1) / CLe, p0 = rank * Nc, pc = max(0, min(N - p0, Nc));
  for (int n = p0 + tid; n < p0 + pc; n += kThreads) {
    const int a = assign[n];
    if (a < 0) continue;
    assign_out[(size_t)b * N + n] = a;
    dist_out[(size_t)b * N + n] = rows.dist(n, a);
  }
  if (rank == 0 && tid == 0) {
    stats[3 * b] = round;
    stats[3 * b + 1] = bid_rows;
    stats[3 * b + 2] = nb;
  }
}

// The cluster a cloud: the largest power of two up to kMaxCluster with
// B CL <= SMs (one wave) and CL <= M (every CTA owns an object).
int cluster_size(int B, int M, int sms) {
  int CL = kMaxCluster;
  while (CL > 1 && ((long long)B * CL > sms || CL > M)) CL /= 2;
  return CL;
}

// Sets the kernel's shared-memory limit where the shape needs more than
// before and checks once per card and cluster size that such a cluster can
// be resident (else the cluster halves); then launches.
int launch(const float* xyz1, const float* xyz2, int B, int N, int M, float eps, int iters,
           void* assign, void* dist, void* stats, int device, cudaStream_t stream) {
  auto kernel = auction_kernel;
  static int sms[MAX_DEVICES];
  static long long limit[MAX_DEVICES];            // the shared-memory attribute set
  static long long fits[MAX_DEVICES][kMaxCluster + 1];  // bytes checked resident, by CL
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int err = 0;
  if (!sms[device])
    err = (int)cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
  if (err) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  for (int CL = cluster_size(B, M, sms[device]);; CL /= 2) {
    const long long bytes = smem_bytes(N, M, CL);
    cfg.gridDim = dim3(B * CL);
    cfg.dynamicSmemBytes = (size_t)bytes;
    attr[0].val.clusterDim.x = CL;
    if (bytes > limit[device]) {
      err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)bytes);
      if (err) return err;
      limit[device] = bytes;
    }
    if (bytes > fits[device][CL]) {
      int clusters = 0;
      err = (int)cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &cfg);
      if (err) return err;
      if (clusters < 1) {
        if (CL == 1) return (int)cudaErrorLaunchOutOfResources;
        continue;
      }
      fits[device][CL] = bytes;
    }
    break;
  }
  err = (int)cudaLaunchKernelEx(&cfg, kernel, xyz1, xyz2, N, M, eps, iters,
                                (int32_t*)assign, (float*)dist, (int32_t*)stats);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace

// The most shared memory a CTA takes (at a cluster of 1), static included;
// the wrapper refuses a shape above the card's 232,448.
P2PB_API long long p2pb_auction_smem_bytes(int N, int M) {
  return smem_bytes(N, M, 1) + kStaticBytes;
}

// xyz1 [B, N, 3] and xyz2 [B, M, 3] f32 -> assign [B, N] int32, dist
// [B, N] f32, stats [B, 3] int32 (rounds run, bidder rows scanned, fallback
// points), on the distances of pairwise_sqdist_ordered(xyz1, xyz2).
P2PB_API int p2pb_auction_emd(const void* xyz1, const void* xyz2, int B, int N, int M,
                              float eps, int iters, void* assign, void* dist, void* stats,
                              int device, void* stream) {
  P2PB_ON_DEVICE(device);
  return launch((const float*)xyz1, (const float*)xyz2, B, N, M, eps, iters, assign, dist,
                stats, device, (cudaStream_t)stream);
}
