// K5: furthest point sampling, [B, N, 3] f32 -> [B, M] int32, by three
// kernels: fps_warp_kernel (one warp per cloud, N <= 1024) and fps_kernel
// (one block per cloud, N < 16,384) for the backbone's SA stages and the
// bucketed recombination (many clouds of at most a few thousand points),
// and fps_cluster_kernel (one 16-CTA thread block cluster per cloud) for
// large N, the exact recombination (149,504 -> 50,000) and the seeding.
//
// Replaces p2p_bridge_tpu/ops/pallas/fps_kernel.py:furthest_point_sample_pallas
// (_fps_kernel batched, by fps_warp_kernel and fps_kernel; _fps_kernel_single,
// which the JAX package takes for N >= 16384, by fps_cluster_kernel).
//
// Semantics (p2p_bridge_tpu/ops/fps.py:_furthest_point_sample_xla): the first
// index is 0, the running point-to-set distance starts at FLT_MAX, and every
// iteration takes the argmax with ties to the lowest index.
//
// What bounds it on the H100: the M-1 iterations are serially dependent, so a
// cloud cannot be split across iterations; each iteration is a pass over N
// distances plus an argmax over all of them. At patch size (N <= 4096, some
// 10 FP32 operations a point) the pass is a few hundred cycles of one SM, so
// an iteration's time is the latency of its reductions and barriers, not its
// operations.
//
// Every kernel holds a thread's points, k * T + t for its thread t of T,
// coordinates and running distance in registers, and scans them in k order
// with a strict >, so each thread offers its lowest-index maximum. An argmax
// over lanes is two redux.sync: the largest distance bits (distances are
// >= 0, so their bits order as the values), then the lowest index among the
// lanes holding it. The winning lane's coordinates travel with the winner by
// shuffle (lane = index % 32), so no iteration waits on a dependent load.
//  - fps_warp_kernel, N <= 1024: one warp per cloud, up to 32 points a lane;
//    an iteration is the pass, one warp argmax and three shuffles: no block
//    barrier at all.
//  - fps_kernel, 1024 < N < 16,384: one block of T = 128..1024 threads, 8
//    points a thread in registers (points past 8 T, N above 8,192, keep
//    coordinates and distance in shared memory). One __syncthreads an
//    iteration: each warp writes its winner (distance, x, y, z, index) into
//    its slot of a table double-buffered by iteration parity; after the
//    barrier every warp reduces the table itself, so all warps agree on the
//    winner without a second barrier. The table [j & 1] is written again at
//    iteration j + 2, after barrier j + 1, which no warp passes before it
//    has read the table at iteration j.
#include <algorithm>
#include <cfloat>
#include <climits>
#include <cmath>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;  // the index of no point: loses every tie
constexpr int MAX_DEVICES = 16;  // cards whose attributes are set
constexpr int kBlockPPT = 8;     // fps_kernel: points a thread holds in registers
constexpr int kBlockMaxPoints = 16383;  // fps_kernel's largest cloud
constexpr int kWarpMaxPoints = 1024;    // fps_warp_kernel's largest cloud

// The argmax of (distance bits v, index i) over the warp's lanes, ties to
// the lowest index; every lane gets it.
__device__ __forceinline__ void argmax(unsigned& v, unsigned& i) {
  const unsigned best = __reduce_max_sync(kAll, v);
  i = __reduce_min_sync(kAll, v == best ? i : kNone);
  v = best;
}

// Points k * T + t (k < PPT) of a cloud into thread t's registers; a slot
// past the cloud gets distance -1, below every real one, so it never wins.
template <int PPT>
__device__ __forceinline__ void load_points(const float* p, int N, int T, int t,
                                            float (&px)[PPT], float (&py)[PPT],
                                            float (&pz)[PPT], float (&pd)[PPT]) {
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = k * T + t;
    const bool in = i < N;
    px[k] = in ? p[3 * i] : 0.0f;
    py[k] = in ? p[3 * i + 1] : 0.0f;
    pz[k] = in ? p[3 * i + 2] : 0.0f;
    pd[k] = in ? FLT_MAX : -1.0f;
  }
}

// The pass of one iteration over a thread's registers against the last
// pick (lx, ly, lz): running distances updated, the thread's best distance
// bv and its k (strict >: the lowest k, i.e. the lowest index, of a tie).
template <int PPT>
__device__ __forceinline__ void pass(float (&px)[PPT], float (&py)[PPT], float (&pz)[PPT],
                                     float (&pd)[PPT], float lx, float ly, float lz,
                                     float& bv, int& bk) {
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const float dd = fminf(pd[k], p2pb::sqdist3(px[k] - lx, py[k] - ly, pz[k] - lz));
    pd[k] = dd;
    if (dd > bv) {
      bv = dd;
      bk = k;
    }
  }
}

// Register k of a thread's points, selected without local memory.
template <int PPT>
__device__ __forceinline__ float pick(const float (&a)[PPT], int k) {
  float r = a[0];
#pragma unroll
  for (int q = 1; q < PPT; ++q) r = k == q ? a[q] : r;
  return r;
}

template <int PPT>
__global__ void __launch_bounds__(32)
    fps_warp_kernel(const float* __restrict__ pts, int N, int M, int32_t* __restrict__ out) {
  const int b = blockIdx.x, lane = threadIdx.x;
  const float* p = pts + (size_t)b * N * 3;
  int32_t* o = out + (size_t)b * M;
  float px[PPT], py[PPT], pz[PPT], pd[PPT];
  load_points<PPT>(p, N, 32, lane, px, py, pz, pd);
  float lx = p[0], ly = p[1], lz = p[2];
  if (lane == 0) o[0] = 0;
  for (int j = 1; j < M; ++j) {
    float bv = -1.0f;
    int bk = 0;
    pass<PPT>(px, py, pz, pd, lx, ly, lz, bv, bk);
    const float wx = pick<PPT>(px, bk), wy = pick<PPT>(py, bk), wz = pick<PPT>(pz, bk);
    // lane 0 holds point 0, so some lane offers a real point
    unsigned v = bv >= 0.0f ? __float_as_uint(bv) : 0u;
    unsigned i = bv >= 0.0f ? (unsigned)(bk * 32 + lane) : kNone;
    argmax(v, i);
    lx = __shfl_sync(kAll, wx, i & 31);
    ly = __shfl_sync(kAll, wy, i & 31);
    lz = __shfl_sync(kAll, wz, i & 31);
    if (lane == 0) o[j] = (int32_t)i;
  }
}

__global__ void __launch_bounds__(1024)
    fps_kernel(const float* __restrict__ pts, int N, int M, int32_t* __restrict__ out) {
  constexpr int PPT = kBlockPPT;
  extern __shared__ float spill[];  // x, y, z, distance [N - PPT T] each
  __shared__ float4 slot_v[2][32];  // distance bits, x, y, z of each warp's winner
  __shared__ unsigned slot_i[2][32];  // its index

  const int b = blockIdx.x, T = blockDim.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nwarps = T >> 5;
  const float* p = pts + (size_t)b * N * 3;
  int32_t* o = out + (size_t)b * M;
  const int held = PPT * T, extra = max(0, N - held);
  float* sx = spill;
  float* sy = spill + extra;
  float* sz = spill + 2 * extra;
  float* sd = spill + 3 * extra;

  float px[PPT], py[PPT], pz[PPT], pd[PPT];
  load_points<PPT>(p, N, T, t, px, py, pz, pd);
  for (int li = t; li < extra; li += T) {  // point held + li = (PPT + li / T) T + t
    const float* q = p + 3 * (size_t)(held + li);
    sx[li] = q[0];
    sy[li] = q[1];
    sz[li] = q[2];
    sd[li] = FLT_MAX;
  }
  float lx = p[0], ly = p[1], lz = p[2];
  if (t == 0) o[0] = 0;
  __syncthreads();

  for (int j = 1; j < M; ++j) {
    const int par = j & 1;
    float bv = -1.0f;
    int bk = 0;
    pass<PPT>(px, py, pz, pd, lx, ly, lz, bv, bk);
    unsigned bi = (unsigned)(bk * T + t);
    float wx = pick<PPT>(px, bk), wy = pick<PPT>(py, bk), wz = pick<PPT>(pz, bk);
    for (int li = t; li < extra; li += T) {  // indices above every register's
      const float dd = fminf(sd[li], p2pb::sqdist3(sx[li] - lx, sy[li] - ly, sz[li] - lz));
      sd[li] = dd;
      if (dd > bv) {
        bv = dd;
        bi = (unsigned)(held + li);
        wx = sx[li];
        wy = sy[li];
        wz = sz[li];
      }
    }
    unsigned v = bv >= 0.0f ? __float_as_uint(bv) : 0u;
    unsigned i = bv >= 0.0f ? bi : kNone;
    argmax(v, i);
    // the winner's lane is its index % 32 (T is a multiple of 32); a warp
    // without points offers bits 0 and no index
    wx = __shfl_sync(kAll, wx, i & 31);
    wy = __shfl_sync(kAll, wy, i & 31);
    wz = __shfl_sync(kAll, wz, i & 31);
    if (lane == 0) {
      slot_v[par][warp] = make_float4(__uint_as_float(v), wx, wy, wz);
      slot_i[par][warp] = i;
    }
    __syncthreads();
    const unsigned sent = lane < nwarps ? slot_i[par][lane] : kNone;
    v = lane < nwarps ? __float_as_uint(slot_v[par][lane].x) : 0u;
    i = sent;
    argmax(v, i);
    const float4 w = slot_v[par][__ffs(__ballot_sync(kAll, sent == i)) - 1];
    lx = w.y;
    ly = w.z;
    lz = w.w;
    if (t == 0) o[j] = (int32_t)i;
  }
}

// fps_kernel's threads for N: the fewest of 128, 256, 512 and 1024 whose
// registers hold the cloud, else 1024 and shared memory for the rest.
int block_threads(int N) {
  int T = 128;
  while (T < 1024 && T * kBlockPPT < N) T *= 2;
  return T;
}

// fps_warp_kernel's points a lane: the fewest of 1, 2, 4, ..., 32 that hold N.
int warp_ppt(int N) {
  int ppt = 1;
  while (ppt * 32 < N) ppt *= 2;
  return ppt;
}

// fps_cluster_kernel: one cluster of 16 CTAs per cloud, 512 threads each. CTA
// rank c owns the contiguous points [c * chunk, (c + 1) * chunk), chunk =
// ceil(N / 16), laid out in positions: warp w holds positions [w * span,
// (w + 1) * span), span = 32 * ceil(chunk / 512) (608 at N = 149,504, 128
// at N = 28,672), lane l the offsets 32 k + l, k < PPT, with coordinates
// and running distance in registers for all M iterations and a copy of the
// coordinates in shared memory (12 * PPT * 512 bytes) for the winner's
// lookup. A span longer than 32 * PPT (N above 163,840) keeps the rest's
// distances in a global scratch row and reads their coordinates from global
// memory.
//
// Late in an FPS a pick changes only the distances within the covering
// radius, so most of the cloud lies where no pick reaches. A warp's rows
// are cut into units (4 of 5 rows at PPT 20, 2 of 2 rows at PPT 4; one
// unit of the whole span past the registers); each unit keeps the bounding
// box of its points and its largest running distance on one lane, and its
// winner (that distance, the lowest index holding it, the point) in a
// table in shared memory. Where the spans fit in registers, the CTA first
// orders its points as a k-d tree whose leaves are the units (each split
// sorts a node's points along its longest axis in shared memory, bitonic,
// and cuts at a unit boundary; the last sort orders each unit by index), so
// that a unit's box is tight and a pick reaches few units. An iteration:
//  - the skip test, lane u for unit u: the per-axis gaps from the last pick
//    to the box, each rounded as the pass rounds a point's difference, and
//    their sqdist3. Rounding to nearest is monotone, so that is at most the
//    pass's sqdist3 of every point in the box, exactly and with no margin;
//    where it is at least the unit's largest running distance no fminf can
//    change a distance and the unit's winner stands. Each CTA counts the
//    skipped passes of its units that hold points;
//  - each unit the test lets through: the pass over its rows (strict >, so
//    each lane offers its lowest offset of its largest distance; offsets
//    ascend with indices within a unit) and its argmax: redux.sync of the
//    largest distance bits (distances are >= 0, so their bits order as the
//    values), the ballot of the lanes holding it and, on a tie, redux.sync
//    of the lowest offset among them; the winning lane writes the unit's
//    entry;
//  - __syncthreads, then warp 0 takes the CTA's winner from its 16 R entries:
//    the largest key (distance bits + 1, or 0 for a unit without points),
//    then the lowest index holding it (in k-d order a CTA's units do not
//    own ascending indices), and its lanes c < 16 push it (key, x, y, z: 16
//    bytes) into slot [rank] of CTA c's inbox with st.async, which also
//    counts its bytes on CTA c's mbarrier;
//  - every warp waits on its CTA's mbarrier for the 16 winners and reduces
//    them with redux.sync and a ballot: the largest key, then the lowest
//    rank (ranks own ascending indices), so all 16 CTAs agree on the winner.
//    The winning CTA writes out[j].
// The table is written only by the iteration that changes an entry: an
// entry of iteration j + 1 is written after its writer's CTA holds the 16
// winners of iteration j, among them its own, which warp 0 pushes after it
// has read the table. Inboxes and mbarriers are double-buffered by
// iteration parity. A CTA pushes iteration j + 2's winner into inbox [j & 1]
// only after it has the 16 winners of iteration j + 1, among them the
// receiver's, which the receiver sends after every one of its warps has read
// inbox [j & 1] at iteration j (its __syncthreads lies between), so no slot
// is overwritten while it is read and no mbarrier phase is skipped.
// An iteration's floor is the latency of one remote store, the CTA's
// barrier and the reductions (some 0.6 us on an H100); the pass of the
// units a pick reaches comes on top, a few hundred cycles a unit, whose
// unrolled code a warp seldom finds fetched. The k-d order costs 7 sorts
// of the CTA's keys before the first pick (about 0.75 ms at 149,504
// points), some 2% of the FPS it shortens.
constexpr int kCluster = 16;
constexpr int kClusterThreads = 512;
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kMaxPPT = 20;  // registers: 4 * 20 of a 512-thread block's 128
constexpr int kUnits = 4;  // a warp's units: its rows cut in 4, each with a box and a winner
constexpr int kOfferBytes = 16;  // key, x, y, z
constexpr int kIndexBits = 14;  // a sorted CTA's local index, in a key's low bits
constexpr unsigned kIndexMask = (1u << kIndexBits) - 1;
constexpr int kCoordBits = 12;  // a coordinate quantised along its node's longest axis
constexpr int kSortedPoints = 1 << kIndexBits;  // a sorted CTA's keys at most

// The points of a CTA's chunk that each of its warps owns.
__host__ __device__ inline int cluster_span(int chunk) {
  return 32 * ((chunk + kClusterThreads - 1) / kClusterThreads);
}

// A warp's units (R) and their rows (ROWS) for PPT points a lane: 4 units,
// or units of 2 rows up to 4 rows; one unit, all of the span, past the
// registers.
template <int PPT, bool SPILL>
struct Units {
  static constexpr int R = SPILL ? 1 : (PPT <= kUnits ? PPT / 2 : kUnits);
  static constexpr int ROWS = PPT / R;
  static constexpr int CTA = kClusterWarps * R;  // a CTA's units
  static constexpr int LEVELS = R == 4 ? 6 : (R == 2 ? 5 : 4);  // log2(CTA)
};

// The largest of a[k0, k0 + KN) and its lowest k, as a tree of pairwise
// maxima in which the higher k wins only where it is strictly larger (k0
// is a constant once the caller's loop is unrolled).
template <int KN, int PPT>
__device__ __forceinline__ void tree_argmax(const float (&a)[PPT], int k0, float& v, int& k) {
  float val[KN];
  int idx[KN];
#pragma unroll
  for (int q = 0; q < KN; ++q) {
    val[q] = a[k0 + q];
    idx[q] = k0 + q;
  }
#pragma unroll
  for (int step = 1; step < KN; step *= 2) {
#pragma unroll
    for (int q = 0; q + step < KN; q += 2 * step) {
      if (val[q + step] > val[q]) {
        val[q] = val[q + step];
        idx[q] = idx[q + step];
      }
    }
  }
  v = val[0];
  k = idx[0];
}

// Sorts keys[0, n) ascending in shared memory, n a power of two, by the
// whole CTA (a bitonic network: each stage compares n / 2 pairs).
__device__ void bitonic_sort(unsigned* keys, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = threadIdx.x; q < n / 2; q += kClusterThreads) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const unsigned a = keys[i], c = keys[i + j];
        if ((a > c) == ((i & k) == 0)) {
          keys[i] = c;
          keys[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// The lowest lane holding the warp's largest v.
__device__ __forceinline__ int lowest_largest(unsigned v) {
  return __ffs(__ballot_sync(kAll, v == __reduce_max_sync(kAll, v))) - 1;
}

// The gap from v to [lo, hi], rounded as the pass rounds p - v for p in it.
__device__ __forceinline__ float gap(float v, float lo, float hi) {
  return v < lo ? lo - v : (v > hi ? v - hi : 0.0f);
}

// Widens box by the lane's points in rows [k0, k0 + KN) (k0 a constant once
// the caller's loop is unrolled).
template <int KN, int PPT>
__device__ __forceinline__ void rows_box(const float (&px)[PPT], const float (&py)[PPT],
                                         const float (&pz)[PPT], const float (&pd)[PPT], int k0,
                                         float (&box)[6]) {
#pragma unroll
  for (int k = k0; k < k0 + KN; ++k) {
    if (pd[k] >= 0.0f) {  // a real point
      box[0] = fminf(box[0], px[k]), box[3] = fmaxf(box[3], px[k]);
      box[1] = fminf(box[1], py[k]), box[4] = fmaxf(box[4], py[k]);
      box[2] = fminf(box[2], pz[k]), box[5] = fmaxf(box[5], pz[k]);
    }
  }
}

// The union of the lanes' boxes, on every lane.
__device__ __forceinline__ void warp_box(float (&box)[6]) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      box[c] = fminf(box[c], __shfl_xor_sync(kAll, box[c], s));
      box[3 + c] = fmaxf(box[3 + c], __shfl_xor_sync(kAll, box[3 + c], s));
    }
  }
}

template <int PPT, bool SPILL>
__global__ void __launch_bounds__(kClusterThreads, 1)
    fps_cluster_kernel(const float* __restrict__ pts, int N, int M, int chunk,
                       float* __restrict__ spill, long long* __restrict__ skipped,
                       int32_t* __restrict__ out) {
  using U = Units<PPT, SPILL>;
  constexpr int R = U::R, ROWS = U::ROWS;
  constexpr int HELD = 32 * PPT;  // a warp's points held in registers
  extern __shared__ float held_xyz[];  // x, y, z [kClusterWarps * HELD] each; the keys
  __shared__ float unit_box[U::CTA][6];  // the k-d build's boxes
  __shared__ float node_cut[U::CTA / 2][3];  // each node's axis, low end, scale
  __shared__ uint4 table[U::CTA];  // key, x, y, z of each unit's winner
  __shared__ unsigned table_i[U::CTA];  // its index
  __shared__ uint4 inbox[2][kCluster];  // key, x, y, z of each CTA's winner
  __shared__ uint64_t full[2];  // the 16 winners of an iteration have landed
  __shared__ unsigned long long cta_skips;

  const int rank = (int)p2pb::cluster_ctarank();
  const int b = blockIdx.x / kCluster;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int span = cluster_span(chunk);
  const int first = rank * chunk + warp * span;  // the warp's first position
  const int count = max(0, min(span, min(chunk - warp * span, N - first)));  // its points
  const int cta_count = max(0, min(chunk, N - rank * chunk));
  const float* p = pts + ((size_t)b * N + first) * 3;
  float* sx = held_xyz + warp * HELD;
  float* sy = sx + kClusterWarps * HELD;
  float* sz = sy + kClusterWarps * HELD;
  float* sd = spill + ((size_t)(b * kCluster + rank) * kClusterWarps + warp) * max(0, span - HELD);
  unsigned* keys = reinterpret_cast<unsigned*>(held_xyz + 3 * kClusterWarps * HELD);
  const bool sorted = !SPILL && cta_count > 0;
  // the CTA's unit of a position
  auto unit_of = [&](int pos) {
    const int w = pos / span;
    return w * R + min((pos - w * span) / (32 * ROWS), R - 1);
  };

  // The CTA's points in k-d order (the spans fit in registers): the
  // coordinates by local index in held_xyz, keys[position] = local index.
  // Each split sorts every node's points by (node, its longest axis
  // quantised, index) and cuts at a unit boundary; the last sort orders
  // each unit by index.
  if (sorted) {
    const float* c = pts + ((size_t)b * N + rank * chunk) * 3;
    float* hx = held_xyz;
    float* hy = hx + kClusterWarps * HELD;
    float* hz = hy + kClusterWarps * HELD;
    int n2 = 1;
    while (n2 < cta_count) n2 <<= 1;
    for (int i = t; i < n2; i += kClusterThreads) {
      keys[i] = i < cta_count ? (unsigned)i : kNone;
      if (i < cta_count) {
        hx[i] = c[3 * i];
        hy[i] = c[3 * i + 1];
        hz[i] = c[3 * i + 2];
      }
    }
    __syncthreads();
    for (int level = 0; level <= U::LEVELS; ++level) {
      if (level < U::LEVELS) {
#pragma unroll
        for (int u = 0; u < R; ++u) {  // the boxes of the warp's units
          float bx[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY, -INFINITY};
          for (int o = 32 * ROWS * u + lane; o < min(count, 32 * ROWS * (u + 1)); o += 32) {
            const unsigned i = keys[warp * span + o] & kIndexMask;
            bx[0] = fminf(bx[0], hx[i]), bx[3] = fmaxf(bx[3], hx[i]);
            bx[1] = fminf(bx[1], hy[i]), bx[4] = fmaxf(bx[4], hy[i]);
            bx[2] = fminf(bx[2], hz[i]), bx[5] = fmaxf(bx[5], hz[i]);
          }
          warp_box(bx);
          if (lane == 0) {
#pragma unroll
            for (int q = 0; q < 6; ++q) unit_box[warp * R + u][q] = bx[q];
          }
        }
        __syncthreads();
        const int per = U::CTA >> level;  // units a node
        if (t < (1 << level)) {  // node t: the union of its units' boxes, its longest axis
          float lx0 = INFINITY, ly0 = INFINITY, lz0 = INFINITY;
          float hx1 = -INFINITY, hy1 = -INFINITY, hz1 = -INFINITY;
          for (int u = t * per; u < (t + 1) * per; ++u) {
            lx0 = fminf(lx0, unit_box[u][0]), hx1 = fmaxf(hx1, unit_box[u][3]);
            ly0 = fminf(ly0, unit_box[u][1]), hy1 = fmaxf(hy1, unit_box[u][4]);
            lz0 = fminf(lz0, unit_box[u][2]), hz1 = fmaxf(hz1, unit_box[u][5]);
          }
          const float ex = hx1 - lx0, ey = hy1 - ly0, ez = hz1 - lz0;
          const int axis = ey > ex ? (ez > ey ? 2 : 1) : (ez > ex ? 2 : 0);
          const float extent = axis == 0 ? ex : (axis == 1 ? ey : ez);
          node_cut[t][0] = (float)axis;
          node_cut[t][1] = axis == 0 ? lx0 : (axis == 1 ? ly0 : lz0);
          node_cut[t][2] = extent > 0.0f ? ((1 << kCoordBits) - 1) / extent : 0.0f;
        }
        __syncthreads();
      }
      for (int pos = t; pos < cta_count; pos += kClusterThreads) {
        const unsigned i = keys[pos] & kIndexMask;
        const int u = unit_of(pos);
        unsigned key = (unsigned)u << kIndexBits;  // the last round: unit, then index
        if (level < U::LEVELS) {
          const int node = u >> (U::LEVELS - level);
          const int axis = (int)node_cut[node][0];
          const float v = axis == 0 ? hx[i] : (axis == 1 ? hy[i] : hz[i]);
          const float q = fminf(fmaxf((v - node_cut[node][1]) * node_cut[node][2], 0.0f),
                                (float)((1 << kCoordBits) - 1));
          key = ((unsigned)node << (kCoordBits + kIndexBits)) | ((unsigned)q << kIndexBits);
        }
        keys[pos] = key | i;
      }
      __syncthreads();
      bitonic_sort(keys, n2);
    }
  }
  // the warp's points in registers and, by position, in held_xyz (a copy
  // for the winner's lookup)
  float px[PPT], py[PPT], pz[PPT], pd[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int o = 32 * k + lane;
    if (o < count) {
      const float* q = sorted ? held_xyz + (keys[warp * span + o] & kIndexMask) : p + 3 * o;
      const int stride = sorted ? kClusterWarps * HELD : 1;
      px[k] = q[0];
      py[k] = q[stride];
      pz[k] = q[2 * stride];
      pd[k] = FLT_MAX;
    } else {  // padding: a distance below every real one never wins
      px[k] = py[k] = pz[k] = 0.0f;
      pd[k] = -1.0f;
    }
  }
  __syncthreads();  // every point read from held_xyz before it is overwritten
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int o = 32 * k + lane;
    if (o < count) {
      sx[o] = px[k];
      sy[o] = py[k];
      sz[o] = pz[k];
    }
  }
  // the local index of the warp's point at offset o
  auto index_of = [&](int o) {
    return (unsigned)(sorted ? rank * chunk + (keys[warp * span + o] & kIndexMask) : first + o);
  };
  // Each unit: its box and its largest running distance on lane u, its
  // winner (while every distance is FLT_MAX: its first point) in the
  // table. A unit without points has an empty box, so it always skips, and
  // offers key 0.
  float box[6];
  float ud = -1.0f;
  unsigned holding = 0;  // the units that hold points
#pragma unroll
  for (int u = 0; u < R; ++u) {
    float bx[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY, -INFINITY};
    rows_box<ROWS, PPT>(px, py, pz, pd, u * ROWS, bx);
    const int o0 = 32 * ROWS * u;  // the unit's first offset
    if (SPILL) {  // one unit: the spill points too
#pragma unroll 1
      for (int o = HELD + lane; o < count; o += 32) {
        const float* q = p + 3 * (size_t)o;
        sd[o - HELD] = FLT_MAX;
        bx[0] = fminf(bx[0], q[0]), bx[3] = fmaxf(bx[3], q[0]);
        bx[1] = fminf(bx[1], q[1]), bx[4] = fmaxf(bx[4], q[1]);
        bx[2] = fminf(bx[2], q[2]), bx[5] = fmaxf(bx[5], q[2]);
      }
    }
    warp_box(bx);
    if (lane == u) {
#pragma unroll
      for (int q = 0; q < 6; ++q) box[q] = bx[q];
      ud = o0 < count ? FLT_MAX : -1.0f;
    }
    if (o0 < count) holding |= 1u << u;
    if (lane == 0) {
      table[warp * R + u] = make_uint4(o0 < count ? __float_as_uint(FLT_MAX) + 1u : 0u,
                                       __float_as_uint(px[u * ROWS]), __float_as_uint(py[u * ROWS]),
                                       __float_as_uint(pz[u * ROWS]));
      table_i[warp * R + u] = o0 < count ? index_of(o0) : kNone;
    }
  }
  if (lane >= R) {  // no unit: never active
#pragma unroll
    for (int q = 0; q < 3; ++q) box[q] = INFINITY, box[3 + q] = -INFINITY;
  }
  unsigned skips = 0, cta_i = 0;  // warp 0: the index of its CTA's winner

  const float* cloud = pts + (size_t)b * N * 3;
  float lx = cloud[0], ly = cloud[1], lz = cloud[2];
  if (t == 0) {
    if (rank == 0) out[(size_t)b * M] = 0;
    cta_skips = 0;
    p2pb::mbar_init(&full[0], 1);
    p2pb::mbar_init(&full[1], 1);
    p2pb::fence_mbar_init_cluster();
  }
  __syncthreads();
  p2pb::cluster_sync();  // every CTA's mbarriers are ready before the first push

  for (int j = 1; j < M; ++j) {
    const int buf = j & 1;
    if (t == 0) p2pb::mbar_arrive_expect_tx(&full[buf], kCluster * kOfferBytes);
    // lane u tests unit u
    const unsigned active = __ballot_sync(
        kAll, p2pb::sqdist3(gap(lx, box[0], box[3]), gap(ly, box[1], box[4]),
                            gap(lz, box[2], box[5])) < ud);
    skips += __popc(holding & ~active);
#pragma unroll
    for (int u = 0; u < R; ++u) {
      if (active >> u & 1) {
#pragma unroll
        for (int k = u * ROWS; k < (u + 1) * ROWS; ++k)
          pd[k] = fminf(pd[k], p2pb::sqdist3(px[k] - lx, py[k] - ly, pz[k] - lz));
        float bv;
        int bo;
        tree_argmax<ROWS, PPT>(pd, u * ROWS, bv, bo);
        bo = 32 * bo + lane;
        if (SPILL) {
#pragma unroll 1
          for (int o = HELD + lane; o < count; o += 32) {  // offsets above every register's
            const float* q = p + 3 * (size_t)o;
            const float dd = fminf(sd[o - HELD], p2pb::sqdist3(q[0] - lx, q[1] - ly, q[2] - lz));
            sd[o - HELD] = dd;
            if (dd > bv) {
              bv = dd;
              bo = o;
            }
          }
        }
        float cx, cy, cz;  // the lane's best point, fetched while the warp reduces
        if (!SPILL || bo < HELD) {
          cx = sx[bo];
          cy = sy[bo];
          cz = sz[bo];
        } else {
          const float* q = p + 3 * (size_t)bo;
          cx = q[0];
          cy = q[1];
          cz = q[2];
        }
        // the unit's largest distance (a lane without points offers bits
        // 0), then its lowest offset: the only lane holding it, or on a tie
        // the lowest offset among the lanes holding it (offsets ascend with
        // indices within a unit)
        const bool real = bv >= 0.0f;
        const unsigned v = real ? __float_as_uint(bv) : 0u;
        const unsigned best = __reduce_max_sync(kAll, v);
        unsigned holders = __ballot_sync(kAll, real && v == best);
        if (holders & (holders - 1)) {
          const unsigned low = __reduce_min_sync(kAll, real && v == best ? (unsigned)bo : kNone);
          holders = __ballot_sync(kAll, (unsigned)bo == low);
        }
        if (lane == u) ud = __uint_as_float(best);
        if (lane == __ffs(holders) - 1) {
          table[warp * R + u] = make_uint4(best + 1u, __float_as_uint(cx), __float_as_uint(cy),
                                           __float_as_uint(cz));
          table_i[warp * R + u] = index_of(bo);
        }
      }
    }
    __syncthreads();
    if (warp == 0) {
      // the CTA's winner: the largest key, then the lowest index holding it
      // (in k-d order a CTA's units do not own ascending indices)
      unsigned key = 0, idx = kNone;
      uint4 e = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int s = lane; s < U::CTA; s += 32) {
        const uint4 c = table[s];
        const unsigned ci = table_i[s];
        if (c.x > key || (c.x == key && ci < idx)) {
          key = c.x;
          idx = ci;
          e = c;
        }
      }
      const unsigned best = __reduce_max_sync(kAll, key);
      unsigned holders = __ballot_sync(kAll, key == best);
      if (holders & (holders - 1)) {
        const unsigned low = __reduce_min_sync(kAll, key == best ? idx : kNone);
        holders = __ballot_sync(kAll, key == best && idx == low);
      }
      const int owner = __ffs(holders) - 1;
      const uint4 w = make_uint4(best, __shfl_sync(kAll, e.y, owner), __shfl_sync(kAll, e.z, owner),
                                 __shfl_sync(kAll, e.w, owner));
      cta_i = __shfl_sync(kAll, idx, owner);
      if (lane < kCluster)
        p2pb::st_async_u4(p2pb::cluster_map(&inbox[buf][rank], lane), w,
                          p2pb::cluster_map(&full[buf], lane));
    }
    // the phase of full[buf] that iteration j completes: its ((j - 1) / 2)th
    p2pb::mbar_wait(&full[buf], ((j - 1) >> 1) & 1);
    const int s = lowest_largest(lane < kCluster ? inbox[buf][lane].x : 0u);
    const uint4 w = inbox[buf][s];
    lx = __uint_as_float(w.y);
    ly = __uint_as_float(w.z);
    lz = __uint_as_float(w.w);
    if (t == 0 && s == rank) out[(size_t)b * M + j] = (int32_t)cta_i;
  }
  if (lane == 0 && skips) atomicAdd(&cta_skips, (unsigned long long)skips);
  p2pb::cluster_sync();  // no CTA exits while another may still push to it
  if (t == 0) skipped[(size_t)b * kCluster + rank] = (long long)cta_skips;
}

// The cluster kernel's points per thread for N: the fewest of 2, 4, 8, 12,
// 16 and 20 that hold a warp's span, else 20 and a spill row.
int cluster_ppt(int N) {
  const int chunk = (N + kCluster - 1) / kCluster;
  const int need = cluster_span(chunk) / 32;
  constexpr int kFewer[] = {2, 4, 8, 12, 16};
  for (int ppt : kFewer)
    if (need <= ppt) return ppt;
  return kMaxPPT;
}

// A warp's points past its registers, for N (0 up to 163,840 points).
int cluster_spill(int N) {
  const int chunk = (N + kCluster - 1) / kCluster;
  return std::max(0, cluster_span(chunk) - 32 * cluster_ppt(N));
}

// Sets the kernel's attributes and checks that a cluster of 16 with its
// shared memory can be resident, once per card; then launches it.
template <int PPT, bool SPILL>
int launch_cluster(const float* pts, int B, int N, int M, float* spill, long long* skipped,
                   int32_t* out, cudaStream_t stream) {
  static bool ready[MAX_DEVICES];
  auto kernel = fps_cluster_kernel<PPT, SPILL>;
  const int chunk = (N + kCluster - 1) / kCluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * kCluster);
  cfg.blockDim = dim3(kClusterThreads);
  // the coordinates; the sort's keys where the spans fit in registers
  const size_t most = (size_t)12 * PPT * kClusterThreads + (SPILL ? 0 : 4 * kSortedPoints);
  cfg.dynamicSmemBytes = most;
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
                                      (int)most);
    int clusters = 0;
    if (!err) err = (int)cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &cfg);
    // a cluster that cannot be resident would never run: refuse the launch
    if (!err && clusters < 1) err = (int)cudaErrorLaunchOutOfResources;
    ready[dev] = !err;
  }
  if (err) return err;
  int keys = 1;
  while (keys < chunk) keys <<= 1;
  cfg.dynamicSmemBytes = (size_t)12 * PPT * kClusterThreads + (SPILL ? 0 : (size_t)4 * keys);
  err = (int)cudaLaunchKernelEx(&cfg, kernel, pts, N, M, chunk, spill, skipped, out);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace


// pts [B, N, 3] f32, out [B, M] int32, 1 <= M <= N <= 16,383: one warp
// per cloud up to 1,024 points, else one block.
P2PB_API int p2pb_fps(const void* pts, int B, int N, int M, void* out, int device,
                      void* stream) {
  P2PB_ON_DEVICE(device);
  if (N < 1 || N > kBlockMaxPoints || M < 1 || M > N) return (int)cudaErrorInvalidValue;
  const float* p = (const float*)pts;
  int32_t* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (N <= kWarpMaxPoints) {
    switch (warp_ppt(N)) {
#define P2PB_WARP(ppt) \
  case ppt: fps_warp_kernel<ppt><<<B, 32, 0, s>>>(p, N, M, o); break;
      P2PB_WARP(1) P2PB_WARP(2) P2PB_WARP(4) P2PB_WARP(8) P2PB_WARP(16) P2PB_WARP(32)
#undef P2PB_WARP
    }
    return (int)cudaGetLastError();
  }
  const int T = block_threads(N);
  const int extra = N - kBlockPPT * T;
  // once per card: room in shared memory for the largest cloud's spill
  static bool ready[MAX_DEVICES];
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!ready[device]) {
    const int err = (int)cudaFuncSetAttribute(
        fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        16 * (kBlockMaxPoints - kBlockPPT * 1024));
    if (err) return err;
    ready[device] = true;
  }
  fps_kernel<<<B, T, extra > 0 ? 16 * (size_t)extra : 0, s>>>(p, N, M, o);
  return (int)cudaGetLastError();
}

// Bytes of global scratch the cluster kernel needs for this shape (0: none):
// the distances of the points past the registers, N above 163,840.
P2PB_API long long p2pb_fps_cluster_scratch_bytes(int B, int N) {
  return (long long)B * kCluster * kClusterWarps * cluster_spill(N) * 4;
}

// The cluster kernel's units that hold points of a cloud of N: each of them
// makes or skips one pass an iteration.
P2PB_API long long p2pb_fps_cluster_units(int N) {
  const int chunk = (N + kCluster - 1) / kCluster, span = cluster_span(chunk);
  const bool spill = cluster_spill(N) > 0;
  const int units = spill ? 1 : (cluster_ppt(N) <= kUnits ? cluster_ppt(N) / 2 : kUnits);
  const int unit = spill ? span : 32 * (cluster_ppt(N) / units);  // a unit's offsets
  long long held = 0;
  for (int c = 0; c < kCluster; ++c) {
    const int cta = std::max(0, std::min(chunk, N - c * chunk));
    for (int w = 0; w < kClusterWarps; ++w) {
      const int count = std::max(0, std::min(span, cta - w * span));
      held += std::min(units, (count + unit - 1) / unit);
    }
  }
  return held;
}

// pts [B, N, 3] f32, out [B, M] int32, 1 <= M <= N, 16 * B blocks at most
// 2^31 - 1; scratch as p2pb_fps_cluster_scratch_bytes says; skipped [B, 16]
// int64 gets each CTA's count of skipped passes. Returns
// cudaErrorLaunchOutOfResources where a 16-CTA cluster cannot be resident.
P2PB_API int p2pb_fps_cluster(const void* pts, int B, int N, int M, void* scratch,
                              void* skipped, void* out, int device, void* stream) {
  P2PB_ON_DEVICE(device);
  const float* p = (const float*)pts;
  float* sd = (float*)scratch;
  long long* sk = (long long*)skipped;
  int32_t* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (cluster_spill(N)) return launch_cluster<kMaxPPT, true>(p, B, N, M, sd, sk, o, s);
  switch (cluster_ppt(N)) {
    case 2: return launch_cluster<2, false>(p, B, N, M, sd, sk, o, s);
    case 4: return launch_cluster<4, false>(p, B, N, M, sd, sk, o, s);
    case 8: return launch_cluster<8, false>(p, B, N, M, sd, sk, o, s);
    case 12: return launch_cluster<12, false>(p, B, N, M, sd, sk, o, s);
    case 16: return launch_cluster<16, false>(p, B, N, M, sd, sk, o, s);
    default: return launch_cluster<kMaxPPT, false>(p, B, N, M, sd, sk, o, s);
  }
}

P2PB_API const char* p2pb_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
