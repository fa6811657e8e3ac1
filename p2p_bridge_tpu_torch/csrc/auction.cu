// K7: auction assignment over a squared-distance matrix. d2 [B, N, M] f32
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
// What bounds it on the H100: bytes. Each round reads the d2 row of every
// point that bids (2048 floats at the PUNet training shape), and the first
// rounds have every point bidding; the least the card could do is read d2
// once. Design: the TPU keeps a cloud's [N, M] matrix in VMEM and makes
// masked [N, M] passes per round; that is not carried over. Here one block
// serves one cloud with price, owner, each point's object and the round's
// winning keys in shared memory (16 M + 4 N bytes), and reads d2 rows from
// device memory. A round has three phases split by block-wide barriers:
// clear the keys; each warp takes the unowned points in turn and scans the
// row with 16-byte loads, lanes keeping a running best (first occurrence)
// and second value that a shuffle tree merges, then lane 0 places its bid
// with one 64-bit atomicMax on (order-preserving bits of bid) << 32 |
// (N - 1 - point), which is "highest bid, then lowest index" in one
// operation; then one thread per object awards it. Arithmetic uses
// __fsub_rn / __fadd_rn, so every value is the plain version's to the bit
// and the assignment is equal, not close. A later design can spread a cloud
// over a thread-block cluster.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr float NEG = -1e30f;

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
  if (v > t.best) {
    t.second = fmaxf(t.second, t.best);
    t.best = v;
    t.idx = m;
  } else {
    t.second = fmaxf(t.second, v);
  }
}

__device__ __forceinline__ Top2 warp_merge(Top2 t) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Top2 o;
    o.best = __shfl_xor_sync(0xffffffffu, t.best, off);
    o.second = __shfl_xor_sync(0xffffffffu, t.second, off);
    o.idx = __shfl_xor_sync(0xffffffffu, t.idx, off);
    if (o.best > t.best || (o.best == t.best && o.idx < t.idx)) {
      o.second = fmaxf(o.second, t.best);
      t = o;
    } else {
      t.second = fmaxf(t.second, o.best);
    }
  }
  return t;
}

// top 2 of value = -d2[row] - price over the row, in the warp
__device__ Top2 scan_row(const float* __restrict__ row, const float* price,
                         int M, int lane) {
  Top2 t{-__int_as_float(0x7f800000), NEG, 0x7fffffff};  // -inf
  if ((M & 3) == 0) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* p4 = reinterpret_cast<const float4*>(price);
#pragma unroll 4
    for (int j = lane; j < (M >> 2); j += 32) {
      const float4 d = __ldg(r4 + j);
      const float4 p = p4[j];
      push(t, __fsub_rn(-d.x, p.x), 4 * j);
      push(t, __fsub_rn(-d.y, p.y), 4 * j + 1);
      push(t, __fsub_rn(-d.z, p.z), 4 * j + 2);
      push(t, __fsub_rn(-d.w, p.w), 4 * j + 3);
    }
  } else {
    for (int m = lane; m < M; m += 32) push(t, __fsub_rn(-__ldg(row + m), price[m]), m);
  }
  return warp_merge(t);
}

__global__ void __launch_bounds__(THREADS)
    auction_kernel(const float* __restrict__ d2, int N, int M, float eps,
                   int iters, int32_t* __restrict__ assign_out,
                   float* __restrict__ dist_out, int32_t* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  float* price = reinterpret_cast<float*>(keys + M);
  int* owner = reinterpret_cast<int*>(price + M);
  int* assign = owner + M;
  __shared__ int unowned, bid_rows, leftover;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = THREADS / 32;
  const float* D = d2 + (size_t)b * N * M;

  for (int m = tid; m < M; m += THREADS) {
    price[m] = 0.0f;
    owner[m] = N;
  }
  for (int n = tid; n < N; n += THREADS) assign[n] = -1;
  if (tid == 0) {
    unowned = N;
    bid_rows = 0;
    leftover = 0;
  }
  __syncthreads();

  int round = 0;
  while (round < iters && unowned > 0) {
    for (int m = tid; m < M; m += THREADS) keys[m] = 0ull;
    __syncthreads();
    int rows = 0;
    for (int p = warp; p < N; p += warps) {
      if (assign[p] >= 0) continue;  // the same for the whole warp
      const Top2 t = scan_row(D + (size_t)p * M, price, M, lane);
      if (lane == 0) {
        const float bid = __fadd_rn(__fsub_rn(t.best, t.second), eps);
        const unsigned long long key =
            ((unsigned long long)ordered(bid) << 32) | (unsigned)(N - 1 - p);
        atomicMax(keys + t.idx, key);
        ++rows;
      }
    }
    if (lane == 0 && rows) atomicAdd(&bid_rows, rows);
    __syncthreads();
    int newly_owned = 0;
    for (int m = tid; m < M; m += THREADS) {
      const unsigned long long key = keys[m];
      if (key == 0ull) continue;
      const int winner = N - 1 - (int)(key & 0xffffffffull);
      price[m] = __fadd_rn(price[m], unordered((unsigned)(key >> 32)));
      const int old = owner[m];
      if (old < N)
        assign[old] = -1;  // evicted; it bid on no object this round
      else
        ++newly_owned;
      owner[m] = winner;
      assign[winner] = m;
    }
    if (newly_owned) atomicSub(&unowned, newly_owned);
    __syncthreads();
    ++round;
  }

  // leftovers: the first-occurrence argmax at the final prices
  for (int p = warp; p < N; p += warps) {
    int a = assign[p];
    if (a < 0) a = scan_row(D + (size_t)p * M, price, M, lane).idx;
    if (assign[p] < 0 && lane == 0) atomicAdd(&leftover, 1);
    if (lane == 0) {
      assign_out[(size_t)b * N + p] = a;
      dist_out[(size_t)b * N + p] = D[(size_t)p * M + a];
    }
  }
  __syncthreads();
  if (tid == 0) {
    stats[3 * b] = round;
    stats[3 * b + 1] = bid_rows;
    stats[3 * b + 2] = leftover;
  }
}

}  // namespace

P2PB_API long long p2pb_auction_smem_bytes(int N, int M) {
  return 16ll * M + 4ll * N;
}

// d2 [B, N, M] f32 (16-byte aligned), assign [B, N] int32, dist [B, N] f32,
// stats [B, 3] int32 (rounds run, bidder rows scanned, fallback points).
P2PB_API int p2pb_auction_emd(const void* d2, int B, int N, int M, float eps,
                              int iters, void* assign, void* dist, void* stats,
                              int device, void* stream) {
  P2PB_ON_DEVICE(device);
  const size_t smem = (size_t)p2pb_auction_smem_bytes(N, M);
  int err = (int)cudaFuncSetAttribute(
      auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  auction_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)d2, N, M, eps, iters, (int32_t*)assign, (float*)dist,
      (int32_t*)stats);
  return (int)cudaGetLastError();
}
