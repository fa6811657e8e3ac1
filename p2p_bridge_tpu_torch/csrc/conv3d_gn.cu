// K1: 3x3x3 SAME voxel convolution + bias, then GroupNorm with a shared [C]
// or per-cloud [B, C] affine, then an optional swish.
// x [B, R, R, R, Cin] T, w [3, 3, 3, Cin, Cout] T -> y [B, R, R, R, Cout] T,
// T f32 or bf16; bias, gamma and beta f32.
//
// Replaces p2p_bridge_tpu/ops/pallas/wconv3d_kernel.py:wconv3d_gn_pallas
// (_conv_fwd, _kernel), with the math of
// p2p_bridge_tpu/ops/pallas/conv3d_kernel.py:_ref_conv and _apply_gn_xla:
// per (cloud, group) statistics over all voxels from the f32 accumulator,
// variance E[y^2] - m^2. It serves every PVConv shape of the shipped
// configs (Cin 35..512, Cout 32..512, r 8..32).
//
// What bounds it on the H100: operations. A PVDS_PUNet forward at 73
// patches runs 3.2 TFLOP of these convolutions: 3.2 ms at the 989 TFLOP/s of
// the bf16 tensor cores, 48 ms at the 67 TFLOP/s of the f32 CUDA cores. The
// GroupNorm statistics span the whole grid of a cloud, i.e. many blocks.
// Both paths are an implicit GEMM per cloud: M = voxels, N = Cout,
// K = 27 * Cin ordered (dx, dy, dz, ci) like the weight; a tile never spans
// two clouds.
//
// bf16 (conv_wgmma_kernel), the path PVDS_PUNet runs as shipped:
//  * a tile is 128 or 256 consecutive voxels of one cloud x N channels,
//    N the widest of 256, 128, 64, 32 that divides Cout (N = Cout up to
//    256: no idle lane; Cout = 512 takes two tiles of 256), a box of the 5-D
//    input: (1, 1, 4, 32) at r = 32, (1, 1, 8, 16) at r = 16, (1, 2, 8, 8) at
//    r = 8 for 128 voxels. The A operand of tap (dx, dy, dz) is that box
//    shifted by the tap. TMA loads it in tiled mode (signed coordinates,
//    out-of-bounds elements zero-filled), so SAME padding costs no masks
//    and no thread time; and it loads the box once with a one-voxel halo
//    in y, whose three row ranges (whole 8-row swizzle groups apart) are
//    the A tiles of the three dy taps: half or less of the A traffic of
//    one box per tap. The wrapper pads Cin to a multiple of 32 with zero channels
//    (TMA wants 16-byte rows; 35 -> 64) and passes the weight as
//    [dx, dz, dy, Cout, Cin], so the K-major B tiles of the three dy taps
//    of a k-chunk are one more TMA box (K-major like A: both operands take
//    one descriptor form, for a per-call copy of the small weight);
//  * a ring of stages (that input box + three weight tiles, k-chunks of 64
//    channels where they fit, else 32, rows swizzled by their width) in
//    dynamic shared memory with a full and an empty mbarrier each. One
//    producer thread keeps the TMA loads in flight; two consumer
//    warpgroups issue wgmma.mma_async m64nNk16 (bf16 in, f32 accumulate)
//    from shared memory, each on one or two 64-row blocks: two independent
//    accumulator chains keep the tensor cores busier than one where the
//    registers allow it (N <= 128) and the card still gets four tiles a
//    block; they keep one group of MMAs in flight and hand a stage back
//    when the MMAs reading it are done;
//  * persistent blocks, one per block slot of the card, walk the tiles
//    cloud-major (the blocks in flight share a cloud's input in L2), and
//    the ring runs on across tiles, so a tile's epilogue overlaps the next
//    one's loads;
//  * epilogue: bias added in f32; each tile's (sum, sum of squares) per
//    slot of N / 8 channels from the f32 registers (shuffles, then a fixed
//    order over the eight warps), one deterministic partial per (cloud,
//    slot, tile), no atomics; a GroupNorm group is one or more whole
//    slots; the pre-norm grid stored in bf16 straight into the output,
//    as the TPU kernel stages it in the compute dtype.
// f32 (conv_ffma_kernel), the f32 twin and any run with training.amp off:
// exact f32 products and sums by FFMA (no TF32). Bound by the 67 TFLOP/s of
// the CUDA cores (48 ms a PVDS_PUNet forward at B = 73), so the design keeps
// the FMA pipes fed and nothing else in their way:
//  * register blocking: each thread holds 8 x 8 outputs (8 x 4 at N = 32),
//    and per k one float4 of A for each of its 8 rows is reused over 4 k
//    with two float4 of B: 64 FMAs per four 16-byte shared loads. A warp is
//    4 (rows) x 8 (columns) lanes, so an A load is 4 distinct 16-byte
//    values (consecutive voxels, 32 bytes apart: no bank conflict) and a B
//    load 8 contiguous ones, the rest broadcast;
//  * a tile is 128 consecutive voxels of one cloud x N = 32, 64 or 128
//    channels (the widest that divides Cout; Cout = 256 and 512 take
//    channel tiles), 128 or 256 threads;
//  * staging as the bf16 kernel's, in f32: per (dx, k-chunk of 8 channels)
//    one box of the tile's voxels with a one-voxel halo in y and z, loaded
//    once and read as the A tiles of all nine (dy, dz) taps at row offsets
//    (a ninth of the A traffic of one gather per tap), with the nine taps'
//    [8, N] weight slices; 16-byte cp.async copies, zero-filled outside the
//    grid (SAME padding) and past Cin, so the loop has no masks. The
//    wrapper pads Cin to a multiple of 4 (16-byte rows: 35 -> 36);
//  * two stages in dynamic shared memory, one __syncthreads a stage (a
//    stage is 72 k-steps of FMAs, 4,608 a thread): the next stage's copies
//    are in flight while this one computes. Eight warps an SM (one block of
//    256 threads at N = 128, two of 128 below), so a thread may hold up to
//    255 registers: the 64 accumulators, 8 A and 8 B vectors and the
//    addresses fit with no spill. On an NVIDIA H100 80GB HBM3 (700 W) a
//    cap of 128 registers, to fit twice the blocks, spills and runs
//    slower, and a third block of 128 threads, an A prefetch one k-step
//    ahead or 16-channel chunks gain nothing;
//  * R is a template parameter (8, 16, 32), so the box geometry and
//    every shared-memory offset of the inner loop are constants;
//  * epilogue: bias added in f32, the pre-norm grid stored in f32 as
//    16-byte rows, one deterministic GroupNorm partial per (cloud, slot of
//    N / 8 channels, tile) from the f32 values (the thread's rows, then the
//    warp's by shuffles, then a fixed order over the warps), no atomics.
// Then gn_stats_kernel reduces the partials in double and the apply pass
// normalises, applies the affine and the swish in f32 and stores T, in
// place (the bf16 pass with 16-byte vectors of 8 channels). Both take their
// arithmetic from group_norm.cuh, which the point branch's GroupNorm
// (group_norm.cu) shares.
#include <climits>

#include "common.cuh"
#include "group_norm.cuh"
#include "hopper.cuh"

namespace {

constexpr int SLOTS = 8;                // GroupNorm partials a tile: N / 8 channels each
constexpr int MAX_DEVICES = 16;         // cards whose launch state is cached

// ---- f32: cp.async + register-blocked FFMA ----------------------------------
constexpr int FM = 128;  // voxels of an f32 tile
constexpr int FK = 8;    // input channels of a k-chunk

// The bm voxels of a tile as a box: z fastest, then y, then x. With a
// one-voxel halo in y it holds the bf16 kernel's A rows of the three dy
// taps, with halos in y and z the f32 kernel's of all nine (dy, dz) taps.
struct Box {
  int zb, yb, xb;
  __host__ __device__ constexpr Box(int R, int bm)
      : zb(R < bm ? R : bm), yb(R < bm / zb ? R : bm / zb), xb(bm / (zb * yb)) {}
  __host__ __device__ constexpr int halo_rows() const { return zb * (yb + 2) * xb; }
  __host__ __device__ constexpr int halo2_rows() const { return (zb + 2) * (yb + 2) * xb; }
};

// f32 threads a block: 8 x 8 outputs each (8 x 4 at N = 32)
__host__ __device__ constexpr int ffma_threads(int N) { return N == 128 ? 256 : 128; }

// Bytes of one f32 stage: the input box with y and z halos (k-chunk rows of
// 32 bytes) and the [9 (dy, dz)][FK][N] weight slices of one dx.
constexpr int ffma_stage_bytes(int R, int N) {
  return (Box(R, FM).halo2_rows() + 9 * N) * FK * 4;
}

template <int N, int R>
__global__ void __launch_bounds__(ffma_threads(N), N == 128 ? 1 : 2)
    conv_ffma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, int Cin, int Cout,
                     float* __restrict__ y, double* __restrict__ partials) {
  constexpr int NT = ffma_threads(N);
  constexpr int NJ = N == 32 ? 1 : 2;  // float4 column groups of a thread, 32 apart
  constexpr int WM = 4;                // warps along M: 32 rows each
  constexpr Box box(R, FM);
  constexpr int ZB = box.zb, YB = box.yb, ZS = box.zb + 2, YS = box.yb + 2;
  constexpr int ROWS = box.halo2_rows();
  constexpr int A_FLOATS = ROWS * FK, STAGE_FLOATS = A_FLOATS + 9 * FK * N;
  constexpr int T = R * R * R / FM;
  extern __shared__ __align__(16) float fsmem[];
  __shared__ float red[WM][N / 4][2];

  const int CT = Cout / N;
  const int nt = blockIdx.x % CT, tile = (blockIdx.x / CT) % T, b = blockIdx.x / (CT * T);
  const int v0 = tile * FM, n0 = nt * N;
  const int x0 = v0 / (R * R), y0 = (v0 / R) % R, z0 = v0 % R;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % WM, wn = warp / WM, tm = lane >> 3, tn = lane & 7;
  const int col0 = wn * 32 * NJ + tn * 4;  // the thread's first column in the tile
  const float* xb = x + (size_t)b * R * R * R * Cin;

  // the thread's rows m = 32 wm + tm + 4 i: four consecutive z of one box
  // line per warp instruction (32 contiguous bytes each: no bank conflict).
  // A warp's 32 rows lie in one x plane and start a z line, so row i sits
  // 4 i + 2 floor(4 i / ZB) box rows after row 0 (2: the z halo of each
  // line crossed): a constant.
  const int m0 = 32 * wm + tm;
  const int a0 = (((m0 / (ZB * YB)) * YS + (m0 / ZB) % YB) * ZS + m0 % ZB) * FK;

  const int chunks = (Cin + FK - 1) / FK, steps = 3 * chunks;  // (dx, k-chunk)
  // one stage: the box for dx and the chunk, rows zero-filled outside the
  // grid (SAME padding) and past Cin; the chunk's 9 x FK weight rows
  auto load = [&](int st, float* buf) {
    const int dx = st / chunks, ci0 = (st - dx * chunks) * FK;
#pragma unroll
    for (int q0 = 0; q0 < FK / 4 * ROWS; q0 += NT) {  // FK / 4 copies a row
      const int q = q0 + tid;
      if (q < FK / 4 * ROWS) {
        const int row = q / (FK / 4), ci = ci0 + 4 * (q % (FK / 4));
        const int bz = row % ZS, by = (row / ZS) % YS, bx = row / (ZS * YS);
        const int gx = x0 + bx + dx - 1, gy = y0 + by - 1, gz = z0 + bz - 1;
        const bool in = (unsigned)gx < (unsigned)R && (unsigned)gy < (unsigned)R &&
                        (unsigned)gz < (unsigned)R && ci < Cin;
        p2pb::cp_async16(buf + row * FK + 4 * (q % (FK / 4)),
                         in ? xb + ((size_t)(gx * R + gy) * R + gz) * Cin + ci : x, in);
      }
    }
    float* bs = buf + A_FLOATS;
#pragma unroll
    for (int q0 = 0; q0 < 9 * FK * N / 4; q0 += NT) {
      const int q = q0 + tid;
      if (q < 9 * FK * N / 4) {
        const int n4 = q % (N / 4), k = (q / (N / 4)) % FK, tap = q / (N / 4 * FK);
        const int ci = ci0 + k;
        p2pb::cp_async16(
            bs + (tap * FK + k) * N + 4 * n4,
            ci < Cin ? w + ((size_t)(dx * 9 + tap) * Cin + ci) * Cout + n0 + 4 * n4 : w,
            ci < Cin);
      }
    }
    p2pb::cp_async_commit();
  };

  float acc[8][4 * NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NJ; ++j) acc[i][j] = 0.0f;

  load(0, fsmem);
  for (int st = 0; st < steps; ++st) {
    // this stage has landed for every thread, and every thread is done with
    // the other buffer: fill it with the next stage while this one computes
    p2pb::cp_async_wait_all();
    __syncthreads();
    if (st + 1 < steps) load(st + 1, fsmem + ((st + 1) & 1) * STAGE_FLOATS);
    const float* as = fsmem + (st & 1) * STAGE_FLOATS + a0;
    const float* bs = fsmem + (st & 1) * STAGE_FLOATS + A_FLOATS + col0;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {  // (dy, dz)
      const float* at = as + ((tap / 3) * ZS + tap % 3) * FK;
      const float* bt = bs + tap * FK * N;
#pragma unroll
      for (int kq = 0; kq < FK / 4; ++kq) {
        float4 a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a[i] = *reinterpret_cast<const float4*>(at + (4 * i + 2 * (4 * i / ZB)) * FK + 4 * kq);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float bv[4 * NJ];
#pragma unroll
          for (int g = 0; g < NJ; ++g) {
            const float4 b4 = *reinterpret_cast<const float4*>(bt + (4 * kq + kk) * N + 32 * g);
            bv[4 * g] = b4.x;
            bv[4 * g + 1] = b4.y;
            bv[4 * g + 2] = b4.z;
            bv[4 * g + 3] = b4.w;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
            for (int j = 0; j < 4 * NJ; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
          }
        }
      }
    }
  }

  // epilogue: y = acc + bias in f32, stored as float4 rows of 16 bytes; per
  // 4-column group the sums over the thread's 8 rows, then over the warp's
  // 32 (lane bits 3-4), then a fixed order over the WM warps of a column
  float* yt = y + ((size_t)b * R * R * R + v0) * Cout + n0;
#pragma unroll
  for (int g = 0; g < NJ; ++g) {
    const int col = col0 + 32 * g;
    const float* bc = bias + n0 + col;
    const float4 bn = make_float4(__ldg(bc), __ldg(bc + 1), __ldg(bc + 2), __ldg(bc + 3));
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 v = make_float4(acc[i][4 * g] + bn.x, acc[i][4 * g + 1] + bn.y,
                                   acc[i][4 * g + 2] + bn.z, acc[i][4 * g + 3] + bn.w);
      *reinterpret_cast<float4*>(yt + (size_t)(32 * wm + tm + 4 * i) * Cout + col) = v;
      s1 += (v.x + v.y) + (v.z + v.w);
      s2 += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
    }
    s1 += __shfl_xor_sync(0xffffffffu, s1, 8);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 8);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 16);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 16);
    if (tm == 0) {
      red[wm][col / 4][0] = s1;
      red[wm][col / 4][1] = s2;
    }
  }
  __syncthreads();
  if (tid < SLOTS) {
    constexpr int G4 = N / SLOTS / 4;  // 4-column groups of a slot
    double s = 0.0, q = 0.0;
    for (int r = 0; r < WM; ++r)
      for (int c = 0; c < G4; ++c) {
        s += (double)red[r][tid * G4 + c][0];
        q += (double)red[r][tid * G4 + c][1];
      }
    // [cloud][slot of the cloud][tile], as the bf16 kernel writes them
    double* pp = partials + (((size_t)b * SLOTS * CT + nt * SLOTS + tid) * T + tile) * 2;
    pp[0] = s;
    pp[1] = q;
  }
}

// ---- bf16: TMA + wgmma -----------------------------------------------------
constexpr int WTHREADS = 2 * 128 + 32;  // two consumer warpgroups + a producer warp
constexpr int MAX_STAGES = 8;

template <int N, int CK, int MB>
__global__ void __launch_bounds__(WTHREADS, N <= 64 && MB == 1 ? 2 : 1)
    conv_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const float* __restrict__ bias, int B, int R, int Cin,
                      int Cout, int zb, int yb, int stages, p2pb::bf16* __restrict__ y,
                      double* __restrict__ partials) {
  using namespace p2pb;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  __shared__ float red[8][SLOTS][2];

  // the swizzled tiles want 1024-byte aligned stages
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // a stage: the input box with a y halo, [x][y - 1 .. y + yb][z][CK], and
  // the [N, CK] weight slices of the three dy taps
  constexpr int BM = 128 * MB;  // voxels of a tile: MB row blocks of 64 a warpgroup
  constexpr int ROW = CK * 2;   // bytes of one row of a tile
  const int a_bytes = BM / yb * (yb + 2) * ROW, b_bytes = N * ROW;
  uint8_t* As = smem;
  uint8_t* Bs = smem + stages * a_bytes;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int T = R * R * R / BM;  // voxel tiles of a cloud
  const int CT = Cout / N;       // channel tiles, the fastest in the walk
  const int chunks = Cin / CK, steps = 9 * chunks;  // (dx, dz, k-chunk)

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // persistent: block i takes tiles i, i + gridDim.x, ... (cloud-major, so
  // the blocks in flight share a cloud's input in L2, and the channel tiles
  // of one voxel tile its input box); the ring runs on across tiles, so the
  // next tile's loads overlap this one's epilogue
  if (warp == 8) {
    // producer: one thread walks the K steps, up to `stages` ahead
    if (lane == 0) {
      int k = 0;
      for (int tl = blockIdx.x; tl < B * T * CT; tl += gridDim.x) {
        const int b = tl / (T * CT), v0 = (tl / CT - b * T) * BM, n0 = (tl % CT) * N;
        const int x0 = v0 / (R * R), y0 = (v0 / R) % R, z0 = v0 % R;
        for (int st = 0; st < steps; ++st, ++k) {
          const int s = k % stages;
          mbar_wait(&empty[s], ((k / stages) & 1) ^ 1);
          const int dxz = st / chunks, ci0 = (st - dxz * chunks) * CK;
          mbar_arrive_expect_tx(&full[s], a_bytes + 3 * b_bytes);
          tma_load_5d(As + s * a_bytes, &xmap, &full[s], ci0, z0 + dxz % 3 - 1, y0 - 1,
                      x0 + dxz / 3 - 1, b);
          tma_load_4d(Bs + s * 3 * b_bytes, &wmap, &full[s], ci0, n0, 0, dxz);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg computes the row blocks MB wg + c (c < MB) of
  // 64 rows each, with an accumulator chain each. A block lies in one x
  // plane: (z', y', x') of its first row give where it starts in the halo
  // box for dy = -1; dy = 0 and +1 start zb rows on
  const int wg = warp >> 2;
  int halo[MB];
#pragma unroll
  for (int c = 0; c < MB; ++c) {
    const int m = 64 * (MB * wg + c);
    halo[c] = m % zb + zb * ((m / zb) % yb + (yb + 2) * (m / (zb * yb)));
  }
  int k = 0;
  for (int tl = blockIdx.x; tl < B * T * CT; tl += gridDim.x) {
    const int b = tl / (T * CT), tile = tl / CT - b * T, nt = tl % CT;
    float acc[MB][N / 2];
#pragma unroll
    for (int c = 0; c < MB; ++c)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[c][i] = 0.0f;
    for (int st = 0; st < steps; ++st, ++k) {
      const int s = k % stages;
      mbar_wait(&full[s], (k / stages) & 1);
      const uint8_t* a = As + s * a_bytes;
      const uint8_t* bq = Bs + s * 3 * b_bytes;
      wgmma_fence();
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const uint64_t db = wgmma_desc(bq + dy * b_bytes, ROW);
#pragma unroll
        for (int kk = 0; kk < CK / 16; ++kk)
#pragma unroll
          for (int c = 0; c < MB; ++c)
            Wgmma<N>::run(acc[c], wgmma_desc(a + (halo[c] + dy * zb) * ROW, ROW) + 2 * kk,
                          db + 2 * kk);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the MMAs of the step before are done: free its stage
      if (st > 0 && lane == 0) mbar_arrive(&empty[(k - 1) % stages]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < MB; ++c) wgmma_fence_regs(acc[c]);
    if (lane == 0) mbar_arrive(&empty[(k - 1) % stages]);

    // epilogue: y = acc + bias in f32; bf16 store; per-slot sums. Lane
    // (g8, t) holds rows g8 and g8 + 8 of its warp's 16, columns 8j + 2t, +1.
    constexpr int GS = N / SLOTS;                  // channels per slot
    constexpr int NSLOT = GS >= 8 ? SLOTS : N / 8;  // slots a lane touches
    const int g8 = lane >> 2, t = lane & 3;
    bf16* yt = y + ((size_t)b * R * R * R + (size_t)tile * BM) * Cout + nt * N;
    const float* bt = bias + nt * N;
    float s1[NSLOT], s2[NSLOT];
#pragma unroll
    for (int i = 0; i < NSLOT; ++i) s1[i] = s2[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < MB; ++c) {
      const int row = 64 * (MB * wg + c) + (warp & 3) * 16 + g8;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float b0 = __ldg(bt + col), b1 = __ldg(bt + col + 1);
        const int sl = GS >= 8 ? j / (GS / 8) : j;  // GS = 4: slot 2j + t / 2
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v0 = acc[c][4 * j + 2 * h] + b0, v1 = acc[c][4 * j + 2 * h + 1] + b1;
          s1[sl] += v0 + v1;
          s2[sl] += v0 * v0 + v1 * v1;
          *reinterpret_cast<__nv_bfloat162*>(yt + (size_t)(row + 8 * h) * Cout + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    // sum over the warp's rows (lane bits 2-4) and the lanes of one slot
    // (bit 0, and bit 1 unless GS = 4 splits a column block in two slots)
#pragma unroll
    for (int i = 0; i < NSLOT; ++i) {
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        if (GS < 8 && o == 2) continue;
        s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], o);
        s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], o);
      }
    }
    if (GS >= 8 ? lane == 0 : (lane == 0 || lane == 2)) {
#pragma unroll
      for (int i = 0; i < NSLOT; ++i) {
        const int g = GS >= 8 ? i : 2 * i + (lane >> 1);
        red[warp][g][0] = s1[i];
        red[warp][g][1] = s2[i];
      }
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the two consumer warpgroups
    if (tid < SLOTS) {
      double s = 0.0, q = 0.0;
      for (int w = 0; w < 8; ++w) {
        s += (double)red[w][tid][0];
        q += (double)red[w][tid][1];
      }
      // [cloud][slot of the cloud][tile]: a group's partials are contiguous
      double* pp = partials + (((size_t)b * SLOTS * CT + nt * SLOTS + tid) * T + tile) * 2;
      pp[0] = s;
      pp[1] = q;
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // red is free again
  }
}

__global__ void gn_stats_kernel(const double* __restrict__ partials, int BG,
                                int T, double count, float eps,
                                float* __restrict__ stats) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= BG) return;
  const float2 ms = p2pb::gn_moments(partials + (size_t)t * T * 2, T, count, eps);
  stats[2 * t] = ms.x;
  stats[2 * t + 1] = ms.y;
}

__device__ __forceinline__ float normalise(float v, const float* st, float g,
                                           float be, int act) {
  return p2pb::gn_normalise(v, st[0], st[1], g, be, act);
}

// f32, in place; blockIdx.y is the cloud
__global__ void gn_apply_kernel(float* y, const float* __restrict__ stats,
                                const float* __restrict__ gamma,
                                const float* __restrict__ beta,
                                int affine_stride, int VC, int C, int groups,
                                int act) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= VC) return;
  const int b = blockIdx.y;
  const size_t i = (size_t)b * VC + t;
  const int c = t % C;
  const size_t a = (size_t)b * affine_stride + c;
  y[i] = normalise(y[i], stats + 2 * ((size_t)b * groups + c / (C / groups)),
                   gamma[a], beta[a], act);
}

// bf16, in place, 8 channels (16 bytes) a thread; C % 8 == 0
__global__ void gn_apply_bf16_kernel(p2pb::bf16* y, const float* __restrict__ stats,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ beta,
                                     int affine_stride, int VC8, int C, int groups,
                                     int act) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= VC8) return;
  const int b = blockIdx.y;
  uint4* p = reinterpret_cast<uint4*>(y) + (size_t)b * VC8 + t;
  uint4 v = *p;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
  const int c0 = (t * 8) % C, gs = C / groups;
  const float* st = stats + 2 * (size_t)b * groups;
  const float* ga = gamma + (size_t)b * affine_stride;
  const float* be = beta + (size_t)b * affine_stride;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    const int c = c0 + 2 * i;
    h[i] = __floats2bfloat162_rn(
        normalise(f.x, st + 2 * (c / gs), ga[c], be[c], act),
        normalise(f.y, st + 2 * ((c + 1) / gs), ga[c + 1], be[c + 1], act));
  }
  *p = v;
}

// ---- host ------------------------------------------------------------------
// a kernel's channel tile: the widest of 256 (bf16 only), 128, 64, 32 that
// divides Cout
int n_tile(int Cout, int bf16) {
  int n = bf16 ? 256 : 128;
  while (n > 32 && Cout % n) n /= 2;
  return n;
}

// partials of one (cloud, group): one per 128-voxel tile and slot of N / 8
// channels (the bf16 kernel's 256-voxel tiles write half as many)
int partials_per_group(int R, int Cout, int groups, int bf16) {
  return Cout / groups / (n_tile(Cout, bf16) / SLOTS) * (R * R * R / 128);
}

// scratch: the partials (double), then the statistics (f32)
long long scratch_bytes(int B, int R, int Cout, int groups, int bf16) {
  return (long long)B * groups * partials_per_group(R, Cout, groups, bf16) * 2 * 8 +
         (long long)B * groups * 2 * 4;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// bf16 tile of `rank` dims (innermost first), zero fill out of bounds,
// swizzled by the inner box row (64 or 128 bytes: k-chunks of 32 or 64)
bool tensor_map(CUtensorMap* map, const void* base, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides,
                const cuuint32_t* box) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUtensorMapSwizzle sw =
      box[0] == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
             dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// shared memory of one block: two blocks an SM for N <= 64 with MB = 1
int smem_budget(int N, int MB) { return (N <= 64 && MB == 1 ? 110 : 225) * 1024; }

int stage_bytes(int R, int N, int CK, int MB) {
  return (Box(R, 128 * MB).halo_rows() + 3 * N) * CK * 2;
}

// SMs of the current card, read once per card
int current_card(int* dev, int* sms) {
  static int sms_of[MAX_DEVICES];
  int err = (int)cudaGetDevice(dev);
  if (err) return err;
  if (*dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!sms_of[*dev])
    err = (int)cudaDeviceGetAttribute(&sms_of[*dev], cudaDevAttrMultiProcessorCount, *dev);
  *sms = sms_of[*dev];
  return err;
}

template <int N, int CK, int MB>
int launch_wgmma(const void* x, const void* wt, const float* bias, int B, int R, int Cin,
                 int Cout, int dev, int sms, p2pb::bf16* y, double* partials,
                 cudaStream_t s) {
  const Box box(R, 128 * MB);
  const int stage = stage_bytes(R, N, CK, MB);
  int stages = smem_budget(N, MB) / stage;
  stages = stages > MAX_STAGES ? MAX_STAGES : stages;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[5] = {(cuuint64_t)Cin, (cuuint64_t)R, (cuuint64_t)R,
                               (cuuint64_t)R, (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)Cin * 2;
  const cuuint64_t xstrides[4] = {row, row * R, row * R * R, row * R * R * R};
  const cuuint32_t xbox[5] = {CK, (cuuint32_t)box.zb, (cuuint32_t)box.yb + 2,
                              (cuuint32_t)box.xb, 1};
  // w [dx, dz][dy][Cout][Cin]: one box holds the three dy slices of a chunk
  // for the N channels of a tile
  const cuuint64_t wdims[4] = {(cuuint64_t)Cin, (cuuint64_t)Cout, 3, 9};
  const cuuint64_t wstrides[3] = {row, row * Cout, row * Cout * 3};
  const cuuint32_t wbox[4] = {CK, (cuuint32_t)N, 3, 1};
  if (!tensor_map(&xmap, x, 5, xdims, xstrides, xbox) ||
      !tensor_map(&wmap, wt, 4, wdims, wstrides, wbox))
    return (int)cudaErrorInvalidValue;
  const int smem = stages * stage + 1024;
  auto kernel = conv_wgmma_kernel<N, CK, MB>;
  // once per card: the shared-memory limit (the budget), and the blocks an
  // SM holds at each R (R sets the stage size, so the shared memory)
  static bool limit_set[MAX_DEVICES];
  static int per_sm_at[MAX_DEVICES][32];
  int err = 0;
  if (!limit_set[dev]) {
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    smem_budget(N, MB) + 1024);
    if (err) return err;
    limit_set[dev] = true;
  }
  int& per_sm = per_sm_at[dev][__builtin_ctz(R)];
  if (!per_sm)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WTHREADS, smem);
  if (err) return err;
  // one persistent block for each block slot of the card
  const int tiles = B * (R * R * R / (128 * MB)) * (Cout / N);
  const int grid = tiles < sms * per_sm ? tiles : sms * per_sm;
  kernel<<<grid, WTHREADS, smem, s>>>(xmap, wmap, bias, B, R, Cin, Cout, box.zb, box.yb,
                                      stages, y, partials);
  return (int)cudaGetLastError();
}

// Row blocks: two a warpgroup (256-voxel tiles, two accumulator chains)
// where N <= 128 and the card still gets four tiles a block slot, else one.
// k-chunks: 64 channels where Cin allows and three stages fit in the
// block's shared memory, else 32.
template <int N>
int launch_n(const void* x, const void* wt, const float* bias, int B, int R, int Cin,
             int Cout, p2pb::bf16* y, double* partials, int* tiles, cudaStream_t s) {
  int dev = 0, sms = 0;
  const int err = current_card(&dev, &sms);
  if (err) return err;
  const int MB = N <= 128 && B * (R * R * R / 256) * (Cout / N) >= 4 * sms ? 2 : 1;
  *tiles = R * R * R / (128 * MB);
  const int CK = Cin % 64 == 0 && smem_budget(N, MB) / stage_bytes(R, N, 64, MB) >= 3 ? 64 : 32;
#define P2PB_LAUNCH(ck, mb) \
  if (CK == ck && MB == mb) \
    return launch_wgmma<N, ck, mb>(x, wt, bias, B, R, Cin, Cout, dev, sms, y, partials, s);
  P2PB_LAUNCH(64, 1) P2PB_LAUNCH(32, 1)
  if constexpr (N <= 128) { P2PB_LAUNCH(64, 2) P2PB_LAUNCH(32, 2) }
#undef P2PB_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The f32 kernel: one block per (cloud, voxel tile, channel tile), channel
// tiles fastest (they share the tile's input boxes in L2); two stages of
// shared memory, whose limit is set once per card.
template <int N, int R>
int launch_ffma(const float* x, const float* w, const float* bias, int B, int Cin, int Cout,
                float* y, double* partials, cudaStream_t s) {
  int dev = 0, sms = 0;
  int err = current_card(&dev, &sms);
  if (err) return err;
  constexpr int smem = 2 * ffma_stage_bytes(R, N);
  auto kernel = conv_ffma_kernel<N, R>;
  static bool limit_set[MAX_DEVICES];
  if (!limit_set[dev]) {
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
    limit_set[dev] = true;
  }
  const long long blocks = (long long)B * (R * R * R / FM) * (Cout / N);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, ffma_threads(N), smem, s>>>(x, w, bias, Cin, Cout, y, partials);
  return (int)cudaGetLastError();
}

// The f32 kernel's R (8, 16 or 32: every shipped config's) and N (32, 64 or
// 128); each (N, R) is a fully unrolled instance, so the list stays short.
template <int N>
int launch_ffma_r(const float* x, const float* w, const float* bias, int B, int R, int Cin,
                  int Cout, float* y, double* partials, cudaStream_t s) {
  switch (R) {
    case 8: return launch_ffma<N, 8>(x, w, bias, B, Cin, Cout, y, partials, s);
    case 16: return launch_ffma<N, 16>(x, w, bias, B, Cin, Cout, y, partials, s);
    case 32: return launch_ffma<N, 32>(x, w, bias, B, Cin, Cout, y, partials, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

P2PB_API long long p2pb_conv3d_gn_scratch_bytes(int B, int R, int Cout,
                                                int groups, int bf16) {
  return scratch_bytes(B, R, Cout, groups, bf16);
}

// gamma/beta hold [C] (affine_stride = 0) or [B, C] with rows affine_stride
// >= C floats apart (a column slice of a wider table).
// Both: Cout % 32 == 0, a GroupNorm group of whole slots (Cout / groups a
// multiple of n_tile(Cout, bf16) / 8), R a power of two >= 8, x and w
// 16-byte aligned.
// f32 (bf16 = 0): x [B, R, R, R, Cin] with Cin % 4 == 0 (16-byte rows) and
// R <= 32, w [3, 3, 3, Cin, Cout] (DHWIO).
// bf16 (bf16 = 1): x [B, R, R, R, Cin] with Cin % 32 == 0, w [3 (dx),
// 3 (dz), 3 (dy), Cout, Cin] (the DHWIO weight with dy and dz swapped and
// every tap transposed: K-major B tiles).
P2PB_API int p2pb_conv3d_gn(const void* x, const void* w, const void* bias,
                            const void* gamma, const void* beta,
                            int affine_stride, int B, int R, int Cin,
                            int Cout, int groups, float eps, int act, int bf16,
                            void* y, void* scratch, int device, void* stream) {
  P2PB_ON_DEVICE(device);
  cudaStream_t s = (cudaStream_t)stream;
  int T = partials_per_group(R, Cout, groups, bf16);  // the bf16 kernel may use fewer
  double* partials = (double*)scratch;
  float* stats = (float*)(partials + (size_t)B * groups * T * 2);
  const int n = n_tile(Cout, bf16);
  if (Cout % 32 || Cout % groups || (Cout / groups) % (n / SLOTS) || R < 8 || (R & (R - 1)) ||
      Cin % (bf16 ? 32 : 4) || (affine_stride && affine_stride < Cout))
    return (int)cudaErrorInvalidValue;
  const float* bs = (const float*)bias;
  int err;
  if (bf16) {
    p2pb::bf16* yb = (p2pb::bf16*)y;
    int tiles = 0;  // voxel tiles of a cloud
    switch (n) {
      case 32: err = launch_n<32>(x, w, bs, B, R, Cin, Cout, yb, partials, &tiles, s); break;
      case 64: err = launch_n<64>(x, w, bs, B, R, Cin, Cout, yb, partials, &tiles, s); break;
      case 128: err = launch_n<128>(x, w, bs, B, R, Cin, Cout, yb, partials, &tiles, s); break;
      default: err = launch_n<256>(x, w, bs, B, R, Cin, Cout, yb, partials, &tiles, s); break;
    }
    T = Cout / groups / (n / SLOTS) * tiles;  // slots of a group x voxel tiles
  } else {
    const float* xf = (const float*)x;
    const float* wf = (const float*)w;
    float* yf = (float*)y;
    switch (n) {
      case 32: err = launch_ffma_r<32>(xf, wf, bs, B, R, Cin, Cout, yf, partials, s); break;
      case 64: err = launch_ffma_r<64>(xf, wf, bs, B, R, Cin, Cout, yf, partials, s); break;
      default: err = launch_ffma_r<128>(xf, wf, bs, B, R, Cin, Cout, yf, partials, s); break;
    }
  }
  if (err) return err;
  const int V = R * R * R;
  const int BG = B * groups;
  gn_stats_kernel<<<(BG + 127) / 128, 128, 0, s>>>(
      partials, BG, T, (double)V * (Cout / groups), eps, stats);
  err = (int)cudaGetLastError();
  if (err) return err;
  if (bf16) {
    const int VC8 = V * Cout / 8;
    gn_apply_bf16_kernel<<<dim3((VC8 + 255) / 256, B), 256, 0, s>>>(
        (p2pb::bf16*)y, stats, (const float*)gamma, (const float*)beta, affine_stride, VC8,
        Cout, groups, act);
  } else {
    const int VC = V * Cout;
    gn_apply_kernel<<<dim3((VC + 255) / 256, B), 256, 0, s>>>(
        (float*)y, stats, (const float*)gamma, (const float*)beta, affine_stride, VC, Cout,
        groups, act);
  }
  return (int)cudaGetLastError();
}
