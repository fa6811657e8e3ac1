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
// Design: two launches, no float atomics, no memset.
//  - scatter_table_kernel builds each cloud's segment table: the entries in
//    ascending (destination, entry) order and each row's first slot. It is a
//    stable LSD radix sort on the destination alone, 8 bits a pass (two
//    passes above 256 rows), run by one thread block cluster a cloud (CL
//    CTAs of 512 threads: up to 16, as many as B * CL <= 2 * SMs allows,
//    fewer where a CTA would get under 1,024 entries). CTA k takes the k-th
//    contiguous slice of the pass's input, each of its 16 warps a
//    contiguous part of that, 32 entries at a time in order:
//    __match_any_sync on the digit gives a lane its rank among the earlier
//    lanes of its digit, and the warp's running count per digit (shared
//    memory) the rest. The warps' digit counts are scanned in (digit, CTA,
//    warp) order through distributed shared memory, so each entry's slot is
//    unique and the sort stable; starting from entry order, each segment is
//    in ascending entry order. The row counts (integer adds into the owning
//    CTA's shared memory, whose result does not depend on their order) are
//    scanned the same way into the segment starts. Pass 1 reads the (entry,
//    destination) pairs pass 0 wrote to global scratch; the cluster
//    barriers order them. Nothing grows with one CTA's shared memory but
//    the rows a CTA owns (at most 8,192, 32 KB), so a cloud takes up to
//    2^20 entries and 2^16 rows. Its time is latency: three cluster
//    barriers and four walks over a slice, each a few microseconds.
//  - scatter_rows_kernel, one thread per 16 bytes of the output: it sums its
//    row's segment in sorted order (K3's weights recomputed from the
//    coordinates) and stores 16 bytes; where C * sizeof(T) is not a multiple
//    of 16 (C = 35, 67) a thread's 16 bytes may span two rows, which it
//    reads element by element.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int MAX_ENTRIES = 1 << 20;  // a cloud's entries
constexpr int MAX_ROWS = 1 << 16;     // two 8-bit digit passes
constexpr int ROW_THREADS = 256;
constexpr int kTableThreads = 512;
constexpr int kWarps = kTableThreads / 32;
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;
constexpr int kMaxCluster = 16;       // non-portable cluster size
constexpr int kMinSlice = 1024;       // entries a CTA at least, where the cluster may shrink
constexpr int kMaxRowsPerCta = 8192;  // the row counts a CTA owns: 32 KB
constexpr int kGroups = kTableThreads / kDigits;  // warp groups a digit's scan splits into
constexpr int kCached = 4;            // a lane's first chunks kept in registers between walks
constexpr int kScanInts = 64;         // block scan scratch [kWarps <= 32], then the range total
// shared ints of a table CTA: digit counts per warp, per group of warps,
// the CTA's digit counts, scan scratch, then the rows it owns
constexpr int kTableFixedInts = (kWarps + kGroups + 1) * kDigits + kScanInts;
constexpr int kTableMaxSmem = (kTableFixedInts + kMaxRowsPerCta) * 4;
constexpr int MAX_DEVICES = 16;  // cards whose attributes are set
constexpr unsigned kFull = 0xffffffffu;

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

// The exclusive prefix over the block of each thread's v, every thread
// calling; `total` gets the block's sum. tmp: kWarps ints of shared memory.
__device__ __forceinline__ int block_exclusive_scan(int v, int* tmp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kWarps ? tmp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, t, o);
      if (lane >= o) t += y;
    }
    if (lane < kWarps) tmp[lane] = t;
  }
  __syncthreads();
  total = tmp[kWarps - 1];
  const int res = x - v + (warp ? tmp[warp - 1] : 0);
  __syncthreads();  // tmp may be reused
  return res;
}

// Entry e's destination row (idx and coords offset to the cloud)
__device__ __forceinline__ int entry_dest(int mode, const int32_t* idx, const float* coords,
                                          int S, int r, int e) {
  if (mode == DEVOX) {
    const int c = e / S;
    float wx, wy, wz;
    return corner(coords + (e - c * S) * 3, c, r, wx, wy, wz);
  }
  return idx[e];
}

// What the table kernel's passes share: the cloud's inputs and outputs,
// this lane's place, and the walks over its warp's part of a pass's input.
struct Table {
  const int32_t* idx;
  const float* coords;
  int mode, S, R, r, rpc;
  int2* seq;
  int32_t* order;
  int* rows;
  unsigned lt;  // this lane's lower lanes

  // Input slot i (< end) of pass 0 (the entries) or of a later pass (seq):
  // its entry and destination, -1 where i is past the part or the
  // destination outside the rows (pass 0 drops such an entry).
  __device__ __forceinline__ void fetch(bool first, int i, int end, int& e, int& dest) const {
    e = i;
    dest = -1;
    if (i < end) {
      if (first) {
        dest = entry_dest(mode, idx, coords, S, r, i);
      } else {
        const int2 p = __ldcg(seq + i);
        e = p.x;
        dest = p.y;
      }
      if (dest < 0 || dest >= R) dest = -1;
    }
  }

  // One chunk of 32 slots: each digit's count goes to the warp's counts
  __device__ __forceinline__ void count(int* mine, int dest, int shift) const {
    const int d = dest >= 0 ? (dest >> shift) & (kDigits - 1) : -1;
    const unsigned peers = __match_any_sync(kFull, d);
    if (d >= 0 && (peers & lt) == 0) mine[d] += __popc(peers);
    __syncwarp();
  }

  // One chunk: each entry to its digit's cursor plus its rank among the
  // chunk's earlier lanes of that digit; the last pass writes the order,
  // pass 0 adds the rows' counts into the owning CTAs
  __device__ __forceinline__ void place(int* mine, int e, int dest, int shift, bool last,
                                        bool count_rows) const {
    const int d = dest >= 0 ? (dest >> shift) & (kDigits - 1) : -1;
    const unsigned peers = __match_any_sync(kFull, d);
    const int cur = d >= 0 ? mine[d] : 0;
    __syncwarp();
    if (d >= 0) {
      const int pos = cur + __popc(peers & lt);
      if (last) order[pos] = e;
      else seq[pos] = make_int2(e, dest);
      if ((peers & lt) == 0) mine[d] = cur + __popc(peers);
    }
    if (count_rows) {
      const unsigned same = __match_any_sync(kFull, dest);
      if (dest >= 0 && (same & lt) == 0) {
        const int owner = dest / rpc;
        p2pb::red_add_cluster_u32(p2pb::cluster_map(rows + (dest - owner * rpc), owner),
                                  __popc(same));
      }
    }
    __syncwarp();
  }
};

// One cluster of CL CTAs per cloud (grid [CL, B]). Writes order [B, E],
// the entries by (destination, entry), and start [B, R + 1], each row's
// first slot; seq [B, E] holds the (entry, destination) pairs between the
// passes. rpc: the rows a CTA owns (CL * rpc >= R, rpc <= kMaxRowsPerCta).
__global__ void __launch_bounds__(kTableThreads)
    scatter_table_kernel(const int32_t* __restrict__ idx, const float* __restrict__ coords,
                         int mode, int S, int E, int R, int r, int rpc, int passes,
                         int2* __restrict__ seq, int32_t* __restrict__ order,
                         int32_t* __restrict__ start) {
  extern __shared__ int4 smem4[];
  int* hist = (int*)smem4;                   // [kWarps][kDigits]: counts, then cursors
  int* part = hist + kWarps * kDigits;       // [kGroups][kDigits]: counts, then offsets
  int* cta_count = part + kGroups * kDigits;  // [kDigits], read by the cluster
  int* tmp = cta_count + kDigits;            // [kWarps] block scan scratch
  int* range_total = tmp + 32;               // the owned rows' total, read by the cluster
  int* rows = tmp + kScanInts;               // [rpc]: counts, then exclusive prefixes
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int digit = tid & (kDigits - 1), group = tid / kDigits;
  const int CL = (int)p2pb::cluster_nctarank(), k = (int)p2pb::cluster_ctarank();
  const size_t b = blockIdx.y;
  const Table t{idx + b * E, coords + b * S * 3, mode, S, R, r, rpc, seq + b * E,
                order + b * E, rows, (1u << lane) - 1};
  start += b * (R + 1);
  int* mine = hist + warp * kDigits;
  for (int i = tid; i < rpc; i += kTableThreads) rows[i] = 0;

  // the owned rows' counts -> their exclusive prefix and total
  auto scan_rows = [&] {
    const int per = (rpc + kTableThreads - 1) / kTableThreads;
    const int i0 = min(tid * per, rpc), i1 = min(i0 + per, rpc);
    int s = 0;
    for (int i = i0; i < i1; ++i) s += rows[i];
    int sum;
    int pre = block_exclusive_scan(s, tmp, sum);
    for (int i = i0; i < i1; ++i) {
      const int cnt = rows[i];
      rows[i] = pre;
      pre += cnt;
    }
    if (tid == 0) *range_total = sum;
  };
  // after a cluster barrier that follows scan_rows everywhere: the owned
  // rows' starts (the totals of the CTAs before, plus the prefix)
  auto write_starts = [&](int kept) {
    int v[kMaxCluster];
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j)
      v[j] = j < k ? p2pb::ld_cluster_s32(p2pb::cluster_map(range_total, j)) : 0;
    int prefix = 0;
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j) prefix += v[j];
    const int per = (rpc + kTableThreads - 1) / kTableThreads;
    const int own = max(0, min(rpc, R - k * rpc));
    const int i0 = min(tid * per, own), i1 = min(i0 + per, own);
    for (int i = i0; i < i1; ++i) start[k * rpc + i] = prefix + rows[i];
    if (k == 0 && tid == 0) start[R] = kept;
  };

  int len = E;  // the pass's input: the entries, then those pass 0 kept
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = pass * kDigitBits;
    const bool first = pass == 0, last = pass + 1 == passes;
    // the CTA's contiguous slice of the input, the warp's part of it
    const int n = (len + CL - 1) / CL;
    const int lo = min(k * n, len), hi = min(lo + n, len);
    const int m = (hi - lo + kWarps - 1) / kWarps;
    const int wlo = min(lo + warp * m, hi), whi = min(wlo + m, hi);
    for (int i = tid; i < kWarps * kDigits / 4; i += kTableThreads)
      smem4[i] = make_int4(0, 0, 0, 0);
    __syncthreads();
    // count: the first kCached chunks' loads all in flight, kept for place
    int ce[kCached], cd[kCached];
#pragma unroll
    for (int j = 0; j < kCached; ++j) t.fetch(first, wlo + 32 * j + lane, whi, ce[j], cd[j]);
#pragma unroll
    for (int j = 0; j < kCached; ++j)
      if (wlo + 32 * j < whi) t.count(mine, cd[j], shift);
    for (int c = wlo + 32 * kCached; c < whi; c += 32) {
      int e, dest;
      t.fetch(first, c + lane, whi, e, dest);
      t.count(mine, dest, shift);
    }
    __syncthreads();
    {  // per digit, each group of the warps' total
      int s = 0;
      for (int w = group * (kWarps / kGroups); w < (group + 1) * (kWarps / kGroups); ++w)
        s += hist[w * kDigits + digit];
      part[group * kDigits + digit] = s;
    }
    __syncthreads();
    if (tid < kDigits) {
      int s = 0;
#pragma unroll
      for (int q = 0; q < kGroups; ++q) s += part[q * kDigits + tid];
      cta_count[tid] = s;
    }
    // every CTA's digit counts are complete (in pass 1 also pass 0's
    // pairs, row counts and range totals)
    p2pb::cluster_sync();
    if (!first) write_starts(len);
    // digit d's first slot for this CTA: the entries of lower digits, plus
    // those of digit d in the CTAs before it
    int total = 0, before = 0;
    if (tid < kDigits) {
      int v[kMaxCluster];
#pragma unroll
      for (int j = 0; j < kMaxCluster; ++j)
        v[j] = j < CL ? p2pb::ld_cluster_s32(p2pb::cluster_map(cta_count + tid, j)) : 0;
#pragma unroll
      for (int j = 0; j < kMaxCluster; ++j) {
        total += v[j];
        if (j < k) before += v[j];
      }
    }
    const int base = block_exclusive_scan(total, tmp, len);  // len: the entries kept
    if (last && passes > 1) p2pb::cluster_arrive();  // this CTA's remote reads are done
    if (tid < kDigits) {  // each group's first slot of digit tid
      int run = base + before;
#pragma unroll
      for (int q = 0; q < kGroups; ++q) {
        const int cnt = part[q * kDigits + tid];
        part[q * kDigits + tid] = run;
        run += cnt;
      }
    }
    __syncthreads();
    {  // each warp's cursor of the digit
      int run = part[group * kDigits + digit];
      for (int w = group * (kWarps / kGroups); w < (group + 1) * (kWarps / kGroups); ++w) {
        const int cnt = hist[w * kDigits + digit];
        hist[w * kDigits + digit] = run;
        run += cnt;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kCached; ++j)
      if (wlo + 32 * j < whi) t.place(mine, ce[j], cd[j], shift, last, first);
    for (int c = wlo + 32 * kCached; c < whi; c += 32) {
      int e, dest;
      t.fetch(first, c + lane, whi, e, dest);
      t.place(mine, e, dest, shift, last, first);
    }
    if (first) {
      // pass 0's pairs and the row counts are complete everywhere
      p2pb::cluster_sync();
      scan_rows();
    }
  }
  if (passes == 1) {
    p2pb::cluster_sync();  // every CTA's range total is written
    write_starts(len);
    p2pb::cluster_arrive();  // this CTA's remote reads are done
  }
  p2pb::cluster_wait();  // no CTA leaves while another may read its shared memory
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

// The cluster size for B clouds of E entries and R rows on a card of `sms`
// SMs: the largest power of two up to kMaxCluster with B * CL <= 2 * sms
// (two CTAs an SM) and CL * kMinSlice <= E, but at least the CTAs that R's
// counts need.
int table_cluster(int B, int E, int R, int sms) {
  int least = 1;
  while (least * kMaxRowsPerCta < R) least *= 2;
  int CL = kMaxCluster;
  while (CL > least && ((long long)B * CL > 2 * sms || CL * kMinSlice > E)) CL /= 2;
  return CL;
}

template <typename T>
int scatter_rows(const void* g, const void* idx, const void* w, const void* coords,
                 int mode, int B, int S, int E, int R, int C, int r, void* out,
                 void* tables, int device, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  auto table = scatter_table_kernel;
  static int sms[MAX_DEVICES];
  static bool fits[MAX_DEVICES][kMaxCluster + 1];  // a cluster of CL can be resident
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int err = 0;
  if (!sms[device]) {  // once per card
    err = (int)cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (!err)
      err = (int)cudaFuncSetAttribute(table, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (!err)
      err = (int)cudaFuncSetAttribute(table, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      kTableMaxSmem);
    if (err) {
      sms[device] = 0;
      return err;
    }
  }
  int CL = table_cluster(B, E, R, sms[device]);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kTableThreads);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  for (;; CL /= 2) {  // a cluster that cannot be resident would never run
    cfg.gridDim = dim3(CL, B);
    attr[0].val.clusterDim.x = CL;
    if (fits[device][CL]) break;
    cfg.dynamicSmemBytes = kTableMaxSmem;
    int clusters = 0;
    err = (int)cudaOccupancyMaxActiveClusters(&clusters, (void*)table, &cfg);
    if (err) return err;
    if (clusters >= 1) {
      fits[device][CL] = true;
      break;
    }
    if (CL == 1 || (CL / 2) * kMaxRowsPerCta < R) return (int)cudaErrorLaunchOutOfResources;
  }
  const int rpc = (R + CL - 1) / CL;
  cfg.dynamicSmemBytes = (size_t)(kTableFixedInts + rpc) * 4;
  int2* seq = (int2*)tables;
  int32_t* order = (int32_t*)(seq + (size_t)B * E);
  int32_t* start = order + (size_t)B * E;
  err = (int)cudaLaunchKernelEx(&cfg, table, (const int32_t*)idx, (const float*)coords, mode,
                                S, E, R, r, rpc, R > kDigits ? 2 : 1, seq, order, start);
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
// R = r^3; tables int32 scratch of B * (3E + R + 1) elements, 8-byte
// aligned; 1 <= E <= 2^20, 1 <= R <= 2^16, B < 65536, S * C and R * C
// below 2^31.
P2PB_API int p2pb_scatter_rows(const void* g, const void* idx, const void* w,
                               const void* coords, int mode, int B, int S, int E, int R,
                               int C, int r, int bf16, void* out, void* tables,
                               int device, void* stream) {
  P2PB_ON_DEVICE(device);
  if (mode < GATHER || mode > DEVOX || E < 1 || E > MAX_ENTRIES || R < 1 || R > MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return scatter_rows<p2pb::bf16>(g, idx, w, coords, mode, B, S, E, R, C, r, out, tables,
                                    device, s);
  return scatter_rows<float>(g, idx, w, coords, mode, B, S, E, R, C, r, out, tables, device,
                             s);
}
