// Native host runtime: room recomposition + host-side point utilities.
//
// TPU-native framework equivalent of the reference's numba JIT kernels
// (reference: denoise_room.py:181-289 update_prediction_*_batches) and
// of the host-side patch bookkeeping. Compiled with g++ -O3 and loaded
// via ctypes (p2p_bridge_tpu/runtime/__init__.py); a numpy fallback
// exists for environments without a toolchain.
//
// All functions use raw pointers + explicit sizes; caller guarantees
// contiguous float32/int64 arrays.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>

extern "C" {

// Accumulate patch predictions into per-point sums/counts.
//   sums   [n_points, 3] float64
//   counts [n_points]    int64
//   patches[n_patches, patch_size, 3] float32
//   idxs   [n_patches, patch_size]    int64
//   cuts   [n_patches]                int64 (valid prefix per patch)
void accumulate_running_mean(
    double* sums, int64_t* counts, const float* patches, const int64_t* idxs,
    const int64_t* cuts, int64_t n_patches, int64_t patch_size,
    int64_t n_points) {
  for (int64_t p = 0; p < n_patches; ++p) {
    const float* patch = patches + p * patch_size * 3;
    const int64_t* pid = idxs + p * patch_size;
    const int64_t cut = std::min(cuts[p], patch_size);
    for (int64_t i = 0; i < cut; ++i) {
      const int64_t t = pid[i];
      if (t < 0 || t >= n_points) continue;
      sums[t * 3 + 0] += patch[i * 3 + 0];
      sums[t * 3 + 1] += patch[i * 3 + 1];
      sums[t * 3 + 2] += patch[i * 3 + 2];
      counts[t] += 1;
    }
  }
}

// Finalize: out[i] = counts[i] ? sums[i]/counts[i] : fallback[i].
// Returns the number of never-updated points.
int64_t finalize_running_mean(
    const double* sums, const int64_t* counts, const float* fallback,
    float* out, int64_t n_points) {
  int64_t misses = 0;
  for (int64_t i = 0; i < n_points; ++i) {
    if (counts[i] > 0) {
      const double inv = 1.0 / static_cast<double>(counts[i]);
      out[i * 3 + 0] = static_cast<float>(sums[i * 3 + 0] * inv);
      out[i * 3 + 1] = static_cast<float>(sums[i * 3 + 1] * inv);
      out[i * 3 + 2] = static_cast<float>(sums[i * 3 + 2] * inv);
    } else {
      out[i * 3 + 0] = fallback[i * 3 + 0];
      out[i * 3 + 1] = fallback[i * 3 + 1];
      out[i * 3 + 2] = fallback[i * 3 + 2];
      ++misses;
    }
  }
  return misses;
}

// Exact sequential FPS on the host (float32), used for room-scale seed
// selection where building device programs is not worth it.
//   coords [n, 3] float32, out_idx [m] int64, scratch dists [n] float32
void fps_host(const float* coords, int64_t n, int64_t m, int64_t* out_idx,
              float* dists) {
  if (m <= 0 || n <= 0) return;
  for (int64_t i = 0; i < n; ++i) dists[i] = 1e38f;
  int64_t last = 0;
  out_idx[0] = 0;
  for (int64_t j = 1; j < m; ++j) {
    const float lx = coords[last * 3 + 0];
    const float ly = coords[last * 3 + 1];
    const float lz = coords[last * 3 + 2];
    float best = -1.0f;
    int64_t besti = 0;
    for (int64_t i = 0; i < n; ++i) {
      const float dx = coords[i * 3 + 0] - lx;
      const float dy = coords[i * 3 + 1] - ly;
      const float dz = coords[i * 3 + 2] - lz;
      const float d = dx * dx + dy * dy + dz * dz;
      const float nd = std::min(d, dists[i]);
      dists[i] = nd;
      if (nd > best) {
        best = nd;
        besti = i;
      }
    }
    last = besti;
    out_idx[j] = besti;
  }
}

// Bucketed approximate FPS for millions of points: uniform-stride
// candidate pool + exact FPS over the pool (matches the quality/speed
// trade-off of fpsample.bucket_fps_kdline_sampling used by the
// reference, denoise_room.py:404).
void bucket_fps_host(const float* coords, int64_t n, int64_t m,
                     int64_t pool_size, int64_t* out_idx, float* dists,
                     int64_t* pool) {
  if (pool_size >= n) {
    fps_host(coords, n, m, out_idx, dists);
    return;
  }
  // stride sampling of the candidate pool (deterministic)
  const double stride = static_cast<double>(n) / pool_size;
  for (int64_t i = 0; i < pool_size; ++i)
    pool[i] = static_cast<int64_t>(i * stride);

  for (int64_t i = 0; i < pool_size; ++i) dists[i] = 1e38f;
  int64_t last = 0;
  out_idx[0] = pool[0];
  for (int64_t j = 1; j < m; ++j) {
    const float lx = coords[pool[last] * 3 + 0];
    const float ly = coords[pool[last] * 3 + 1];
    const float lz = coords[pool[last] * 3 + 2];
    float best = -1.0f;
    int64_t besti = 0;
    for (int64_t i = 0; i < pool_size; ++i) {
      const int64_t c = pool[i];
      const float dx = coords[c * 3 + 0] - lx;
      const float dy = coords[c * 3 + 1] - ly;
      const float dz = coords[c * 3 + 2] - lz;
      const float d = dx * dx + dy * dy + dz * dz;
      const float nd = std::min(d, dists[i]);
      dists[i] = nd;
      if (nd > best) {
        best = nd;
        besti = i;
      }
    }
    last = besti;
    out_idx[j] = pool[besti];
  }
}

}  // extern "C"
