// GroupNorm arithmetic shared by K1's epilogue (conv3d_gn.cu) and the point
// branch's fused GroupNorm (group_norm.cu): the statistics of one (cloud,
// group) from its partial sums, and the normalisation, affine and swish of
// one value.
#pragma once

#include <cuda_runtime.h>

namespace p2pb {

// Mean and 1 / sqrt(var + eps) of one (cloud, group) of `count` values from
// its T partial (sum, sum of squares) pairs at pp, added in index order in
// double; var = E[x^2] - m^2 clamped at 0, as flax.linen.GroupNorm takes it.
__device__ __forceinline__ float2 gn_moments(const double* pp, int T, double count,
                                             float eps) {
  double s = 0.0, s2 = 0.0;
  for (int i = 0; i < T; ++i) {
    s += pp[2 * i];
    s2 += pp[2 * i + 1];
  }
  const double m = s / count;
  const double v = fmax(s2 / count - m * m, 0.0);
  return make_float2((float)m, (float)(1.0 / sqrt(v + (double)eps)));
}

// (v - mean) * rstd, then the affine g, be, then swish if act; all in f32
__device__ __forceinline__ float gn_normalise(float v, float mean, float rstd, float g,
                                              float be, int act) {
  v = (v - mean) * rstd;
  v = v * g + be;
  return act ? v * (1.0f / (1.0f + expf(-v))) : v;
}

}  // namespace p2pb
