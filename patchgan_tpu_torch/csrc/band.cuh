// Band forms of the instance-norm kernels, for spatial parallelism
// (parallel/spatial.py): each plane's rows are split over the ranks of a
// spatial group, so its statistics are a sum over the group. A band kernel
// works on one rank's rows only and leaves the sum to a collective between
// two launches:
//
//   stats   per-plane fp32 (sum, sum of squares) of this band's values
//   apply   y = act((x - mean) * rstd) from the plane's summed stats and its
//           global element count
//   bwd     per-plane (sum gm, sum gm * xhat) of this band, then
//           dx = rstd * (gm - m1 - xhat * m2) from the summed pair
//
// with the JAX package's formulas (norm_plane.cuh's mean_rstd, with the
// global count in place of the plane's). The fused conv kernels' band
// entries (conv_norm_act.cu, convt_norm_act.cu) end in the stats of their
// fp32 output, and their finish is `apply` on that output; so is the
// finish of those kernels' NCHW forms on the wgmma core, with the plane's
// own count.
//
// Bound on the H100: bytes, as K1 and K1-bwd. Apply is elementwise over
// blocks of APPLY_SPAN elements of one plane, each block reading its
// plane's stats once. The stats and the backward's two halves are
// band_norm.cuh's (a plane's sums on a group of threads or split over a
// thread-block cluster with 16-byte loads, in a fixed order with no
// atomics, so two launches give the same bits; dx walked as one range of
// 16-byte vectors).
#pragma once

#include "in_common.cuh"

namespace pgt {
namespace band {

constexpr int THREADS = 256;
constexpr long APPLY_SPAN = 16L * THREADS;   // elements a block applies

__device__ __forceinline__ float2 mean_rstd(float2 t, float count,
                                            float eps) {
  const float mean = t.x / count;
  const float var = t.y / count - mean * mean;
  return make_float2(mean, rsqrtf(var + eps));
}

// Block b: elements [lo, lo + APPLY_SPAN) of plane b / spans.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS)
    apply_kernel(const Tin* __restrict__ x, const float2* __restrict__ stats,
                 Tout* __restrict__ y, long plane, int spans, float count,
                 float eps, int act) {
  const long p = blockIdx.x / spans;
  const long lo = (blockIdx.x % spans) * APPLY_SPAN;
  const long hi = lo + APPLY_SPAN < plane ? lo + APPLY_SPAN : plane;
  const float2 st = mean_rstd(stats[p], count, eps);
  const Tin* xp = x + p * plane;
  Tout* yp = y + p * plane;
  for (long i = lo + threadIdx.x; i < hi; i += blockDim.x)
    yp[i] = from_f32<Tout>(activate((to_f32(xp[i]) - st.x) * st.y, act));
}

// After a fused conv's GEMM without a K split: stats[p] = the sum, in
// index order, of plane p's `parts` per-tile partials. One thread a plane.
__global__ void stats_from_partials(const float2* __restrict__ part,
                                    float2* __restrict__ stats, long planes,
                                    int parts) {
  const long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= planes) return;
  float s = 0.f, ss = 0.f;
  for (int i = 0; i < parts; ++i) {
    const float2 v = part[p * parts + i];
    s += v.x;
    ss += v.y;
  }
  stats[p] = make_float2(s, ss);
}

// After a K split: block p adds the `splits` slices of plane p in slice
// order into slice 0 (as finish_split does) and takes its stats.
__global__ void __launch_bounds__(THREADS)
    split_stats(float* __restrict__ acc, int splits, long slice,
                float2* __restrict__ stats, long plane) {
  float* a = acc + blockIdx.x * plane;
  float s = 0.f, ss = 0.f;
  for (long i = threadIdx.x; i < plane; i += blockDim.x) {
    float v = a[i];
    for (int k = 1; k < splits; ++k) v += a[k * slice + i];
    a[i] = v;
    s += v;
    ss += v * v;
  }
  const float2 t = block_sum2(s, ss);
  if (threadIdx.x == 0) stats[blockIdx.x] = t;
}

inline int spans_of(long plane) {
  return (int)((plane + APPLY_SPAN - 1) / APPLY_SPAN);
}

// apply_kernel over `planes` planes of `plane` elements: norm_act.cu's
// pgt_in_apply, and the finish of K2's and K3's NCHW forms on the wgmma
// core (count = plane there).
template <typename Tin, typename Tout>
void launch_apply(const Tin* x, const float2* stats, Tout* y, long planes,
                  long plane, float count, float eps, int act,
                  cudaStream_t st) {
  const int spans = spans_of(plane);
  apply_kernel<Tin, Tout><<<planes * spans, THREADS, 0, st>>>(
      x, stats, y, plane, spans, count, eps, act);
}

}  // namespace band
}  // namespace pgt
