// NHWC (channels_last) forms of the instance-norm kernels, segmented:
// K1's and K1-bwd's where a (sample, channel tile) is too large for the
// one-pass kernels of norm_nhwc_cluster.cuh (the host's
// nhwc_one_pass_plan decides), and the finish of K2's and K3's NHWC
// forms (conv_gemm.cuh's launch_conv_in_act_nhwc).
//
// In an NHWC tensor the (n, c) plane a statistic runs over is strided by
// C: neighbouring channels of one pixel are neighbours in memory, so the
// NCHW plane staging (norm_plane.cuh: one contiguous plane a group of
// threads) does not carry over. Here a block takes a tile of contiguous
// channels, `lanes` chunks of W channels each (W: 16 bytes of the element
// type on the vector path, one channel on the element path), `rows`
// pixels at a time (lanes * rows = THREADS), over one segment of one
// sample's H*W pixels. Neighbouring lanes read neighbouring 16 bytes of a
// pixel. Each thread keeps fp32 sums for its W channels; the block adds
// its rows in order in shared memory and writes one partial per (n, c,
// segment); reduce_parts (one warp a plane, a fixed xor order) adds a
// plane's partials; a last kernel normalises. The segments spread one
// sample over several blocks, so the grid fills the card at the deep
// levels' few planes and at the shallow levels' large ones alike. No
// atomics anywhere: two launches on the same inputs give the same bits.
//
// Bound on the H100: bytes, as the NCHW forms. A simple design first: the
// forward reads x twice (the statistics, then the apply; the second read
// mostly from L2 at the training shapes), the backward x three times and
// g twice, where the NCHW kernels keep a plane in registers.
//
// Kernels (grid (segs, tiles, N) of THREADS threads, the segments
// seg_len pixels each; reduce_parts one warp a plane):
//   seg_stats     part[(n C + c) segs + s] = (sum x, sum x^2), segment s
//   split_stats   the same over the sum of a K split's fp32 slices, which
//                 it writes back into slice 0 (the fused convs' finish)
//   reduce_parts  stats[p] = the sum of plane p's `parts` partials
//   apply         y = act((x - mean) * rstd), mean and rstd from stats
//   bwd_sums      part = (sum gm, sum gm * xhat) over segment s,
//                 gm = g * act'(xhat)
//   bwd_apply     dx = rstd * (gm - mean(gm) - xhat * mean(gm * xhat))
// The statistics are the JAX package's: fp32 sums, var = E[x^2] - mean^2.
#pragma once

#include <type_traits>

#include "norm_plane.cuh"

namespace pgt {
namespace nhwc {

constexpr int THREADS = 256;
constexpr int MAX_W = 8;   // channels a thread holds: 16 bytes of bf16

// W values of T at p (16-byte loads when W > 1) as fp32
template <typename T, int W>
__device__ __forceinline__ void load_f(const T* p, float (&f)[W]) {
  if constexpr (W == 1) {
    f[0] = to_f32(p[0]);
  } else if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(p + 4 * q);
      f[4 * q] = v.x;
      f[4 * q + 1] = v.y;
      f[4 * q + 2] = v.z;
      f[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < W / 8; ++q) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + 8 * q);
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        f[8 * q + 2 * k] = __uint_as_float(w[k] << 16);
        f[8 * q + 2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
      }
    }
  }
}

template <typename T, int W>
__device__ __forceinline__ void store_f(T* p, const float (&f)[W]) {
  if constexpr (W == 1) {
    p[0] = from_f32<T>(f[0]);
  } else if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int q = 0; q < W / 4; ++q)
      *reinterpret_cast<float4*>(p + 4 * q) =
          make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < W / 8; ++q)
      *reinterpret_cast<uint4*>(p + 8 * q) = make_uint4(
          norm::pack_bf16x2(f[8 * q], f[8 * q + 1]),
          norm::pack_bf16x2(f[8 * q + 2], f[8 * q + 3]),
          norm::pack_bf16x2(f[8 * q + 4], f[8 * q + 5]),
          norm::pack_bf16x2(f[8 * q + 6], f[8 * q + 7]));
  }
}

// Where a thread sits: its lane (chunk of W channels) and row, its first
// channel, and the block's segment [p0, p1) of the sample's pixels.
struct Place {
  int lane, row, rows, ch;
  bool live;
  long p0, p1;
};

template <int W>
__device__ __forceinline__ Place place(long hw, int C, int lanes,
                                       long seg_len) {
  Place t;
  t.lane = threadIdx.x & (lanes - 1);
  t.row = threadIdx.x / lanes;
  t.rows = THREADS / lanes;
  t.ch = (blockIdx.y * lanes + t.lane) * W;
  t.live = t.ch < C;
  t.p0 = blockIdx.x * seg_len;
  t.p1 = t.p0 + seg_len < hw ? t.p0 + seg_len : hw;
  return t;
}

// The block's per-channel sums of (a, b) over its rows, in row order, into
// part[(n C + c) segs + segment]
template <int W>
__device__ __forceinline__ void write_partials(const float (&a)[W],
                                               const float (&b)[W],
                                               const Place& t, int lanes,
                                               int C, float2* part) {
  __shared__ float ra[THREADS * MAX_W], rb[THREADS * MAX_W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    ra[(t.row * lanes + t.lane) * W + j] = a[j];
    rb[(t.row * lanes + t.lane) * W + j] = b[j];
  }
  __syncthreads();
  const int q = threadIdx.x;
  if (q < lanes * W) {
    const int ch = blockIdx.y * lanes * W + q;
    float s = 0.f, ss = 0.f;
    for (int r = 0; r < t.rows; ++r) {
      s += ra[r * lanes * W + q];
      ss += rb[r * lanes * W + q];
    }
    if (ch < C)
      part[((long)blockIdx.z * C + ch) * gridDim.x + blockIdx.x] =
          make_float2(s, ss);
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(THREADS)
    seg_stats(const T* __restrict__ x, float2* __restrict__ part, long hw,
              int C, int lanes, long seg_len) {
  const Place t = place<W>(hw, C, lanes, seg_len);
  const T* xn = x + (long)blockIdx.z * hw * C + t.ch;
  float s[W], ss[W];
#pragma unroll
  for (int j = 0; j < W; ++j) s[j] = ss[j] = 0.f;
  if (t.live)
    for (long p = t.p0 + t.row; p < t.p1; p += t.rows) {
      float f[W];
      load_f<T, W>(xn + p * C, f);
#pragma unroll
      for (int j = 0; j < W; ++j) {
        s[j] += f[j];
        ss[j] += f[j] * f[j];
      }
    }
  write_partials<W>(s, ss, t, lanes, C, part);
}

// After a K split: each element the sum of the `splits` slices (`slice`
// floats apart, added in slice order, kept in slice 0), and its partials.
template <int W>
__global__ void __launch_bounds__(THREADS)
    split_stats(float* __restrict__ acc, int splits, long slice,
                float2* __restrict__ part, long hw, int C, int lanes,
                long seg_len) {
  const Place t = place<W>(hw, C, lanes, seg_len);
  float* an = acc + (long)blockIdx.z * hw * C + t.ch;
  float s[W], ss[W];
#pragma unroll
  for (int j = 0; j < W; ++j) s[j] = ss[j] = 0.f;
  if (t.live)
    for (long p = t.p0 + t.row; p < t.p1; p += t.rows) {
      float f[W];
      load_f<float, W>(an + p * C, f);
      for (int k = 1; k < splits; ++k) {
        float e[W];
        load_f<float, W>(an + k * slice + p * C, e);
#pragma unroll
        for (int j = 0; j < W; ++j) f[j] += e[j];
      }
      store_f<float, W>(an + p * C, f);
#pragma unroll
      for (int j = 0; j < W; ++j) {
        s[j] += f[j];
        ss[j] += f[j] * f[j];
      }
    }
  write_partials<W>(s, ss, t, lanes, C, part);
}

// One warp a plane: stats[p] = the sum of part[p * parts + i] over i, each
// lane over i = lane mod 32, then an xor butterfly (a fixed order).
__global__ void __launch_bounds__(THREADS)
    reduce_parts(const float2* __restrict__ part, float2* __restrict__ stats,
                 long planes, int parts) {
  const long p = (long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (p >= planes) return;   // the whole warp
  const int lane = threadIdx.x & 31;
  float s = 0.f, ss = 0.f;
  for (int i = lane; i < parts; i += 32) {
    const float2 v = part[p * parts + i];
    s += v.x;
    ss += v.y;
  }
  const float2 t = warp_sum2(s, ss);
  if (lane == 0) stats[p] = t;
}

template <typename Tin, typename Tout, int W>
__global__ void __launch_bounds__(THREADS)
    apply(const Tin* __restrict__ x, const float2* __restrict__ stats,
          Tout* __restrict__ y, long hw, int C, int lanes, long seg_len,
          float eps, int act) {
  const Place t = place<W>(hw, C, lanes, seg_len);
  if (!t.live) return;
  const long base = (long)blockIdx.z * hw * C + t.ch;
  float mean[W], rstd[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const float2 m =
        norm::mean_rstd(stats[(long)blockIdx.z * C + t.ch + j], hw, eps);
    mean[j] = m.x;
    rstd[j] = m.y;
  }
  for (long p = t.p0 + t.row; p < t.p1; p += t.rows) {
    float f[W];
    load_f<Tin, W>(x + base + p * C, f);
#pragma unroll
    for (int j = 0; j < W; ++j)
      f[j] = activate((f[j] - mean[j]) * rstd[j], act);
    store_f<Tout, W>(y + base + p * C, f);
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(THREADS)
    bwd_sums(const T* __restrict__ g, const T* __restrict__ x,
             const float2* __restrict__ stats, float2* __restrict__ part,
             long hw, int C, int lanes, long seg_len, float eps, int act) {
  const Place t = place<W>(hw, C, lanes, seg_len);
  const long base = (long)blockIdx.z * hw * C + t.ch;
  float s1[W], s2[W];
#pragma unroll
  for (int j = 0; j < W; ++j) s1[j] = s2[j] = 0.f;
  if (t.live) {
    float mean[W], rstd[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float2 m =
          norm::mean_rstd(stats[(long)blockIdx.z * C + t.ch + j], hw, eps);
      mean[j] = m.x;
      rstd[j] = m.y;
    }
    for (long p = t.p0 + t.row; p < t.p1; p += t.rows) {
      float xf[W], gf[W];
      load_f<T, W>(x + base + p * C, xf);
      load_f<T, W>(g + base + p * C, gf);
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const float xh = (xf[j] - mean[j]) * rstd[j];
        const float gm = gf[j] * activate_grad(xh, act);
        s1[j] += gm;
        s2[j] += gm * xh;
      }
    }
  }
  write_partials<W>(s1, s2, t, lanes, C, part);
}

template <typename T, int W>
__global__ void __launch_bounds__(THREADS)
    bwd_apply(const T* __restrict__ g, const T* __restrict__ x,
              const float2* __restrict__ stats,
              const float2* __restrict__ sums, T* __restrict__ dx, long hw,
              int C, int lanes, long seg_len, float eps, int act) {
  const Place t = place<W>(hw, C, lanes, seg_len);
  if (!t.live) return;
  const long base = (long)blockIdx.z * hw * C + t.ch;
  float mean[W], rstd[W], m1[W], m2[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const long pl = (long)blockIdx.z * C + t.ch + j;
    const float2 m = norm::mean_rstd(stats[pl], hw, eps);
    mean[j] = m.x;
    rstd[j] = m.y;
    const float2 u = sums[pl];
    m1[j] = u.x / (float)hw;
    m2[j] = u.y / (float)hw;
  }
  for (long p = t.p0 + t.row; p < t.p1; p += t.rows) {
    float xf[W], gf[W];
    load_f<T, W>(x + base + p * C, xf);
    load_f<T, W>(g + base + p * C, gf);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float xh = (xf[j] - mean[j]) * rstd[j];
      const float gm = gf[j] * activate_grad(xh, act);
      gf[j] = rstd[j] * (gm - m1[j] - xh * m2[j]);
    }
    store_f<T, W>(dx + base + p * C, gf);
  }
}

// Host side. The geometry of a kernel over C channels in chunks of W:
// lanes, the fewest power of two covering a pixel's chunks (at most 32);
// tiles of lanes * W channels along grid.y.
struct Geo {
  int lanes, tiles;
  long seg_len;
  dim3 grid;
};

inline Geo geo(long n, long hw, int C, int W, int segs) {
  Geo g;
  const int chunks = (C + W - 1) / W;
  g.lanes = 1;
  while (g.lanes < chunks && g.lanes < 32) g.lanes *= 2;
  g.tiles = (chunks + g.lanes - 1) / g.lanes;
  g.seg_len = (hw + segs - 1) / segs;
  g.grid = dim3(segs, g.tiles, n);
  return g;
}

// The checks every entry point makes: sizes, and on the vector path
// (`vec`) C a multiple of 8 and every pointer on 16 bytes.
inline bool shape_ok(long n, long hw, int C, int segs, int vec,
                     std::initializer_list<const void*> ptrs) {
  if (n <= 0 || hw <= 0 || C <= 0 || segs <= 0 || segs > 65535 ||
      n > 65535)
    return false;
  if (vec) {
    if (C % 8) return false;
    for (const void* p : ptrs)
      if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  }
  return true;
}

inline void launch_reduce(const float2* part, float2* stats, long planes,
                          int parts, cudaStream_t st) {
  const long per = THREADS / 32;
  reduce_parts<<<(planes + per - 1) / per, THREADS, 0, st>>>(part, stats,
                                                             planes, parts);
}

// W of a kernel whose vector unit is 16 bytes of T
template <typename T>
constexpr int vec_w() {
  return 16 / (int)sizeof(T);
}

template <typename T>
void launch_seg_stats(const T* x, float2* part, long n, long hw, int C,
                      int segs, int vec, cudaStream_t st) {
  if (vec) {
    constexpr int W = vec_w<T>();
    const Geo g = geo(n, hw, C, W, segs);
    seg_stats<T, W><<<g.grid, THREADS, 0, st>>>(x, part, hw, C, g.lanes,
                                                g.seg_len);
  } else {
    const Geo g = geo(n, hw, C, 1, segs);
    seg_stats<T, 1><<<g.grid, THREADS, 0, st>>>(x, part, hw, C, g.lanes,
                                                g.seg_len);
  }
}

inline void launch_split_stats(float* acc, int splits, long slice,
                               float2* part, long n, long hw, int C, int segs,
                               int vec, cudaStream_t st) {
  if (vec) {
    const Geo g = geo(n, hw, C, 4, segs);
    split_stats<4><<<g.grid, THREADS, 0, st>>>(acc, splits, slice, part, hw,
                                               C, g.lanes, g.seg_len);
  } else {
    const Geo g = geo(n, hw, C, 1, segs);
    split_stats<1><<<g.grid, THREADS, 0, st>>>(acc, splits, slice, part, hw,
                                               C, g.lanes, g.seg_len);
  }
}

// the vector unit is 16 bytes of the output type
template <typename Tin, typename Tout>
void launch_apply(const Tin* x, const float2* stats, Tout* y, long n,
                  long hw, int C, int segs, int vec, float eps, int act,
                  cudaStream_t st) {
  if (vec) {
    constexpr int W = vec_w<Tout>();
    const Geo g = geo(n, hw, C, W, segs);
    apply<Tin, Tout, W><<<g.grid, THREADS, 0, st>>>(x, stats, y, hw, C,
                                                    g.lanes, g.seg_len, eps,
                                                    act);
  } else {
    const Geo g = geo(n, hw, C, 1, segs);
    apply<Tin, Tout, 1><<<g.grid, THREADS, 0, st>>>(x, stats, y, hw, C,
                                                    g.lanes, g.seg_len, eps,
                                                    act);
  }
}

// K1's NHWC form: statistics, their reduction, the apply. part holds
// n * C * segs pairs, stats n * C.
template <typename T>
void launch_in_act(const T* x, T* y, float2* part, float2* stats, long n,
                   long hw, int C, int segs, int vec, float eps, int act,
                   cudaStream_t st) {
  launch_seg_stats<T>(x, part, n, hw, C, segs, vec, st);
  launch_reduce(part, stats, n * C, segs, st);
  launch_apply<T, T>(x, stats, y, n, hw, C, segs, vec, eps, act, st);
}

// K1-bwd's NHWC form: x's statistics, then (sum gm, sum gm * xhat), then
// dx. part holds n * C * segs pairs, stats and sums n * C each.
template <typename T>
void launch_in_act_bwd(const T* g, const T* x, T* dx, float2* part,
                       float2* stats, float2* sums, long n, long hw, int C,
                       int segs, int vec, float eps, int act,
                       cudaStream_t st) {
  launch_seg_stats<T>(x, part, n, hw, C, segs, vec, st);
  launch_reduce(part, stats, n * C, segs, st);
  if (vec) {
    constexpr int W = vec_w<T>();
    const Geo ge = geo(n, hw, C, W, segs);
    bwd_sums<T, W><<<ge.grid, THREADS, 0, st>>>(g, x, stats, part, hw, C,
                                                ge.lanes, ge.seg_len, eps,
                                                act);
    launch_reduce(part, sums, n * C, segs, st);
    bwd_apply<T, W><<<ge.grid, THREADS, 0, st>>>(g, x, stats, sums, dx, hw,
                                                 C, ge.lanes, ge.seg_len, eps,
                                                 act);
  } else {
    const Geo ge = geo(n, hw, C, 1, segs);
    bwd_sums<T, 1><<<ge.grid, THREADS, 0, st>>>(g, x, stats, part, hw, C,
                                                ge.lanes, ge.seg_len, eps,
                                                act);
    launch_reduce(part, sums, n * C, segs, st);
    bwd_apply<T, 1><<<ge.grid, THREADS, 0, st>>>(g, x, stats, sums, dx, hw,
                                                 C, ge.lanes, ge.seg_len, eps,
                                                 act);
  }
}

}  // namespace nhwc
}  // namespace pgt
