// Band forms of K1's statistics and K1-bwd's two halves, redesigned for
// the H100: a band's (sum, sum of squares) (pgt_in_stats, norm_act.cu),
// K1-bwd's sums (pgt_in_bwd_sums) and dx given the summed sums
// (pgt_in_bwd_apply), both in norm_act_bwd.cu; the formulas and the other
// band entries are band.cuh's.
//
// Replaces, with the rest of the band forms, the JAX package's
// patchgan_tpu/ops/pallas/norm_act.py::_fwd_kernel's statistics
// (:152-163, pallas_call :211) and _backward_pallas (_bwd_kernel
// :166-198) over a band of each plane's rows (spatial parallelism,
// parallel/spatial.py).
//
// Bound on the H100: bytes. The statistics read x once, the sums g and x,
// and both write 8 bytes a plane; dx reads g and x once and writes dx
// once. A few fp32 operations an element (one tanh at most) are far below
// the fp32 rate.
//
// Sums, per plane p, of what each element adds (a Term): StatsTerm (v,
// v^2) of x for the statistics; BwdTerm (gm, gm * xhat) of g and x for
// K1-bwd, gm = g * act'(xhat), xhat from the plane's global stats and
// count. One template over the Term, so both take the same two kernels;
// the host (band_sums_plan in ops/kernels/norm_act.py) picks one and
// passes its geometry:
//   group    a plane of at most THREADS * UNROLL chunks: K1-bwd's plane
//            machinery (norm_plane.cuh), a group of threads sized to the
//            plane by plane_geometry, its 16-byte chunks held in
//            registers, the group's fixed-order sum (xor butterflies,
//            several planes a warp where a plane is short);
//   cluster  a larger plane: `cluster` CTAs (at most 8, the portable
//            limit) split its chunks into contiguous segments; a thread
//            keeps UNROLL chunks of each input in flight and adds its own
//            in chunk order, block_sum2 reduces the CTA, and every CTA
//            pushes its pair into rank 0's shared memory (st.async counted
//            on rank 0's mbarrier: norm_nhwc_cluster.cuh), which adds the
//            pairs in rank order. Nothing is staged: nothing is read twice.
// A chunk is 16 bytes where the plane's bytes are a multiple of 16 and
// the inputs sit on 16 bytes, else one element. No atomics: two launches
// on the same inputs give the same bits.
//
// dx = rstd * (gm - m1 - xhat * m2), m1 and m2 the summed sums over the
// count, over the band's planes x plane elements walked as one range of
// chunks (the sums' chunks: 16 bytes, or single elements), so a chunk
// never crosses a plane. A thread loads `unroll` chunks of g and x,
// THREADS apart, with their planes' stats and sums (16 bytes against 48
// of data) before it unpacks or stores any; the blocks walk the range in
// rounds (band_bwd_apply_plan sets unroll and the grid). A thread finds
// its chunks' planes by adding, after one division at its start.
// The activation is a template parameter in both.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "band.cuh"
#include "norm_nhwc_cluster.cuh"
#include "norm_plane.cuh"

namespace pgt {
namespace band {

constexpr int UNROLL = 4;        // chunks a thread has in flight
constexpr int MAX_CLUSTER = 8;

// g is unread (null) for the statistics; so are stats, count and eps
template <typename T>
struct SumsArgs {
  const T* g;
  const T* x;
  const float2* stats;
  float2* sums;
  long planes, plane;
  float count, eps;
};

// What an element of a plane adds to its pair of sums: (v, v^2) of x
struct StatsTerm {
  static constexpr bool kGrad = false;
  template <typename Ch>
  static __device__ __forceinline__ void add(const Ch& xc, const Ch&,
                                             float2, float& s1, float& s2) {
    float xf[Ch::W];
    xc.unpack(xf);
#pragma unroll
    for (int j = 0; j < Ch::W; ++j) {
      s1 += xf[j];
      s2 += xf[j] * xf[j];
    }
  }
};

// (gm, gm * xhat) of g and x, gm = g * act'(xhat), st the plane's (mean,
// rstd)
template <int ACT>
struct BwdTerm {
  static constexpr bool kGrad = true;
  template <typename Ch>
  static __device__ __forceinline__ void add(const Ch& xc, const Ch& gc,
                                             float2 st, float& s1,
                                             float& s2) {
    constexpr int W = Ch::W;
    float xf[W], gf[W];
    xc.unpack(xf);
    gc.unpack(gf);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float xh = (xf[j] - st.x) * st.y;
      const float gm = gf[j] * activate_grad(xh, ACT);
      s1 += gm;
      s2 += gm * xh;
    }
  }
};

// A group of `group` threads a plane (norm_plane.cuh's geometry): chunk
// i of the plane goes to lane i % group; C chunks of each input a thread
// are loaded before any is added. A missing chunk is zero (adds 0).
template <typename T, int C, bool VEC, typename Term>
__global__ void __launch_bounds__(norm::MAX_THREADS)
    sums_group(SumsArgs<T> a, int group) {
  using Ch = norm::Chunk<T, VEC>;
  constexpr int W = Ch::W;
  __shared__ float2 part[32];
  const norm::Place at = norm::place<W>(a.planes, a.plane, group);
  const long p =
      (long)blockIdx.x * (blockDim.x / group) + threadIdx.x / group;
  const float2 st = Term::kGrad && at.live
                        ? mean_rstd(a.stats[p], a.count, a.eps)
                        : make_float2(0.f, 0.f);
  const T* xp = a.x + at.off;
  const T* gp = a.g + at.off;
  Ch xr[C], gr[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int i = k * group + at.lane;
    if (i < at.chunks) {
      xr[k].load(xp + (long)i * W);
      if constexpr (Term::kGrad) gr[k].load(gp + (long)i * W);
    }
  }
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < C; ++k) Term::add(xr[k], gr[k], st, s1, s2);
  for (int i = C * group + at.lane; i < at.chunks; i += group) {
    Ch xc, gc;
    xc.load(xp + (long)i * W);
    if constexpr (Term::kGrad) gc.load(gp + (long)i * W);
    Term::add(xc, gc, st, s1, s2);
  }
  const float2 u = norm::group_sum2(s1, s2, group, part);
  if (at.live && at.lane == 0) a.sums[p] = u;
}

// CTA b: rank b % cluster of plane b / cluster, chunks [rank * seg,
// (rank + 1) * seg) of it; thread t takes chunks lo + t + m * THREADS in
// order of m.
template <typename T, bool VEC, typename Term>
__global__ void __launch_bounds__(THREADS)
    sums_cluster(SumsArgs<T> a, long seg, int cluster) {
  namespace op = nhwc::one_pass;
  using Ch = norm::Chunk<T, VEC>;
  constexpr int W = Ch::W;
  __shared__ uint64_t bar[2];
  __shared__ float2 recv[MAX_CLUSTER];
  const long p = blockIdx.x / cluster;
  const int rank = (int)(blockIdx.x % cluster);
  if (cluster > 1) op::barriers_init(bar, cluster * 8);
  const float2 st = Term::kGrad ? mean_rstd(a.stats[p], a.count, a.eps)
                                : make_float2(0.f, 0.f);
  const long chunks = a.plane / W;
  const long lo = rank * seg;
  const long hi = lo + seg < chunks ? lo + seg : chunks;
  const T* xp = a.x + p * a.plane;
  const T* gp = a.g + p * a.plane;
  float s1 = 0.f, s2 = 0.f;
  for (long i = lo + threadIdx.x; i < hi; i += (long)THREADS * UNROLL) {
    Ch xc[UNROLL], gc[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long j = i + (long)k * THREADS;
      if (j < hi) {
        xc[k].load(xp + j * W);
        if constexpr (Term::kGrad) gc[k].load(gp + j * W);
      }
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) Term::add(xc[k], gc[k], st, s1, s2);
  }
  const float2 t = block_sum2(s1, s2);
  if (cluster == 1) {
    if (threadIdx.x == 0) a.sums[p] = t;
    return;
  }
  op::cluster_wait();   // rank 0's mbarrier is set: the pushes may start
  if (threadIdx.x == 0) op::push(recv + rank, t, bar, 0);
  if (rank == 0 && threadIdx.x == 0) {
    op::barrier_wait(bar);
    float u1 = 0.f, u2 = 0.f;
    for (int r = 0; r < cluster; ++r) {
      u1 += recv[r].x;
      u2 += recv[r].y;
    }
    a.sums[p] = make_float2(u1, u2);
  }
}

template <typename T>
struct DxArgs {
  const T* g;
  const T* x;
  const float2* stats;
  const float2* sums;
  T* dx;
  long planes, per;   // per: chunks a plane
  int unroll;
  float count, eps;
};

// Chunk v's plane p and its place r in it (v = p * per + r), moved on by
// a fixed step dq * per + dr (dr < per) without a division.
struct Walk {
  long p, r;
  __device__ __forceinline__ void step(long dq, long dr, long per) {
    p += dq;
    r += dr;
    if (r >= per) {
      r -= per;
      ++p;
    }
  }
};

// Round q of block b: chunks q * span + k * THREADS + t (k < unroll),
// span = THREADS * unroll, q = b, b + gridDim.x, ...; a chunk stays
// packed (norm_plane.cuh's Chunk) until its plane's sums have come too.
template <typename T, bool VEC, int ACT>
__global__ void __launch_bounds__(THREADS)
    bwd_apply_vec(DxArgs<T> a) {
  using Ch = norm::Chunk<T, VEC>;
  constexpr int W = Ch::W;
  const long per = a.per, n = a.planes * per;
  const long span = (long)THREADS * a.unroll;
  const long jump = (long)gridDim.x * span;
  long v = (long)blockIdx.x * span + threadIdx.x;
  if (v >= n) return;
  Walk w{v / per, v % per};
  const long dq = THREADS / per, dr = THREADS % per;
  const long jq = jump / per, jr = jump % per;
  for (; v < n; v += jump) {
    Ch xc[UNROLL], gc[UNROLL];
    float2 st[UNROLL], su[UNROLL];
    Walk u = w;
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long i = v + (long)k * THREADS;
      if (k < a.unroll && i < n) {
        xc[k].load(a.x + i * W);
        gc[k].load(a.g + i * W);
        st[k] = a.stats[u.p];
        su[k] = a.sums[u.p];
      }
      u.step(dq, dr, per);
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long i = v + (long)k * THREADS;
      if (k < a.unroll && i < n) {
        const float2 m = mean_rstd(st[k], a.count, a.eps);
        const float m1 = su[k].x / a.count, m2 = su[k].y / a.count;
        float xf[W], gf[W];
        xc[k].unpack(xf);
        gc[k].unpack(gf);
#pragma unroll
        for (int j = 0; j < W; ++j) {
          const float xh = (xf[j] - m.x) * m.y;
          const float gm = gf[j] * activate_grad(xh, ACT);
          gf[j] = m.y * (gm - m1 - xh * m2);
        }
        Ch::store(a.dx + i * W, gf);
      }
    }
    w.step(jq, jr, per);
  }
}

// Host side.

// f(std::integral_constant<int, ACT>) for the activation code `act`
template <typename F>
inline cudaError_t with_act(int act, F&& f) {
  switch (act) {
    case ACT_TANH: return f(std::integral_constant<int, ACT_TANH>());
    case ACT_RELU: return f(std::integral_constant<int, ACT_RELU>());
    case ACT_LEAKY: return f(std::integral_constant<int, ACT_LEAKY>());
    default: return f(std::integral_constant<int, ACT_NONE>());
  }
}

// f(std::integral_constant<bool, b>)
template <typename F>
inline cudaError_t with_bool(bool b, F&& f) {
  return b ? f(std::true_type()) : f(std::false_type());
}

// KERNEL over `blocks` CTAs of THREADS in clusters of `cluster` along x
template <auto KERNEL, typename... Args>
inline cudaError_t launch_clustered(long blocks, int cluster,
                                    cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, KERNEL, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The sums' geometry (band_sums_plan): cluster 0 takes the group kernel
// with (vec, group, per_thread 1 or 4, threads), else `cluster` (1, 2, 4
// or 8) CTAs a plane; Term: what an element adds. Returns
// cudaErrorInvalidValue for a geometry the kernels cannot take.
template <typename Term, typename T>
inline cudaError_t launch_sums(const SumsArgs<T>& a, int vec, int group,
                               int per_thread, int threads, int cluster,
                               cudaStream_t st) {
  constexpr int esize = sizeof(T);
  if (cluster > 0) {
    if (cluster > MAX_CLUSTER || (cluster & (cluster - 1)) ||
        a.planes <= 0 || a.plane <= 0 ||
        a.planes * cluster > 0x7fffffffL ||
        (vec && ((a.plane * esize) % 16 ||
                 reinterpret_cast<uintptr_t>(a.g) % 16 ||
                 reinterpret_cast<uintptr_t>(a.x) % 16)))
      return cudaErrorInvalidValue;
    const long chunks = vec ? a.plane / (16 / esize) : a.plane;
    const long seg = (chunks + cluster - 1) / cluster;
    return with_bool(vec, [&](auto v) {
      return launch_clustered<sums_cluster<T, decltype(v)::value, Term>>(
          a.planes * cluster, cluster, st, a, seg, cluster);
    });
  }
  const long grid = norm::grid_of(
      a.planes, a.plane, esize, vec, group, per_thread, threads,
      {static_cast<const void*>(a.g), static_cast<const void*>(a.x)});
  if (grid == 0 || per_thread == 8) return cudaErrorInvalidValue;
  return with_bool(vec, [&](auto v) {
    constexpr bool VEC = decltype(v)::value;
    if (per_thread == 1)
      sums_group<T, 1, VEC, Term><<<grid, threads, 0, st>>>(a, group);
    else
      sums_group<T, 4, VEC, Term><<<grid, threads, 0, st>>>(a, group);
    return cudaGetLastError();
  });
}

// K1-bwd's sums in activation `act`
template <typename T>
inline cudaError_t launch_bwd_sums(const SumsArgs<T>& a, int act, int vec,
                                   int group, int per_thread, int threads,
                                   int cluster, cudaStream_t st) {
  return with_act(act, [&](auto c) {
    return launch_sums<BwdTerm<decltype(c)::value>>(a, vec, group,
                                                    per_thread, threads,
                                                    cluster, st);
  });
}

// dx's geometry (band_bwd_apply_plan): vec (16-byte chunks, else single
// elements), unroll (1, 2 or 4) and the grid. Returns
// cudaErrorInvalidValue for one the kernel cannot take.
template <typename T>
inline cudaError_t launch_bwd_apply(const T* g, const T* x,
                                    const float2* stats, const float2* sums,
                                    T* dx, long planes, long plane,
                                    float count, float eps, int act, int vec,
                                    int unroll, long grid, cudaStream_t st) {
  constexpr int esize = sizeof(T);
  if (planes <= 0 || plane <= 0 || grid <= 0 || grid > 0x7fffffffL ||
      !(unroll == 1 || unroll == 2 || unroll == 4) ||
      (vec && ((plane * esize) % 16 || reinterpret_cast<uintptr_t>(g) % 16 ||
               reinterpret_cast<uintptr_t>(x) % 16 ||
               reinterpret_cast<uintptr_t>(dx) % 16)))
    return cudaErrorInvalidValue;
  const DxArgs<T> a{g, x, stats, sums, dx, planes,
                    vec ? plane / (16 / esize) : plane, unroll, count, eps};
  return with_bool(vec, [&](auto v) {
    return with_act(act, [&](auto c) {
      bwd_apply_vec<T, decltype(v)::value, decltype(c)::value>
          <<<grid, THREADS, 0, st>>>(a);
      return cudaGetLastError();
    });
  });
}

}  // namespace band
}  // namespace pgt
