// K1-bwd: backward of the affine-free instance norm + activation, NCHW.
//
// Replaces: patchgan_tpu/ops/pallas/norm_act.py::_backward_pallas
// (pallas_call at :253, body _bwd_kernel :166-198), reached via the
// custom VJP of instance_norm_act_pallas. In the port it is the gradient of
// every normed generator level: K1's own, and the recompute backward of K2
// and K3 (ops/kernels/*.py), which feed it the conv output recomputed in
// the compute dtype.
//
// Computes, per (n, c) plane over H*W, from the forward input x and the
// output gradient g:
//   mean, rstd from x in fp32 (var = E[x^2] - mean^2, rstd = rsqrt(var+eps))
//   xhat = (x - mean) * rstd,  gm = g * act'(xhat)
//   dx = rstd * (gm - mean(gm) - xhat * mean(gm * xhat))
// dx is written in the dtype of g and x.
//
// Bound on the H100: bytes. It must read x and g and write dx once; the
// arithmetic (a few fp32 operations per element, one tanh at most) is far
// below the fp32 rate, so the floor is 3 tensors / 3.35 TB/s.
//
// Design (norm_plane.cuh): as the TPU kernel holds a (1, H, W, cb) block
// in VMEM and takes its passes from there, a group of threads here loads
// its plane's x and g once, in 16-byte chunks, into registers, and takes
// both reductions and dx from that copy: 6 bytes an element in bf16, what
// the bound counts. The group is sized to the plane by the host
// (plane_geometry): a few lanes for the deep levels' 2 x 2 to 16 x 16
// planes, which then share a warp and reduce with shuffles alone; a warp
// for 32 x 32; a block for 64 x 64 and 128 x 128. Both reductions run in
// a fixed order with no atomics, so a run is bit-reproducible. A plane
// larger than the registers hold (group * per_thread chunks) reads the
// rest from memory in each pass; a plane whose bytes are no multiple of
// 16 goes element by element.
//
// Band form (spatial parallelism, band.cuh): pgt_in_bwd_sums gives a band's
// per-plane (sum gm, sum gm * xhat) from the plane's global statistics
// (band_norm.cuh: small planes on the plane machinery above, larger ones
// split over a thread-block cluster), and pgt_in_bwd_apply writes the
// band's dx from those sums summed over the spatial group (band_norm.cuh:
// the band walked as one range of 16-byte vectors).
//
// NHWC form (channels_last): g and x in [N, H, W, C] order.
// pgt_in_act_bwd_nhwc_one_pass (norm_nhwc_cluster.cuh): one launch, a
// thread-block cluster a (sample, channel tile), x and g read once into
// shared memory and all three phases taken from there; the host takes it
// wherever a tile's pixels fit a cluster's shared memory.
// pgt_in_act_bwd_nhwc (norm_nhwc.cuh), the segmented kernels for the rest:
// x's per-segment partial statistics and their sum, then the partial (sum
// gm, sum gm * xhat) and their sum, then dx, each pass a block over a tile
// of contiguous channels and a segment of one sample's pixels.

#include "band.cuh"
#include "band_norm.cuh"
#include "norm_nhwc.cuh"
#include "norm_nhwc_cluster.cuh"
#include "norm_plane.cuh"

namespace pgt {

template <typename T, int C, bool VEC>
__global__ void __launch_bounds__(norm::MAX_THREADS)
    in_act_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
                      T* __restrict__ dx, long planes, long plane, int group,
                      float eps, int act) {
  using Ch = norm::Chunk<T, VEC>;
  constexpr int W = Ch::W;
  __shared__ float2 part[2][32];
  const norm::Place at = norm::place<W>(planes, plane, group);
  const T* xp = x + at.off;
  const T* gp = g + at.off;
  T* dp = dx + at.off;
  const int held = C * group;   // chunks the group's registers hold

  Ch xr[C], gr[C];   // zero where the plane has no chunk
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int i = k * group + at.lane;
    if (i < at.chunks) {
      xr[k].load(xp + (long)i * W);
      gr[k].load(gp + (long)i * W);
    }
  }
  float s = 0.f, ss = 0.f;
  auto add = [&](const Ch& c) {
    float f[W];
    c.unpack(f);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      s += f[j];
      ss += f[j] * f[j];
    }
  };
#pragma unroll
  for (int k = 0; k < C; ++k) add(xr[k]);
  for (int i = held + at.lane; i < at.chunks; i += group) {
    Ch c;
    c.load(xp + (long)i * W);
    add(c);
  }
  const float2 st =
      norm::mean_rstd(norm::group_sum2(s, ss, group, part[0]), plane, eps);
  const float mean = st.x, rstd = st.y;

  // (sum gm, sum gm * xhat); a missing chunk has g = 0, so adds 0
  float s1 = 0.f, s2 = 0.f;
  auto sums = [&](const Ch& xc, const Ch& gc) {
    float xf[W], gf[W];
    xc.unpack(xf);
    gc.unpack(gf);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float xh = (xf[j] - mean) * rstd;
      const float gm = gf[j] * activate_grad(xh, act);
      s1 += gm;
      s2 += gm * xh;
    }
  };
#pragma unroll
  for (int k = 0; k < C; ++k) sums(xr[k], gr[k]);
  for (int i = held + at.lane; i < at.chunks; i += group) {
    Ch xc, gc;
    xc.load(xp + (long)i * W);
    gc.load(gp + (long)i * W);
    sums(xc, gc);
  }
  const float2 u = norm::group_sum2(s1, s2, group, part[1]);
  const float m1 = u.x / (float)plane, m2 = u.y / (float)plane;

  auto write = [&](const Ch& xc, const Ch& gc, long i) {
    float xf[W], gf[W], d[W];
    xc.unpack(xf);
    gc.unpack(gf);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float xh = (xf[j] - mean) * rstd;
      const float gm = gf[j] * activate_grad(xh, act);
      d[j] = rstd * (gm - m1 - xh * m2);
    }
    Ch::store(dp + i * W, d);
  };
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int i = k * group + at.lane;
    if (i < at.chunks) write(xr[k], gr[k], i);
  }
  for (int i = held + at.lane; i < at.chunks; i += group) {
    Ch xc, gc;
    xc.load(xp + (long)i * W);
    gc.load(gp + (long)i * W);
    write(xc, gc, i);
  }
}

template <typename T, bool VEC>
void launch_bwd(const T* g, const T* x, T* dx, long planes, long plane,
                int group, int per_thread, int threads, long grid, float eps,
                int act, cudaStream_t st) {
#define PGT_BWD(C)                                                        \
  in_act_bwd_kernel<T, C, VEC>                                            \
      <<<grid, threads, 0, st>>>(g, x, dx, planes, plane, group, eps, act)
  switch (per_thread) {
    case 1: PGT_BWD(1); break;
    case 4: PGT_BWD(4); break;
    default: PGT_BWD(8); break;
  }
#undef PGT_BWD
}

}  // namespace pgt

// g, x, dx: [planes, plane] contiguous, all bf16 (bf16 != 0) or all fp32.
// vec, group, per_thread, threads: the launch geometry (norm_plane.cuh),
// chosen by plane_geometry in ops/kernels/norm_act.py. Returns
// cudaErrorInvalidValue for a geometry the kernel cannot take, else
// cudaGetLastError() after the launch.
extern "C" int pgt_in_act_bwd(const void* g, const void* x, void* dx,
                              long planes, long plane, int act, float eps,
                              int bf16, int vec, int group, int per_thread,
                              int threads, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long grid = pgt::norm::grid_of(planes, plane, bf16 ? 2 : 4, vec,
                                        group, per_thread, threads,
                                        {g, x, dx});
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) {
    using T = __nv_bfloat16;
    const T* gt = static_cast<const T*>(g);
    const T* xt = static_cast<const T*>(x);
    T* dt = static_cast<T*>(dx);
    if (vec)
      pgt::launch_bwd<T, true>(gt, xt, dt, planes, plane, group, per_thread,
                               threads, grid, eps, act, st);
    else
      pgt::launch_bwd<T, false>(gt, xt, dt, planes, plane, group, per_thread,
                                threads, grid, eps, act, st);
  } else {
    const float* gt = static_cast<const float*>(g);
    const float* xt = static_cast<const float*>(x);
    float* dt = static_cast<float*>(dx);
    if (vec)
      pgt::launch_bwd<float, true>(gt, xt, dt, planes, plane, group,
                                   per_thread, threads, grid, eps, act, st);
    else
      pgt::launch_bwd<float, false>(gt, xt, dt, planes, plane, group,
                                    per_thread, threads, grid, eps, act, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// Band form. g, x: [planes, plane] contiguous, both bf16 (bf16 != 0) or
// fp32; stats: the planes' global fp32 (sum, sum of squares) of the
// forward's input, count: a plane's global element count; sums: out, fp32
// pairs. vec, group, per_thread, threads, cluster: the launch geometry
// (band_norm.cuh), chosen by band_sums_plan in ops/kernels/norm_act.py.
// Returns cudaErrorInvalidValue for what the kernels cannot take, else
// the launch's error or cudaGetLastError() after it.
extern "C" int pgt_in_bwd_sums(const void* g, const void* x,
                               const void* stats, void* sums, long planes,
                               long plane, float count, int act, float eps,
                               int bf16, int vec, int group, int per_thread,
                               int threads, int cluster, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (planes <= 0 || plane <= 0 || !(count > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const float2* sp = static_cast<const float2*>(stats);
  float2* out = static_cast<float2*>(sums);
  namespace bn = pgt::band;
  if (bf16) {
    using B = __nv_bfloat16;
    const bn::SumsArgs<B> a{static_cast<const B*>(g),
                            static_cast<const B*>(x), sp, out, planes,
                            plane, count, eps};
    return static_cast<int>(bn::launch_bwd_sums(
        a, act, vec, group, per_thread, threads, cluster, st));
  }
  const bn::SumsArgs<float> a{static_cast<const float*>(g),
                              static_cast<const float*>(x), sp, out, planes,
                              plane, count, eps};
  return static_cast<int>(bn::launch_bwd_sums(a, act, vec, group,
                                              per_thread, threads, cluster,
                                              st));
}

// Band form. dx from g, x, the global stats and the (sum gm, sum gm *
// xhat) pairs summed over the band's group. vec, unroll, grid: the launch
// geometry (band_norm.cuh), chosen by band_bwd_apply_plan in
// ops/kernels/norm_act.py. Returns cudaErrorInvalidValue for what the
// kernel cannot take, else cudaGetLastError() after the launch.
extern "C" int pgt_in_bwd_apply(const void* g, const void* x,
                                const void* stats, const void* sums, void* dx,
                                long planes, long plane, float count, int act,
                                float eps, int bf16, int vec, int unroll,
                                long grid, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!(count > 0.f)) return static_cast<int>(cudaErrorInvalidValue);
  const float2* sp = static_cast<const float2*>(stats);
  const float2* up = static_cast<const float2*>(sums);
  if (bf16) {
    using B = __nv_bfloat16;
    return static_cast<int>(pgt::band::launch_bwd_apply(
        static_cast<const B*>(g), static_cast<const B*>(x), sp, up,
        static_cast<B*>(dx), planes, plane, count, eps, act, vec, unroll,
        grid, st));
  }
  return static_cast<int>(pgt::band::launch_bwd_apply(
      static_cast<const float*>(g), static_cast<const float*>(x), sp, up,
      static_cast<float*>(dx), planes, plane, count, eps, act, vec, unroll,
      grid, st));
}

// NHWC form. g, x, dx: [n, hw, c] (hw = H * W), all bf16 (bf16 != 0) or
// all fp32; part: fp32 pairs, n * c * segs; stats, sums: fp32 pairs,
// n * c each; segs and vec as pgt_in_act_nhwc's. Returns
// cudaErrorInvalidValue for what the kernels cannot take, else
// cudaGetLastError() after the launches.
extern "C" int pgt_in_act_bwd_nhwc(const void* g, const void* x, void* dx,
                                   void* part, void* stats, void* sums,
                                   long n, long hw, int c, int act, float eps,
                                   int bf16, int vec, int segs,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!pgt::nhwc::shape_ok(n, hw, c, segs, vec, {g, x, dx}))
    return static_cast<int>(cudaErrorInvalidValue);
  float2* pp = static_cast<float2*>(part);
  float2* sp = static_cast<float2*>(stats);
  float2* up = static_cast<float2*>(sums);
  if (bf16) {
    using B = __nv_bfloat16;
    pgt::nhwc::launch_in_act_bwd<B>(
        static_cast<const B*>(g), static_cast<const B*>(x),
        static_cast<B*>(dx), pp, sp, up, n, hw, c, segs, vec, eps, act, st);
  } else {
    pgt::nhwc::launch_in_act_bwd<float>(
        static_cast<const float*>(g), static_cast<const float*>(x),
        static_cast<float*>(dx), pp, sp, up, n, hw, c, segs, vec, eps, act,
        st);
  }
  return static_cast<int>(cudaGetLastError());
}

// One-pass NHWC form. g, x, dx: [n, hw, c], all bf16 (bf16 != 0) or all
// fp32, every pointer on 16 bytes; lanes and cluster as
// pgt_in_act_nhwc_one_pass's. Returns cudaErrorInvalidValue for what the
// kernel cannot take, else the launch's error or cudaGetLastError() after
// it.
extern "C" int pgt_in_act_bwd_nhwc_one_pass(const void* g, const void* x,
                                            void* dx, long n, long hw, int c,
                                            int act, float eps, int bf16,
                                            int lanes, int cluster,
                                            void* stream) {
  namespace op = pgt::nhwc::one_pass;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using B = __nv_bfloat16;
  const long smem =
      bf16 ? op::check<B>(n, hw, c, lanes, cluster, 2, {g, x, dx})
           : op::check<float>(n, hw, c, lanes, cluster, 2, {g, x, dx});
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return static_cast<int>(op::launch_in_act_bwd<B>(
        static_cast<const B*>(g), static_cast<const B*>(x),
        static_cast<B*>(dx), n, hw, c, lanes, cluster, smem, eps, act, st));
  return static_cast<int>(op::launch_in_act_bwd<float>(
      static_cast<const float*>(g), static_cast<const float*>(x),
      static_cast<float*>(dx), n, hw, c, lanes, cluster, smem, eps, act,
      st));
}
