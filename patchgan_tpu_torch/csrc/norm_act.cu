// K1: affine-free instance norm + activation, forward, NCHW.
//
// Replaces: patchgan_tpu/ops/pallas/norm_act.py::_forward (pallas_call at
// :211, body _fwd_kernel :152-163), reached via instance_norm_act_pallas.
//
// Computes, per (n, c) plane over H*W: fp32 mean, var = E[x^2] - mean^2,
// rstd = rsqrt(var + eps), y = act((x - mean) * rstd), act in
// {none, tanh, relu, leakyrelu(0.2)}.
//
// Bound on the H100: bytes. It must read x and write y once; a handful of
// fp32 operations per element is far below the fp32 rate, so the floor is
// (read + write) / 3.35 TB/s.
//
// Design (norm_plane.cuh, shared with K1-bwd): a group of threads sized to
// the plane by the host (plane_geometry) loads its plane once, in 16-byte
// chunks, into registers, reduces (sum, sum of squares) over the group in
// a fixed order (no atomics, so runs are bit-reproducible), and writes y
// from that copy with 16-byte stores. A plane larger than the registers
// hold reads the rest again from memory; a plane whose bytes are no
// multiple of 16 goes element by element. The fused conv kernels keep
// their own finishing pass (in_common.cuh's normalize_plane).
//
// Band form (spatial parallelism, band.cuh): pgt_in_stats gives a band's
// per-plane (sum, sum of squares), on band_norm.cuh's sums (a plane on a
// group of threads, or split over a thread-block cluster, with 16-byte
// loads), and pgt_in_apply normalises a band from the plane's stats
// summed over the spatial group and its global count.
//
// NHWC form (channels_last): x in [N, H, W, C] order, whose (n, c) plane
// is strided by C. pgt_in_act_nhwc_one_pass (norm_nhwc_cluster.cuh): one
// launch, a thread-block cluster a (sample, channel tile), x read once into
// shared memory; the host takes it wherever a tile's pixels fit a
// cluster's shared memory. pgt_in_act_nhwc (norm_nhwc.cuh), the segmented
// kernels for the rest: a block holds a tile of contiguous channels over a
// segment of one sample's pixels, writes per-segment partial statistics, a
// warp a plane adds them, and a last pass normalises.

#include "band.cuh"
#include "band_norm.cuh"
#include "norm_nhwc.cuh"
#include "norm_nhwc_cluster.cuh"
#include "norm_plane.cuh"

namespace pgt {

template <typename T, int C, bool VEC>
__global__ void __launch_bounds__(norm::MAX_THREADS)
    in_act_kernel(const T* __restrict__ x, T* __restrict__ y, long planes,
                  long plane, int group, float eps, int act) {
  using Ch = norm::Chunk<T, VEC>;
  constexpr int W = Ch::W;
  __shared__ float2 part[32];
  const norm::Place at = norm::place<W>(planes, plane, group);
  const T* xp = x + at.off;
  T* yp = y + at.off;
  const int held = C * group;

  Ch xr[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int i = k * group + at.lane;
    if (i < at.chunks) xr[k].load(xp + (long)i * W);
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
      norm::mean_rstd(norm::group_sum2(s, ss, group, part), plane, eps);

  auto write = [&](const Ch& c, long i) {
    float f[W];
    c.unpack(f);
#pragma unroll
    for (int j = 0; j < W; ++j) f[j] = activate((f[j] - st.x) * st.y, act);
    Ch::store(yp + i * W, f);
  };
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int i = k * group + at.lane;
    if (i < at.chunks) write(xr[k], i);
  }
  for (int i = held + at.lane; i < at.chunks; i += group) {
    Ch c;
    c.load(xp + (long)i * W);
    write(c, i);
  }
}

template <typename T, bool VEC>
void launch_fwd(const T* x, T* y, long planes, long plane, int group,
                int per_thread, int threads, long grid, float eps, int act,
                cudaStream_t st) {
#define PGT_FWD(C)                                                          \
  in_act_kernel<T, C, VEC>                                                  \
      <<<grid, threads, 0, st>>>(x, y, planes, plane, group, eps, act)
  switch (per_thread) {
    case 1: PGT_FWD(1); break;
    case 4: PGT_FWD(4); break;
    default: PGT_FWD(8); break;
  }
#undef PGT_FWD
}

}  // namespace pgt

// x, y: [planes, plane] contiguous, both bf16 (bf16 != 0) or both fp32.
// vec, group, per_thread, threads: the launch geometry (norm_plane.cuh),
// chosen by plane_geometry in ops/kernels/norm_act.py. Returns
// cudaErrorInvalidValue for a geometry the kernel cannot take, else
// cudaGetLastError() after the launch.
extern "C" int pgt_in_act(const void* x, void* y, long planes, long plane,
                          int act, float eps, int bf16, int vec, int group,
                          int per_thread, int threads, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long grid = pgt::norm::grid_of(planes, plane, bf16 ? 2 : 4, vec,
                                        group, per_thread, threads, {x, y});
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) {
    using T = __nv_bfloat16;
    const T* xt = static_cast<const T*>(x);
    T* yt = static_cast<T*>(y);
    if (vec)
      pgt::launch_fwd<T, true>(xt, yt, planes, plane, group, per_thread,
                               threads, grid, eps, act, st);
    else
      pgt::launch_fwd<T, false>(xt, yt, planes, plane, group, per_thread,
                                threads, grid, eps, act, st);
  } else {
    const float* xt = static_cast<const float*>(x);
    float* yt = static_cast<float*>(y);
    if (vec)
      pgt::launch_fwd<float, true>(xt, yt, planes, plane, group, per_thread,
                                   threads, grid, eps, act, st);
    else
      pgt::launch_fwd<float, false>(xt, yt, planes, plane, group,
                                    per_thread, threads, grid, eps, act, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// Band form. x: [planes, plane] contiguous, bf16 (bf16 != 0) or fp32;
// stats: out, fp32 pairs, one a plane. vec, group, per_thread, threads,
// cluster: the launch geometry (band_norm.cuh, the same kernels as
// pgt_in_bwd_sums'), chosen by band_sums_plan in ops/kernels/norm_act.py.
// Returns cudaErrorInvalidValue for what the kernels cannot take, else the
// launch's error or cudaGetLastError() after it.
extern "C" int pgt_in_stats(const void* x, void* stats, long planes,
                            long plane, int bf16, int vec, int group,
                            int per_thread, int threads, int cluster,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (planes <= 0 || plane <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  float2* out = static_cast<float2*>(stats);
  namespace bn = pgt::band;
  if (bf16) {
    using B = __nv_bfloat16;
    const bn::SumsArgs<B> a{nullptr, static_cast<const B*>(x), nullptr, out,
                            planes, plane, 0.f, 0.f};
    return static_cast<int>(bn::launch_sums<bn::StatsTerm>(
        a, vec, group, per_thread, threads, cluster, st));
  }
  const bn::SumsArgs<float> a{nullptr, static_cast<const float*>(x), nullptr,
                              out, planes, plane, 0.f, 0.f};
  return static_cast<int>(bn::launch_sums<bn::StatsTerm>(
      a, vec, group, per_thread, threads, cluster, st));
}

namespace pgt {
template <typename Tin, typename Tout>
void launch_apply(const void* x, const void* stats, void* y, long planes,
                  long plane, float count, float eps, int act,
                  cudaStream_t st) {
  band::launch_apply(static_cast<const Tin*>(x),
                     static_cast<const float2*>(stats), static_cast<Tout*>(y),
                     planes, plane, count, eps, act, st);
}
}  // namespace pgt

// Band form. x: [planes, plane] contiguous, fp32 or bf16 (x_bf16), y the
// same shape in fp32 or bf16 (y_bf16): a fused conv's fp32 output is
// normalised into the compute dtype. stats: the planes' fp32 (sum, sum of
// squares) summed over the band's group, count: a plane's global element
// count. Returns cudaGetLastError().
extern "C" int pgt_in_apply(const void* x, const void* stats, void* y,
                            long planes, long plane, float count, int act,
                            float eps, int x_bf16, int y_bf16,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (planes <= 0 || plane <= 0 || !(count > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  using B = __nv_bfloat16;
  if (x_bf16 && y_bf16)
    pgt::launch_apply<B, B>(x, stats, y, planes, plane, count, eps, act, st);
  else if (x_bf16)
    pgt::launch_apply<B, float>(x, stats, y, planes, plane, count, eps, act,
                                st);
  else if (y_bf16)
    pgt::launch_apply<float, B>(x, stats, y, planes, plane, count, eps, act,
                                st);
  else
    pgt::launch_apply<float, float>(x, stats, y, planes, plane, count, eps,
                                    act, st);
  return static_cast<int>(cudaGetLastError());
}

// NHWC form. x, y: [n, hw, c] (an NHWC tensor: hw = H * W), both bf16
// (bf16 != 0) or both fp32; part: fp32 pairs, n * c * segs; stats: fp32
// pairs, n * c; segs: segments of a sample's pixels (grid.x); vec: 16-byte
// vectors (c a multiple of 8, every pointer on 16 bytes), else element by
// element. Returns cudaErrorInvalidValue for what the kernels cannot take,
// else cudaGetLastError() after the launches.
extern "C" int pgt_in_act_nhwc(const void* x, void* y, void* part,
                               void* stats, long n, long hw, int c, int act,
                               float eps, int bf16, int vec, int segs,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!pgt::nhwc::shape_ok(n, hw, c, segs, vec, {x, y}))
    return static_cast<int>(cudaErrorInvalidValue);
  float2* pp = static_cast<float2*>(part);
  float2* sp = static_cast<float2*>(stats);
  if (bf16) {
    using B = __nv_bfloat16;
    pgt::nhwc::launch_in_act<B>(static_cast<const B*>(x), static_cast<B*>(y),
                                pp, sp, n, hw, c, segs, vec, eps, act, st);
  } else {
    pgt::nhwc::launch_in_act<float>(static_cast<const float*>(x),
                                    static_cast<float*>(y), pp, sp, n, hw, c,
                                    segs, vec, eps, act, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// One-pass NHWC form. x, y: [n, hw, c], both bf16 (bf16 != 0) or both
// fp32, every pointer on 16 bytes; lanes: the tile's 16-byte chunks a
// pixel (c a multiple of lanes * 16 bytes), cluster: CTAs a (sample, tile),
// both chosen by nhwc_one_pass_plan in ops/kernels/norm_act.py. Returns
// cudaErrorInvalidValue for what the kernel cannot take, else the launch's
// error or cudaGetLastError() after it.
extern "C" int pgt_in_act_nhwc_one_pass(const void* x, void* y, long n,
                                        long hw, int c, int act, float eps,
                                        int bf16, int lanes, int cluster,
                                        void* stream) {
  namespace op = pgt::nhwc::one_pass;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using B = __nv_bfloat16;
  const long smem = bf16 ? op::check<B>(n, hw, c, lanes, cluster, 1, {x, y})
                         : op::check<float>(n, hw, c, lanes, cluster, 1,
                                            {x, y});
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return static_cast<int>(op::launch_in_act<B>(
        static_cast<const B*>(x), static_cast<B*>(y), n, hw, c, lanes,
        cluster, smem, eps, act, st));
  return static_cast<int>(op::launch_in_act<float>(
      static_cast<const float*>(x), static_cast<float*>(y), n, hw, c, lanes,
      cluster, smem, eps, act, st));
}
