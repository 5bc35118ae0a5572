// K2: conv(k=4, s=2, p=1, no bias) + instance norm + activation, forward,
// NCHW input, OIHW weight.
//
// Replaces: patchgan_tpu/ops/pallas/conv_norm_act.py::_forward
// (pallas_call at :176, body _kernel :133-161, _parity_planes :119-130),
// reached via fused_conv_norm_act.
//
// Bound on the H100: operations at the shallow encoder levels (enc1-enc3
// do 537 M MACs per 256-px tile against a few MB of activations), bytes at
// the deep ones, where the 4 MB bf16 weight of a 512 -> 512 level is read
// for a 16- or 4-pixel plane.
//
// Design: the Pallas kernel holds a whole sample plane in VMEM because the
// norm's statistics span all of Ho*Wo; one H100 block cannot hold a
// shallow level's plane. So the conv is an implicit GEMM (conv_gemm.cuh)
// with M = Ho*Wo pixels of one sample, N = Cout, K = 16*Cin ordered
// (ci, ky, kx) as the OIHW weight is stored, gathering the stride-2 input
// window with zero-padding masks. Its epilogue writes the fp32 conv output
// to scratch plus per-(n, c, M-tile) partial statistics, and the finishing
// pass normalises from that fp32 accumulator, never a bf16-rounded copy,
// as the Pallas kernel does (conv_norm_act.py:154-161). The deep levels
// (enc4-enc6: 64 output tiles at 8 samples, K up to 8192) split K across
// blocks to fill the card, and normalise from the summed slices. That is
// the WMMA core's NCHW form, which fp32 and other widths take: in bf16
// with Cin and Cout multiples of 64 and x and w on 16 bytes (the host
// planner's choice) pgt_conv_in_act runs on the wgmma core of
// conv_wgmma.cuh instead, in one C call: the layout pass copies x into
// channels_last scratch and the weight into [Cout, 4, 4, Cin], the NHWC
// problem with H padded and an NCHW acc takes the product and its stats,
// and band.cuh's apply normalises into y (launch_conv_in_act_nchw_wgmma).
//
// The OIHW weight is already k-contiguous with K = 16 * Cin a multiple of
// 8, so the core stages it as it is. With k = k0 + ak0 + 2j a gathering
// thread's kx = ak0 + 2 (j & 1) alternates, ky = (j >> 1) & 3 steps and ci
// every eighth j: its four row and two column masks and its base offset
// are set up once a block.
//
// Band form (spatial parallelism): pgt_conv_band takes a rank's band of
// rows with its halo rows (parallel/spatial.py; the halo holds the zero
// rows at the image's edges, so the band pads no row of H); it writes the
// fp32 conv output of the band's own output rows in NCHW and their
// per-plane stats, and norm_act.cu's pgt_in_apply finishes it from the
// stats summed over the spatial group. In bf16 with Cin and Cout multiples
// of 64 (the host planner's choice) it runs on the wgmma core of
// conv_wgmma.cuh: the layout pass copies the band into channels_last
// scratch and the weight into [Cout, 4, 4, Cin], and the NHWC problem
// with no row of H padded and an NCHW acc takes the product
// (launch_conv_band_wgmma); otherwise the WMMA core of conv_gemm.cuh reads
// the NCHW band as it is (launch_conv_band).
//
// NHWC form (channels_last): pgt_conv_in_act_nhwc takes x as [N, H, W,
// Cin] and the channels_last weight, physically [Cout, 4, 4, Cin], which
// is B k-contiguous as it stands with k = (ky * 4 + kx) * Cin + ci, so
// nothing is packed. A second problem struct (ConvNhwcProblem): in bf16
// with Cin and Cout multiples of 64 and x on 16 bytes (the host planner's
// nhwc_gemm_plan), the wgmma core of conv_wgmma.cuh, a K step 64 channels
// of one tap copied straight from x; otherwise the WMMA core above, where
// with Cin a multiple of BK a K step lies inside one tap, and a gathering
// thread, whose k slots are every second one, reads the step's 32 channels
// of its pixel as 16-byte vectors (one 64-byte run, in L1 for the thread
// of the other parity) and keeps its parity's half; other Cin go element
// by element. The fp32 accumulator is NHWC, and the finish is
// norm_nhwc.cuh's (launch_conv_in_act_nhwc, launch_conv_in_act_nhwc_wgmma).

#include "conv_wgmma.cuh"

namespace pgt {

template <typename T>
struct ConvProblem {
  const T* x;   // [N, Cin, H, W]
  const T* bw;  // [Cout, Cin, 4, 4], row co is B[:, co]
  int Cin, H, W, Cout, Ho, Wo;
  int pt;  // zero rows padded above the input: 1, or 0 for a haloed band
  int M, Mw, K, G, ldb;

  struct Gather {
    const T* xs;   // this sample's first plane
    int base;      // in-plane offset of tap (ky, kx) = (0, ak0)
    unsigned ok;   // bit 2 * ky + side: tap (ky, ak0 + 2 side) inside
  };
  __device__ __forceinline__ Gather gather(int n, int, bool valid, int r,
                                           int c, int ax) const {
    const int iy = 2 * r - pt, ix = 2 * c - 1 + ax;
    Gather t;
    t.xs = x + (long)n * Cin * H * W;
    t.base = iy * W + ix;
    t.ok = 0;
#pragma unroll
    for (int ky = 0; ky < 4; ++ky)
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const int yy = iy + ky, xx = ix + 2 * side;
        if (valid && yy >= 0 && yy < H && xx >= 0 && xx < W)
          t.ok |= 1u << (2 * ky + side);
      }
    return t;
  }
  // pair i of the K step at k0: channel k0 / 16 + i / 4, row ky = i & 3,
  // columns kx = ak0 and ak0 + 2
  __device__ __forceinline__ void load_a(const Gather& t, int k0, int kend,
                                         pair_t<T> (&v)[BK / 4]) const {
    const int hw = H * W, ci0 = k0 >> 4, ciend = kend >> 4;
    const T zero = from_f32<T>(0.f);
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const int ci = ci0 + (i >> 2), ky = i & 3;
      const T* row = t.xs + (long)ci * hw + t.base + ky * W;
      const bool live = ci < ciend;
      v[i].x = live && (t.ok >> (2 * ky) & 1) ? row[0] : zero;
      v[i].y = live && (t.ok >> (2 * ky + 1) & 1) ? row[2] : zero;
    }
  }
  __device__ __forceinline__ long out(int n, int, int r, int c,
                                      int co) const {
    return (((long)n * Cout + co) * Ho + r) * Wo + c;
  }
};

// The NHWC problem: x [N, H, W, Cin], the weight [Cout, 4, 4, Cin] (k =
// tap * Cin + ci, tap = ky * 4 + kx). VEC: Cin a multiple of BK and x on
// 16 bytes. PAD_H: one zero row padded above the input (pt = 1), or none
// (pt = 0) for a haloed band. NHWC_OUT: acc [N, Ho, Wo, Cout], or NCHW
// [N, Cout, Ho, Wo] (the NCHW form and the band entry on the wgmma core,
// reading the layout pass's channels_last copies).
template <typename T, bool VEC, bool PAD_H = true, bool NHWC_OUT = true>
struct ConvNhwcProblem {
  static constexpr bool kChannelsLast = NHWC_OUT;
  const T* x;
  const T* bw;
  static constexpr int pt = PAD_H ? 1 : 0;
  int Cin, H, W, Cout, Ho, Wo;
  int M, Mw, K, G, ldb;

  struct Gather {
    const T* xs;   // this sample
    int iy, ix;    // the pixel of tap (0, 0)
    unsigned ok;   // bit tap: tap (ky, kx) inside the image
    int ak0;
  };
  __device__ __forceinline__ Gather gather(int n, int, bool valid, int r,
                                           int c, int ax) const {
    Gather t;
    t.xs = x + (long)n * H * W * Cin;
    t.iy = 2 * r - pt;
    t.ix = 2 * c - 1;
    t.ak0 = ax;
    t.ok = 0;
#pragma unroll
    for (int ky = 0; ky < 4; ++ky)
#pragma unroll
      for (int kx = 0; kx < 4; ++kx) {
        const int yy = t.iy + ky, xx = t.ix + kx;
        if (valid && yy >= 0 && yy < H && xx >= 0 && xx < W)
          t.ok |= 1u << (ky * 4 + kx);
      }
    return t;
  }
  __device__ __forceinline__ const T* at(const Gather& t, int tap,
                                         int ci) const {
    return t.xs + ((long)(t.iy + (tap >> 2)) * W + t.ix + (tap & 3)) * Cin +
           ci;
  }
  // the wgmma core (conv_wgmma.cuh): the channels of a tap, and a row's
  // channels ci .. of tap `tap`, or null outside the image
  __host__ __device__ __forceinline__ int tap_channels() const { return Cin; }
  __device__ __forceinline__ const T* a_src(const Gather& t, int tap,
                                            int ci) const {
    return t.ok >> tap & 1 ? at(t, tap, ci) : nullptr;
  }
  __device__ __forceinline__ void load_a(const Gather& t, int k0, int kend,
                                         pair_t<T> (&v)[BK / 4]) const {
    if constexpr (VEC) {
      // K and kend are multiples of BK: the step is whole and in one tap
      const int tap = k0 / Cin;
      if (t.ok >> tap & 1)
        load_step_channels<T>(at(t, tap, k0 - tap * Cin), t.ak0, v);
      else
        zero_pairs<T>(v);
    } else {
      const T zero = from_f32<T>(0.f);
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) {
        T e[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = k0 + t.ak0 + 4 * i + 2 * h;
          const int tap = k / Cin;
          e[h] = k < kend && (t.ok >> tap & 1) ? *at(t, tap, k - tap * Cin)
                                               : zero;
        }
        v[i].x = e[0];
        v[i].y = e[1];
      }
    }
  }
  __device__ __forceinline__ long out(int n, int, int r, int c,
                                      int co) const {
    if constexpr (!NHWC_OUT) return (((long)n * Cout + co) * Ho + r) * Wo + c;
    return (((long)n * Ho + r) * Wo + c) * Cout + co;
  }
};

template <typename T, bool VEC, bool PAD_H = true, bool NHWC_OUT = true>
ConvNhwcProblem<T, VEC, PAD_H, NHWC_OUT> nhwc_problem(const void* x,
                                                      const void* w, int cin,
                                                      int h, int wd,
                                                      int cout) {
  ConvNhwcProblem<T, VEC, PAD_H, NHWC_OUT> p;
  p.x = static_cast<const T*>(x);
  p.bw = static_cast<const T*>(w);
  p.Cin = cin;
  p.H = h;
  p.W = wd;
  p.Cout = cout;
  p.Ho = (h + 2 * p.pt - 4) / 2 + 1;
  p.Wo = (wd - 2) / 2 + 1;
  p.M = p.Ho * p.Wo;
  p.Mw = p.Wo;
  p.K = 16 * cin;
  p.G = 1;
  p.ldb = p.K;
  return p;
}

template <typename T, bool VEC>
int run_nhwc(const void* x, const void* w, void* y, void* acc, void* part,
             void* stats, int batch, int split_batch, int cin, int h, int wd,
             int cout, int act, float eps, int vec, int segs,
             cudaStream_t st) {
  const auto p = nhwc_problem<T, VEC>(x, w, cin, h, wd, cout);
  return launch_conv_in_act_nhwc<T>(
      p, batch, split_batch, static_cast<float*>(acc),
      static_cast<float2*>(part), static_cast<float2*>(stats),
      static_cast<T*>(y), (long)p.M, segs, vec, act, eps, st);
}

template <typename T>
ConvProblem<T> problem(const void* x, const void* w, int cin, int h, int wd,
                       int cout, bool band = false) {
  ConvProblem<T> p;
  p.x = static_cast<const T*>(x);
  p.bw = static_cast<const T*>(w);
  p.Cin = cin;
  p.H = h;
  p.W = wd;
  p.Cout = cout;
  p.pt = band ? 0 : 1;
  p.Ho = (h + 2 * p.pt - 4) / 2 + 1;
  p.Wo = (wd + 2 - 4) / 2 + 1;
  p.M = p.Ho * p.Wo;
  p.Mw = p.Wo;
  p.K = 16 * cin;
  p.G = 1;
  p.ldb = p.K;
  return p;
}

template <typename T>
int run(const void* x, const void* w, void* y, void* acc, void* part,
        int batch, int split_batch, int cin, int h, int wd, int cout,
        int act, float eps, cudaStream_t st) {
  const ConvProblem<T> p = problem<T>(x, w, cin, h, wd, cout);
  return launch_conv_in_act<T>(p, batch, split_batch,
                               static_cast<float*>(acc),
                               static_cast<float2*>(part), static_cast<T*>(y),
                               (long)p.M, act, eps, st);
}

template <typename T>
int run_band(const void* x, const void* w, void* acc, void* part,
             void* stats, int batch, int split_batch, int cin, int h, int wd,
             int cout, cudaStream_t st) {
  const ConvProblem<T> p = problem<T>(x, w, cin, h, wd, cout, true);
  return launch_conv_band<T>(p, batch, split_batch, static_cast<float*>(acc),
                             static_cast<float2*>(part),
                             static_cast<float2*>(stats), (long)p.M, st);
}

// The wgmma core's entries (the NCHW form, PAD_H; the band, not): bf16
// with Cin a multiple of 64 and the scratch on 16 bytes checked, the
// layout pass of x into xt [N, H, W, Cin] and of w into wt [Cout, 4, 4,
// Cin], and into p the problem on those copies, its acc NCHW.
template <bool PAD_H>
int wgmma_problem(const void* x, const void* w, void* xt, void* wt, int bf16,
                  int batch, int cin, int h, int wd, int cout,
                  ConvNhwcProblem<__nv_bfloat16, true, PAD_H, false>& p,
                  cudaStream_t st) {
  if (!bf16 || cin % wg::BKC || reinterpret_cast<uintptr_t>(xt) % 16 ||
      reinterpret_cast<uintptr_t>(wt) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = wg::launch_nchw_to_nhwc(x, xt, batch, cin, (long)h * wd,
                                          st);
  if (e == cudaSuccess) e = wg::launch_nchw_to_nhwc(w, wt, cout, cin, 16, st);
  p = nhwc_problem<__nv_bfloat16, true, PAD_H, false>(xt, wt, cin, h, wd,
                                                      cout);
  return static_cast<int>(e);
}

}  // namespace pgt

// K split the launch below takes for this shape when its split_batch is
// `batch`: acc holds that many fp32 copies of y's shape.
extern "C" int pgt_conv_splits(int batch, int cin, int h, int wd, int cout) {
  return pgt::splits_for(pgt::problem<float>(nullptr, nullptr, cin, h, wd,
                                             cout),
                         batch);
}

// x [N, Cin, H, W], w [Cout, Cin, 4, 4] (16-byte aligned), y [N, Cout,
// Ho, Wo], all bf16 (bf16 != 0) or all fp32. core: 1 the wgmma core
// (conv_wgmma.cuh: bf16, Cin and Cout multiples of 64; bn, stages, splits
// and samples from the host planner; xt, wt: bf16 scratch of x's and w's
// sizes on 16 bytes, which the layout pass fills with x as [N, H, W, Cin]
// and w as [Cout, 4, 4, Cin]; stats: fp32 pairs, N * Cout), 0 the WMMA
// core (conv_gemm.cuh; splits must be pgt_conv_splits(split_batch, ...);
// xt, wt, stats unused). split_batch: the batch whose K split the plan
// took (N for the fastest split); acc: fp32 scratch of `splits` times y's
// shape; part: fp32 pairs, N * Cout * ceil(Ho*Wo / pgt_tile_m()) for the
// WMMA core, N * Cout * tiles for the wgmma core (tiles 1 where it packs
// samples). Launches the layout passes (wgmma core), the GEMM, the stats
// and the finish. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// what the kernels cannot take.
extern "C" int pgt_conv_in_act(const void* x, const void* w, void* y,
                               void* acc, void* part, void* xt, void* wt,
                               void* stats, int batch, int split_batch,
                               int cin, int h, int wd, int cout, int act,
                               float eps, int bf16, int core, int bn,
                               int stages, int splits, int samples,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (core) {
    pgt::ConvNhwcProblem<__nv_bfloat16, true, true, false> p;
    const int rc = pgt::wgmma_problem<true>(x, w, xt, wt, bf16, batch, cin,
                                            h, wd, cout, p, st);
    if (rc != 0) return rc;
    return pgt::launch_conv_in_act_nchw_wgmma(
        p, batch, bn, stages, splits, samples, static_cast<float*>(acc),
        static_cast<float2*>(part), static_cast<float2*>(stats),
        static_cast<__nv_bfloat16*>(y), (long)p.M, act, eps, st);
  }
  if (split_batch < 1 ||
      splits != pgt_conv_splits(split_batch, cin, h, wd, cout))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return pgt::run<__nv_bfloat16>(x, w, y, acc, part, batch, split_batch,
                                   cin, h, wd, cout, act, eps, st);
  return pgt::run<float>(x, w, y, acc, part, batch, split_batch, cin, h, wd,
                         cout, act, eps, st);
}

// Band form: the K split pgt_conv_band's WMMA core takes for this band at
// split_batch `batch` (the host planner's, which the entry checks).
extern "C" int pgt_conv_band_splits(int batch, int cin, int h, int wd,
                                    int cout) {
  return pgt::splits_for(
      pgt::problem<float>(nullptr, nullptr, cin, h, wd, cout, true), batch);
}

// Band form. x [N, Cin, H, W]: a band with one halo row above and below
// (H counts them), H unpadded and W padded by one each side; w as
// pgt_conv_in_act's. core: 1 the wgmma core (bf16, Cin and Cout multiples
// of 64; bn, stages, splits and samples from the host planner; xt, wt:
// bf16 scratch of x's and w's sizes on 16 bytes, which the layout pass
// fills with x as [N, H, W, Cin] and w as [Cout, 4, 4, Cin]), 0 the WMMA
// core (splits must be pgt_conv_band_splits(split_batch, ...); xt, wt
// unused). acc: fp32 scratch of `splits` times [N, Cout, Ho, Wo] with Ho =
// (H - 4) / 2 + 1, slice 0 the band's conv output on return; part: fp32
// pairs, N * Cout * ceil(Ho*Wo / pgt_tile_m()) for the WMMA core, N * Cout
// * tiles for the wgmma core (tiles 1 where it packs samples); stats: fp32
// pairs, N * Cout. Returns cudaGetLastError(), or cudaErrorInvalidValue
// for what the kernels cannot take.
extern "C" int pgt_conv_band(const void* x, const void* w, void* xt, void* wt,
                             void* acc, void* part, void* stats, int batch,
                             int split_batch, int cin, int h, int wd,
                             int cout, int bf16, int core, int bn, int stages,
                             int splits, int samples, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (core) {
    pgt::ConvNhwcProblem<__nv_bfloat16, true, false, false> p;
    const int rc = pgt::wgmma_problem<false>(x, w, xt, wt, bf16, batch, cin,
                                             h, wd, cout, p, st);
    if (rc != 0) return rc;
    return pgt::launch_conv_band_wgmma(
        p, batch, bn, stages, splits, samples, static_cast<float*>(acc),
        static_cast<float2*>(part), static_cast<float2*>(stats), (long)p.M,
        st);
  }
  if (split_batch < 1 ||
      splits != pgt_conv_band_splits(split_batch, cin, h, wd, cout))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return pgt::run_band<__nv_bfloat16>(x, w, acc, part, stats, batch,
                                        split_batch, cin, h, wd, cout, st);
  return pgt::run_band<float>(x, w, acc, part, stats, batch, split_batch, cin,
                              h, wd, cout, st);
}

// The band forms' layout pass alone: x [batch, C, P] -> y [batch, P, C],
// bf16 (conv_wgmma.cuh's nchw_to_nhwc). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape it cannot take.
extern "C" int pgt_nchw_to_nhwc(const void* x, void* y, int batch, int c,
                                long p, void* stream) {
  return static_cast<int>(pgt::wg::launch_nchw_to_nhwc(
      x, y, batch, c, p, static_cast<cudaStream_t>(stream)));
}

// NHWC form. x [N, H, W, Cin] (an NHWC tensor), w the channels_last weight
// [Cout, 4, 4, Cin] (16-byte aligned), y [N, Ho, Wo, Cout], all bf16
// (bf16 != 0) or all fp32. core: 1 the wgmma core (conv_wgmma.cuh: bf16,
// Cin and Cout multiples of 64, x on 16 bytes; bn, stages, splits and
// samples from the host planner), 0 the WMMA core (conv_gemm.cuh; splits
// must be pgt_conv_splits(split_batch, ...); x_vec: Cin a multiple of
// pgt_tile_k() and x on 16 bytes, the vector gather). acc: fp32 scratch of
// `splits` times y's size (NHWC); part: fp32 pairs, N * Cout * max(tiles,
// segs) with tiles = ceil(Ho*Wo / pgt_tile_m()) for the WMMA core, 1 or
// that for the wgmma core (1 where it packs samples); stats: fp32 pairs,
// N * Cout; segs, vec: the finish's segments and 16-byte vectors
// (norm_nhwc.cuh). Returns cudaGetLastError(), or cudaErrorInvalidValue
// for what the kernels cannot take.
extern "C" int pgt_conv_in_act_nhwc(const void* x, const void* w, void* y,
                                    void* acc, void* part, void* stats,
                                    int batch, int split_batch, int cin,
                                    int h, int wd, int cout, int act,
                                    float eps, int bf16, int x_vec, int vec,
                                    int segs, int core, int bn, int stages,
                                    int splits, int samples, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using B = __nv_bfloat16;
  if (core) {
    if (!bf16 || cin % pgt::wg::BKC || reinterpret_cast<uintptr_t>(x) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    const auto p = pgt::nhwc_problem<B, true>(x, w, cin, h, wd, cout);
    return pgt::launch_conv_in_act_nhwc_wgmma(
        p, batch, bn, stages, splits, samples, static_cast<float*>(acc),
        static_cast<float2*>(part), static_cast<float2*>(stats),
        static_cast<B*>(y), (long)p.M, segs, vec, act, eps, st);
  }
  if ((x_vec && (cin % pgt::BK || reinterpret_cast<uintptr_t>(x) % 16)) ||
      split_batch < 1 || splits != pgt_conv_splits(split_batch, cin, h, wd,
                                                   cout))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) {
    if (x_vec)
      return pgt::run_nhwc<B, true>(x, w, y, acc, part, stats, batch,
                                    split_batch, cin, h, wd, cout, act, eps,
                                    vec, segs, st);
    return pgt::run_nhwc<B, false>(x, w, y, acc, part, stats, batch,
                                   split_batch, cin, h, wd, cout, act, eps,
                                   vec, segs, st);
  }
  if (x_vec)
    return pgt::run_nhwc<float, true>(x, w, y, acc, part, stats, batch,
                                      split_batch, cin, h, wd, cout, act, eps,
                                      vec, segs, st);
  return pgt::run_nhwc<float, false>(x, w, y, acc, part, stats, batch,
                                     split_batch, cin, h, wd, cout, act, eps,
                                     vec, segs, st);
}

// BK of the core: the vector gathers' channel multiple
extern "C" int pgt_tile_k(void) { return pgt::BK; }
