// K3: transposed conv(k=4, s=2, p=1, no bias) over concat(x, skip) +
// instance norm + activation, forward, NCHW, torch IOHW weight (unflipped).
//
// Replaces: patchgan_tpu/ops/pallas/convt_norm_act.py::_forward
// (pallas_call at :178, body _kernel :118-153), reached via
// fused_convt_norm_act.
//
// Bound on the H100: operations. dec2-dec5 do 537-1074 M MACs per 256-px
// tile against at most a few MB of activations and weights.
//
// Design: segregated by output parity. Output pixel (2t + di, 2u + dj)
// depends on a disjoint 2 x 2 slice of the 4 x 4 kernel, so the grid
// covers the four classes (di, dj) and each is an implicit GEMM
// (conv_gemm.cuh) with M = H*W, N = Cout, K = 4 * (Cx + Cs) ordered
// (ci, a, b). The input is read through two pointers, x for ci < Cx and
// skip above, so the decoder's concat is never materialised. Per spatial
// dim, with torch's unflipped weight w[ci, co, k]:
//   out[2t]     = x[t] * w[1] + x[t-1] * w[3]
//   out[2t + 1] = x[t+1] * w[0] + x[t] * w[2]
// i.e. tap a in {0, 1} of class d reads x[t + d - a] with w[1 - d + 2a]
// (the JAX package's pre-flipped wf[j] = w[3 - j], ops/conv.py:155-158).
// Results are stored interleaved straight into the [N, Cout, 2H, 2W] fp32
// scratch; statistics partials span all four classes, and the finishing
// pass shared with K1 and K2 normalises over the full 2H x 2W plane.
// dec1 and dec2 (4x4 and 8x8 inputs, K = 4096) split K across blocks.
// That is the WMMA core's NCHW form, which fp32 and other widths take: in
// bf16 with Cx, Cs and Cout multiples of 64 and x, skip and w on 16 bytes
// (the host planner's choice) pgt_convt_in_act runs on the wgmma core of
// conv_wgmma.cuh instead, in one C call: the layout pass copies x and
// skip into channels_last scratch, the pack writes the NHWC form's layout
// (taps outer) from the NCHW weight, the NHWC problem with H padded (Hc =
// H, row0 = 0) and an NCHW acc takes the product and its stats, and
// band.cuh's apply normalises into y (launch_conv_in_act_nchw_wgmma).
//
// Before the GEMM, a pack kernel writes the weight k-contiguous per class,
//   wp[g][co][ci * 4 + ay * 2 + ax] = w[ci, co, 1 - (g >> 1) + 2 ay,
//                                       1 - (g & 1) + 2 ax],
// zero-padded to Kp = K rounded up to BK, so the core stages B with
// 16-byte copies. With k = k0 + ak0 + 2j a gathering thread's ax = ak0 is
// fixed, ay = j & 1 alternates and ci steps every second j: its column
// mask, two row masks and two in-plane offsets are set up once a block,
// and each element costs one predicated 2-byte load.
//
// Band form (spatial parallelism): pgt_convt_band takes a rank's band of
// x and skip rows with one halo row above and below (parallel/spatial.py;
// the halo holds the zero rows at the image's edges); class row r of the
// band's output reads input row r + dy - ay + 1 (row0 = 1, where the whole
// plane's is 0 and its missing rows read as zero), so a tap on a halo row
// reads it. It writes the fp32 output of the band's own 2 * Hc rows in
// NCHW and their per-plane stats; norm_act.cu's pgt_in_apply finishes it
// from the stats summed over the spatial group. In bf16 with Cx, Cs and
// Cout multiples of 64 (the host planner's choice) it runs on the wgmma
// core of conv_wgmma.cuh: the layout pass copies the x and skip bands into
// channels_last scratch, the pack kernel writes the NHWC form's packed
// layout (taps outer) straight from the NCHW weight, and the NHWC
// problem with no row of H padded (Hc = H - 2, row0 = 1) and an NCHW acc
// takes the product (launch_conv_band_wgmma); otherwise the WMMA core of
// conv_gemm.cuh reads the NCHW bands as they are (launch_conv_band).
//
// NHWC form (channels_last): pgt_convt_in_act_nhwc takes x and skip as
// [N, H, W, C] and the channels_last weight, physically [Cx + Cs, 4, 4,
// Cout]. Its pack kernel transposes that through shared memory, 32 input
// by 32 output channels of one tap a block, into wp[g][co][k] with k =
// (2 ay + ax) * (Cx + Cs) + ci: taps outer, channels inner, x's then
// skip's. A second problem struct (ConvTNhwcProblem): in bf16 with Cx, Cs
// and Cout multiples of 64 and x and skip on 16 bytes (the host planner's
// nhwc_gemm_plan), the wgmma core of conv_wgmma.cuh, a K step 64 channels
// of one tap of x or of skip copied straight from it; otherwise the WMMA
// core, where with Cx and Cs multiples of BK a K step is 32 channels of
// one tap of x or of skip, read as 16-byte vectors, each gathering thread
// keeping its parity's half (conv_norm_act.cu's scheme); other widths go
// element by element. The skip concat stays fused (two pointers). The fp32
// accumulator is NHWC, the classes interleaved into it, and the finish is
// norm_nhwc.cuh's (launch_conv_in_act_nhwc, launch_conv_in_act_nhwc_wgmma).

#include "conv_wgmma.cuh"

namespace pgt {

template <typename T>
struct ConvTProblem {
  const T* x;   // [N, Cx, H, W]
  const T* s;   // [N, Cs, H, W], or unused when Cs == 0
  const T* bw;  // packed weight [4][Cout][ldb]
  int Cx, Cs, H, W, Cout;
  int Hc;    // output rows of one parity class (H for the whole plane)
  int row0;  // input row of class row 0's tap ay = 0 at dy = 0
  int M, Mw, K, G, ldb;

  struct Gather {
    const T* xs;     // this sample's first x plane
    const T* ss;     // this sample's first skip plane
    int off0, off1;  // in-plane offsets of taps ay = 0 and ay = 1
    bool ok0, ok1;   // those taps lie inside the image
  };
  __device__ __forceinline__ Gather gather(int n, int g, bool valid, int r,
                                           int c, int ax) const {
    const int iy = r + (g >> 1) + row0, ix = c + (g & 1) - ax;
    const bool col = valid && ix >= 0 && ix < W;
    Gather t;
    t.xs = x + (long)n * Cx * H * W;
    t.ss = s + (long)n * Cs * H * W;
    t.ok0 = col && iy < H;     // iy >= 0 always
    t.ok1 = col && iy >= 1;    // iy - 1 < H always
    t.off0 = t.ok0 ? iy * W + ix : 0;
    t.off1 = t.ok1 ? (iy - 1) * W + ix : 0;
    return t;
  }
  // pair i of the K step at k0: channel ci = k0 / 4 + i, taps ay = 0, 1
  __device__ __forceinline__ void load_a(const Gather& t, int k0, int kend,
                                         pair_t<T> (&v)[BK / 4]) const {
    const int hw = H * W, ci0 = k0 >> 2, ciend = kend >> 2;
    const T zero = from_f32<T>(0.f);
    const T* plane = ci0 < Cx ? t.xs + (long)ci0 * hw
                              : t.ss + (long)(ci0 - Cx) * hw;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const int ci = ci0 + i;
      if (ci == Cx) plane = t.ss;
      const bool live = ci < ciend;
      v[i].x = live && t.ok0 ? plane[t.off0] : zero;
      v[i].y = live && t.ok1 ? plane[t.off1] : zero;
      plane += hw;
    }
  }
  __device__ __forceinline__ long out(int n, int g, int r, int c,
                                      int co) const {
    return (((long)n * Cout + co) * (2 * Hc) + 2 * r + (g >> 1)) * (2 * W) +
           2 * c + (g & 1);
  }
};

// One thread per (co, ci slot of Kp / 4): reads the 16 taps of w[ci, co]
// (two or four 16-byte loads), writes 4 values into each class's row, at
// k = 4 ci + tap or, TAP_MAJOR (the NHWC form's layout, Kp = 4 C), at k =
// tap C + ci. Slots ci >= C write the zero padding.
template <typename T, bool TAP_MAJOR = false>
__global__ void pack_convt_weight(const T* __restrict__ w, T* __restrict__ wp,
                                  int C, int Cout, int Kp) {
  const int slots = Kp / 4;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)Cout * slots) return;
  const int ci = idx % slots, co = idx / slots;
  uint4 raw[sizeof(T)];  // 16 values of T
  const T* tap = reinterpret_cast<const T*>(raw);
  const uint4* src =
      reinterpret_cast<const uint4*>(w + ((long)ci * Cout + co) * 16);
#pragma unroll
  for (int i = 0; i < (int)sizeof(T); ++i)
    raw[i] = ci < C ? src[i] : make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    T* dst = wp + ((long)g * Cout + co) * Kp + (TAP_MAJOR ? ci : 4 * ci);
#pragma unroll
    for (int ay = 0; ay < 2; ++ay)
#pragma unroll
      for (int ax = 0; ax < 2; ++ax)
        dst[(2 * ay + ax) * (TAP_MAJOR ? C : 1)] =
            tap[(1 - (g >> 1) + 2 * ay) * 4 + 1 - (g & 1) + 2 * ax];
  }
}

inline int packed_k(int cx, int cs) {
  return (4 * (cx + cs) + BK - 1) / BK * BK;
}

template <typename T, bool TAP_MAJOR = false>
int pack(const void* w, void* wp, int cx, int cs, int cout, cudaStream_t st) {
  const int kp = packed_k(cx, cs);
  if (TAP_MAJOR && kp != 4 * (cx + cs))
    return static_cast<int>(cudaErrorInvalidValue);
  const long threads = (long)cout * (kp / 4);
  pack_convt_weight<T, TAP_MAJOR><<<(threads + 255) / 256, 256, 0, st>>>(
      static_cast<const T*>(w), static_cast<T*>(wp), cx + cs, cout, kp);
  return static_cast<int>(cudaGetLastError());
}

// NHWC pack: w [C, 4, 4, Cout] (channels_last IOHW) -> wp [4][Cout][Kp],
// wp[g][co][(2 ay + ax) C + ci] = w[ci, co, 1 - dy + 2 ay, 1 - dx + 2 ax]
// for g = 2 dy + dx, zero from 4C up to Kp. Block (x, y, z): input
// channels 32x .. 32x + 31, output channels 32y .. 32y + 31, tap z = ky * 4
// + kx (z = 16: the zero padding), read along co, written along ci.
template <typename T>
__global__ void pack_convt_weight_nhwc(const T* __restrict__ w,
                                       T* __restrict__ wp, int C, int Cout,
                                       int Kp) {
  const int ci0 = blockIdx.x * 32, co0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;  // 32 x 8
  if (blockIdx.z == 16) {
    if (blockIdx.x) return;
    for (int k = 4 * C + tx; k < Kp; k += 32)
      for (int q = ty; q < 4 * 32; q += 8) {
        const int g = q >> 5, co = co0 + (q & 31);
        if (co < Cout) wp[((long)g * Cout + co) * Kp + k] = from_f32<T>(0.f);
      }
    return;
  }
  const int ky = blockIdx.z >> 2, kx = blockIdx.z & 3;
  const int g = 2 * (1 - (ky & 1)) + 1 - (kx & 1);
  const int tap = 2 * (ky >> 1) + (kx >> 1);
  __shared__ T tile[32][33];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ci = ci0 + ty + 8 * j, co = co0 + tx;
    tile[ty + 8 * j][tx] =
        ci < C && co < Cout ? w[(((long)ci * 4 + ky) * 4 + kx) * Cout + co]
                            : from_f32<T>(0.f);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = co0 + ty + 8 * j, ci = ci0 + tx;
    if (co < Cout && ci < C)
      wp[((long)g * Cout + co) * Kp + (long)tap * C + ci] =
          tile[tx][ty + 8 * j];
  }
}

template <typename T>
int pack_nhwc(const void* w, void* wp, int cx, int cs, int cout,
              cudaStream_t st) {
  const int c = cx + cs, kp = packed_k(cx, cs);
  const dim3 grid((c + 31) / 32, (cout + 31) / 32, kp > 4 * c ? 17 : 16);
  pack_convt_weight_nhwc<T><<<grid, 256, 0, st>>>(
      static_cast<const T*>(w), static_cast<T*>(wp), c, cout, kp);
  return static_cast<int>(cudaGetLastError());
}

// The NHWC problem: x [N, H, W, Cx], skip [N, H, W, Cs], the packed
// weight [4][Cout][ldb] (k = (2 ay + ax) * C + ci). VEC: Cx and Cs
// multiples of BK, x and skip on 16 bytes. PAD_H: the whole plane (Hc =
// H, row0 = 0, the rows outside it read as zero), or haloed bands (Hc = H
// - 2, row0 = 1). NHWC_OUT: acc [N, 2 Hc, 2 W, Cout], or NCHW [N, Cout,
// 2 Hc, 2 W] (the NCHW form and the band entry on the wgmma core, reading
// the layout pass's channels_last copies).
template <typename T, bool VEC, bool PAD_H = true, bool NHWC_OUT = true>
struct ConvTNhwcProblem {
  static constexpr bool kChannelsLast = NHWC_OUT;
  const T* x;
  const T* s;
  const T* bw;
  // input row of class row 0's tap ay = 0 at dy = 0
  static constexpr int row0 = PAD_H ? 0 : 1;
  int Cx, Cs, C, H, W, Cout;
  int Hc;    // output rows of one parity class (H for the whole plane)
  int M, Mw, K, G, ldb;

  struct Gather {
    const T* xs;   // this sample's x
    const T* ss;   // this sample's skip
    int iy, ix;    // the input pixel of tap (ay, ax) = (0, 0)
    bool valid;
    int ak0;
  };
  __device__ __forceinline__ Gather gather(int n, int g, bool valid, int r,
                                           int c, int ax) const {
    Gather t;
    t.xs = x + (long)n * H * W * Cx;
    t.ss = s + (long)n * H * W * Cs;
    t.iy = r + (g >> 1) + row0;
    t.ix = c + (g & 1);
    t.valid = valid;
    t.ak0 = ax;
    return t;
  }
  // the channels of tap (ay, ax) from ci on, or null outside the image
  __device__ __forceinline__ const T* at(const Gather& t, int tap,
                                         int ci) const {
    const int yy = t.iy - (tap >> 1), xx = t.ix - (tap & 1);
    if (!t.valid || yy < 0 || yy >= H || xx < 0 || xx >= W) return nullptr;
    const long pix = (long)yy * W + xx;
    return ci < Cx ? t.xs + pix * Cx + ci : t.ss + pix * Cs + (ci - Cx);
  }
  // the wgmma core (conv_wgmma.cuh): the channels of a tap (x's, then
  // skip's), and a row's channels ci .. of tap `tap`, or null outside the
  // image
  __host__ __device__ __forceinline__ int tap_channels() const { return C; }
  __device__ __forceinline__ const T* a_src(const Gather& t, int tap,
                                            int ci) const {
    return at(t, tap, ci);
  }
  __device__ __forceinline__ void load_a(const Gather& t, int k0, int kend,
                                         pair_t<T> (&v)[BK / 4]) const {
    if constexpr (VEC) {
      // K and kend are multiples of BK: the step is whole, in one tap and
      // in x or in skip
      const int tap = k0 / C;
      const T* p = at(t, tap, k0 - tap * C);
      if (p)
        load_step_channels<T>(p, t.ak0, v);
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
          const int tap = k / C;
          const T* p = k < kend ? at(t, tap, k - tap * C) : nullptr;
          e[h] = p ? *p : zero;
        }
        v[i].x = e[0];
        v[i].y = e[1];
      }
    }
  }
  __device__ __forceinline__ long out(int n, int g, int r, int c,
                                      int co) const {
    if constexpr (!NHWC_OUT)
      return (((long)n * Cout + co) * (2 * Hc) + 2 * r + (g >> 1)) *
                 (2 * W) + 2 * c + (g & 1);
    return (((long)n * 2 * Hc + 2 * r + (g >> 1)) * (2 * W) + 2 * c +
            (g & 1)) * Cout + co;
  }
};

template <typename T, bool VEC, bool PAD_H = true, bool NHWC_OUT = true>
ConvTNhwcProblem<T, VEC, PAD_H, NHWC_OUT> nhwc_problem(
    const void* x, const void* s, const void* wp, int cx, int cs, int h,
    int wd, int cout) {
  ConvTNhwcProblem<T, VEC, PAD_H, NHWC_OUT> p;
  p.x = static_cast<const T*>(x);
  p.s = static_cast<const T*>(s);
  p.bw = static_cast<const T*>(wp);
  p.Cx = cx;
  p.Cs = cs;
  p.C = cx + cs;
  p.H = h;
  p.W = wd;
  p.Cout = cout;
  p.Hc = PAD_H ? h : h - 2;
  p.M = p.Hc * wd;
  p.Mw = wd;
  p.K = 4 * (cx + cs);
  p.G = 4;
  p.ldb = packed_k(cx, cs);
  return p;
}

template <typename T, bool VEC>
int run_nhwc(const void* x, const void* s, const void* w, void* wp, void* y,
             void* acc, void* part, void* stats, int batch, int split_batch,
             int cx, int cs, int h, int wd, int cout, int act, float eps,
             int vec, int segs, cudaStream_t st) {
  const int rc = pack_nhwc<T>(w, wp, cx, cs, cout, st);
  if (rc != 0) return rc;
  const auto p = nhwc_problem<T, VEC>(x, s, wp, cx, cs, h, wd, cout);
  return launch_conv_in_act_nhwc<T>(
      p, batch, split_batch, static_cast<float*>(acc),
      static_cast<float2*>(part), static_cast<float2*>(stats),
      static_cast<T*>(y), 4L * p.M, segs, vec, act, eps, st);
}

template <typename T>
ConvTProblem<T> problem(const void* x, const void* s, const void* wp, int cx,
                        int cs, int h, int wd, int cout,
                        bool band = false) {
  ConvTProblem<T> p;
  p.x = static_cast<const T*>(x);
  p.s = static_cast<const T*>(s);
  p.bw = static_cast<const T*>(wp);
  p.Cx = cx;
  p.Cs = cs;
  p.H = h;
  p.W = wd;
  p.Cout = cout;
  p.Hc = band ? h - 2 : h;
  p.row0 = band ? 1 : 0;
  p.M = p.Hc * wd;
  p.Mw = wd;
  p.K = 4 * (cx + cs);
  p.G = 4;
  p.ldb = packed_k(cx, cs);
  return p;
}

template <typename T>
int run(const void* x, const void* s, const void* w, void* wp, void* y,
        void* acc, void* part, int batch, int split_batch, int cx, int cs,
        int h, int wd, int cout, int act, float eps, cudaStream_t st) {
  const int rc = pack<T>(w, wp, cx, cs, cout, st);
  if (rc != 0) return rc;
  const ConvTProblem<T> p = problem<T>(x, s, wp, cx, cs, h, wd, cout);
  return launch_conv_in_act<T>(p, batch, split_batch,
                               static_cast<float*>(acc),
                               static_cast<float2*>(part), static_cast<T*>(y),
                               4L * p.M, act, eps, st);
}

// The wgmma core's entries (the NCHW form, PAD_H; the band, not): bf16
// with Cx and Cs multiples of 64 and the scratch on 16 bytes checked, the
// layout pass of x into xt and of skip into skt ([N, H, W, C]), the pack
// of the NCHW weight into wp in the NHWC form's order (taps outer), and
// into p the problem on those copies, its acc NCHW.
template <bool PAD_H>
int wgmma_problem(const void* x, const void* skip, const void* w, void* wp,
                  void* xt, void* skt, int bf16, int batch, int cx, int cs,
                  int h, int wd, int cout,
                  ConvTNhwcProblem<__nv_bfloat16, true, PAD_H, false>& p,
                  cudaStream_t st) {
  if (!bf16 || cx % wg::BKC || cs % wg::BKC ||
      reinterpret_cast<uintptr_t>(xt) % 16 ||
      (cs && reinterpret_cast<uintptr_t>(skt) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const long plane = (long)h * wd;
  cudaError_t e = wg::launch_nchw_to_nhwc(x, xt, batch, cx, plane, st);
  if (e == cudaSuccess && cs)
    e = wg::launch_nchw_to_nhwc(skip, skt, batch, cs, plane, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  p = nhwc_problem<__nv_bfloat16, true, PAD_H, false>(xt, skt, wp, cx, cs, h,
                                                      wd, cout);
  return pack<__nv_bfloat16, true>(w, wp, cx, cs, cout, st);
}

template <typename T>
int run_band(const void* x, const void* s, const void* w, void* wp,
             void* acc, void* part, void* stats, int batch, int split_batch,
             int cx, int cs, int h, int wd, int cout, cudaStream_t st) {
  const int rc = pack<T>(w, wp, cx, cs, cout, st);
  if (rc != 0) return rc;
  const ConvTProblem<T> p = problem<T>(x, s, wp, cx, cs, h, wd, cout, true);
  return launch_conv_band<T>(p, batch, split_batch, static_cast<float*>(acc),
                             static_cast<float2*>(part),
                             static_cast<float2*>(stats), 4L * p.M, st);
}

}  // namespace pgt

// K split the launch below takes for this shape when its split_batch is
// `batch`: acc holds that many fp32 copies of y's shape.
extern "C" int pgt_convt_splits(int batch, int cx, int cs, int h, int wd,
                                int cout) {
  return pgt::splits_for(pgt::problem<float>(nullptr, nullptr, nullptr, cx,
                                             cs, h, wd, cout),
                         batch);
}

// Row length of the packed weight: 4 * (cx + cs) rounded up to BK.
extern "C" int pgt_convt_packed_k(int cx, int cs) {
  return pgt::packed_k(cx, cs);
}

// The pack kernel alone: w [Cx + Cs, Cout, 4, 4] -> wp [4, Cout,
// pgt_convt_packed_k()], bf16 (bf16 != 0) or fp32, w 16-byte aligned.
// Returns cudaGetLastError().
extern "C" int pgt_convt_pack(const void* w, void* wp, int cx, int cs,
                              int cout, int bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return pgt::pack<__nv_bfloat16>(w, wp, cx, cs, cout, st);
  return pgt::pack<float>(w, wp, cx, cs, cout, st);
}

// x [N, Cx, H, W], skip [N, Cs, H, W] (Cs may be 0, skip then unused),
// w [Cx + Cs, Cout, 4, 4] (16-byte aligned), y [N, Cout, 2H, 2W], all bf16
// (bf16 != 0) or all fp32; wp: scratch of the packed weight, 4 * Cout *
// pgt_convt_packed_k() elements. core: 1 the wgmma core (conv_wgmma.cuh:
// bf16, Cx, Cs and Cout multiples of 64; bn, stages, splits and samples
// from the host planner; wp then in the NHWC form's order; xt, skt: bf16
// scratch of x's and skip's sizes on 16 bytes, which the layout pass fills
// with x and skip as [N, H, W, C]; stats: fp32 pairs, N * Cout), 0 the
// WMMA core (conv_gemm.cuh; splits must be pgt_convt_splits(split_batch,
// ...); xt, skt, stats unused). split_batch: the batch whose K split the
// plan took (N for the fastest split); acc: fp32 scratch of `splits`
// times y's shape; part: fp32 pairs, N * Cout * 4 * tiles, tiles =
// ceil(H*W / pgt_tile_m()) for the WMMA core, 1 or that for the wgmma core
// (1 where it packs samples). Launches the layout passes (wgmma core), the
// pack, the GEMM, the stats and the finish. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for what the kernels cannot take.
extern "C" int pgt_convt_in_act(const void* x, const void* skip,
                                const void* w, void* wp, void* y, void* acc,
                                void* part, void* xt, void* skt, void* stats,
                                int batch, int split_batch, int cx, int cs,
                                int h, int wd, int cout, int act, float eps,
                                int bf16, int core, int bn, int stages,
                                int splits, int samples, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using B = __nv_bfloat16;
  if (core) {
    pgt::ConvTNhwcProblem<B, true, true, false> p;
    const int rc = pgt::wgmma_problem<true>(x, skip, w, wp, xt, skt, bf16,
                                            batch, cx, cs, h, wd, cout, p,
                                            st);
    if (rc != 0) return rc;
    return pgt::launch_conv_in_act_nchw_wgmma(
        p, batch, bn, stages, splits, samples, static_cast<float*>(acc),
        static_cast<float2*>(part), static_cast<float2*>(stats),
        static_cast<B*>(y), 4L * p.M, act, eps, st);
  }
  if (split_batch < 1 ||
      splits != pgt_convt_splits(split_batch, cx, cs, h, wd, cout))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return pgt::run<B>(x, skip, w, wp, y, acc, part, batch, split_batch, cx,
                       cs, h, wd, cout, act, eps, st);
  return pgt::run<float>(x, skip, w, wp, y, acc, part, batch, split_batch,
                         cx, cs, h, wd, cout, act, eps, st);
}

// Band form: the K split pgt_convt_band's WMMA core takes for this band at
// split_batch `batch` (the host planner's, which the entry checks).
extern "C" int pgt_convt_band_splits(int batch, int cx, int cs, int h,
                                     int wd, int cout) {
  return pgt::splits_for(pgt::problem<float>(nullptr, nullptr, nullptr, cx,
                                             cs, h, wd, cout, true),
                         batch);
}

// Band form. x [N, Cx, H, W], skip [N, Cs, H, W]: a band with one halo
// row above and below (H counts them); w and wp as pgt_convt_in_act's.
// The band's output has 2 * Hc rows, Hc = H - 2. core: 1 the wgmma core
// (bf16, Cx, Cs and Cout multiples of 64; bn, stages, splits and samples
// from the host planner; wp then in the NHWC form's order; xt, skt: bf16
// scratch of x's and skip's sizes on 16 bytes, which the layout pass fills
// with x and skip as [N, H, W, C]), 0 the WMMA core (splits must be
// pgt_convt_band_splits(split_batch, ...); xt, skt unused). acc: fp32
// scratch of `splits` times [N, Cout, 2 Hc, 2 W], slice 0 the output on
// return; part: fp32 pairs, N * Cout * 4 * tiles, tiles = ceil(Hc*W /
// pgt_tile_m()) for the WMMA core, 1 or that for the wgmma core (1 where
// it packs samples); stats: fp32 pairs, N * Cout. Launches the layout
// passes (wgmma core), the pack, the GEMM and the stats. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for what the kernels cannot
// take.
extern "C" int pgt_convt_band(const void* x, const void* skip, const void* w,
                              void* wp, void* xt, void* skt, void* acc,
                              void* part, void* stats, int batch,
                              int split_batch, int cx, int cs, int h, int wd,
                              int cout, int bf16, int core, int bn,
                              int stages, int splits, int samples,
                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using B = __nv_bfloat16;
  if (core) {
    pgt::ConvTNhwcProblem<B, true, false, false> p;
    const int rc = pgt::wgmma_problem<false>(x, skip, w, wp, xt, skt, bf16,
                                             batch, cx, cs, h, wd, cout, p,
                                             st);
    if (rc != 0) return rc;
    return pgt::launch_conv_band_wgmma(
        p, batch, bn, stages, splits, samples, static_cast<float*>(acc),
        static_cast<float2*>(part), static_cast<float2*>(stats), 4L * p.M,
        st);
  }
  if (split_batch < 1 ||
      splits != pgt_convt_band_splits(split_batch, cx, cs, h, wd, cout))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return pgt::run_band<__nv_bfloat16>(x, skip, w, wp, acc, part, stats,
                                        batch, split_batch, cx, cs, h, wd,
                                        cout, st);
  return pgt::run_band<float>(x, skip, w, wp, acc, part, stats, batch,
                              split_batch, cx, cs, h, wd, cout, st);
}

// NHWC form: the pack kernel alone on a channels_last weight [Cx + Cs,
// Cout, 4, 4] -> wp [4, Cout, pgt_convt_packed_k()], bf16 (bf16 != 0) or
// fp32. Returns cudaGetLastError().
extern "C" int pgt_convt_pack_nhwc(const void* w, void* wp, int cx, int cs,
                                   int cout, int bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return pgt::pack_nhwc<__nv_bfloat16>(w, wp, cx, cs, cout, st);
  return pgt::pack_nhwc<float>(w, wp, cx, cs, cout, st);
}

// NHWC form. x [N, H, W, Cx], skip [N, H, W, Cs] (Cs may be 0, skip then
// unused), w the channels_last weight [Cx + Cs, Cout, 4, 4], y [N, 2H, 2W,
// Cout], all bf16 (bf16 != 0) or all fp32; wp as pgt_convt_in_act's (NHWC
// order). core: 1 the wgmma core (conv_wgmma.cuh: bf16, Cx, Cs and Cout
// multiples of 64, x and skip on 16 bytes; bn, stages, splits and samples
// from the host planner), 0 the WMMA core (conv_gemm.cuh; splits must be
// pgt_convt_splits(split_batch, ...); x_vec: Cx and Cs multiples of 32, x
// and skip on 16 bytes, the vector gather). acc: fp32 scratch of `splits`
// times y's size (NHWC); part: fp32 pairs, N * Cout * max(4 * tiles, segs)
// with tiles = ceil(H*W / pgt_tile_m()) for the WMMA core, 1 or that for
// the wgmma core (1 where it packs samples); stats: fp32 pairs, N * Cout;
// segs, vec: the finish's segments and 16-byte vectors (norm_nhwc.cuh).
// Launches the pack, the GEMM and the finish. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for what the kernels cannot take.
extern "C" int pgt_convt_in_act_nhwc(const void* x, const void* skip,
                                     const void* w, void* wp, void* y,
                                     void* acc, void* part, void* stats,
                                     int batch, int split_batch, int cx,
                                     int cs, int h, int wd, int cout, int act,
                                     float eps, int bf16, int x_vec, int vec,
                                     int segs, int core, int bn, int stages,
                                     int splits, int samples, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using B = __nv_bfloat16;
  const bool off16 = reinterpret_cast<uintptr_t>(x) % 16 ||
                     (cs && reinterpret_cast<uintptr_t>(skip) % 16);
  if (core) {
    if (!bf16 || cx % pgt::wg::BKC || cs % pgt::wg::BKC || off16)
      return static_cast<int>(cudaErrorInvalidValue);
    const int rc = pgt::pack_nhwc<B>(w, wp, cx, cs, cout, st);
    if (rc != 0) return rc;
    const auto p = pgt::nhwc_problem<B, true>(x, skip, wp, cx, cs, h, wd,
                                              cout);
    return pgt::launch_conv_in_act_nhwc_wgmma(
        p, batch, bn, stages, splits, samples, static_cast<float*>(acc),
        static_cast<float2*>(part), static_cast<float2*>(stats),
        static_cast<B*>(y), 4L * p.M, segs, vec, act, eps, st);
  }
  if ((x_vec && (cx % pgt::BK || cs % pgt::BK || off16)) || split_batch < 1 ||
      splits != pgt_convt_splits(split_batch, cx, cs, h, wd, cout))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) {
    if (x_vec)
      return pgt::run_nhwc<B, true>(x, skip, w, wp, y, acc, part, stats,
                                    batch, split_batch, cx, cs, h, wd, cout,
                                    act, eps, vec, segs, st);
    return pgt::run_nhwc<B, false>(x, skip, w, wp, y, acc, part, stats, batch,
                                   split_batch, cx, cs, h, wd, cout, act, eps,
                                   vec, segs, st);
  }
  if (x_vec)
    return pgt::run_nhwc<float, true>(x, skip, w, wp, y, acc, part, stats,
                                      batch, split_batch, cx, cs, h, wd, cout,
                                      act, eps, vec, segs, st);
  return pgt::run_nhwc<float, false>(x, skip, w, wp, y, acc, part, stats,
                                     batch, split_batch, cx, cs, h, wd, cout,
                                     act, eps, vec, segs, st);
}
