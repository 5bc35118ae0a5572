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

#include "conv_gemm.cuh"

namespace pgt {

template <typename T>
struct ConvTProblem {
  const T* x;  // [N, Cx, H, W]
  const T* s;  // [N, Cs, H, W], or unused when Cs == 0
  const T* w;  // [Cx + Cs, Cout, 4, 4]
  int Cx, Cs, H, W, Cout;
  int M, Mw, K, G;

  __device__ __forceinline__ T a(int n, int g, int r, int c, int k) const {
    const int ci = k >> 2, ay = (k >> 1) & 1, ax = k & 1;
    const int iy = r + (g >> 1) - ay, ix = c + (g & 1) - ax;
    if (iy < 0 || iy >= H || ix < 0 || ix >= W) return from_f32<T>(0.f);
    if (ci < Cx) return x[(((long)n * Cx + ci) * H + iy) * W + ix];
    return s[(((long)n * Cs + (ci - Cx)) * H + iy) * W + ix];
  }
  __device__ __forceinline__ T b(int g, int k, int co) const {
    const int ci = k >> 2, ay = (k >> 1) & 1, ax = k & 1;
    const int ky = 1 - (g >> 1) + 2 * ay, kx = 1 - (g & 1) + 2 * ax;
    return w[(((long)ci * Cout + co) * 4 + ky) * 4 + kx];
  }
  __device__ __forceinline__ long out(int n, int g, int r, int c,
                                      int co) const {
    return (((long)n * Cout + co) * (2 * H) + 2 * r + (g >> 1)) * (2 * W) +
           2 * c + (g & 1);
  }
};

template <typename T>
ConvTProblem<T> problem(const void* x, const void* s, const void* w, int cx,
                        int cs, int h, int wd, int cout) {
  ConvTProblem<T> p;
  p.x = static_cast<const T*>(x);
  p.s = static_cast<const T*>(s);
  p.w = static_cast<const T*>(w);
  p.Cx = cx;
  p.Cs = cs;
  p.H = h;
  p.W = wd;
  p.Cout = cout;
  p.M = h * wd;
  p.Mw = wd;
  p.K = 4 * (cx + cs);
  p.G = 4;
  return p;
}

template <typename T>
int run(const void* x, const void* s, const void* w, void* y, void* acc,
        void* part, int batch, int cx, int cs, int h, int wd, int cout,
        int act, float eps, cudaStream_t st) {
  const ConvTProblem<T> p = problem<T>(x, s, w, cx, cs, h, wd, cout);
  return launch_conv_in_act<T>(p, batch, static_cast<float*>(acc),
                               static_cast<float2*>(part), static_cast<T*>(y),
                               4L * p.M, act, eps, st);
}

}  // namespace pgt

// K split the launch below takes for this shape: acc holds that many
// fp32 copies of y's shape.
extern "C" int pgt_convt_splits(int batch, int cx, int cs, int h, int wd,
                                int cout) {
  return pgt::splits_for(pgt::problem<float>(nullptr, nullptr, nullptr, cx,
                                             cs, h, wd, cout),
                         batch);
}

// x [N, Cx, H, W], skip [N, Cs, H, W] (Cs may be 0, skip then unused),
// w [Cx + Cs, Cout, 4, 4], y [N, Cout, 2H, 2W], all bf16 (bf16 != 0) or
// all fp32; acc: fp32 scratch of pgt_convt_splits() times y's shape;
// part: fp32 pairs, N * Cout * 4 * ceil(H*W / pgt_tile_m()).
// Returns cudaGetLastError().
extern "C" int pgt_convt_in_act(const void* x, const void* skip,
                                const void* w, void* y, void* acc, void* part,
                                int batch, int cx, int cs, int h, int wd,
                                int cout, int act, float eps, int bf16,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return pgt::run<__nv_bfloat16>(x, skip, w, y, acc, part, batch, cx, cs, h,
                                   wd, cout, act, eps, st);
  return pgt::run<float>(x, skip, w, y, acc, part, batch, cx, cs, h, wd, cout,
                         act, eps, st);
}
