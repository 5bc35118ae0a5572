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
// blocks to fill the card, and normalise from the summed slices.

#include "conv_gemm.cuh"

namespace pgt {

template <typename T>
struct ConvProblem {
  const T* x;  // [N, Cin, H, W]
  const T* w;  // [Cout, Cin, 4, 4]
  int Cin, H, W, Cout, Ho, Wo;
  int M, Mw, K, G;

  __device__ __forceinline__ T a(int n, int, int r, int c, int k) const {
    const int ci = k >> 4, ky = (k >> 2) & 3, kx = k & 3;
    const int iy = 2 * r - 1 + ky, ix = 2 * c - 1 + kx;
    if (iy < 0 || iy >= H || ix < 0 || ix >= W) return from_f32<T>(0.f);
    return x[(((long)n * Cin + ci) * H + iy) * W + ix];
  }
  __device__ __forceinline__ T b(int, int k, int co) const {
    return w[(long)co * K + k];
  }
  __device__ __forceinline__ long out(int n, int, int r, int c,
                                      int co) const {
    return (((long)n * Cout + co) * Ho + r) * Wo + c;
  }
};

template <typename T>
ConvProblem<T> problem(const void* x, const void* w, int cin, int h, int wd,
                       int cout) {
  ConvProblem<T> p;
  p.x = static_cast<const T*>(x);
  p.w = static_cast<const T*>(w);
  p.Cin = cin;
  p.H = h;
  p.W = wd;
  p.Cout = cout;
  p.Ho = (h + 2 - 4) / 2 + 1;
  p.Wo = (wd + 2 - 4) / 2 + 1;
  p.M = p.Ho * p.Wo;
  p.Mw = p.Wo;
  p.K = 16 * cin;
  p.G = 1;
  return p;
}

template <typename T>
int run(const void* x, const void* w, void* y, void* acc, void* part,
        int batch, int cin, int h, int wd, int cout, int act, float eps,
        cudaStream_t st) {
  const ConvProblem<T> p = problem<T>(x, w, cin, h, wd, cout);
  return launch_conv_in_act<T>(p, batch, static_cast<float*>(acc),
                               static_cast<float2*>(part), static_cast<T*>(y),
                               (long)p.M, act, eps, st);
}

}  // namespace pgt

// K split the launch below takes for this shape: acc holds that many
// fp32 copies of y's shape.
extern "C" int pgt_conv_splits(int batch, int cin, int h, int wd, int cout) {
  return pgt::splits_for(pgt::problem<float>(nullptr, nullptr, cin, h, wd,
                                             cout),
                         batch);
}

// x [N, Cin, H, W], w [Cout, Cin, 4, 4], y [N, Cout, Ho, Wo], all bf16
// (bf16 != 0) or all fp32; acc: fp32 scratch of pgt_conv_splits() times
// y's shape; part: fp32 pairs, N * Cout * ceil(Ho*Wo / pgt_tile_m()).
// Returns cudaGetLastError().
extern "C" int pgt_conv_in_act(const void* x, const void* w, void* y,
                               void* acc, void* part, int batch, int cin,
                               int h, int wd, int cout, int act, float eps,
                               int bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return pgt::run<__nv_bfloat16>(x, w, y, acc, part, batch, cin, h, wd,
                                   cout, act, eps, st);
  return pgt::run<float>(x, w, y, acc, part, batch, cin, h, wd, cout, act,
                         eps, st);
}
