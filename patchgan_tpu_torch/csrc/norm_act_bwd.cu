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
// Design: one block owns one plane, in three passes, as K1 does:
//   1. (sum, sum of squares) of x, reduced with pgt::block_sum2;
//   2. (sum gm, sum gm * xhat), reduced the same way;
//   3. dx.
// Both reductions run in a fixed order with no atomics, so a run is
// bit-reproducible. Passes 2 and 3 read the plane again, mostly from L1/L2
// (a 128 x 128 bf16 plane of x and g is 64 KB). The block has as many
// threads as a quarter of the plane, between one warp and 256, so the deep
// levels' 2 x 2 to 16 x 16 planes do not leave 7 of 8 warps idle.

#include "in_common.cuh"

namespace pgt {

constexpr int BWD_MAX_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(BWD_MAX_THREADS)
    in_act_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
                      T* __restrict__ dx, long plane, float eps, int act) {
  const long off = (long)blockIdx.x * plane;
  const T* gp = g + off;
  const T* xp = x + off;
  T* dp = dx + off;
  const float inv_n = 1.f / (float)plane;

  float s = 0.f, ss = 0.f;
  for (long i = threadIdx.x; i < plane; i += blockDim.x) {
    const float v = to_f32(xp[i]);
    s += v;
    ss += v * v;
  }
  const float2 t = block_sum2(s, ss);
  const float mean = t.x * inv_n;
  const float var = t.y * inv_n - mean * mean;
  const float rstd = rsqrtf(var + eps);

  float s1 = 0.f, s2 = 0.f;
  for (long i = threadIdx.x; i < plane; i += blockDim.x) {
    const float xh = (to_f32(xp[i]) - mean) * rstd;
    const float gm = to_f32(gp[i]) * activate_grad(xh, act);
    s1 += gm;
    s2 += gm * xh;
  }
  __syncthreads();  // every thread has read block_sum2's slot before reuse
  const float2 u = block_sum2(s1, s2);
  const float m1 = u.x * inv_n, m2 = u.y * inv_n;

  for (long i = threadIdx.x; i < plane; i += blockDim.x) {
    const float xh = (to_f32(xp[i]) - mean) * rstd;
    const float gm = to_f32(gp[i]) * activate_grad(xh, act);
    dp[i] = from_f32<T>(rstd * (gm - m1 - xh * m2));
  }
}

}  // namespace pgt

// g, x, dx: [planes, plane] contiguous, all bf16 (bf16 != 0) or all fp32.
// Returns cudaGetLastError() after the launch.
extern "C" int pgt_in_act_bwd(const void* g, const void* x, void* dx,
                              long planes, long plane, int act, float eps,
                              int bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  long threads = ((plane / 4 + 31) / 32) * 32;
  threads = threads < 32 ? 32
            : threads > pgt::BWD_MAX_THREADS ? pgt::BWD_MAX_THREADS
                                             : threads;
  if (bf16) {
    pgt::in_act_bwd_kernel<__nv_bfloat16><<<planes, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g),
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(dx), plane, eps, act);
  } else {
    pgt::in_act_bwd_kernel<float><<<planes, threads, 0, st>>>(
        static_cast<const float*>(g), static_cast<const float*>(x),
        static_cast<float*>(dx), plane, eps, act);
  }
  return static_cast<int>(cudaGetLastError());
}
