// K1: affine-free instance norm + activation, forward, NCHW.
//
// Replaces: patchgan_tpu/ops/pallas/norm_act.py::_forward (pallas_call at
// :211, body _fwd_kernel :152-163), reached via instance_norm_act_pallas.
//
// Computes, per (n, c) plane over H*W: fp32 mean, var = E[x^2] - mean^2,
// rstd = rsqrt(var + eps), y = act((x - mean) * rstd), act in
// {none, tanh, relu, leakyrelu(0.2)}.
//
// Bound on the H100: bytes. It reads each element once for the statistics
// and once more to normalise (the second read mostly hits L2), and writes
// once; a handful of fp32 operations per element is far below the
// tensor-free fp32 rate, so the floor is (read + write) / 3.35 TB/s.
//
// Design: NCHW keeps each plane contiguous, so one block owns one plane
// end to end. Pass 1 accumulates fp32 (sum, sum of squares) per thread
// and reduces with warp shuffles in a fixed order (no atomics, so runs are
// bit-reproducible); pass 2 is pgt::normalize_plane, the finishing pass
// shared with the fused conv kernels (in_common.cuh). CUDA C++ rather
// than Triton so that one header carries the finishing pass for all three
// kernels.

#include "in_common.cuh"

namespace pgt {

constexpr int IN_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(IN_THREADS)
    in_act_kernel(const T* __restrict__ x, T* __restrict__ y, long plane,
                  float eps, int act) {
  const T* xp = x + blockIdx.x * plane;
  T* yp = y + blockIdx.x * plane;
  float s = 0.f, ss = 0.f;
  for (long i = threadIdx.x; i < plane; i += blockDim.x) {
    const float v = to_f32(xp[i]);
    s += v;
    ss += v * v;
  }
  const float2 t = block_sum2(s, ss);
  normalize_plane(xp, yp, plane, t.x, t.y, eps, act);
}

}  // namespace pgt

// x, y: [planes, plane] contiguous, both bf16 (bf16 != 0) or both fp32.
// Returns cudaGetLastError() after the launch.
extern "C" int pgt_in_act(const void* x, void* y, long planes, long plane,
                          int act, float eps, int bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    pgt::in_act_kernel<__nv_bfloat16><<<planes, pgt::IN_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        plane, eps, act);
  } else {
    pgt::in_act_kernel<float><<<planes, pgt::IN_THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(y), plane, eps,
        act);
  }
  return static_cast<int>(cudaGetLastError());
}
