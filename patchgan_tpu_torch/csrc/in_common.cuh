// Shared device code of the kernels: dtype conversion, 16-byte cp.async
// copies, the activation table, a fixed-order block reduction, and the
// finishing pass (statistics -> normalise -> activate -> store) that the
// plain IN+act kernel (norm_act.cu) runs after its own statistics pass and
// the two fused conv kernels run from per-tile partial statistics.
//
// Statistics follow the JAX package's formula exactly: fp32 sums,
// mean = s / n, var = ss / n - mean^2, rstd = rsqrt(var + eps). Every
// reduction here runs in a fixed order (no atomics), so a run is
// bit-reproducible.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pgt {

// 16-byte global -> shared copy that bypasses L1; it writes zeros
// without reading when `valid` is false
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

enum Act { ACT_NONE = 0, ACT_TANH = 1, ACT_RELU = 2, ACT_LEAKY = 3 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case ACT_TANH:
      return tanhf(v);
    case ACT_RELU:
      return v > 0.f ? v : 0.f;
    case ACT_LEAKY:
      return v >= 0.f ? v : 0.2f * v;
    default:
      return v;
  }
}

// d act / d v, written out as the JAX package's _act_grad
// (patchgan_tpu/ops/pallas/norm_act.py:61-71): relu' is 0 at 0, leakyrelu'
// is 1 at 0.
__device__ __forceinline__ float activate_grad(float v, int act) {
  switch (act) {
    case ACT_TANH: {
      const float t = tanhf(v);
      return 1.f - t * t;
    }
    case ACT_RELU:
      return v > 0.f ? 1.f : 0.f;
    case ACT_LEAKY:
      return v >= 0.f ? 1.f : 0.2f;
    default:
      return 1.f;
  }
}

__device__ __forceinline__ float2 warp_sum2(float a, float b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  return make_float2(a, b);
}

// Sum of (a, b) over the block, returned to every thread. blockDim.x is a
// multiple of 32.
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 warp_part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float2 v = warp_sum2(a, b);
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    float2 p = lane < nw ? warp_part[lane] : make_float2(0.f, 0.f);
    p = warp_sum2(p.x, p.y);
    if (lane == 0) warp_part[0] = p;
  }
  __syncthreads();
  return warp_part[0];
}

// y = act((x - mean) * rstd) over one plane of n elements, from the
// plane's fp32 (sum, sum of squares). One block per plane.
template <typename Tin, typename Tout>
__device__ __forceinline__ void normalize_plane(const Tin* x, Tout* y, long n,
                                                float s, float ss, float eps,
                                                int act) {
  const float mean = s / (float)n;
  const float var = ss / (float)n - mean * mean;
  const float rstd = rsqrtf(var + eps);
  for (long i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = (to_f32(x[i]) - mean) * rstd;
    y[i] = from_f32<Tout>(activate(v, act));
  }
}

// Finishing pass of the fused conv kernels: block p owns plane p of the
// fp32 conv output `acc`; part[p * parts + i] holds that plane's partial
// (sum, sum of squares) from `parts` tiles, reduced here in index order.
template <typename Tout>
__global__ void finish_from_partials(const float* __restrict__ acc,
                                     const float2* __restrict__ part,
                                     Tout* __restrict__ y, long plane,
                                     int parts, float eps, int act) {
  const long p = blockIdx.x;
  __shared__ float2 total;
  if (threadIdx.x == 0) {
    float s = 0.f, ss = 0.f;
    for (int i = 0; i < parts; ++i) {
      const float2 v = part[p * parts + i];
      s += v.x;
      ss += v.y;
    }
    total = make_float2(s, ss);
  }
  __syncthreads();
  normalize_plane(acc + p * plane, y + p * plane, plane, total.x, total.y,
                  eps, act);
}

constexpr int FINISH_THREADS = 256;

}  // namespace pgt
