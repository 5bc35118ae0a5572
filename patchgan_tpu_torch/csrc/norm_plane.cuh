// Plane staging shared by K1 (norm_act.cu) and K1-bwd (norm_act_bwd.cu):
// a group of threads owns one contiguous (n, c) plane of an NCHW tensor,
// loads it once into registers in 16-byte chunks, reduces over the group
// in a fixed order, and writes its output from those registers.
//
// Launch geometry (chosen on the host by plane_geometry in
// ops/kernels/norm_act.py and passed through the C entry points):
//   vec         1: chunks of 16 bytes (8 bf16 or 4 fp32); the plane's
//               byte size is a multiple of 16 and every base pointer sits
//               on 16 bytes. 0: chunks of one element (any plane).
//   group       threads on one plane, a power of two up to MAX_THREADS.
//               Up to 32, several planes share a warp (or one plane a
//               warp) and reduce with xor shuffles inside their group;
//               above 32 the block is the group, one plane a block.
//   per_thread  chunks of each input a thread holds in registers (one of
//               1, 4, 8). Chunk i of a plane goes to lane i % group,
//               so neighbouring lanes read neighbouring 16 bytes. A plane
//               of more than group * per_thread chunks keeps the rest in
//               memory and reads it again in each pass (mostly from L2).
//   threads     block size: the group itself above 32, else a multiple
//               of 32 holding threads / group planes.
#pragma once

#include <stdint.h>

#include <initializer_list>

#include "in_common.cuh"

namespace pgt {
namespace norm {

constexpr int MAX_THREADS = 512;

// One chunk of a plane: 16 bytes on the vector path, one element on the
// element path. load / unpack to fp32 / store from fp32.
template <typename T, bool VEC>
struct Chunk;

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

template <>
struct Chunk<__nv_bfloat16, true> {
  static constexpr int W = 8;
  uint4 raw;
  __device__ __forceinline__ Chunk() : raw(make_uint4(0u, 0u, 0u, 0u)) {}
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void unpack(float (&f)[W]) const {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&f)[W]) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                   pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
  }
};

template <>
struct Chunk<float, true> {
  static constexpr int W = 4;
  float4 raw;
  __device__ __forceinline__ Chunk()
      : raw(make_float4(0.f, 0.f, 0.f, 0.f)) {}
  __device__ __forceinline__ void load(const float* p) {
    raw = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ void unpack(float (&f)[W]) const {
    f[0] = raw.x;
    f[1] = raw.y;
    f[2] = raw.z;
    f[3] = raw.w;
  }
  static __device__ __forceinline__ void store(float* p,
                                               const float (&f)[W]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <typename T>
struct Chunk<T, false> {
  static constexpr int W = 1;
  T raw;
  __device__ __forceinline__ Chunk() : raw(from_f32<T>(0.f)) {}
  __device__ __forceinline__ void load(const T* p) { raw = __ldg(p); }
  __device__ __forceinline__ void unpack(float (&f)[W]) const {
    f[0] = to_f32(raw);
  }
  static __device__ __forceinline__ void store(T* p, const float (&f)[W]) {
    p[0] = from_f32<T>(f[0]);
  }
};

// Where this thread sits: its plane's offset, its lane in the group, the
// plane's chunk count, and whether the plane exists (the last block may
// hold fewer planes than it has room for; its idle groups still take part
// in the shuffles, on zeros, and store nothing).
struct Place {
  long off;
  int lane, chunks;
  bool live;
};

template <int W>
__device__ __forceinline__ Place place(long planes, long plane, int group) {
  const long p =
      (long)blockIdx.x * (blockDim.x / group) + threadIdx.x / group;
  Place s;
  s.live = p < planes;
  s.off = s.live ? p * plane : 0;
  s.lane = threadIdx.x & (group - 1);
  s.chunks = s.live ? (int)(plane / W) : 0;
  return s;
}

// Sum of (a, b) over the group, returned to each of its threads, in a
// fixed order (two launches on the same inputs give the same bits).
// group <= 32: an xor butterfly inside the group. group > 32 (the block):
// warp sums into `part`, then every thread adds them in warp order.
__device__ __forceinline__ float2 group_sum2(float a, float b, int group,
                                             float2* part) {
  if (group <= 32) {
    for (int o = group >> 1; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    return make_float2(a, b);
  }
  const float2 v = warp_sum2(a, b);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f, ss = 0.f;
  const int nw = blockDim.x >> 5;
  for (int i = 0; i < nw; ++i) {
    s += part[i].x;
    ss += part[i].y;
  }
  return make_float2(s, ss);
}

// The JAX package's statistics from the plane's fp32 (sum, sum of
// squares): mean = s / n, var = ss / n - mean^2, rstd = rsqrt(var + eps).
__device__ __forceinline__ float2 mean_rstd(float2 t, long n, float eps) {
  const float mean = t.x / (float)n;
  const float var = t.y / (float)n - mean * mean;
  return make_float2(mean, rsqrtf(var + eps));
}

// Host side: the geometry's checks and grid. Returns 0 where the kernel
// cannot take the geometry (the launcher then reports
// cudaErrorInvalidValue).
inline long grid_of(long planes, long plane, int esize, int vec, int group,
                    int per_thread, int threads,
                    std::initializer_list<const void*> ptrs) {
  const bool pow2 = group > 0 && (group & (group - 1)) == 0;
  if (!pow2 || group > MAX_THREADS || threads < 32 ||
      threads > MAX_THREADS || threads % 32 ||
      (group > 32 ? threads != group : threads % group) || planes <= 0 ||
      plane <= 0 ||
      !(per_thread == 1 || per_thread == 4 || per_thread == 8))
    return 0;
  if (vec) {
    if ((plane * esize) % 16) return 0;
    for (const void* p : ptrs)
      if (reinterpret_cast<uintptr_t>(p) % 16) return 0;
  }
  const long per_block = threads / group;
  return (planes + per_block - 1) / per_block;
}

}  // namespace norm
}  // namespace pgt
