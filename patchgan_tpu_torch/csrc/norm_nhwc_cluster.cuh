// One-pass NHWC (channels_last) forms of K1 (norm_act.cu) and K1-bwd
// (norm_act_bwd.cu) on a thread-block cluster.
//
// Replaces, with the segmented kernels of norm_nhwc.cuh, the JAX package's
// patchgan_tpu/ops/pallas/norm_act.py::instance_norm_act_pallas:
// _fwd_kernel (per-(n, c) fp32 mean and rstd over H*W, var = E[x^2] -
// mean^2, then act(xhat)) and _bwd_kernel (dx = rstd * (gm - mean(gm) -
// xhat * mean(gm * xhat)), gm = g * act'(xhat), x the only residual).
//
// Bound on the H100: bytes (14 fp32 operations an element against 6
// bytes moved in bf16). The segmented kernels read x three times and g
// twice in the backward and write their partials to memory between five
// launches; at the 128 x 128 levels the planes do not stay in the 50 MB
// L2 between the passes. Here one launch reads each input once: a cluster
// of `cluster` CTAs (at most 8, the portable limit) owns one (sample,
// channel tile) and splits its pixels into as many segments, each CTA
// copying its segment of x (and g) into shared memory with cp.async (16
// bytes a thread; each thread later reads back only the chunks it copied,
// so the copies need no barrier, and the rows of a tile are too short for
// TMA's bulk copies to pay). The statistics then run from shared memory:
//   1. each CTA sums (x, x^2) over its segment, a thread over its rows,
//      xor shuffles over a warp's rows, the warps in order, and pushes
//      its per-channel partials into every CTA of the cluster
//      (distributed shared memory, st.async), each write counted on the
//      receiver's mbarrier; once a CTA's barrier has all of them it adds
//      them in rank order, so every CTA holds the same bits;
//   2. the backward the same for (gm, gm * xhat);
//   3. y (or dx) from shared memory, written once.
// The mbarriers' transaction counts stand in for cluster barriers, whose
// release fences wait on every load in flight; a CTA leaves only after
// its peers' partials have landed in it, so none exits under a write. No
// atomics, no partials in device memory, no scratch: two launches on the
// same inputs give the same bits. A tile is `lanes` chunks of 16 bytes
// (at least 32 bytes of a pixel's channels, so a warp's loads and stores
// cover whole sectors, or the whole pixel where it is smaller). The
// planner (nhwc_one_pass_plan in ops/kernels/norm_act.py) picks lanes and
// cluster where a tile's pixels fit a CTA's shared memory; larger planes
// take the segmented kernels.
#pragma once

#include <stdint.h>

#include "norm_nhwc.cuh"

namespace pgt {
namespace nhwc {
namespace one_pass {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 8;
constexpr long SMEM_MAX = 232448;   // an H100 block's shared memory

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The shared memory a CTA takes, in this order: two mbarriers; the warps'
// partials; the partials of each phase as every rank pushed them; the
// per-channel coefficients of each phase; the staged inputs.
struct Layout {
  uint64_t* bar;
  float2 *warp, *recv1, *recv2, *coef1, *coef2;
  unsigned char* stage;
};

__host__ __device__ __forceinline__ long red_bytes(int cw, int cluster) {
  return 16 + (long)(WARPS + 2 * cluster + 2) * cw * 8;
}

__device__ __forceinline__ Layout layout(unsigned char* smem, int cw,
                                         int cluster) {
  Layout l;
  l.bar = reinterpret_cast<uint64_t*>(smem);
  l.warp = reinterpret_cast<float2*>(smem + 16);
  l.recv1 = l.warp + WARPS * cw;
  l.recv2 = l.recv1 + cluster * cw;
  l.coef1 = l.recv2 + cluster * cw;
  l.coef2 = l.coef1 + cw;
  l.stage = smem + red_bytes(cw, cluster);
  return l;
}

// Thread 0 readies both mbarriers, each to complete once `bytes` have
// landed (every rank's partials of one phase); then the cluster barrier
// every push waits behind (arrived at here, waited on by cluster_wait
// before the first push), so no CTA writes into a peer's barrier before
// the peer set it.
__device__ __forceinline__ void barriers_init(uint64_t* bar, unsigned bytes) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(bar + k))
                   : "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              smem_u32(bar + k)),
          "r"(bytes)
          : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  __syncwarp();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void barrier_wait(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar))
      : "memory");
}

// v into CTA `rank`'s copy of `dst`, counted on its copy of `bar`
__device__ __forceinline__ void push(float2* dst, float2 v, uint64_t* bar,
                                     int rank) {
  unsigned d, b;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d)
               : "r"(smem_u32(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(b)
               : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(d),
      "f"(v.x), "f"(v.y), "r"(b)
      : "memory");
}

// Where a thread sits: its lane (chunk of W channels) and first row, the
// CTA's tile (cw channels from c0) and segment [p0, p0 + seg).
struct Tile {
  int lane, row, rows, lanes, cw, c0, seg;
  long p0, seg_len;
};

template <int W>
__device__ __forceinline__ Tile tile_of(long hw, int lanes) {
  Tile t;
  t.lanes = lanes;
  t.lane = threadIdx.x & (lanes - 1);
  t.row = threadIdx.x / lanes;
  t.rows = THREADS / lanes;
  t.cw = lanes * W;
  t.c0 = blockIdx.y * t.cw;
  t.seg_len = (hw + gridDim.x - 1) / gridDim.x;
  t.p0 = blockIdx.x * t.seg_len;
  const long left = hw - t.p0;
  t.seg = (int)(left < 0 ? 0 : left < t.seg_len ? left : t.seg_len);
  return t;
}

// the CTA's segment of one input into `stage`, chunk (pixel p, lane) at
// p * lanes + lane: thread t's chunks are t + k * THREADS
template <typename T, int W>
__device__ __forceinline__ void stage_in(const T* src, T* stage,
                                         const Tile& t, int C) {
  const T* s = src + t.p0 * C + t.c0 + t.lane * W;
  T* d = stage + t.lane * W;
#pragma unroll 4
  for (int p = t.row; p < t.seg; p += t.rows)
    cp_async16(d + (long)p * t.cw, s + (long)p * C, true);
}

// The CTA's per-channel sums of (a, b), in a fixed order (xor shuffles
// over the warp's rows of a lane, then the warps in order), pushed into
// slot blockIdx.x of `recv` in every CTA of the cluster; then, once this
// CTA's `bar` has every rank's, thread q < cw's channel summed in rank
// order (the same bits in every CTA).
template <int W>
__device__ __forceinline__ float2 cluster_sum(float (&a)[W], float (&b)[W],
                                              const Tile& t, float2* warp,
                                              float2* recv, uint64_t* bar) {
  for (int o = 16; o >= t.lanes; o >>= 1) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      a[j] += __shfl_xor_sync(0xffffffffu, a[j], o);
      b[j] += __shfl_xor_sync(0xffffffffu, b[j], o);
    }
  }
  const int w = threadIdx.x >> 5, wl = threadIdx.x & 31;
  if (wl < t.lanes) {
#pragma unroll
    for (int j = 0; j < W; ++j)
      warp[w * t.cw + wl * W + j] = make_float2(a[j], b[j]);
  }
  __syncthreads();
  const int q = threadIdx.x, ranks = (int)gridDim.x;
  if (q >= t.cw) return make_float2(0.f, 0.f);
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int k = 0; k < WARPS; ++k) {
    const float2 v = warp[k * t.cw + q];
    s += v.x;
    ss += v.y;
  }
  for (int r = 0; r < ranks; ++r)
    push(recv + blockIdx.x * t.cw + q, make_float2(s, ss), bar, r);
  barrier_wait(bar);
  s = ss = 0.f;
  for (int r = 0; r < ranks; ++r) {
    const float2 v = recv[r * t.cw + q];
    s += v.x;
    ss += v.y;
  }
  return make_float2(s, ss);
}

// (mean, rstd) of every channel of the tile, from x staged in `sx`, into
// each thread's mean / rstd for its own channels.
template <typename T, int W>
__device__ __forceinline__ void statistics(const T* sx, const Tile& t,
                                           long hw, float eps,
                                           const Layout& l, float (&mean)[W],
                                           float (&rstd)[W]) {
  float s[W], ss[W];
#pragma unroll
  for (int j = 0; j < W; ++j) s[j] = ss[j] = 0.f;
#pragma unroll 4
  for (int p = t.row; p < t.seg; p += t.rows) {
    float f[W];
    load_f<T, W>(sx + (long)p * t.cw + t.lane * W, f);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      s[j] += f[j];
      ss[j] += f[j] * f[j];
    }
  }
  cluster_wait();   // every peer's mbarriers are set: pushes may start
  const float2 tot = cluster_sum<W>(s, ss, t, l.warp, l.recv1, l.bar);
  if ((int)threadIdx.x < t.cw)
    l.coef1[threadIdx.x] = norm::mean_rstd(tot, hw, eps);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const float2 m = l.coef1[t.lane * W + j];
    mean[j] = m.x;
    rstd[j] = m.y;
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(THREADS)
    in_act_one_pass(const T* __restrict__ x, T* __restrict__ y, long hw,
                    int C, int lanes, float eps, int act) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile t = tile_of<W>(hw, lanes);
  const Layout l = layout(smem, t.cw, (int)gridDim.x);
  const long base = (long)blockIdx.z * hw * C;
  T* sx = reinterpret_cast<T*>(l.stage);
  stage_in<T, W>(x + base, sx, t, C);
  cp_async_commit();
  barriers_init(l.bar, gridDim.x * t.cw * 8);
  cp_async_wait_all();
  float mean[W], rstd[W];
  statistics<T, W>(sx, t, hw, eps, l, mean, rstd);
  T* yn = y + base + t.p0 * C + t.c0 + t.lane * W;
#pragma unroll 4
  for (int p = t.row; p < t.seg; p += t.rows) {
    float f[W];
    load_f<T, W>(sx + (long)p * t.cw + t.lane * W, f);
#pragma unroll
    for (int j = 0; j < W; ++j)
      f[j] = activate((f[j] - mean[j]) * rstd[j], act);
    store_f<T, W>(yn + (long)p * C, f);
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(THREADS)
    in_act_bwd_one_pass(const T* __restrict__ g, const T* __restrict__ x,
                        T* __restrict__ dx, long hw, int C, int lanes,
                        float eps, int act) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile t = tile_of<W>(hw, lanes);
  const Layout l = layout(smem, t.cw, (int)gridDim.x);
  const long base = (long)blockIdx.z * hw * C;
  T* sx = reinterpret_cast<T*>(l.stage);
  T* sg = sx + t.seg_len * t.cw;
  stage_in<T, W>(x + base, sx, t, C);
  cp_async_commit();
  stage_in<T, W>(g + base, sg, t, C);
  cp_async_commit();
  barriers_init(l.bar, gridDim.x * t.cw * 8);
  // x first: its statistics run while g's copies land
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  float mean[W], rstd[W];
  statistics<T, W>(sx, t, hw, eps, l, mean, rstd);
  cp_async_wait_all();
  float s1[W], s2[W];
#pragma unroll
  for (int j = 0; j < W; ++j) s1[j] = s2[j] = 0.f;
#pragma unroll 4
  for (int p = t.row; p < t.seg; p += t.rows) {
    float xf[W], gf[W];
    load_f<T, W>(sx + (long)p * t.cw + t.lane * W, xf);
    load_f<T, W>(sg + (long)p * t.cw + t.lane * W, gf);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float xh = (xf[j] - mean[j]) * rstd[j];
      const float gm = gf[j] * activate_grad(xh, act);
      s1[j] += gm;
      s2[j] += gm * xh;
    }
  }
  const float2 u = cluster_sum<W>(s1, s2, t, l.warp, l.recv2, l.bar + 1);
  if ((int)threadIdx.x < t.cw) {
    const float inv = 1.f / (float)hw;
    l.coef2[threadIdx.x] = make_float2(u.x * inv, u.y * inv);
  }
  __syncthreads();
  float m1[W], m2[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const float2 m = l.coef2[t.lane * W + j];
    m1[j] = m.x;
    m2[j] = m.y;
  }
  T* dn = dx + base + t.p0 * C + t.c0 + t.lane * W;
#pragma unroll 4
  for (int p = t.row; p < t.seg; p += t.rows) {
    float xf[W], gf[W];
    load_f<T, W>(sx + (long)p * t.cw + t.lane * W, xf);
    load_f<T, W>(sg + (long)p * t.cw + t.lane * W, gf);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float xh = (xf[j] - mean[j]) * rstd[j];
      const float gm = gf[j] * activate_grad(xh, act);
      gf[j] = rstd[j] * (gm - m1[j] - xh * m2[j]);
    }
    store_f<T, W>(dn + (long)p * C, gf);
  }
}

// Host side. The checks of both entry points: sizes, C a multiple of the
// tile (lanes chunks of 16 bytes, at most THREADS channels), the cluster,
// every pointer on 16 bytes, and the shared memory a CTA takes with
// `inputs` tensors staged, which it returns (0 where the kernel cannot
// take the call).
template <typename T>
inline long check(long n, long hw, int C, int lanes, int cluster, int inputs,
                  std::initializer_list<const void*> ptrs) {
  constexpr int W = vec_w<T>();
  const bool pow2 = lanes > 0 && (lanes & (lanes - 1)) == 0;
  if (n <= 0 || n > 65535 || hw <= 0 || C <= 0 || !pow2 || lanes > 32 ||
      lanes * W > THREADS || C % (lanes * W) || C / (lanes * W) > 65535 ||
      cluster < 1 || cluster > MAX_CLUSTER)
    return 0;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return 0;
  const long seg_len = (hw + cluster - 1) / cluster;
  const long bytes =
      red_bytes(lanes * W, cluster) + seg_len * lanes * 16 * inputs;
  return bytes <= SMEM_MAX ? bytes : 0;
}

// Launches KERNEL over (cluster, tiles, n) CTAs in clusters of `cluster`
// along x, with `smem` bytes of dynamic shared memory; a launch refused
// (cluster or shared memory too large) returns its error.
template <auto KERNEL, typename... Args>
inline cudaError_t launch(long n, int tiles, int cluster, long smem,
                          cudaStream_t st, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, tiles, (unsigned)n);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, KERNEL, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
inline cudaError_t launch_in_act(const T* x, T* y, long n, long hw, int C,
                                 int lanes, int cluster, long smem,
                                 float eps, int act, cudaStream_t st) {
  constexpr int W = vec_w<T>();
  return launch<in_act_one_pass<T, W>>(n, C / (lanes * W), cluster, smem,
                                       st, x, y, hw, C, lanes, eps, act);
}

template <typename T>
inline cudaError_t launch_in_act_bwd(const T* g, const T* x, T* dx, long n,
                                     long hw, int C, int lanes, int cluster,
                                     long smem, float eps, int act,
                                     cudaStream_t st) {
  constexpr int W = vec_w<T>();
  return launch<in_act_bwd_one_pass<T, W>>(n, C / (lanes * W), cluster,
                                           smem, st, g, x, dx, hw, C, lanes,
                                           eps, act);
}

}  // namespace one_pass
}  // namespace nhwc
}  // namespace pgt
