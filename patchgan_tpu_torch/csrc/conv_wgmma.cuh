// Hopper GEMM core of every form of K2 (conv_norm_act.cu) and K3
// (convt_norm_act.cu) in bf16, NHWC (channels_last), NCHW and band: wgmma
// fed by an async-copy ring.
//
// Replaces, for those forms, the WMMA core of conv_gemm.cuh, which stays
// for fp32, for channel runs that are no multiple of 64 and for pointers
// off 16 bytes. The TPU kernels these forms port are
// patchgan_tpu/ops/pallas/conv_norm_act.py::_forward (pallas_call at :176)
// and convt_norm_act.py::_forward (pallas_call at :178).
//
// Bound on the H100: operations at the bulk levels (enc1-enc3, dec3-dec5:
// 0.5-1 GMAC a level at batch 16 against a few MB), bytes at the deep ones
// (enc4-enc6, dec1, dec2: the 4-8 MB weight read for 64 to 4 pixels a
// sample).
//
// The product of a (sample, class) is out[m, co] = sum_k A[m, k] B[k, co]
// with k = tap * C + ci. A K step is 64 channels of one tap: for each
// output pixel one contiguous 128-byte run of the channels_last input,
// which is one row of a K-major wgmma operand under the 128-byte swizzle.
// So A needs no register staging: thread (r0, j) of the 128 copies 16-byte
// chunk j of rows r0 + 16 i with cp.async.cg straight to its swizzled
// address (chunk j ^ (row & 7) of the row's 128 bytes), a tap outside the
// image zero-filled (src-size 0). B is K-major already (K2's channels_last
// weight [Cout][16 Cin]; K3's pack wp[g][co][tap C + ci]) and goes in the
// same way. The problem gives each row's source (P::gather once a block,
// P::a_src a K step); K3 reads x's or skip's channels by the chunk, so the
// decoder's concat is never materialised.
//
// A block is one warpgroup (128 threads) over a tile of BM = 64 output rows
// by BN (64 or 128) output channels. A ring of S (3 or 4) stages, each A
// (64 x 128 bytes) then B (BN x 128 bytes), lies in dynamic shared memory
// on 1024 bytes (the swizzle's period). K step i: wait for its copies
// (cp.async.wait_group S - 2), fence them to the async proxy, one barrier;
// four wgmma.mma_async m64nBNk16 from shared-memory descriptors, fp32
// accumulators in registers; then the copies of step i + S - 1 into the
// stage of step i - 1, which every thread's wgmma.wait_group 0 of the last
// step has released; wgmma.wait_group 0. The copies of S - 1 steps fly
// while the tensor cores run one.
//
// Rows of several samples: where a (sample, class) product has M < 64
// pixels (enc5, dec1: 16; enc6: 4), a tile packs BM / M samples, each row
// carrying its own sample, so the B tile is read once for all of them;
// otherwise a tile holds one sample's rows and a sample takes ceil(M / 64)
// tiles. The slot of sample n is n mod (BM / M) whatever the batch, and a
// row's sums do not depend on its neighbours', so a sample's bits do not
// change with the batch.
//
// Epilogue: the accumulators go through the ring's memory (row stride
// BN + 8 floats) to the NHWC fp32 `acc`, 16 bytes a thread along the
// channels, the classes interleaved as P::out places them; then, without a
// K split, one partial (sum, sum of squares) per (sample, channel, class,
// tile) over the sample's rows in row order into part[((n Cout + co) G +
// g) tiles + tile], which norm_nhwc.cuh's reduce_parts adds. With a K split
// (the deep levels' few tiles), block s sums its share of the K steps into
// slice s of acc and split_stats adds the slices in order. No atomics: two
// launches give the same bits. The host planner (nhwc_gemm_plan in
// ops/kernels/conv_norm_act.py) picks BN, S, the split and the packing.
//
// NCHW output (the NCHW forms pgt_conv_in_act / pgt_convt_in_act, and the
// band entries pgt_conv_band / pgt_convt_band of spatial parallelism,
// whose NCHW bands carry one halo row above and below): the core reads
// channels_last copies and writes NCHW. A layout pass (nchw_to_nhwc below,
// one launch a tensor) first copies x (and skip), and K2's weight, into
// channels_last scratch: bytes-bound, 4096 elements a block through shared
// memory (64 pixels x 64 channels, or 16 x 256 for the weight's 16 taps),
// 16-byte loads along the pixels and 16-byte stores along the channels.
// Two flags of the problem say the rest: whether it pads H (the NCHW
// forms, as the NHWC form, one zero row above the image, taps outside it
// zero-filled by the copy; a band pads none, its halo holds those rows),
// and whether its acc is channels_last (kChannelsLast). An NCHW acc's
// epilogue keeps the tile channel-major in the ring's memory (column
// stride BM + 4 floats: a warp's fragment stores fall in 32 banks), so a
// warp stores 32 consecutive rows of one channel: 128 contiguous bytes of
// K2's plane, every other float of a K3 class's output row (the grid walks
// a row tile's classes fastest, so the other x-parity class fills the
// rest of those sectors while they are still in L2). The stats are the
// partials' reduce, or after a K split band.cuh's split_stats, which adds
// the slices into slice 0 in order; a band takes no apply (its stats are
// summed over the spatial group first), an NCHW form band.cuh's apply
// with the plane's own count.
#pragma once

#include <stdint.h>

#include "conv_gemm.cuh"
#include "wgmma.cuh"

namespace pgt {
namespace wg {

constexpr int BM = 64;         // rows a tile: one warpgroup's wgmma M
constexpr int BKC = 64;        // channels a K step
constexpr int ROW = 128;       // bytes of a ring row: 64 bf16

__host__ __device__ constexpr int stage_bytes(int bn) { return (BM + bn) * ROW; }
// the ring, the epilogue's fp32 tile in the same memory, and 1024 bytes
// to put the ring on the swizzle's period
__host__ __device__ constexpr int smem_bytes(int bn, int stages) {
  return (stages * stage_bytes(bn) > BM * (bn + 8) * 4
              ? stages * stage_bytes(bn)
              : BM * (bn + 8) * 4) +
         1024;
}

// samples a tile packs for M pixels a (sample, class)
__host__ __device__ inline int samples_for(int M) {
  return M < BM ? BM / M : 1;
}

// How the rows of a launch fall into tiles.
struct Tiling {
  int batch;     // samples of the launch
  int samples;   // samples a tile (samples_for(M))
  int tiles;     // tiles a sample: ceil(M / BM), or 1 where samples > 1
  int splits;    // K split
  long slice;    // floats between two slices of acc
};

// Sample n and pixel m of row r of row tile bx; false for a padding row
__device__ __forceinline__ bool row_of(const Tiling& t, int M, int bx, int r,
                                       int& n, int& m) {
  if (t.samples > 1) {
    const int slot = r / M;
    n = bx * t.samples + slot;
    m = r - slot * M;
    return slot < t.samples && n < t.batch;
  }
  n = bx / t.tiles;
  m = (bx - n * t.tiles) * BM + r;
  return m < M;
}

}  // namespace wg

// The product of problem P (a ConvNhwcProblem or ConvTNhwcProblem in
// bf16, its channel runs multiples of 64 and its pointers on 16 bytes).
template <typename P, int BN, int S>
__global__ void __launch_bounds__(wg::THREADS, 1)
    conv_wgmma_kernel(const P p, const wg::Tiling t, float* __restrict__ acc,
                      float2* __restrict__ part) {
  using T = __nv_bfloat16;
  using wg::cp16;
  using wg::row_of;
  using wg::Wgmma;
  // local names hide conv_gemm.cuh's tile constants
  constexpr int BM = wg::BM, BKC = wg::BKC, ROW = wg::ROW;
  constexpr int A_BYTES = BM * ROW, STAGE = wg::stage_bytes(BN);
  constexpr int LDC = BN + 8;   // the epilogue tile's row stride, floats
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = wg::smem_u32(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;

  // an NHWC acc: grid (row tiles, Cout / BN, G * splits); an NCHW one:
  // grid (row tiles * G * splits, Cout / BN), the classes and splits
  // of a row tile fastest, so the two x-parity classes that share the
  // sectors of an output row store into them close in time
  constexpr bool kNhwc = ChannelsLastOut<P>::value;
  const int gs = p.G * t.splits;
  const int tid = threadIdx.x, nt = blockIdx.y;
  const int bx = kNhwc ? blockIdx.x : blockIdx.x / gs;
  const int gz = kNhwc ? blockIdx.z : blockIdx.x - bx * gs;
  const int split = gz % t.splits, g = gz / t.splits;
  const int cpt = p.tap_channels() / BKC;   // K steps a tap
  const int nk = p.K / BKC;
  const int per = (nk + t.splits - 1) / t.splits;
  const int kb = min(nk, split * per), ke = min(nk, kb + per);

  // this thread copies 16-byte chunk j of rows r0 + 16 i of A and B
  const int j = tid & 7, r0 = tid >> 3;
  const unsigned own = r0 * ROW + ((j ^ (r0 & 7)) << 4);
  typename P::Gather ga[BM / 16];
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    int n, m;
    const bool v = row_of(t, p.M, bx, r0 + 16 * i, n, m);
    ga[i] = p.gather(v ? n : 0, g, v, v ? m / p.Mw : 0, v ? m % p.Mw : 0, 0);
  }
  const T* const brow =
      p.bw + ((long)g * p.Cout + nt * BN + r0) * p.ldb + 8 * j;

  auto load = [&](int ks, int s) {
    const unsigned a = base + s * STAGE + own;
    const int tap = ks / cpt, ci = (ks - tap * cpt) * BKC + 8 * j;
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) {
      const T* src = p.a_src(ga[i], tap, ci);
      cp16(a + i * 16 * ROW, src ? src : p.bw, src != nullptr);
    }
    const T* bs = brow + (long)ks * BKC;
#pragma unroll
    for (int i = 0; i < BN / 16; ++i)
      cp16(a + A_BYTES + i * 16 * ROW, bs + (long)16 * i * p.ldb, true);
  };

  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (kb + s < ke) load(kb + s, s);
    cp_async_commit();
  }
  int s = 0;
  for (int ks = kb; ks < ke; ++ks) {
    wg::cp_wait<S - 2>();   // this thread's copies of step ks have landed
    wg::fence_async_smem();
    __syncthreads();    // everyone's have; step ks - 1's stage is free
    const unsigned a = base + s * STAGE;
    const uint64_t da = wg::desc_sw128(a);
    const uint64_t db = wg::desc_sw128(a + A_BYTES);
    wg::fence_operands(d);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKC / 16; ++kk)
      Wgmma<BN>::mma(d, da + 2 * kk, db + 2 * kk);
    wg::wgmma_commit();
    if (ks + S - 1 < ke) load(ks + S - 1, s == 0 ? S - 1 : s - 1);
    cp_async_commit();
    wg::wgmma_wait0();
    wg::fence_operands(d);
    s = s + 1 == S ? 0 : s + 1;
  }
  wg::cp_wait<0>();
  __syncthreads();   // the ring is free for the epilogue tile

  // accumulators -> the epilogue tile: row-major cs[row * LDC + channel]
  // for an NHWC acc, channel-major cs[channel * LDR + row] for an NCHW
  // one (wgmma's D fragment: warp w rows 16 w .. 16 w + 15, lane l
  // rows l / 4 and l / 4 + 8, columns 8 q + 2 (l % 4) and the next)
  constexpr int LDR = BM + 4;
  static_assert(wg::smem_bytes(BN, S) >= BN * LDR * 4 + 1024,
                "the channel-major tile does not fit the ring");
  float* const cs = reinterpret_cast<float*>(smem_raw + (base - raw));
  auto tile = [&](int r, int c) -> float {
    return kNhwc ? cs[r * LDC + c] : cs[c * LDR + r];
  };
  {
    const int rr = (tid >> 5) * 16 + ((tid & 31) >> 2), cc = 2 * (tid & 3);
#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
      if constexpr (kNhwc) {
        *reinterpret_cast<float2*>(cs + rr * LDC + 8 * q + cc) =
            make_float2(d[4 * q], d[4 * q + 1]);
        *reinterpret_cast<float2*>(cs + (rr + 8) * LDC + 8 * q + cc) =
            make_float2(d[4 * q + 2], d[4 * q + 3]);
      } else {
        float* const col = cs + (8 * q + cc) * LDR + rr;
        col[0] = d[4 * q];
        col[LDR] = d[4 * q + 1];
        col[8] = d[4 * q + 2];
        col[LDR + 8] = d[4 * q + 3];
      }
    }
  }
  __syncthreads();
  // the fp32 output (this split's slice)
  float* const out = acc + split * t.slice;
  if constexpr (kNhwc) {
    // 16 bytes a thread along the channels
    constexpr int V = BN / 4;
    for (int idx = tid; idx < BM * V; idx += wg::THREADS) {
      const int r = idx / V, c4 = idx - r * V;
      int n, m;
      if (row_of(t, p.M, bx, r, n, m))
        *reinterpret_cast<float4*>(
            out + p.out(n, g, m / p.Mw, m % p.Mw, nt * BN + 4 * c4)) =
            *reinterpret_cast<const float4*>(cs + r * LDC + 4 * c4);
    }
  } else {
    // NCHW: thread (r, h) stores row r of channels h, h + 2, ..., so a
    // warp stores 32 consecutive rows of one channel
    const int r = tid & (BM - 1);
    int n, m;
    if (row_of(t, p.M, bx, r, n, m)) {
      const int y = m / p.Mw, x = m - y * p.Mw;
      const long o = p.out(n, g, y, x, nt * BN);
      const long plane = p.out(n, g, y, x, nt * BN + 1) - o;
      for (int cl = tid / BM; cl < BN; cl += wg::THREADS / BM)
        out[o + cl * plane] = cs[cl * LDR + r];
    }
  }
  if (t.splits > 1) return;   // split_stats takes the statistics
  // per (sample, channel) partials over the sample's rows, in row order
  const bool packed = t.samples > 1;
  for (int cl = tid; cl < BN; cl += wg::THREADS) {
    const int co = nt * BN + cl;
    for (int slot = 0; slot < t.samples; ++slot) {
      int n, m;
      if (!row_of(t, p.M, bx, packed ? slot * p.M : 0, n, m)) break;
      const int first = packed ? slot * p.M : 0;
      const int rows = packed ? p.M : min(BM, p.M - m);
      float sum = 0.f, sq = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float v = tile(first + r, cl);
        sum += v;
        sq += v * v;
      }
      part[((long)(n * p.Cout + co) * p.G + g) * t.tiles + m / BM] =
          make_float2(sum, sq);
    }
  }
}

namespace wg {

template <typename P, int BN, int S>
cudaError_t launch_gemm(const P& p, const Tiling& t, float* acc,
                        float2* part, cudaStream_t st) {
  constexpr int smem = smem_bytes(BN, S);
  static_assert(smem <= SMEM_MAX, "the ring does not fit a block");
  cudaError_t e = cudaFuncSetAttribute(
      conv_wgmma_kernel<P, BN, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int rows = t.samples > 1 ? (t.batch + t.samples - 1) / t.samples
                                 : t.batch * t.tiles;
  const dim3 grid = ChannelsLastOut<P>::value
                        ? dim3(rows, p.Cout / BN, p.G * t.splits)
                        : dim3(rows * p.G * t.splits, p.Cout / BN, 1);
  conv_wgmma_kernel<P, BN, S><<<grid, THREADS, smem, st>>>(p, t, acc, part);
  return cudaGetLastError();
}

// The product of P into `acc` (`splits` slices of batch * Cout * plane
// floats) and, without a K split, its partials into `part`; t returns the
// tiling. bn: 64 or 128 dividing Cout; stages: 3 or 4; samples:
// samples_for(M), as the host planner computed it. cudaErrorInvalidValue
// for what the core cannot take.
template <typename P>
cudaError_t run_gemm(const P& p, int batch, int bn, int stages, int splits,
                     int samples, long plane, float* acc, float2* part,
                     Tiling& t, cudaStream_t st) {
  if (batch < 1 || p.M < 1 || (bn != 64 && bn != 128) || p.Cout % bn ||
      (stages != 3 && stages != 4) || splits < 1 || splits > 65535 / p.G ||
      p.K % BKC || p.tap_channels() % BKC || p.ldb % 8 ||
      samples != samples_for(p.M) ||
      reinterpret_cast<uintptr_t>(p.bw) % 16)
    return cudaErrorInvalidValue;
  t.batch = batch;
  t.samples = samples;
  t.tiles = samples > 1 ? 1 : (p.M + BM - 1) / BM;
  t.splits = splits;
  t.slice = (long)batch * p.Cout * plane;
  if (bn == 128)
    return stages == 4 ? launch_gemm<P, 128, 4>(p, t, acc, part, st)
                       : launch_gemm<P, 128, 3>(p, t, acc, part, st);
  return stages == 4 ? launch_gemm<P, 64, 4>(p, t, acc, part, st)
                     : launch_gemm<P, 64, 3>(p, t, acc, part, st);
}

// The layout pass of the NCHW forms and the band entries: x [B][C][P] (B
// stacks of C planes of P pixels: an NCHW x, skip or band, or K2's weight
// [Cout][Cin][16]) -> y [B][P][C]
// (channels_last), bf16. Block (pixel tile, channel tile, b) moves TP
// pixels x TC channels (4096 elements; TP = 64, or 16 for planes of at
// most 16 pixels: K2's weight, whose 16 taps would leave three quarters
// of a 64-pixel tile idle) through shared memory: 16-byte loads along the
// pixels where P and x lie on 8 elements (a warp reads 128-byte runs of
// four channels, or 32-byte runs of 16), 16-byte stores along the
// channels where C and y do (a warp writes four pixels' 128-byte runs, or
// one pixel's 512 bytes), element by element otherwise. The tile is
// pixel-major with its 16-byte chunks swizzled by the pixel's group of
// eight (chunk c / 8 ^ p / 8 of row p), so the load's 2-byte stores of
// one pixel group fall in different chunks (at TP = 16 two groups share
// a chunk's banks) and the store's 16-byte reads of a row in eight.
constexpr int LT_ELEMS = 4096;
constexpr int LT_THREADS = 256;

template <int TP>
__global__ void __launch_bounds__(LT_THREADS)
    nchw_to_nhwc(const unsigned short* __restrict__ x,
                 unsigned short* __restrict__ y, int C, long P, bool vec_in,
                 bool vec_out) {
  constexpr int TC = LT_ELEMS / TP;
  __shared__ __align__(16) unsigned short tile[LT_ELEMS];
  const long p0 = (long)blockIdx.x * TP;
  const int c0 = blockIdx.y * TC, tid = threadIdx.x;
  const unsigned short* const xs = x + (long)blockIdx.z * C * P;
  unsigned short* const ys = y + (long)blockIdx.z * P * C;
  auto at = [](int p, int c) {
    const int chunk = c >> 3;
    return p * TC + ((chunk & ~7) | ((chunk ^ (p >> 3)) & 7)) * 8 + (c & 7);
  };
  if (vec_in) {
    for (int i = tid; i < LT_ELEMS / 8; i += LT_THREADS) {
      const int c = i / (TP / 8), pc = i % (TP / 8);
      const long pix = p0 + 8 * pc;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (c0 + c < C && pix < P)
        v = *reinterpret_cast<const uint4*>(xs + (long)(c0 + c) * P + pix);
      const unsigned e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 8; ++k)
        tile[at(8 * pc + k, c)] =
            static_cast<unsigned short>(e[k >> 1] >> (16 * (k & 1)));
    }
  } else {
    for (int i = tid; i < LT_ELEMS; i += LT_THREADS) {
      const int c = i / TP, pl = i - c * TP;
      const long pix = p0 + pl;
      tile[at(pl, c)] =
          c0 + c < C && pix < P ? xs[(long)(c0 + c) * P + pix] : 0;
    }
  }
  __syncthreads();
  if (vec_out) {
    for (int i = tid; i < LT_ELEMS / 8; i += LT_THREADS) {
      const int pl = i / (TC / 8), c = 8 * (i % (TC / 8));
      const long pix = p0 + pl;
      if (pix < P && c0 + c < C)
        *reinterpret_cast<uint4*>(ys + pix * C + c0 + c) =
            *reinterpret_cast<const uint4*>(tile + at(pl, c));
    }
  } else {
    for (int i = tid; i < LT_ELEMS; i += LT_THREADS) {
      const int pl = i / TC, c = i - pl * TC;
      const long pix = p0 + pl;
      if (pix < P && c0 + c < C) ys[pix * C + c0 + c] = tile[at(pl, c)];
    }
  }
}

inline cudaError_t launch_nchw_to_nhwc(const void* x, void* y, int batch,
                                       int C, long P, cudaStream_t st) {
  const int tp = P <= 16 ? 16 : 64, tc = LT_ELEMS / tp;
  if (batch < 1 || batch > 65535 || C < 1 || P < 1 ||
      (C + tc - 1) / tc > 65535)
    return cudaErrorInvalidValue;
  const bool vec_in = P % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_out = C % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const dim3 grid((P + tp - 1) / tp, (C + tc - 1) / tc, batch);
  const auto* xs = static_cast<const unsigned short*>(x);
  auto* ys = static_cast<unsigned short*>(y);
  if (tp == 16)
    nchw_to_nhwc<16><<<grid, LT_THREADS, 0, st>>>(xs, ys, C, P, vec_in,
                                                   vec_out);
  else
    nchw_to_nhwc<64><<<grid, LT_THREADS, 0, st>>>(xs, ys, C, P, vec_in,
                                                   vec_out);
  return cudaGetLastError();
}

}  // namespace wg

// NHWC form on the wgmma core: the product into the NHWC `acc`, then the
// per-plane statistics (reduce_parts over the tiles' partials, or
// split_stats after a K split, then reduce_parts over its `segs` segments)
// and norm_nhwc.cuh's apply into y. `acc` holds `splits` slices of N * Cout
// * plane floats, `part` N * Cout * max(G * tiles, segs) pairs, `stats` N *
// Cout. Returns cudaGetLastError(), or cudaErrorInvalidValue for what the
// core cannot take.
template <typename P>
int launch_conv_in_act_nhwc_wgmma(const P& p, int batch, int bn, int stages,
                                  int splits, int samples, float* acc,
                                  float2* part, float2* stats,
                                  __nv_bfloat16* y, long plane, int segs,
                                  int vec, int act, float eps,
                                  cudaStream_t st) {
  if (!nhwc::shape_ok(batch, plane, p.Cout, segs, vec, {acc, y}))
    return static_cast<int>(cudaErrorInvalidValue);
  wg::Tiling t;
  const cudaError_t e = wg::run_gemm(p, batch, bn, stages, splits, samples,
                                     plane, acc, part, t, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long planes = (long)batch * p.Cout;
  if (splits == 1) {
    nhwc::launch_reduce(part, stats, planes, p.G * t.tiles, st);
  } else {
    nhwc::launch_split_stats(acc, splits, t.slice, part, batch, plane,
                             p.Cout, segs, vec, st);
    nhwc::launch_reduce(part, stats, planes, segs, st);
  }
  nhwc::launch_apply<float, __nv_bfloat16>(acc, stats, y, batch, plane,
                                           p.Cout, segs, vec, eps, act, st);
  return static_cast<int>(cudaGetLastError());
}

// A problem with an NCHW acc (a band's, or an NCHW form's) on the wgmma
// core: the product into `acc`, then the per-plane (sum, sum of squares)
// of its fp32 output into `stats`: reduce_parts over the tiles' partials,
// or band::split_stats after a K split (the slices added into slice 0 in
// order, the stats over the sum). No apply: a band's caller sums the stats
// over the spatial group first. `acc` holds `splits` slices of N * Cout *
// plane floats, `part` N * Cout * G * tiles pairs. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for what the core cannot
// take.
template <typename P>
int launch_conv_band_wgmma(const P& p, int batch, int bn, int stages,
                           int splits, int samples, float* acc, float2* part,
                           float2* stats, long plane, cudaStream_t st) {
  static_assert(!ChannelsLastOut<P>::value, "the problem writes NHWC");
  wg::Tiling t;
  const cudaError_t e = wg::run_gemm(p, batch, bn, stages, splits, samples,
                                     plane, acc, part, t, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long planes = (long)batch * p.Cout;
  if (splits == 1)
    nhwc::launch_reduce(part, stats, planes, p.G * t.tiles, st);
  else
    band::split_stats<<<planes, band::THREADS, 0, st>>>(acc, splits, t.slice,
                                                         stats, plane);
  return static_cast<int>(cudaGetLastError());
}

// NCHW form on the wgmma core (a problem that pads H, its acc NCHW, read
// from the layout pass's channels_last copies): launch_conv_band_wgmma's
// product and stats, then band.cuh's apply over each plane of `plane`
// elements into the NCHW y. The stats follow the plan's split and
// packing, which follow split_batch, so a sample's bits do not change
// with the batch. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// what the core cannot take.
template <typename P>
int launch_conv_in_act_nchw_wgmma(const P& p, int batch, int bn, int stages,
                                  int splits, int samples, float* acc,
                                  float2* part, float2* stats,
                                  __nv_bfloat16* y, long plane, int act,
                                  float eps, cudaStream_t st) {
  const int rc = launch_conv_band_wgmma(p, batch, bn, stages, splits,
                                        samples, acc, part, stats, plane, st);
  if (rc != 0) return rc;
  band::launch_apply<float, __nv_bfloat16>(acc, stats, y,
                                           (long)batch * p.Cout, plane,
                                           (float)plane, eps, act, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pgt
