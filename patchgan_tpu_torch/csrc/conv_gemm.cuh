// Implicit-GEMM core shared by the fused conv kernels (conv_norm_act.cu,
// convt_norm_act.cu).
//
// A problem P describes, per sample n and group g (the convT kernel's
// four output parity classes; one group for the plain conv), a product
//   out[m, co] = sum_k A[m, k] * B[k, co],   m < M, co < Cout, k < K
// where A is gathered from the input on the fly (zero outside the image)
// and B is a weight laid out k-contiguous, B[k, co] = P::bw[(g * Cout +
// co) * ldb + k], with ldb a multiple of 8 and, where K is not, zeros
// from K up to the next multiple of 8. The problem supplies
//   Gather gather(n, g, valid, r, c, ak0)  a thread's addressing for
//       output pixel m = r * Mw + c and k = k0 + ak0 + 2j, set up once
//   void load_a(Gather, k0, kend, v)  the 16 A elements of that thread
//       for the K step at k0 (zero for k >= kend), as pairs:
//       v[i].x at k = k0 + ak0 + 4i, v[i].y at k = k0 + ak0 + 4i + 2
//   long out(n, g, r, c, co)  index of the fp32 result in `acc`
// and, where `acc` is NHWC (channels contiguous), a member
// `static constexpr bool kChannelsLast = true`: the epilogue then walks
// the tile channel by channel, so neighbouring threads store neighbouring
// channels of one pixel.
//
// One block computes a BM x BN tile of one (n, g) product with fp32
// accumulation: bf16 through WMMA 16x16x16 tensor-core fragments, fp32
// through plain FMAs (so fp32 runs keep full fp32 products, as the JAX
// reference does). Shared-memory tiles are stored k-major for A and
// channel-major for B, so the gather's stores from neighbouring threads
// land on neighbouring addresses.
//
// The bf16 path is a two-stage pipeline with one barrier per K step: B's
// next tile goes to the other stage by 16-byte cp.async (zero-filled past
// kend and Cout), and A's next elements are loaded into registers before
// this step's MMAs and stored to the other stage after them. The fp32
// path stages the same operands synchronously in one stage. The epilogue
// tile `Cs` shares the staging memory, so a block takes about 19 KB.
//
// Without a K split, the epilogue writes the fp32 tile to `acc` and one
// partial (sum, sum of squares) per channel over the tile's valid pixels
// to part[((n * Cout + co) * G + g) * gridDim.x + tile], with no atomics;
// finish_from_partials (in_common.cuh) then reduces those in a fixed
// order and normalises from the fp32 accumulator (for an NHWC `acc`,
// norm_nhwc.cuh's reduce_parts and apply, launch_conv_in_act_nhwc).
//
// The deep levels have few output tiles and a long K (enc4-enc6: 64
// blocks, 256 K steps each), too few blocks to fill the card. There K is
// split `splits` ways: block s of a tile sums its share of K into slice
// s of `acc`, and finish_split adds the slices in order, takes the
// statistics over the summed plane, and normalises.
#pragma once

#include <mma.h>

#include <type_traits>

#include "band.cuh"
#include "in_common.cuh"
#include "norm_nhwc.cuh"

namespace pgt {

// Whether problem P writes an NHWC `acc` (its kChannelsLast member)
template <typename P, typename = void>
struct ChannelsLastOut : std::false_type {};
template <typename P>
struct ChannelsLastOut<P, std::void_t<decltype(P::kChannelsLast)>>
    : std::bool_constant<P::kChannelsLast> {};

constexpr int BM = 64, BN = 64, BK = 32, GEMM_THREADS = 128;
// blocks that keep every SM of an H100 SXM (132) busy with a few each
constexpr int TARGET_BLOCKS = 4 * 132;
constexpr int LDA = BM + 8;  // As[k * LDA + m]; 16-row fragments stay
                             // 32-byte aligned
constexpr int LDC = BM + 4;  // Cs is channel-major: Cs[co * LDC + m]

// two elements of T, the unit a problem's load_a hands over
template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
};
template <typename T>
using pair_t = typename Pair<T>::type;

// K split of a product with `tiles` output tiles: double it while the
// grid is below TARGET_BLOCKS and every split keeps >= 8 K steps.
inline int choose_splits(long tiles, int K) {
  const int ksteps = (K + BK - 1) / BK;
  int s = 1;
  while (tiles * s < TARGET_BLOCKS && ksteps / (2 * s) >= 8) s *= 2;
  return s;
}

// Blocks per SM the bf16 kernel is held to (<= 64 registers a thread):
// with 8, the 1024 blocks of enc1 at 8 tiles fit in one wave on 132 SMs;
// 7 (72 registers) measured 1.4x slower there from the second wave.
template <typename T>
struct MinBlocks {
  static constexpr int value = std::is_same<T, float>::value ? 1 : 8;
};

template <typename T, typename P>
__global__ void __launch_bounds__(GEMM_THREADS, MinBlocks<T>::value)
    conv_gemm_kernel(const P p, int splits, long slice,
                     float* __restrict__ acc, float2* __restrict__ part) {
  constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;
  constexpr int STAGES = kTensorCores ? 2 : 1;
  // Bs[co * LDB + k]: 8 bf16 of padding keep wmma's and cp.async's
  // alignment; fp32 reads along co (FMA path) want an odd stride instead
  constexpr int LDB = kTensorCores ? BK + 8 : BK + 1;
  constexpr int A_STAGE = BK * LDA, B_STAGE = BN * LDB;
  constexpr int STAGE_BYTES = STAGES * (A_STAGE + B_STAGE) * sizeof(T);
  constexpr int C_BYTES = BN * LDC * sizeof(float);
  __shared__ __align__(128)
      unsigned char smem[STAGE_BYTES > C_BYTES ? STAGE_BYTES : C_BYTES];
  T* const As = reinterpret_cast<T*>(smem);     // STAGES x A_STAGE
  T* const Bs = As + STAGES * A_STAGE;          // STAGES x B_STAGE
  float* const Cs = reinterpret_cast<float*>(smem);  // after the K loop

  const int mt = blockIdx.x, nt = blockIdx.y;
  const int split = blockIdx.z % splits, ng = blockIdx.z / splits;
  const int g = ng % p.G, n = ng / p.G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ksteps = (p.K + BK - 1) / BK;
  const int per = (ksteps + splits - 1) / splits;
  const int kbegin = split * per * BK, kend = min(p.K, kbegin + per * BK);

  // each thread gathers A for one fixed row m and every second k
  const int am = tid % BM, ak0 = tid / BM;  // ak0 in {0, 1}
  const int m = mt * BM + am;
  const bool mvalid = m < p.M;
  const auto ga = p.gather(n, g, mvalid, mvalid ? m / p.Mw : 0,
                           mvalid ? m % p.Mw : 0, ak0);
  pair_t<T> av[BK / 4];
  auto store_a = [&](T* a) {
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      a[(ak0 + 4 * i) * LDA + am] = av[i].x;
      a[(ak0 + 4 * i + 2) * LDA + am] = av[i].y;
    }
  };
  // B rows of this (g, co tile) in the k-contiguous weight
  const T* const brow = p.bw + ((long)g * p.Cout + nt * BN) * p.ldb;

  using namespace nvcuda;
  const int wm = warp >> 1, wn = warp & 1;  // 2 x 2 warps of 32 x 32
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf[2][2];
  const int tm = tid >> 3, tn = tid & 7;  // FMA path: 4 rows x 8 cols each
  float c[4][8];
  if constexpr (kTensorCores) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(cf[i][j], 0.f);

    // B tile of the K step at k0 -> stage b: BN rows of BK bf16, four
    // 16-byte chunks a row, two chunks a thread
    auto stage_b = [&](T* b, int k0) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int ch = tid + q * GEMM_THREADS, row = ch >> 2;
        const int kc = (ch & 3) * 8;
        const bool ok = nt * BN + row < p.Cout && k0 + kc < kend;
        cp_async16(b + row * LDB + kc,
                   ok ? brow + (long)row * p.ldb + k0 + kc : p.bw, ok);
      }
      cp_async_commit();
    };
    if (kbegin < kend) {
      stage_b(Bs, kbegin);
      p.load_a(ga, kbegin, kend, av);
      store_a(As);
      cp_async_wait_all();
      __syncthreads();
    }
    int s = 0;
    for (int k0 = kbegin; k0 < kend; k0 += BK) {
      const bool more = k0 + BK < kend;
      if (more) {  // the next step's loads fly during this step's MMAs
        stage_b(Bs + (s ^ 1) * B_STAGE, k0 + BK);
        p.load_a(ga, k0 + BK, kend, av);
      }
      const T* a = As + s * A_STAGE;
      const T* b = Bs + s * B_STAGE;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major>
            af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major>
            bf[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(af[i], a + kk * LDA + wm * 32 + i * 16, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(bf[j], b + (wn * 32 + j * 16) * LDB + kk,
                                 LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(cf[i][j], af[i], bf[j], cf[i][j]);
      }
      if (more) store_a(As + (s ^ 1) * A_STAGE);
      cp_async_wait_all();
      __syncthreads();  // stage s^1 is full, stage s free to refill
      s ^= 1;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) c[i][j] = 0.f;
    const int bk = tid % BK, bc0 = tid / BK;  // bc0 in {0, 1, 2, 3}
    for (int k0 = kbegin; k0 < kend; k0 += BK) {
      p.load_a(ga, k0, kend, av);
      store_a(As);
#pragma unroll 4
      for (int j = 0; j < BN / 4; ++j) {
        const int cl = bc0 + 4 * j, k = k0 + bk;
        Bs[cl * LDB + bk] = (nt * BN + cl < p.Cout && k < kend)
                                ? brow[(long)cl * p.ldb + k]
                                : from_f32<T>(0.f);
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float av4[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) av4[i] = to_f32(As[kk * LDA + tm * 4 + i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = to_f32(Bs[(tn * 8 + j) * LDB + kk]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) c[i][j] = fmaf(av4[i], bv[j], c[i][j]);
      }
      __syncthreads();
    }
  }

  if constexpr (kTensorCores) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wn * 32 + j * 16) * LDC + wm * 32 + i * 16,
                                cf[i][j], LDC, wmma::mem_col_major);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) Cs[(tn * 8 + j) * LDC + tm * 4 + i] = c[i][j];
  }
  __syncthreads();

  // fp32 conv output (this split's slice), coalesced along m (NCHW) or
  // along the channels (NHWC)
  float* out = acc + split * slice;
  for (int idx = tid; idx < BM * BN; idx += GEMM_THREADS) {
    int ml, cl;
    if constexpr (ChannelsLastOut<P>::value) {
      cl = idx % BN;
      ml = idx / BN;
    } else {
      ml = idx % BM;
      cl = idx / BM;
    }
    const int mm = mt * BM + ml, co = nt * BN + cl;
    if (mm < p.M && co < p.Cout)
      out[p.out(n, g, mm / p.Mw, mm % p.Mw, co)] = Cs[cl * LDC + ml];
  }
  if (splits > 1) return;  // finish_split takes the statistics
  // per-channel partial statistics over this tile's valid pixels
  const int rows = min(BM, p.M - mt * BM);
  for (int cl = warp; cl < BN; cl += GEMM_THREADS / 32) {
    const int co = nt * BN + cl;
    float s = 0.f, ss = 0.f;
    for (int ml = lane; ml < rows; ml += 32) {
      const float v = Cs[cl * LDC + ml];
      s += v;
      ss += v * v;
    }
    const float2 t = warp_sum2(s, ss);
    if (lane == 0 && co < p.Cout)
      part[((long)(n * p.Cout + co) * p.G + g) * gridDim.x + mt] = t;
  }
}

// The NHWC problems' vector gather (conv_norm_act.cu, convt_norm_act.cu):
// the pair of slots (ak0 + 4i, ak0 + 4i + 2) of a K step from 8
// channels' bf16 words (a, b: channels 8q .. 8q + 3, 8q + 4 .. 8q + 7 hold
// pairs 2q and 2q + 1): the low halves for ak0 = 0, the high ones for 1
__device__ __forceinline__ __nv_bfloat162 parity_pair(unsigned a, unsigned b,
                                                      int ak0) {
  const unsigned v = __byte_perm(a, b, ak0 ? 0x7632 : 0x5410);
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}

// Pairs v[0..7] of a K step whose 32 channels start at p, as a thread of
// parity ak0 takes them: v[i] = (channel 4i + ak0, 4i + 2 + ak0). p is on
// 16 bytes.
template <typename T>
__device__ __forceinline__ void load_step_channels(const T* p, int ak0,
                                                   pair_t<T> (&v)[BK / 4]) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const float4 f = *reinterpret_cast<const float4*>(p + 4 * i);
      v[i] = ak0 ? make_float2(f.y, f.w) : make_float2(f.x, f.z);
    }
  } else {
#pragma unroll
    for (int q = 0; q < BK / 8; ++q) {
      const uint4 u = *reinterpret_cast<const uint4*>(p + 8 * q);
      v[2 * q] = parity_pair(u.x, u.y, ak0);
      v[2 * q + 1] = parity_pair(u.z, u.w, ak0);
    }
  }
}

template <typename T>
__device__ __forceinline__ void zero_pairs(pair_t<T> (&v)[BK / 4]) {
  const T zero = from_f32<T>(0.f);
#pragma unroll
  for (int i = 0; i < BK / 4; ++i) {
    v[i].x = zero;
    v[i].y = zero;
  }
}

// Finishing pass after a K split: block p owns plane p; each element is
// the sum of the `splits` slices of `acc` (`slice` elements apart, added
// in slice order and kept in slice 0), then the statistics and the
// normalisation run over the summed plane.
template <typename Tout>
__global__ void finish_split(float* __restrict__ acc, int splits, long slice,
                             Tout* __restrict__ y, long plane, float eps,
                             int act) {
  float* a = acc + blockIdx.x * plane;
  float s = 0.f, ss = 0.f;
  for (long i = threadIdx.x; i < plane; i += blockDim.x) {
    float v = a[i];
    for (int k = 1; k < splits; ++k) v += a[k * slice + i];
    a[i] = v;
    s += v;
    ss += v * v;
  }
  const float2 t = block_sum2(s, ss);  // its barrier publishes a[]
  normalize_plane(a, y + blockIdx.x * plane, plane, t.x, t.y, eps, act);
}

template <typename P>
int splits_for(const P& p, int batch) {
  const long tiles = (long)((p.M + BM - 1) / BM) * ((p.Cout + BN - 1) / BN) *
                     batch * p.G;
  return choose_splits(tiles, p.K);
}

// Runs the product, then the finishing pass over the N * Cout planes of
// `plane` elements each, writing y. The K split is the one a batch of
// `split_batch` samples takes: a sample's sums run in the same order
// whatever `batch` is when `split_batch` is held fixed. `acc` holds
// splits_for(p, split_batch) slices of N * Cout * plane floats. Returns
// cudaGetLastError().
template <typename T, typename P>
int launch_conv_in_act(const P& p, int batch, int split_batch, float* acc,
                       float2* part, T* y, long plane, int act, float eps,
                       cudaStream_t st) {
  if (split_batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int splits = splits_for(p, split_batch);
  const long slice = (long)batch * p.Cout * plane;
  const dim3 grid((p.M + BM - 1) / BM, (p.Cout + BN - 1) / BN,
                  batch * p.G * splits);
  conv_gemm_kernel<T, P><<<grid, GEMM_THREADS, 0, st>>>(p, splits, slice,
                                                         acc, part);
  if (splits == 1) {
    finish_from_partials<T><<<(long)batch * p.Cout, FINISH_THREADS, 0, st>>>(
        acc, part, y, plane, p.G * grid.x, eps, act);
  } else {
    finish_split<T><<<(long)batch * p.Cout, FINISH_THREADS, 0, st>>>(
        acc, splits, slice, y, plane, eps, act);
  }
  return static_cast<int>(cudaGetLastError());
}

// NHWC form: the product into an NHWC `acc`, then the per-plane
// statistics (reduce_parts over the tiles' partials, or split_stats after
// a K split, which adds the slices into slice 0, then reduce_parts over
// its `segs` segments) and norm_nhwc.cuh's apply into y. `part` holds N *
// Cout * max(G * ceil(M / BM), segs) pairs, `stats` N * Cout; `vec`: the
// finish's 16-byte vectors (Cout a multiple of 8, acc and y on 16 bytes).
// Returns cudaGetLastError().
template <typename T, typename P>
int launch_conv_in_act_nhwc(const P& p, int batch, int split_batch,
                            float* acc, float2* part, float2* stats, T* y,
                            long plane, int segs, int vec, int act, float eps,
                            cudaStream_t st) {
  if (split_batch < 1 ||
      !nhwc::shape_ok(batch, plane, p.Cout, segs, vec, {acc, y}))
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = splits_for(p, split_batch);
  const long slice = (long)batch * p.Cout * plane;
  const long planes = (long)batch * p.Cout;
  const dim3 grid((p.M + BM - 1) / BM, (p.Cout + BN - 1) / BN,
                  batch * p.G * splits);
  conv_gemm_kernel<T, P><<<grid, GEMM_THREADS, 0, st>>>(p, splits, slice,
                                                         acc, part);
  if (splits == 1) {
    nhwc::launch_reduce(part, stats, planes, p.G * grid.x, st);
  } else {
    nhwc::launch_split_stats(acc, splits, slice, part, batch, plane, p.Cout,
                             segs, vec, st);
    nhwc::launch_reduce(part, stats, planes, segs, st);
  }
  nhwc::launch_apply<float, T>(acc, stats, y, batch, plane, p.Cout, segs,
                               vec, eps, act, st);
  return static_cast<int>(cudaGetLastError());
}

// Band form (spatial parallelism, band.cuh): the product as above, then
// the per-plane (sum, sum of squares) of the fp32 output into `stats`
// (from the tiles' partials, or after adding a K split's slices into slice
// 0) and no finishing pass: the caller sums the stats over the spatial
// group and normalises slice 0 of `acc` with band::apply_kernel. The K
// split is the one this band's product takes at `split_batch` samples.
template <typename T, typename P>
int launch_conv_band(const P& p, int batch, int split_batch, float* acc,
                     float2* part, float2* stats, long plane,
                     cudaStream_t st) {
  if (split_batch < 1 || p.M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = splits_for(p, split_batch);
  const long slice = (long)batch * p.Cout * plane;
  const long planes = (long)batch * p.Cout;
  const dim3 grid((p.M + BM - 1) / BM, (p.Cout + BN - 1) / BN,
                  batch * p.G * splits);
  conv_gemm_kernel<T, P><<<grid, GEMM_THREADS, 0, st>>>(p, splits, slice,
                                                         acc, part);
  if (splits == 1) {
    band::stats_from_partials<<<(planes + 255) / 256, 256, 0, st>>>(
        part, stats, planes, p.G * grid.x);
  } else {
    band::split_stats<<<planes, band::THREADS, 0, st>>>(acc, splits, slice,
                                                         stats, plane);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pgt

// Rows of one GEMM tile; the wrapper sizes the partial-statistics buffer
// as N * Cout * G * ceil(M / tile_m).
extern "C" int pgt_tile_m(void) { return pgt::BM; }
