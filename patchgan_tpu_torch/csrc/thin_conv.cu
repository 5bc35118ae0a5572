// K4 and K4-wgrad: the thin-channel 3x3 / stride-1 / pad-1 convolution,
// NCHW input, OIHW weight, forward and weight gradient.
//
// Replaces: patchgan_tpu/ops/pallas/thin_conv.py::_forward (pallas_call at
// :196, body _fwd_kernel :143-155) and ::_wgrad (pallas_call at :216, body
// _wgrad_kernel :158-176), reached via thin_conv3x3 from the s2d boundary
// convs (ops/s2d.py::_conv3): generator enc0 (Cin 12 -> 64) and the
// discriminator's conv0, image part (12 -> 64) and mask part (4 Cm -> 64),
// on the 128 x 128 s2d grid of a 256-px image.
//
// Bound on the H100: bytes. Forward: 2 * 9 Cin * Cout FLOPs per pixel
// against (Cin + Cout) * 2 bytes in bf16, about 100 FLOPs a byte at
// Cin 28, a third of the bf16 tensor cores' ridge; wgrad reads x and dy and
// writes a 64 x 9 Cin fp32 dw, the same FLOPs over fewer bytes (at the
// s2d step's shapes 40 / 48 MB a call: 0.012 / 0.014 ms).
//
// Design. The Pallas kernels materialise a transposed, padded copy of x
// (_prep) and contract an im2col patch matrix on the MXU; the wgrad sums
// per-sample partials across a sequential grid. Here:
// - x is read in place: a block stages one output tile's haloed input
//   (TH + 2 rows x TW + 2 columns, every channel) in shared memory with
//   zeros outside the image, channel-innermost, so the im2col operand of
//   tap (r, s) is a plain strided view of the staged tile and no patch
//   matrix is ever built;
// - bf16 runs on the tensor cores through WMMA 16x16x16 with fp32
//   accumulation, Cin zero-padded to 16 per tap; fp32 runs on plain FMAs
//   (no TF32), as the JAX reference keeps full fp32 products;
// - both kernels run a persistent grid, as many blocks as the card holds
//   at once, each walking the tiles with the grid's stride, so no partial
//   second wave runs;
// - bf16 staging of x goes through registers: where W % 8 == 0 a thread
//   loads a run of pixels of each of 8 channels as vectors, transposes
//   them with byte permutes and stores 16-byte channel-innermost vectors
//   (channel-innermost 2-byte stores would conflict 8-16 ways); the halo
//   columns, and every column at other widths, load element by element.
//   The next tile's loads are issued before the current tile's MMAs and
//   stored after them: one barrier pair a tile;
// - the forward's weight is packed once a call by a small kernel into the
//   block's shared-memory layout (zero past Cin and Cout), which each
//   block copies once with 16-byte cp.async; its bf16 epilogue writes 8
//   pixels of a channel as one 16-byte store where W % 8 == 0;
// - the wgrad is a reduction over N * H * W pixels into a tiny output. A
//   block cannot carry a sum across the grid as the TPU's sequential grid
//   does, so each block sums the tiles it walks into an fp32 partial
//   [64, 9 Cin] in registers and stores it; a second pass adds the
//   partials in a fixed order. No atomics: runs are bit-reproducible on a
//   given card, as the instance-norm statistics are (in_common.cuh).
//
// The wgrad in bf16 (thin_wgrad_tma, where W % 8 == 0 and x, dy lie on 16
// bytes: the s2d step's calls) is a GEMM on the wgmma path: M = 64 output
// channels, K = pixels, A = dy. In NCHW, 64 pixels of one channel are one
// 128-byte row of a K-major operand under the 128-byte swizzle, which TMA
// copies as it is. B is x's tap views, and a tap's shift along W moves a
// K-major row by 2 bytes, which neither a 16-byte copy, a descriptor's start
// nor a TMA box can take (a swizzled box at col0 +- 1 stopped the kernel with
// an illegal instruction on the H100). Of the two ways round it, staging x once
// channel-innermost for an MN-major B (register transposes, and the no-swizzle
// transposed descriptor) or three column-shifted K-major copies, this takes the
// copies: TMA lands the aligned one (shift 1) and 16-byte halo columns, and the
// threads build shifts 0 and 2 from them in shared memory, one 16-byte chunk
// and one neighbouring element a store, while shift 1's wgmmas run. So A and B
// take conv_wgmma.cuh's one descriptor form (wgmma.cuh), TMA reads zeros
// outside the image and past Cin, and x's bytes cross from L2 once. A tile is 4
// output rows (6 staged: the halo adds half of x's rows, against twice at TH =
// 2), and rows r, r + 1, r + 2 of a shift's copy lie in consecutive 128-byte
// rows, so one m64n(3 CP)k16 covers a shift's three tap rows: 3 wgmma a
// 16-pixel slice. One warpgroup an SM, persistent, a ring of whole tiles on
// mbarriers; one partial a block, so one an SM (half the WMMA kernel's 264),
// added by the same reduce. The other bf16 inputs keep the WMMA kernel
// (thin_wgrad), chosen by shape and alignment alone; its dy tile (64-pixel
// rows) is copied by 16-byte cp.async into the other of two stages while the
// MMAs run.
#include <cuda.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "in_common.cuh"
#include "wgmma.cuh"

namespace pgt {
namespace thin {

constexpr int TH = 2, TW = 64;             // output tile: rows x columns
constexpr int TM = TH * TW;                // output pixels of a tile
constexpr int RW = TW + 2;                 // staged positions of a row
constexpr int HALO = (TH + 2) * RW;        // staged input positions
constexpr int BN = 64;                     // output channels of a block
constexpr int LDW = BN + 8;                // bf16 weight row stride
constexpr int LDD = TM + 8;                // bf16 dy row stride (wgrad)
constexpr int LDF = BN + 4;                // fp32 dy row stride (wgrad)
constexpr int FWD_THREADS = 128, WG_THREADS = 256;
constexpr int MAX_CIN = 32;
constexpr int MAX_KF = 9;  // fp32 wgrad: K = 9 Cin <= 288 in 16 columns

template <typename T>
struct Bf16 {
  static constexpr bool value = std::is_same<T, __nv_bfloat16>::value;
};

// wgrad partial columns per tap: bf16 pads Cin to the WMMA depth
template <typename T>
__host__ __device__ inline int kstride(int cin) {
  return Bf16<T>::value ? (cin + 15) / 16 * 16 : cin;
}

// rows per tap of the forward's packed weight, in both dtypes
__host__ __device__ inline int wrows(int cin) { return (cin + 15) / 16 * 16; }

// row stride of the forward's packed weight: bf16 pads 8 channels, so
// neighbouring WMMA rows start on other banks
template <typename T>
__host__ __device__ constexpr int wld() {
  return Bf16<T>::value ? LDW : BN;
}

// channel stride of a staged input position: the WMMA depth for bf16;
// odd for fp32, so a warp reading 32 neighbouring positions hits 32 banks
template <typename T>
__host__ __device__ inline int xstride(int cin) {
  return Bf16<T>::value ? (cin + 15) / 16 * 16 : (cin | 1);
}

// Offset of (position, channel) in the staged input tile. bf16: slabs of
// 16 channels, xs[((ci / 16) * HALO + pos) * 16 + ci % 16], so the WMMA
// operand of a tap is a 16-channel matrix with a 32-byte row stride;
// fp32: xs[pos * cs + ci].
template <typename T>
__device__ __forceinline__ int xoff(int pos, int ci, int cs) {
  if constexpr (Bf16<T>::value)
    return ((ci >> 4) * HALO + pos) * 16 + (ci & 15);
  return pos * cs + ci;
}

struct Tile {
  int n, row0, col0;
};

__device__ inline Tile tile_at(int t, int h, int wd) {
  const int tw = (wd + TW - 1) / TW, th = (h + TH - 1) / TH;
  Tile p;
  p.n = t / (tw * th);
  p.row0 = (t / tw) % th * TH;
  p.col0 = t % tw * TW;
  return p;
}

// Shared-memory fill with U global loads in flight a thread: element i
// (i < total, strided over the block) is load(i), then store(i, value).
// A loop that stores each value before it loads the next waits a full
// load latency per element.
template <int U, typename V, typename Load, typename Store>
__device__ __forceinline__ void fill(int total, Load load, Store store) {
  for (int base = threadIdx.x; base < total; base += U * blockDim.x) {
    V v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * blockDim.x;
      if (i < total) v[u] = load(i);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * blockDim.x;
      if (i < total) store(i, v[u]);
    }
  }
}

// fp32: the haloed input of a tile at xoff(position, ci), position = row *
// RW + column from (row0 - 1, col0 - 1); channels from cin to cs are zero.
__device__ void stage_x_fp32(const float* __restrict__ x, float* xs,
                             const Tile& p, int cin, int h, int wd, int cs) {
  const long plane = (long)h * wd;
  fill<8, float>(
      cs * HALO,
      [&](int i) {
        const int ci = i / HALO, pos = i - ci * HALO;
        const int rr = pos / RW, cc = pos - rr * RW;
        const int gy = p.row0 + rr - 1, gx = p.col0 + cc - 1;
        if (ci >= cin || gy < 0 || gy >= h || gx < 0 || gx >= wd) return 0.f;
        return x[((long)p.n * cin + ci) * plane + (long)gy * wd + gx];
      },
      [&](int i, float v) { xs[xoff<float>(i % HALO, i / HALO, cs)] = v; });
}

// 32-bit word i of a register vector
template <typename V>
__device__ __forceinline__ unsigned& word(V& v, int i) {
  return reinterpret_cast<unsigned*>(&v)[i];
}
template <typename V>
__device__ __forceinline__ unsigned word(const V& v, int i) {
  return reinterpret_cast<const unsigned*>(&v)[i];
}

// bf16: the haloed input of a tile, staged through registers, so that the
// next tile's loads fly while the current one is computed (load(), then
// store() after the MMAs). The cs / 8 groups of 8 channels split into
// tasks, at most one of each kind a thread:
// - interior: PIX pixels of one staged row (columns col0 + PIX k ...) in
//   8 channels, one PIX-element load per channel (a vector where `vec`:
//   W % 8 == 0 and x 16-byte aligned, so a run is aligned and wholly in
//   or out of the image; else element by element), transposed by byte
//   permutes into PIX 16-byte channel-innermost stores;
// - edge: the halo column col0 - 1 or col0 + TW of one row in 8 channels,
//   eight 2-byte loads and one 16-byte store.
// Rows vary fastest over the threads, then the 8-channel half of a slab,
// so 8 neighbouring threads store to 4 distinct 32-byte position phases
// in both halves: 2-way conflicts.
template <int PIX, int THREADS>
struct XStager {
  using Vec = typename std::conditional<PIX == 8, uint4, uint2>::type;
  static constexpr int CHUNKS = TW / PIX;
  Vec v[8];  // v[c]: PIX pixels of channel 8 g + c
  uint4 e;   // the edge task's 8 channels
  int rr, g, k, er, eg, ecol;
  bool interior, edge;

  __device__ __forceinline__ XStager(int tid, int cs) {
    const int groups = cs / 8;
    interior = tid < (TH + 2) * CHUNKS * groups;
    rr = tid & 3;
    k = (tid >> 3) % CHUNKS;
    g = (tid >> 3) / CHUNKS * 2 + ((tid >> 2) & 1);
    const int et = tid - (THREADS - (TH + 2) * 2 * groups);
    edge = et >= 0;
    er = et & 3;
    ecol = (et >> 2) & 1 ? RW - 1 : 0;  // staged column
    eg = et >> 3;
  }

  __device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ x,
                                       const Tile& p, int cin, int h, int wd,
                                       bool vec) {
    const long plane = (long)h * wd;
    const unsigned short* xb = reinterpret_cast<const unsigned short*>(x);
    if (interior) {
      const int gy = p.row0 + rr - 1, gx = p.col0 + PIX * k;
      const bool row = gy >= 0 && gy < h && gx < wd;
      const unsigned short* src = xb + ((long)p.n * cin + 8 * g) * plane +
                                  (row ? (long)gy * wd + gx : 0);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const bool ok = row && 8 * g + c < cin;
        if (vec) {
          v[c] = ok ? *reinterpret_cast<const Vec*>(src + c * plane) : Vec{};
        } else {
#pragma unroll
          for (int q = 0; q < PIX / 2; ++q) {
            const unsigned lo =
                ok && gx + 2 * q < wd ? src[c * plane + 2 * q] : 0u;
            const unsigned hi =
                ok && gx + 2 * q + 1 < wd ? src[c * plane + 2 * q + 1] : 0u;
            word(v[c], q) = lo | hi << 16;
          }
        }
      }
    }
    if (edge) {
      const int gy = p.row0 + er - 1, gx = p.col0 + ecol - 1;
      const bool ok = gy >= 0 && gy < h && gx >= 0 && gx < wd;
      const unsigned short* src = xb + ((long)p.n * cin + 8 * eg) * plane +
                                  (ok ? (long)gy * wd + gx : 0);
      unsigned b[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        b[c] = ok && 8 * eg + c < cin ? src[c * plane] : 0u;
      e = make_uint4(b[0] | b[1] << 16, b[2] | b[3] << 16, b[4] | b[5] << 16,
                     b[6] | b[7] << 16);
    }
  }

  __device__ __forceinline__ void store(__nv_bfloat16* xs, int cs) const {
    if (interior) {
      __nv_bfloat16* dst =
          xs + xoff<__nv_bfloat16>(rr * RW + 1 + PIX * k, 8 * g, cs);
#pragma unroll
      for (int q = 0; q < PIX; ++q) {
        // pixel q of channels 2j (low half) and 2j + 1 (high half)
        const unsigned sel = q & 1 ? 0x7632 : 0x5410;
        *reinterpret_cast<uint4*>(dst + 16 * q) = make_uint4(
            __byte_perm(word(v[0], q >> 1), word(v[1], q >> 1), sel),
            __byte_perm(word(v[2], q >> 1), word(v[3], q >> 1), sel),
            __byte_perm(word(v[4], q >> 1), word(v[5], q >> 1), sel),
            __byte_perm(word(v[6], q >> 1), word(v[7], q >> 1), sel));
      }
    }
    if (edge)
      *reinterpret_cast<uint4*>(
          xs + xoff<__nv_bfloat16>(er * RW + ecol, 8 * eg, cs)) = e;
  }
};

// Forward: the packed weight, the staged input tile and (bf16) one 16 x 16
// fp32 epilogue tile a warp.
template <typename T>
size_t fwd_smem(int cin) {
  const size_t ws = (size_t)9 * wrows(cin) * wld<T>() * sizeof(T);
  const size_t xs = (size_t)HALO * xstride<T>(cin) * sizeof(T);
  const size_t ep =
      Bf16<T>::value ? (size_t)FWD_THREADS / 32 * 256 * sizeof(float) : 0;
  return ws + xs + ep;
}

// wp[((cb * 9 + tap) * wrows(cin) + ci) * wld + c] = w[cb * BN + c, ci,
// tap], zero where ci >= cin, c >= BN or cb * BN + c >= cout: the layout
// that Cout block cb copies into shared memory as it is.
template <typename T>
__global__ void pack_thin_weight(const T* __restrict__ w, T* __restrict__ wp,
                                 int cin, int cout, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int ks = wrows(cin), c = i % wld<T>(), r = i / wld<T>();
  const int ci = r % ks, tap = r / ks % 9, co = r / ks / 9 * BN + c;
  wp[i] = c < BN && co < cout && ci < cin ? w[((long)co * cin + ci) * 9 + tap]
                                          : from_f32<T>(0.f);
}

// y[n, co, p] = sum_(r, s, ci) w[co, ci, r, s] x[n, ci, p + (r - 1, s - 1)]
// for the 64 output channels of blockIdx.y, over tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... (vec: W % 8 == 0 and x, y 16-byte aligned)
template <typename T>
__global__ void __launch_bounds__(FWD_THREADS)
    thin_fwd(const T* __restrict__ x, const T* __restrict__ wp,
             T* __restrict__ y, int cin, int h, int wd, int cout, int tiles,
             bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ks = wrows(cin), cs = xstride<T>(cin), wsize = 9 * ks * wld<T>();
  T* ws = reinterpret_cast<T*>(smem);
  T* xs = ws + wsize;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int co0 = blockIdx.y * BN;

  // the block's packed weight, once: a contiguous slab of 16-byte chunks
  {
    const char* src =
        reinterpret_cast<const char*>(wp + (long)blockIdx.y * wsize);
    char* dst = reinterpret_cast<char*>(ws);
    for (int i = tid; i < wsize * (int)sizeof(T) / 16; i += FWD_THREADS)
      cp_async16(dst + 16 * i, src + 16 * i, true);
    cp_async_commit();
  }

  if constexpr (Bf16<T>::value) {
    using namespace nvcuda;
    float* ep = reinterpret_cast<float*>(xs + HALO * cs) + warp * 256;
    XStager<8, FWD_THREADS> st(tid, cs);
    int t = blockIdx.x;
    if (t < tiles) {
      st.load(x, tile_at(t, h, wd), cin, h, wd, vec);
      st.store(xs, cs);
    }
    cp_async_wait_all();
    __syncthreads();
    // warp: output row (warp >> 1) of the tile, 32 columns, 64 channels
    const int rowl = warp >> 1, cb = (warp & 1) * 32;
    for (; t < tiles; t += gridDim.x) {
      const Tile p = tile_at(t, h, wd);
      const bool more = t + gridDim.x < tiles;
      // the next tile's loads fly during this tile's MMAs
      if (more) st.load(x, tile_at(t + gridDim.x, h, wd), cin, h, wd, vec);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
      for (int tap = 0; tap < 9; ++tap) {
        const int r = tap / 3, s = tap - 3 * r;
        for (int c0 = 0; c0 < ks; c0 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              a[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              b[4];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(
                a[i], xs + xoff<T>((rowl + r) * RW + cb + 16 * i + s, c0, cs),
                16);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wmma::load_matrix_sync(b[j], ws + (tap * ks + c0) * LDW + 16 * j,
                                   LDW);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
      }
      // epilogue, each warp on its own: a 16 x 16 result goes through the
      // warp's ep[co * 16 + pixel], then lane (co, half) writes 8 pixels
      // of one channel
      const int cl = lane >> 1, hf = lane & 1, gy = p.row0 + rowl;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::store_matrix_sync(ep, acc[i][j], 16, wmma::mem_col_major);
          __syncwarp();
          const float4 lo =
              *reinterpret_cast<const float4*>(ep + cl * 16 + 8 * hf);
          const float4 hi =
              *reinterpret_cast<const float4*>(ep + cl * 16 + 8 * hf + 4);
          __syncwarp();
          const int co = co0 + 16 * j + cl;
          const int gx = p.col0 + cb + 16 * i + 8 * hf;
          if (co < cout && gy < h && gx < wd) {
            T* dst = y + (((long)p.n * cout + co) * h + gy) * wd + gx;
            const __nv_bfloat162 o[4] = {__floats2bfloat162_rn(lo.x, lo.y),
                                         __floats2bfloat162_rn(lo.z, lo.w),
                                         __floats2bfloat162_rn(hi.x, hi.y),
                                         __floats2bfloat162_rn(hi.z, hi.w)};
            if (vec) {
              *reinterpret_cast<uint4*>(dst) = make_uint4(
                  word(o[0], 0), word(o[1], 0), word(o[2], 0), word(o[3], 0));
            } else {
#pragma unroll
              for (int q = 0; q < 8; ++q)
                if (gx + q < wd) dst[q] = q & 1 ? o[q >> 1].y : o[q >> 1].x;
            }
          }
        }
      __syncthreads();  // every warp is done with xs
      if (more) st.store(xs, cs);
      __syncthreads();  // the next tile is staged
    }
  } else {
    cp_async_wait_all();
    __syncthreads();
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile p = tile_at(t, h, wd);
      stage_x_fp32(x, xs, p, cin, h, wd, cs);
      __syncthreads();
      // thread: pixels lane + 32 i of the tile, channels warp * 16 + j
      float acc[4][16];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;
      int base[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = lane + 32 * i;
        base[i] = ((m / TW) * RW + m % TW) * cs;
      }
      for (int tap = 0; tap < 9; ++tap) {
        const int toff = (tap / 3 * RW + tap % 3) * cs;
        for (int ci = 0; ci < cin; ++ci) {
          float a[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = xs[base[i] + toff + ci];
          const float* wr = ws + (tap * ks + ci) * BN + warp * 16;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float b = wr[j];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int co = co0 + warp * 16 + j;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = lane + 32 * i;
          const int gy = p.row0 + m / TW, gx = p.col0 + m % TW;
          if (co < cout && gy < h && gx < wd)
            y[(((long)p.n * cout + co) * h + gy) * wd + gx] = acc[i][j];
        }
      }
      __syncthreads();  // before the next tile restages xs
    }
  }
}

// Wgrad: bf16, two dy stages and the staged input tile; fp32, one dy tile
// (pixel-major fp32) and the input tile.
template <typename T>
size_t wgrad_smem(int cin) {
  const size_t dys = Bf16<T>::value ? (size_t)2 * BN * LDD * sizeof(T)
                                    : (size_t)TM * LDF * sizeof(float);
  return dys + (size_t)HALO * xstride<T>(cin) * sizeof(T);
}

// Partial weight gradient of the 64 output channels of blockIdx.y over the
// tiles blockIdx.x, blockIdx.x + gridDim.x, ... (vec: W % 8 == 0 and x, dy
// 16-byte aligned):
//   part[blk][co][tap * ks + ci] = sum_pixels dy[n, co, p] x[n, ci, p + tap]
// with blk = blockIdx.x * gridDim.y + blockIdx.y, fp32.
template <typename T>
__global__ void __launch_bounds__(WG_THREADS, 2)
    thin_wgrad(const T* __restrict__ x, const T* __restrict__ dy,
               float* __restrict__ part, int cin, int h, int wd, int cout,
               int tiles, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool kTensorCores = Bf16<T>::value;
  constexpr int DY_STAGE = BN * LDD;  // bf16 elements of a dy stage
  const int ks = kstride<T>(cin), cs = xstride<T>(cin), kp = 9 * ks;
  T* dys = reinterpret_cast<T*>(smem);
  T* xs = reinterpret_cast<T*>(
      smem + (kTensorCores ? 2 * DY_STAGE * sizeof(T)
                           : TM * LDF * sizeof(float)));
  float* dyf = reinterpret_cast<float*>(smem);  // fp32: dyf[m * LDF + co]
  const int tid = threadIdx.x, warp = tid >> 5;
  const int co0 = blockIdx.y * BN;
  float* out =
      part + ((long)blockIdx.x * gridDim.y + blockIdx.y) * BN * (long)kp;

  // element i = (channel, pixel) of a tile's dy, or -1 outside the image
  // and past cout
  auto dy_at = [&](const Tile& p, int i) -> long {
    const int c = i / TM, m = i - c * TM;
    const int gy = p.row0 + m / TW, gx = p.col0 + m % TW, co = co0 + c;
    if (gy >= h || gx >= wd || co >= cout) return -1;
    return (((long)p.n * cout + co) * h + gy) * wd + gx;
  };

  using namespace nvcuda;
  // bf16: warp owns channel rows 16 cf.. and every other 16-column block
  // of K from `half`; fp32: thread owns channels 4 cg.. and columns kg +
  // 16 j of K = 9 cin
  const int cf = warp & 3, half = warp >> 2, kfs = ks / 16, nkf = 9 * kfs;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAX_KF];
  const int cg = tid & 15, kg = tid >> 4, kdim = 9 * cin;
  float accf[4][MAX_KF * 2];
  int off[MAX_KF * 2];
  if constexpr (kTensorCores) {
#pragma unroll
    for (int q = 0; q < MAX_KF; ++q) wmma::fill_fragment(acc[q], 0.f);
    XStager<4, WG_THREADS> st(tid, cs);
    // a tile's dy -> stage d: 8 pixels a 16-byte cp.async where vec (zero
    // outside the image and past cout), else element by element
    auto stage_dy = [&](T* d, const Tile& p) {
      if (vec) {
        for (int i = tid; i < BN * TM / 8; i += WG_THREADS) {
          const long o = dy_at(p, 8 * i);
          const int c = 8 * i / TM, m = 8 * i - c * TM;
          cp_async16(d + c * LDD + m, o < 0 ? dy : dy + o, o >= 0);
        }
        cp_async_commit();
      } else {
        fill<8, T>(
            BN * TM,
            [&](int i) {
              const long o = dy_at(p, i);
              return o < 0 ? from_f32<T>(0.f) : dy[o];
            },
            [&](int i, T v) { d[i / TM * LDD + i % TM] = v; });
      }
    };
    int t = blockIdx.x, s = 0;
    if (t < tiles) {
      const Tile p = tile_at(t, h, wd);
      stage_dy(dys, p);
      st.load(x, p, cin, h, wd, vec);
      st.store(xs, cs);
    }
    cp_async_wait_all();
    __syncthreads();
    for (; t < tiles; t += gridDim.x) {
      const bool more = t + gridDim.x < tiles;
      if (more) {  // the next tile's loads fly during this tile's MMAs
        const Tile pn = tile_at(t + gridDim.x, h, wd);
        stage_dy(dys + (s ^ 1) * DY_STAGE, pn);
        st.load(x, pn, cin, h, wd, vec);
      }
      const T* d = dys + s * DY_STAGE;
      for (int m0 = 0; m0 < TM; m0 += 16) {
        const int rowl = m0 / TW, col = m0 % TW;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            a;
        wmma::load_matrix_sync(a, d + 16 * cf * LDD + m0, LDD);
#pragma unroll
        for (int q = 0; q < MAX_KF; ++q) {
          const int kf = half + 2 * q;
          if (kf < nkf) {
            const int tap = kf / kfs, c0 = (kf - tap * kfs) * 16;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major>
                b;
            wmma::load_matrix_sync(
                b, xs + xoff<T>((rowl + tap / 3) * RW + col + tap % 3, c0, cs),
                16);
            wmma::mma_sync(acc[q], a, b, acc[q]);
          }
        }
      }
      __syncthreads();  // every warp is done with xs and stage s
      if (more) st.store(xs, cs);
      cp_async_wait_all();
      __syncthreads();  // the next tile is staged
      s ^= 1;
    }
#pragma unroll
    for (int q = 0; q < MAX_KF; ++q) {
      const int kf = half + 2 * q;
      if (kf < nkf)
        wmma::store_matrix_sync(out + 16 * cf * kp + 16 * kf, acc[q], kp,
                                wmma::mem_row_major);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 2 * MAX_KF; ++j) {
      const int k = kg + 16 * j, tap = k / cin, ci = k - tap * cin;
      off[j] = k < kdim ? (tap / 3 * RW + tap % 3) * cs + ci : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) accf[i][j] = 0.f;
    }
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile p = tile_at(t, h, wd);
      stage_x_fp32(x, xs, p, cin, h, wd, cs);
      fill<8, float>(
          BN * TM,
          [&](int i) {
            const long o = dy_at(p, i);
            return o < 0 ? 0.f : dy[o];
          },
          [&](int i, float v) { dyf[i % TM * LDF + i / TM] = v; });
      __syncthreads();
      for (int m = 0; m < TM; ++m) {
        const int xb = ((m / TW) * RW + m % TW) * cs;
        const float4 d = *reinterpret_cast<const float4*>(dyf + m * LDF +
                                                          4 * cg);
#pragma unroll
        for (int j = 0; j < 2 * MAX_KF; ++j) {
          const float a = xs[xb + off[j]];
          accf[0][j] = fmaf(d.x, a, accf[0][j]);
          accf[1][j] = fmaf(d.y, a, accf[1][j]);
          accf[2][j] = fmaf(d.z, a, accf[2][j]);
          accf[3][j] = fmaf(d.w, a, accf[3][j]);
        }
      }
      __syncthreads();  // before the next tile restages dyf and xs
    }
#pragma unroll
    for (int j = 0; j < 2 * MAX_KF; ++j) {
      const int k = kg + 16 * j;
      if (k < kdim)
#pragma unroll
        for (int i = 0; i < 4; ++i) out[(4 * cg + i) * kp + k] = accf[i][j];
    }
  }
}

// K4-wgrad on the tensor cores' wgmma path: bf16, W % 8 == 0, x and dy on
// 16 bytes (the s2d step's four calls). One block of one warpgroup an SM,
// persistent over tiles of TH_W output rows x TW columns of one sample.
// A tile is one GEMM step, M = the block's 64 output channels, K = its
// pixels, N = 3 CP per column shift s (the tap rows r = 0..2 and CP
// channels each); CP = Cin rounded up to 16 or 32.
//
// TMA fills a ring of wg_stages(CP) stages, one tile a stage, each counted
// on its own mbarrier:
// - dy: each output row's 64 channels x 64 pixels, one 128-byte K-major
//   row a channel under the 128-byte swizzle (A, rows at 128 bytes);
// - x: the TH_W + 2 haloed rows of CP channels at columns col0 ..
//   col0 + 63, rows (row, channel) at 128 bytes in the same layout: the
//   B of shift s = 1. Rows r..r + 2 are 3 CP consecutive rows, so one
//   descriptor of N = 3 CP covers the three tap rows;
// - the halo columns col0 - 8 .. col0 - 1 and col0 + 64 .. col0 + 71 of
//   those rows (16 bytes a row and channel, no swizzle).
// TMA reads zeros outside the image and past Cin, but takes no box whose first
// column lies off 16 bytes, so it cannot copy the one-element shifts (a
// swizzled box at col0 +- 1 stopped the kernel with an illegal instruction on
// the H100). The threads build them in the stage: the B of shift 0 (x[col0 - 1
// + k]) and of shift 2 (x[col0 + 1 + k]), each 16-byte chunk from one chunk of
// shift 1 and one element of its neighbour chunk (or the halo), by byte
// permutes, stored in the same swizzled layout.
// A tile: its three shifts' wgmmas (for each output row and 16-pixel
// slice, one m64n(3 CP)k16 a shift), committed; while they run, the wait
// for the next tile's stage and its shifted copies, fenced to the async
// proxy; then a barrier, and this tile's stage goes back to TMA for the
// tile wg_stages on. The
// accumulators (3 x 3 CP / 2 floats a thread) sum every tile of the
// block; at the end each thread stores its fragment into the block's
// partial, laid out as thin_wgrad's (ks = CP), which thin_wgrad_reduce
// adds in a fixed order.
constexpr int TH_W = 4;                    // output rows of a tile
constexpr int DY_ROW = BN * 128;           // bytes of one output row's dy
constexpr int HALO_W = 8;                  // halo box: 16 bytes of a row

__host__ __device__ constexpr int wg_cp(int cin) {
  return cin <= 16 ? 16 : 32;
}
// a stage: dy, the three shifts' x rows, the left and right halos
__host__ __device__ constexpr int wg_xrows(int cp) {
  return (TH_W + 2) * cp * 128;
}
__host__ __device__ constexpr int wg_halo(int cp) {
  return (TH_W + 2) * cp * HALO_W * 2;
}
__host__ __device__ constexpr int wg_stage(int cp) {
  return TH_W * DY_ROW + 3 * wg_xrows(cp) + 2 * wg_halo(cp);
}
// the bytes TMA lands in a stage: all but shifts 0 and 2
__host__ __device__ constexpr int wg_landed(int cp) {
  return wg_stage(cp) - 2 * wg_xrows(cp);
}
// as many stages as fit beside the 1024 bytes that align the ring, at most 4
__host__ __device__ constexpr int wg_stages(int cp) {
  return (wg::SMEM_MAX - 1024) / wg_stage(cp) < 4
             ? (int)((wg::SMEM_MAX - 1024) / wg_stage(cp))
             : 4;
}
__host__ __device__ constexpr int wg_smem(int cp) {
  return wg_stages(cp) * wg_stage(cp) + 1024;
}

inline int wg_tiles_of(int n, int h, int wd) {
  return n * ((h + TH_W - 1) / TH_W) * ((wd + TW - 1) / TW);
}

// Shifts 0 and 2 of a stage's x (xs: its three shifts' rows, halo: left
// then right halo) from shift 1 and the halos. Task i: half i % 2 (chunks
// 4 (i % 2) .. 4 (i % 2) + 3) of row R = i / 2 (R = r CP + c: staged row
// r, channel c). Under the 128-byte swizzle chunk j of a row sits at 16
// (j ^ R % 8) bytes, the same in each shift; a halo row is 8 elements at
// 16 R bytes. A task loads its 4 chunks of shift 1 and the two elements
// beside them (of the row's other half, or of a halo), then stores 4
// chunks of each shift.
template <int CP>
__device__ __forceinline__ void shift_copies(unsigned char* xs,
                                             const unsigned char* halo) {
  constexpr int ROWS = (TH_W + 2) * CP, XROWS = ROWS * 128;
  for (int i = threadIdx.x; i < 2 * ROWS; i += wg::THREADS) {
    const int row = i >> 1, j0 = 4 * (i & 1), sw = row & 7;
    const unsigned char* src = xs + XROWS + row * 128;
    uint4 m[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      m[k] = *reinterpret_cast<const uint4*>(src + (((j0 + k) ^ sw) << 4));
    // x[col0 - 1 + 8 j0] and x[col0 + 8 j0 + 32]
    const unsigned prev =
        j0 ? *reinterpret_cast<const unsigned short*>(
                 src + (((j0 - 1) ^ sw) << 4) + 14)
           : *reinterpret_cast<const unsigned short*>(halo + row * 16 + 14);
    const unsigned next =
        j0 ? *reinterpret_cast<const unsigned short*>(halo +
                                                      (ROWS + row) * 16)
           : *reinterpret_cast<const unsigned short*>(
                 src + ((4 ^ sw) << 4));
    unsigned char* const left = xs + row * 128;
    unsigned char* const right = xs + 2 * XROWS + row * 128;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // left: x[col0 - 1 + p], the previous element then this chunk's
      // 0..6; right: x[col0 + 1 + p], this chunk's 1..7 then the next
      const unsigned before = k ? m[k - 1].w >> 16 : prev;
      const unsigned after = k < 3 ? m[k + 1].x & 0xffffu : next;
      const int at = ((j0 + k) ^ sw) << 4;
      *reinterpret_cast<uint4*>(left + at) = make_uint4(
          (m[k].x << 16) | before, __byte_perm(m[k].x, m[k].y, 0x5432),
          __byte_perm(m[k].y, m[k].z, 0x5432),
          __byte_perm(m[k].z, m[k].w, 0x5432));
      *reinterpret_cast<uint4*>(right + at) = make_uint4(
          __byte_perm(m[k].x, m[k].y, 0x5432),
          __byte_perm(m[k].y, m[k].z, 0x5432),
          __byte_perm(m[k].z, m[k].w, 0x5432), (m[k].w >> 16) | (after << 16));
    }
  }
}

template <int CP>
__global__ void __launch_bounds__(wg::THREADS, 1)
    thin_wgrad_tma(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap thalo,
                   const __grid_constant__ CUtensorMap tdy,
                   float* __restrict__ part, int h, int wd, int tiles) {
  constexpr int N = 3 * CP, S = wg_stages(CP), STAGE = wg_stage(CP);
  constexpr int XROWS = wg_xrows(CP), X0 = TH_W * DY_ROW;
  constexpr int HALO = X0 + 3 * XROWS;   // the halos' offset in a stage
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[S];
  const unsigned raw = wg::smem_u32(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;
  unsigned char* const ring = smem_raw + (base - raw);
  const int tid = threadIdx.x;
  const int co0 = blockIdx.y * BN;
  const int tw = (wd + TW - 1) / TW, th = (h + TH_W - 1) / TH_W;

  // thread 0: tile t's dy rows, x rows (shift 1) and halos into stage s,
  // four boxes
  auto issue = [&](int t, int s) {
    const int n = t / (tw * th), row0 = t / tw % th * TH_W,
              col0 = t % tw * TW;
    const unsigned st = base + s * STAGE, bar = wg::smem_u32(full + s);
    wg::mbar_expect_tx(bar, wg_landed(CP));
    wg::tma_load_4d(st, &tdy, col0, co0, row0, n, bar);
    wg::tma_load_4d(st + X0 + XROWS, &tx, col0, 0, row0 - 1, n, bar);
    wg::tma_load_4d(st + HALO, &thalo, col0 - HALO_W, 0, row0 - 1, n, bar);
    wg::tma_load_4d(st + HALO + (TH_W + 2) * CP * 16, &thalo, col0 + TW, 0,
                    row0 - 1, n, bar);
  };
  // the wgmmas of shift sh on stage st
  auto mma = [&](float (&acc)[N / 2], unsigned st, int sh) {
#pragma unroll
    for (int r = 0; r < TH_W; ++r) {
      const uint64_t da = wg::desc_sw128(st + r * DY_ROW);
      const uint64_t db = wg::desc_sw128(st + X0 + sh * XROWS + r * CP * 128);
#pragma unroll
      for (int kk = 0; kk < TW / 16; ++kk)
        wg::Wgmma<N>::mma(acc, da + 2 * kk, db + 2 * kk);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) wg::mbar_init(wg::smem_u32(full + s), 1);
    wg::mbar_fence_init();
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (blockIdx.x + s * gridDim.x < tiles)
        issue(blockIdx.x + s * gridDim.x, s);
  }
  __syncthreads();

  float d[3][N / 2];
#pragma unroll
  for (int sh = 0; sh < 3; ++sh)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) d[sh][i] = 0.f;
  // stage s's shifted copies, once its TMA has landed (phase `parity`)
  auto shifts = [&](int s, unsigned parity) {
    wg::mbar_wait(wg::smem_u32(full + s), parity);
    shift_copies<CP>(ring + s * STAGE + X0, ring + s * STAGE + HALO);
    wg::fence_async_smem();   // to the async proxy the wgmmas read through
    __syncwarp();   // the .aligned wgmma instructions need whole warps
  };
  if (blockIdx.x < tiles) shifts(0, 0);
  __syncthreads();
  int s = 0;
  unsigned phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const unsigned st = base + s * STAGE;
#pragma unroll
    for (int sh = 0; sh < 3; ++sh) wg::fence_operands(d[sh]);
    wg::wgmma_fence();
#pragma unroll
    for (int sh = 0; sh < 3; ++sh) mma(d[sh], st, sh);
    wg::wgmma_commit();
    // the next tile's shifted copies while this tile's MMAs run
    const int sn = s + 1 == S ? 0 : s + 1;
    const unsigned pn = sn ? phase : phase ^ 1;
    if (t + gridDim.x < tiles) shifts(sn, pn);
    wg::wgmma_wait0();
#pragma unroll
    for (int sh = 0; sh < 3; ++sh) wg::fence_operands(d[sh]);
    // every warp's MMAs on stage s are done, every copy of stage sn made
    __syncthreads();
    if (tid == 0 && t + S * gridDim.x < tiles) issue(t + S * gridDim.x, s);
    s = sn;
    phase = pn;
  }

  // the fragments into the block's partial part[blk][co][tap CP + ci]
  // (wgmma's D: warp w rows 16 w .. 16 w + 15, lane l rows l / 4 and
  // l / 4 + 8, columns 8 q + 2 (l % 4) and the next; column rr CP + ci of
  // shift s is tap 3 rr + s)
  float* const out =
      part + ((long)blockIdx.x * gridDim.y + blockIdx.y) * BN * 9 * CP;
  const int row = (tid >> 5) * 16 + ((tid & 31) >> 2), c2 = 2 * (tid & 3);
#pragma unroll
  for (int sh = 0; sh < 3; ++sh)
#pragma unroll
    for (int q = 0; q < N / 8; ++q) {
      const int rr = 8 * q / CP, ci = 8 * q % CP + c2;
      float* const o = out + row * 9 * CP + (3 * rr + sh) * CP + ci;
      *reinterpret_cast<float2*>(o) =
          make_float2(d[sh][4 * q], d[sh][4 * q + 1]);
      *reinterpret_cast<float2*>(o + 8 * 9 * CP) =
          make_float2(d[sh][4 * q + 2], d[sh][4 * q + 3]);
    }
}

// dw[co, ci, r, s] = the sum of the nblk partials in a fixed order. A
// block of 32 x RED_ROWS threads: column tx owns the partial element o
// (o = co * 9 ks + tap * ks + ci, consecutive over the warp), row ty sums
// partials ty, ty + RED_ROWS, ... and the row sums are added in row order.
constexpr int RED_ROWS = 8;

__global__ void thin_wgrad_reduce(const float* __restrict__ part,
                                  float* __restrict__ dw, int nblk, int cblks,
                                  int cin, int cout, int ks) {
  __shared__ float rows[RED_ROWS][33];
  const int kp = 9 * ks;
  const long o = (long)blockIdx.x * 32 + threadIdx.x;
  const bool valid = o < (long)cout * kp;
  float s = 0.f;
  if (valid) {
    // part[blk][co / BN][co % BN][k]: element o of every block
    const long stride = (long)cblks * BN * kp;
    for (int b = threadIdx.y; b < nblk; b += RED_ROWS)
      s += part[b * stride + o];
  }
  rows[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || !valid) return;
  float t = 0.f;
#pragma unroll
  for (int r = 0; r < RED_ROWS; ++r) t += rows[r][threadIdx.x];
  const int co = o / kp, k = o - (long)co * kp, tap = k / ks, ci = k - tap * ks;
  if (ci < cin) dw[((long)co * cin + ci) * 9 + tap] = t;
}

inline int tiles_of(int n, int h, int wd) {
  return n * ((h + TH - 1) / TH) * ((wd + TW - 1) / TW);
}

// The persistent grid: as many blocks as the current device holds at once
// (the occupancy query for the kernel, dtype and Cin, times the SM count;
// cached per device and Cin), shared by the Cout blocks and capped at the
// tile count. Each block walks the tiles with the grid's stride. *per_sm,
// if given, receives the blocks one SM holds.
constexpr int MAX_DEVICES = 64;
template <typename K>
dim3 persistent_grid(K kernel, int threads, size_t smem, size_t smem_max,
                     int (&cache)[MAX_DEVICES], int tiles, int cout,
                     int* per_sm) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  if (dev >= MAX_DEVICES) dev = MAX_DEVICES - 1;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (cache[dev] == 0) {
    // the largest Cin's shared memory, so a launch at any Cin is allowed
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_max);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cache[dev], kernel,
                                                  threads, smem);
  }
  if (per_sm) *per_sm = cache[dev];
  const int cblks = (cout + BN - 1) / BN;
  return dim3(min(tiles, max(1, cache[dev] * sms / cblks)), cblks);
}

template <typename T>
dim3 fwd_grid(int n, int cin, int h, int wd, int cout,
              int* per_sm = nullptr) {
  static int cache[MAX_CIN + 1][MAX_DEVICES];
  return persistent_grid(thin_fwd<T>, FWD_THREADS, fwd_smem<T>(cin),
                         fwd_smem<T>(MAX_CIN), cache[cin], tiles_of(n, h, wd),
                         cout, per_sm);
}

template <typename T>
dim3 wgrad_grid(int n, int cin, int h, int wd, int cout,
                int* per_sm = nullptr) {
  static int cache[MAX_CIN + 1][MAX_DEVICES];
  return persistent_grid(thin_wgrad<T>, WG_THREADS, wgrad_smem<T>(cin),
                         wgrad_smem<T>(MAX_CIN), cache[cin],
                         tiles_of(n, h, wd), cout, per_sm);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

inline int packed_size(int cin, int cout, bool bf16) {
  return (cout + BN - 1) / BN * 9 * wrows(cin) *
         (bf16 ? wld<__nv_bfloat16>() : wld<float>());
}

template <typename T>
int pack(const void* w, void* wp, int cin, int cout, cudaStream_t st) {
  const int total = packed_size(cin, cout, Bf16<T>::value);
  pack_thin_weight<T><<<(total + 255) / 256, 256, 0, st>>>(
      static_cast<const T*>(w), static_cast<T*>(wp), cin, cout, total);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_fwd(const void* x, const void* w, void* wp, void* y, int n, int cin,
            int h, int wd, int cout, cudaStream_t st) {
  const int rc = pack<T>(w, wp, cin, cout, st);
  if (rc != 0) return rc;
  thin_fwd<T><<<fwd_grid<T>(n, cin, h, wd, cout), FWD_THREADS,
                fwd_smem<T>(cin), st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wp), static_cast<T*>(y),
      cin, h, wd, cout, tiles_of(n, h, wd),
      wd % 8 == 0 && aligned16(x) && aligned16(y));
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled, taken from the driver through the runtime (the
// library links no libcuda); null where the driver has none
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The TMA map of a bf16 NCHW tensor [n][c][h][w] whose box is box_w pixels
// of box_h rows in box_c channels of one sample, listed innermost first as
// (w, c, h, n): the box lands row by row, each row's box_c channels
// consecutive, as the kernel's A and B take them. 64 pixels (128 bytes) a
// row under the 128-byte swizzle, or 8 (16 bytes) unswizzled; reads
// outside the tensor give zeros. W % 8 == 0 and p on 16 bytes (TMA's
// strides and base).
inline bool nchw_map(EncodeTiled enc, CUtensorMap* m, const void* p, int n,
                     int c, int h, int w, int box_w, int box_c, int box_h) {
  const cuuint64_t dims[4] = {(cuuint64_t)w, (cuuint64_t)c, (cuuint64_t)h,
                              (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)h * w * 2, (cuuint64_t)w * 2,
                                 (cuuint64_t)c * h * w * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_w, (cuuint32_t)box_c,
                             (cuuint32_t)box_h, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             box_w == TW ? CU_TENSOR_MAP_SWIZZLE_128B
                         : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The wgmma kernel takes a call in bf16 where TMA can map x and dy: W % 8
// == 0 and both on 16 bytes (ops/kernels/thin_conv.py's thin_wgrad_plan
// makes the same choice)
template <typename T>
inline bool wgrad_on_tma(int wd, const void* x, const void* dy) {
  return Bf16<T>::value && wd % 8 == 0 && aligned16(x) && aligned16(dy);
}

template <int CP>
dim3 wgrad_tma_grid(int n, int h, int wd, int cout, int* per_sm = nullptr) {
  static int cache[MAX_DEVICES];
  return persistent_grid(thin_wgrad_tma<CP>, wg::THREADS, wg_smem(CP),
                         wg_smem(CP), cache, wg_tiles_of(n, h, wd), cout,
                         per_sm);
}

inline dim3 wgrad_tma_grid(int n, int cin, int h, int wd, int cout,
                           int* per_sm = nullptr) {
  return wg_cp(cin) == 16 ? wgrad_tma_grid<16>(n, h, wd, cout, per_sm)
                          : wgrad_tma_grid<32>(n, h, wd, cout, per_sm);
}

template <int CP>
int run_wgrad_tma(const void* x, const void* dy, void* part, void* dw, int n,
                  int cin, int h, int wd, int cout, cudaStream_t st) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tx, thalo, tdy;
  if (!nchw_map(enc, &tx, x, n, cin, h, wd, TW, CP, TH_W + 2) ||
      !nchw_map(enc, &thalo, x, n, cin, h, wd, HALO_W, CP, TH_W + 2) ||
      !nchw_map(enc, &tdy, dy, n, cout, h, wd, TW, BN, TH_W))
    return cudaErrorInvalidValue;
  const dim3 grid = wgrad_tma_grid<CP>(n, h, wd, cout);
  thin_wgrad_tma<CP><<<grid, wg::THREADS, wg_smem(CP), st>>>(
      tx, thalo, tdy, static_cast<float*>(part), h, wd,
      wg_tiles_of(n, h, wd));
  const long outs = (long)cout * 9 * CP;
  thin_wgrad_reduce<<<(outs + 31) / 32, dim3(32, RED_ROWS), 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), grid.x,
      grid.y, cin, cout, CP);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_wgrad(const void* x, const void* dy, void* part, void* dw, int n,
              int cin, int h, int wd, int cout, cudaStream_t st) {
  if (wgrad_on_tma<T>(wd, x, dy))
    return wg_cp(cin) == 16
               ? run_wgrad_tma<16>(x, dy, part, dw, n, cin, h, wd, cout, st)
               : run_wgrad_tma<32>(x, dy, part, dw, n, cin, h, wd, cout, st);
  const dim3 grid = wgrad_grid<T>(n, cin, h, wd, cout);
  thin_wgrad<T><<<grid, WG_THREADS, wgrad_smem<T>(cin), st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<float*>(part), cin, h, wd, cout, tiles_of(n, h, wd),
      wd % 8 == 0 && aligned16(x) && aligned16(dy));
  const long outs = (long)cout * 9 * kstride<T>(cin);
  thin_wgrad_reduce<<<(outs + 31) / 32, dim3(32, RED_ROWS), 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), grid.x,
      grid.y, cin, cout, kstride<T>(cin));
  return static_cast<int>(cudaGetLastError());
}

inline bool valid(int n, int cin, int h, int wd, int cout) {
  return n > 0 && cin > 0 && cin <= MAX_CIN && h > 0 && wd > 0 && cout > 0;
}

}  // namespace thin
}  // namespace pgt

// Elements of the forward's packed weight, the output of
// pgt_thin_conv_pack and the scratch wp of pgt_thin_conv_fwd:
// [ceil(Cout / 64)][9][Cin rounded up to 16][72 bf16 or 64 fp32].
extern "C" int pgt_thin_conv_packed_size(int cin, int cout, int bf16) {
  return pgt::thin::packed_size(cin, cout, bf16 != 0);
}

// The pack kernel alone: w [Cout, Cin, 3, 3] -> wp (16-byte aligned), bf16
// (bf16 != 0) or fp32. Returns cudaGetLastError().
extern "C" int pgt_thin_conv_pack(const void* w, void* wp, int cin, int cout,
                                  int bf16, void* stream) {
  using namespace pgt::thin;
  if (!valid(1, cin, 1, 1, cout)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return pack<__nv_bfloat16>(w, wp, cin, cout, st);
  return pack<float>(w, wp, cin, cout, st);
}

// x [N, Cin, H, W], w [Cout, Cin, 3, 3], y [N, Cout, H, W], all bf16
// (bf16 != 0) or all fp32; 1 <= Cin <= 32; wp: 16-byte aligned scratch of
// pgt_thin_conv_packed_size() elements. Launches the pack, then the conv.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for shapes the
// kernel does not take.
extern "C" int pgt_thin_conv_fwd(const void* x, const void* w, void* wp,
                                 void* y, int n, int cin, int h, int wd,
                                 int cout, int bf16, void* stream) {
  using namespace pgt::thin;
  if (!valid(n, cin, h, wd, cout)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run_fwd<__nv_bfloat16>(x, w, wp, y, n, cin, h, wd, cout, st);
  return run_fwd<float>(x, w, wp, y, n, cin, h, wd, cout, st);
}

// fp32 elements of the scratch `part` that pgt_thin_conv_wgrad needs on
// the current device: one partial a block of its grid (in bf16 at W % 8
// == 0, the larger of the two kernels' grids: the alignment of x and dy
// picks one at the launch).
extern "C" long pgt_thin_conv_wgrad_scratch(int n, int cin, int h, int wd,
                                            int cout, int bf16) {
  using namespace pgt::thin;
  if (!valid(n, cin, h, wd, cout)) return 0;
  const dim3 g = bf16 ? wgrad_grid<__nv_bfloat16>(n, cin, h, wd, cout)
                      : wgrad_grid<float>(n, cin, h, wd, cout);
  long blocks = (long)g.x * g.y;
  if (bf16 && wd % 8 == 0) {
    const dim3 t = wgrad_tma_grid(n, cin, h, wd, cout);
    if ((long)t.x * t.y > blocks) blocks = (long)t.x * t.y;
  }
  const int ks = bf16 ? kstride<__nv_bfloat16>(cin) : kstride<float>(cin);
  return blocks * BN * 9 * ks;
}

// Blocks along the tiles of the forward (wgrad == 0) or the weight
// gradient on the current device, as the launches take them (the wgmma
// kernel's in bf16 at W % 8 == 0, for x and dy on 16 bytes); *per_sm
// receives the blocks one SM holds.
extern "C" int pgt_thin_conv_grid(int n, int cin, int h, int wd, int cout,
                                  int bf16, int wgrad, int* per_sm) {
  using namespace pgt::thin;
  if (!valid(n, cin, h, wd, cout)) return 0;
  if (wgrad && bf16 && wd % 8 == 0)
    return wgrad_tma_grid(n, cin, h, wd, cout, per_sm).x;
  if (wgrad)
    return bf16 ? wgrad_grid<__nv_bfloat16>(n, cin, h, wd, cout, per_sm).x
                : wgrad_grid<float>(n, cin, h, wd, cout, per_sm).x;
  return bf16 ? fwd_grid<__nv_bfloat16>(n, cin, h, wd, cout, per_sm).x
              : fwd_grid<float>(n, cin, h, wd, cout, per_sm).x;
}

// x [N, Cin, H, W] and dy [N, Cout, H, W], both bf16 or both fp32; dw
// [Cout, Cin, 3, 3] fp32; part: pgt_thin_conv_wgrad_scratch() floats.
// bf16 at W % 8 == 0 with x and dy on 16 bytes runs thin_wgrad_tma, the
// rest thin_wgrad; then the reduce. Returns cudaGetLastError(),
// cudaErrorInvalidValue for shapes the kernels do not take, or
// cudaErrorNotSupported where the driver offers no TMA map encoder.
extern "C" int pgt_thin_conv_wgrad(const void* x, const void* dy, void* part,
                                   void* dw, int n, int cin, int h, int wd,
                                   int cout, int bf16, void* stream) {
  using namespace pgt::thin;
  if (!valid(n, cin, h, wd, cout)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run_wgrad<__nv_bfloat16>(x, dy, part, dw, n, cin, h, wd, cout, st);
  return run_wgrad<float>(x, dy, part, dw, n, cin, h, wd, cout, st);
}
