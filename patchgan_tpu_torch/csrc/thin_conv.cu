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
// writes a 64 x 9 Cin fp32 dw, the same FLOPs over fewer bytes.
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
// - the forward stages the block's [9 Cin, 64] weight once and walks
//   several tiles with it;
// - the wgrad is a reduction over N * H * W pixels into a tiny output. A
//   block cannot carry a sum across the grid as the TPU's sequential grid
//   does, so each block sums the tiles of its share into an fp32 partial
//   [64, 9 Cin] in registers and stores it; a second pass adds the
//   partials in a fixed order. No atomics: runs are bit-reproducible, as
//   the instance-norm statistics are (in_common.cuh);
// - bf16 staging moves 8 channels of a position per 16-byte shared store:
//   channel-innermost 2-byte stores would conflict 8-16 ways.
#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "in_common.cuh"

namespace pgt {
namespace thin {

constexpr int TH = 2, TW = 64;             // output tile: rows x columns
constexpr int TM = TH * TW;                // output pixels of a tile
constexpr int HALO = (TH + 2) * (TW + 2);  // staged input positions
constexpr int BN = 64;                     // output channels of a block
constexpr int LDW = BN + 8;                // bf16 weight row stride
constexpr int LDC = TM + 4;                // fp32 epilogue stride
constexpr int LDD = TM + 8;                // bf16 dy row stride (wgrad)
constexpr int LDF = BN + 4;                // fp32 dy row stride (wgrad)
constexpr int FWD_THREADS = 128, WG_THREADS = 256;
// blocks that keep the 132 SMs of an H100 SXM busy: the forward holds
// 2-3 blocks per SM, the wgrad 2, and each wgrad block writes a partial
constexpr int FWD_TARGET = 4 * 132, WG_TARGET = 2 * 132;
constexpr int MAX_CIN = 32;
constexpr int MAX_KF = 9;  // fp32 wgrad: K = 9 Cin <= 288 in 16 columns

template <typename T>
struct Bf16 {
  static constexpr bool value = std::is_same<T, __nv_bfloat16>::value;
};

// weight rows per tap: bf16 pads Cin to the WMMA depth
template <typename T>
__host__ __device__ inline int kstride(int cin) {
  return Bf16<T>::value ? (cin + 15) / 16 * 16 : cin;
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

// Haloed input of a tile at xoff(position, ci), position = row * (TW + 2)
// + column from (row0 - 1, col0 - 1); channels from cin to cs are zero.
template <typename T>
__device__ void stage_x(const T* __restrict__ x, T* xs, const Tile& p,
                        int cin, int h, int wd, int cs) {
  const long plane = (long)h * wd;
  // global offset of channel ci at position pos, or -1 outside the image
  auto at = [&](int ci, int pos) -> long {
    const int rr = pos / (TW + 2), cc = pos - rr * (TW + 2);
    const int gy = p.row0 + rr - 1, gx = p.col0 + cc - 1;
    if (ci >= cin || gy < 0 || gy >= h || gx < 0 || gx >= wd) return -1;
    return ((long)p.n * cin + ci) * plane + (long)gy * wd + gx;
  };
  if constexpr (Bf16<T>::value) {
    // a task moves 8 channels of one position: eight loads, each
    // coalesced over the warp's neighbouring positions, and one 16-byte
    // store (2-byte stores at the cs stride conflict 8-16 ways)
    fill<4, uint4>(
        cs / 8 * HALO,
        [&](int i) {
          const int g = i / HALO, pos = i - g * HALO;
          unsigned b[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const long o = at(8 * g + j, pos);
            b[j] = o < 0 ? 0u : __bfloat16_as_ushort(x[o]);
          }
          return make_uint4(b[0] | b[1] << 16, b[2] | b[3] << 16,
                            b[4] | b[5] << 16, b[6] | b[7] << 16);
        },
        [&](int i, uint4 v) {
          const int g = i / HALO, pos = i - g * HALO;
          *reinterpret_cast<uint4*>(xs + xoff<T>(pos, 8 * g, cs)) = v;
        });
  } else {
    fill<8, T>(
        cs * HALO,
        [&](int i) {
          const long o = at(i / HALO, i % HALO);
          return o < 0 ? from_f32<T>(0.f) : x[o];
        },
        [&](int i, T v) { xs[xoff<T>(i % HALO, i / HALO, cs)] = v; });
  }
}

template <typename T>
size_t fwd_smem(int cin) {
  const size_t ws = (size_t)9 * kstride<T>(cin) *
                    (Bf16<T>::value ? LDW : BN) * sizeof(T);
  const size_t xs = (size_t)HALO * xstride<T>(cin) * sizeof(T);
  // bf16: the fp32 epilogue reuses the input tile's space
  const size_t cst = Bf16<T>::value ? (size_t)BN * LDC * sizeof(float) : 0;
  return ws + (xs > cst ? xs : cst);
}

// y[n, co, p] = sum_(r, s, ci) w[co, ci, r, s] x[n, ci, p + (r - 1, s - 1)]
// for the 64 output channels of blockIdx.y, over tiles [blockIdx.x * per,
// + per).
template <typename T>
__global__ void __launch_bounds__(FWD_THREADS)
    thin_fwd(const T* __restrict__ x, const T* __restrict__ w,
             T* __restrict__ y, int cin, int h, int wd, int cout, int tiles,
             int per) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool kTensorCores = Bf16<T>::value;
  const int ks = kstride<T>(cin), cs = xstride<T>(cin);
  const int ldw = kTensorCores ? LDW : BN;
  T* ws = reinterpret_cast<T*>(smem);
  T* xs = ws + 9 * ks * ldw;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int co0 = blockIdx.y * BN;

  // the block's weights, ws[(tap * ks + ci) * ldw + co], zero past cin
  // and cout: zeros first, then the weight read in its own (co, ci, tap)
  // order, so a warp's loads are contiguous
  for (int i = tid; i < 9 * ks * ldw; i += blockDim.x)
    ws[i] = from_f32<T>(0.f);
  __syncthreads();
  fill<8, T>(
      min(BN, cout - co0) * 9 * cin,
      [&](int i) { return w[(long)co0 * cin * 9 + i]; },
      [&](int i, T v) {
        const int c = i / (9 * cin), r = i - c * 9 * cin;
        ws[(r % 9 * ks + r / 9) * ldw + c] = v;
      });

  const int t1 = min(tiles, (blockIdx.x + 1) * per);
  for (int t = blockIdx.x * per; t < t1; ++t) {
    const Tile p = tile_at(t, h, wd);
    stage_x(x, xs, p, cin, h, wd, cs);
    __syncthreads();
    if constexpr (kTensorCores) {
      // warp: output row (warp >> 1) of the tile, 32 columns, 64 channels
      using namespace nvcuda;
      const int rowl = warp >> 1, cb = (warp & 1) * 32;
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
                a[i],
                xs + xoff<T>((rowl + r) * (TW + 2) + cb + 16 * i + s, c0, cs),
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
      __syncthreads();  // every warp is done with xs, which cs reuses
      float* cst = reinterpret_cast<float*>(xs);  // cst[co * LDC + pixel]
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::store_matrix_sync(cst + 16 * j * LDC + rowl * TW + cb + 16 * i,
                                  acc[i][j], LDC, wmma::mem_col_major);
      __syncthreads();
      for (int idx = tid; idx < BN * TM; idx += blockDim.x) {
        const int c = idx / TM, m = idx - c * TM;
        const int gy = p.row0 + m / TW, gx = p.col0 + m % TW, co = co0 + c;
        if (gy < h && gx < wd && co < cout)
          y[(((long)p.n * cout + co) * h + gy) * wd + gx] =
              from_f32<T>(cst[c * LDC + m]);
      }
    } else {
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
        base[i] = ((m / TW) * (TW + 2) + m % TW) * cs;
      }
      for (int tap = 0; tap < 9; ++tap) {
        const int toff = (tap / 3 * (TW + 2) + tap % 3) * cs;
        for (int ci = 0; ci < cin; ++ci) {
          float a[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = to_f32(xs[base[i] + toff + ci]);
          const T* wr = ws + (tap * ks + ci) * BN + warp * 16;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float b = to_f32(wr[j]);
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
            y[(((long)p.n * cout + co) * h + gy) * wd + gx] =
                from_f32<T>(acc[i][j]);
        }
      }
    }
    __syncthreads();  // before the next tile restages xs
  }
}

template <typename T>
size_t wgrad_smem(int cin) {
  const size_t dys = Bf16<T>::value ? (size_t)BN * LDD * sizeof(T)
                                    : (size_t)TM * LDF * sizeof(float);
  return dys + (size_t)HALO * xstride<T>(cin) * sizeof(T);
}

// Partial weight gradient of the 64 output channels of blockIdx.y over the
// tiles [blockIdx.x * per, + per) (vec: dy may be read 8 pixels at a
// time):
//   part[blk][co][tap * ks + ci] = sum_pixels dy[n, co, p] x[n, ci, p + tap]
// with blk = blockIdx.x * gridDim.y + blockIdx.y, fp32.
template <typename T>
__global__ void __launch_bounds__(WG_THREADS, 2)
    thin_wgrad(const T* __restrict__ x, const T* __restrict__ dy,
               float* __restrict__ part, int cin, int h, int wd, int cout,
               int tiles, int per, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool kTensorCores = Bf16<T>::value;
  const int ks = kstride<T>(cin), cs = xstride<T>(cin), kp = 9 * ks;
  T* dys = reinterpret_cast<T*>(smem);
  T* xs = reinterpret_cast<T*>(
      smem + (kTensorCores ? BN * LDD * sizeof(T) : TM * LDF * sizeof(float)));
  float* dyf = reinterpret_cast<float*>(smem);  // fp32: dyf[m * LDF + co]
  const int tid = threadIdx.x, warp = tid >> 5;
  const int co0 = blockIdx.y * BN;
  float* out =
      part + ((long)blockIdx.x * gridDim.y + blockIdx.y) * BN * (long)kp;

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
  } else {
#pragma unroll
    for (int j = 0; j < 2 * MAX_KF; ++j) {
      const int k = kg + 16 * j, tap = k / cin, ci = k - tap * cin;
      off[j] = k < kdim ? (tap / 3 * (TW + 2) + tap % 3) * cs + ci : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) accf[i][j] = 0.f;
    }
  }

  const int t1 = min(tiles, (blockIdx.x + 1) * per);
  for (int t = blockIdx.x * per; t < t1; ++t) {
    const Tile p = tile_at(t, h, wd);
    stage_x(x, xs, p, cin, h, wd, cs);
    // dy of the tile, zero outside the image and past cout
    auto dy_at = [&](int i) -> long {   // element i = (channel, pixel)
      const int c = i / TM, m = i - c * TM;
      const int gy = p.row0 + m / TW, gx = p.col0 + m % TW, co = co0 + c;
      if (gy >= h || gx >= wd || co >= cout) return -1;
      return (((long)p.n * cout + co) * h + gy) * wd + gx;
    };
    if (kTensorCores && vec) {
      // 8 pixels of a row a task, one 16-byte load and store
      fill<4, uint4>(
          BN * TM / 8,
          [&](int i) {
            const long o = dy_at(8 * i);
            return o < 0 ? make_uint4(0u, 0u, 0u, 0u)
                         : *reinterpret_cast<const uint4*>(dy + o);
          },
          [&](int i, uint4 v) {
            const int c = 8 * i / TM, m = 8 * i - c * TM;
            *reinterpret_cast<uint4*>(dys + c * LDD + m) = v;
          });
    } else {
      fill<8, T>(
          BN * TM,
          [&](int i) {
            const long o = dy_at(i);
            return o < 0 ? from_f32<T>(0.f) : dy[o];
          },
          [&](int i, T v) {
            const int c = i / TM, m = i - c * TM;
            if constexpr (kTensorCores)
              dys[c * LDD + m] = v;
            else
              dyf[m * LDF + c] = to_f32(v);
          });
    }
    __syncthreads();
    if constexpr (kTensorCores) {
      for (int m0 = 0; m0 < TM; m0 += 16) {
        const int rowl = m0 / TW, col = m0 % TW;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            a;
        wmma::load_matrix_sync(a, dys + 16 * cf * LDD + m0, LDD);
#pragma unroll
        for (int q = 0; q < MAX_KF; ++q) {
          const int kf = half + 2 * q;
          if (kf < nkf) {
            const int tap = kf / kfs, c0 = (kf - tap * kfs) * 16;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major>
                b;
            wmma::load_matrix_sync(
                b,
                xs + xoff<T>((rowl + tap / 3) * (TW + 2) + col + tap % 3, c0,
                             cs),
                16);
            wmma::mma_sync(acc[q], a, b, acc[q]);
          }
        }
      }
    } else {
      for (int m = 0; m < TM; ++m) {
        const int xb = ((m / TW) * (TW + 2) + m % TW) * cs;
        const float4 d = *reinterpret_cast<const float4*>(dyf + m * LDF +
                                                          4 * cg);
#pragma unroll
        for (int j = 0; j < 2 * MAX_KF; ++j) {
          const float a = to_f32(xs[xb + off[j]]);
          accf[0][j] = fmaf(d.x, a, accf[0][j]);
          accf[1][j] = fmaf(d.y, a, accf[1][j]);
          accf[2][j] = fmaf(d.z, a, accf[2][j]);
          accf[3][j] = fmaf(d.w, a, accf[3][j]);
        }
      }
    }
    __syncthreads();  // before the next tile restages dys and xs
  }

  if constexpr (kTensorCores) {
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
      const int k = kg + 16 * j;
      if (k < kdim)
#pragma unroll
        for (int i = 0; i < 4; ++i) out[(4 * cg + i) * kp + k] = accf[i][j];
    }
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

// tiles per block for a grid of about `target` blocks
inline int per_block(int tiles, int target) {
  return (tiles + target - 1) / target;
}

template <typename T>
int run_fwd(const void* x, const void* w, void* y, int n, int cin, int h,
            int wd, int cout, cudaStream_t st) {
  const int tiles = tiles_of(n, h, wd), cblks = (cout + BN - 1) / BN;
  const int per = per_block(tiles, max(1, FWD_TARGET / cblks));
  const size_t smem = fwd_smem<T>(cin);
  cudaFuncSetAttribute(thin_fwd<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid((tiles + per - 1) / per, cblks);
  thin_fwd<T><<<grid, FWD_THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      cin, h, wd, cout, tiles, per);
  return static_cast<int>(cudaGetLastError());
}

inline int wgrad_per(int n, int h, int wd, int cout) {
  const int cblks = (cout + BN - 1) / BN;
  return per_block(tiles_of(n, h, wd), max(1, WG_TARGET / cblks));
}

template <typename T>
int run_wgrad(const void* x, const void* dy, void* part, void* dw, int n,
              int cin, int h, int wd, int cout, cudaStream_t st) {
  const int tiles = tiles_of(n, h, wd), cblks = (cout + BN - 1) / BN;
  const int per = wgrad_per(n, h, wd, cout);
  const int nblk = (tiles + per - 1) / per;
  const size_t smem = wgrad_smem<T>(cin);
  cudaFuncSetAttribute(thin_wgrad<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  thin_wgrad<T><<<dim3(nblk, cblks), WG_THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<float*>(part), cin, h, wd, cout, tiles, per,
      // 16-byte dy loads: every 8-pixel run of a row is aligned and whole
      wd % 8 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0);
  const long outs = (long)cout * 9 * kstride<T>(cin);
  thin_wgrad_reduce<<<(outs + 31) / 32, dim3(32, RED_ROWS), 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), nblk, cblks,
      cin, cout, kstride<T>(cin));
  return static_cast<int>(cudaGetLastError());
}

inline bool valid(int n, int cin, int h, int wd, int cout) {
  return n > 0 && cin > 0 && cin <= MAX_CIN && h > 0 && wd > 0 && cout > 0;
}

}  // namespace thin
}  // namespace pgt

// x [N, Cin, H, W], w [Cout, Cin, 3, 3], y [N, Cout, H, W], all bf16
// (bf16 != 0) or all fp32; 1 <= Cin <= 32. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int pgt_thin_conv_fwd(const void* x, const void* w, void* y,
                                 int n, int cin, int h, int wd, int cout,
                                 int bf16, void* stream) {
  using namespace pgt::thin;
  if (!valid(n, cin, h, wd, cout)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run_fwd<__nv_bfloat16>(x, w, y, n, cin, h, wd, cout, st);
  return run_fwd<float>(x, w, y, n, cin, h, wd, cout, st);
}

// fp32 elements of the scratch `part` that pgt_thin_conv_wgrad needs.
extern "C" long pgt_thin_conv_wgrad_scratch(int n, int cin, int h, int wd,
                                            int cout, int bf16) {
  using namespace pgt::thin;
  if (!valid(n, cin, h, wd, cout)) return 0;
  const int per = wgrad_per(n, h, wd, cout), cblks = (cout + BN - 1) / BN;
  const long nblk = (tiles_of(n, h, wd) + per - 1) / per;
  const int ks = bf16 ? kstride<__nv_bfloat16>(cin) : kstride<float>(cin);
  return nblk * cblks * BN * 9 * ks;
}

// x [N, Cin, H, W] and dy [N, Cout, H, W], both bf16 or both fp32; dw
// [Cout, Cin, 3, 3] fp32; part: pgt_thin_conv_wgrad_scratch() floats.
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
