// The int8 tap-GEMM tile shared by kernel A (conv3x3_int8.cu, a dense table
// of the 9 taps of a 3x3 conv) and kernel F (conv_sparse_int8.cu, the 25
// real (tap, phase-block) products of the s2d/d2s rewrites).
//
// A tap table entry (row, col, cblk, oblk, widx) adds one GEMM to output
// block oblk:
//
//   acc[b,i,j,oblk,n] += sum_{c < kb} x[b, i+row-px, j+col-py, cblk*kb + c]
//                                     * w[widx, c, n]
//   out[b,i,j,oblk*bn + n] = max(((acc + bias[oblk*bn + n] + 128) & 0xFF)
//                                - 128, 0)                       (relu)
//
// px = 1 (SAME: rows outside the input read 0) or 0 (VALID: the input
// carries the 1-pixel halo and Xo = Xi - 2); py likewise.
// Layouts: x (B, Xi, Yi, C) int8 NHWC, w (T, kb, bn) int8, bias (nb*bn,)
// int8, out (B, Xo, Yo, nb*bn) int8; all contiguous.  Accumulation is
// int32; the wrappers keep |acc| <= taps * kb * 128 * 128 below 2^31.
//
// A block computes TX x TY output pixels x TN channels of one output block,
// with __dp4a (4 int8 MACs per instruction) on 4 channels packed per int32
// (channel counts off a multiple of 4 are zero-padded while packing, which
// is exact).  Per group of at most 9 consecutive entries with the same
// (oblk, cblk), and per chunk of KW packed words of that channel block, it
// stages the input halo tile once and the group's weight slices, then runs
// the group's taps.  Entries are ordered by (oblk, cblk) by the wrappers;
// a block skips the entries of other output blocks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 32;     // table entries per launch
constexpr int kGroup = 9;        // taps staged together (one 3x3 window)
constexpr int TX = 8;            // output rows per block
constexpr int TY = 16;           // output columns per block
constexpr int TN = 64;           // output channels per block
constexpr int KW = 8;            // packed channel words (4 x int8) per chunk
constexpr int HX = TX + 2;       // halo rows
constexpr int HY = TY + 2;       // halo columns
constexpr int THREADS = 256;
constexpr int PX = 4;            // pixels per thread
constexpr int NC = 8;            // output channels per thread
static_assert(PX * 32 == TX * TY, "32 pixel groups of PX pixels");
static_assert(NC * (THREADS / 32) == TN, "one channel group per warp");
static_assert(kMaxTaps <= THREADS, "one thread loads one table entry");

// row, col in 0..2; cblk: input channel block; oblk: output block;
// widx: weight slice.  Passed by value (kernel parameter space).
struct TapTable {
  int n;
  int row[kMaxTaps], col[kMaxTaps], cblk[kMaxTaps], oblk[kMaxTaps],
      widx[kMaxTaps];
};

struct ConvShape {
  int Xi, Yi, C;       // input extents and channels
  int Xo, Yo;          // output extents
  int px, py;          // 1 = SAME, 0 = VALID (input carries the halo)
  int kb, bn, nb;      // channels per input block, per output block; blocks
  int T;               // weight slices
};

// 3 blocks per SM: without the bound ptxas takes 110 registers (2 blocks),
// and kernel A's default forms ran 14% slower than at 80 (NVIDIA H100
// 80GB HBM3, 700.00 W).
__global__ void __launch_bounds__(THREADS, 3)
conv_taps_int8_kernel(const int8_t* __restrict__ x,
                      const int8_t* __restrict__ w,
                      const int8_t* __restrict__ bias,
                      int8_t* __restrict__ out, ConvShape sh, TapTable tab,
                      int relu, int vec) {
  // +1 word of padding per halo pixel keeps the pixel-strided reads
  // of a warp on distinct banks.
  __shared__ int xs[HX * HY][KW + 1];
  __shared__ __align__(16) int ws[kGroup][KW][TN];
  __shared__ int t_row[kMaxTaps], t_col[kMaxTaps], t_cblk[kMaxTaps],
      t_oblk[kMaxTaps], t_widx[kMaxTaps];

  const int tid = threadIdx.x;
  if (tid < tab.n) {
    t_row[tid] = tab.row[tid];
    t_col[tid] = tab.col[tid];
    t_cblk[tid] = tab.cblk[tid];
    t_oblk[tid] = tab.oblk[tid];
    t_widx[tid] = tab.widx[tid];
  }

  const int pg = tid & 31;        // pixel group: pixels pg + 32*p
  const int cg = tid >> 5;        // channel group = warp: weights broadcast
  const int tiles_y = (sh.Yo + TY - 1) / TY;
  const int tiles_n = (sh.bn + TN - 1) / TN;
  const int x0 = (blockIdx.x / tiles_y) * TX;
  const int y0 = (blockIdx.x % tiles_y) * TY;
  const int ob = blockIdx.y / tiles_n;
  const int n0 = (blockIdx.y % tiles_n) * TN;
  const int b = blockIdx.z;
  const int cwb = (sh.kb + 3) >> 2;   // packed words per input block
  // warps whose channels all lie past the block's width skip the products
  const bool live = n0 + cg * NC < sh.bn;

  int acc[PX][NC];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[p][j] = 0;

  const int8_t* xb = x + (size_t)b * sh.Xi * sh.Yi * sh.C;
  __syncthreads();

  int g0 = 0;
  while (g0 < tab.n) {
    if (t_oblk[g0] != ob) {
      ++g0;
      continue;
    }
    const int cb = t_cblk[g0];
    int g1 = g0 + 1;
    while (g1 < tab.n && g1 - g0 < kGroup && t_oblk[g1] == ob &&
           t_cblk[g1] == cb)
      ++g1;
    const int nt = g1 - g0;

    for (int k0 = 0; k0 < cwb; k0 += KW) {
      // Stage the input halo tile: (HX*HY) pixels x KW words.
      for (int i = tid; i < HX * HY * KW; i += THREADS) {
        const int hp = i / KW, kw = i % KW;
        const int gx = x0 + hp / HY - sh.px, gy = y0 + hp % HY - sh.py;
        const int cl = (k0 + kw) * 4;              // channel in the block
        int v = 0;
        if (gx >= 0 && gx < sh.Xi && gy >= 0 && gy < sh.Yi && cl < sh.kb) {
          const int8_t* p =
              xb + ((size_t)gx * sh.Yi + gy) * sh.C + cb * sh.kb + cl;
          if (vec) {
            v = *reinterpret_cast<const int*>(p);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (cl + q < sh.kb) v |= (int)(uint8_t)p[q] << (8 * q);
          }
        }
        xs[hp][kw] = v;
      }
      // Stage the group's weight slices: nt taps x KW words x TN channels,
      // packing 4 consecutive input channels of one output channel per word.
      for (int i = tid; i < nt * KW * TN; i += THREADS) {
        const int n = i % TN, kw = (i / TN) % KW, t = i / (TN * KW);
        const int gn = n0 + n, cl = (k0 + kw) * 4;
        const int8_t* wt = w + (size_t)t_widx[g0 + t] * sh.kb * sh.bn;
        int v = 0;
        if (gn < sh.bn) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (cl + q < sh.kb)
              v |= (int)(uint8_t)wt[(size_t)(cl + q) * sh.bn + gn] << (8 * q);
        }
        ws[t][kw][n] = v;
      }
      __syncthreads();

      if (live) {
#pragma unroll 1
        for (int t = 0; t < nt; ++t) {
          const int dx = t_row[g0 + t], dy = t_col[g0 + t];
#pragma unroll
          for (int kw = 0; kw < KW; ++kw) {
            const int4 wa =
                *reinterpret_cast<const int4*>(&ws[t][kw][cg * NC]);
            const int4 wb =
                *reinterpret_cast<const int4*>(&ws[t][kw][cg * NC + 4]);
            const int wv[NC] = {wa.x, wa.y, wa.z, wa.w,
                                wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int p = 0; p < PX; ++p) {
              const int pix = pg + 32 * p;
              const int xv = xs[(pix / TY + dx) * HY + pix % TY + dy][kw];
#pragma unroll
              for (int j = 0; j < NC; ++j)
                acc[p][j] = __dp4a(xv, wv[j], acc[p][j]);
            }
          }
        }
      }
      __syncthreads();
    }
    g0 = g1;
  }

  const int n_out = sh.nb * sh.bn;
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int pix = pg + 32 * p;
    const int gx = x0 + pix / TY, gy = y0 + pix % TY;
    if (gx >= sh.Xo || gy >= sh.Yo) continue;
    int8_t* o = out + (((size_t)b * sh.Xo + gx) * sh.Yo + gy) * n_out +
                (size_t)ob * sh.bn;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int gn = n0 + cg * NC + j;
      if (gn < sh.bn) {
        int v = ((acc[p][j] + (int)bias[ob * sh.bn + gn] + 128) & 0xFF) - 128;
        if (relu && v < 0) v = 0;
        o[gn] = (int8_t)v;
      }
    }
  }
}

// Validate and launch.  Returns a cudaError_t.
inline int launch_conv_taps(const void* x, const void* w, const void* bias,
                            void* out, int B, const ConvShape& sh,
                            const TapTable& tab, int relu, void* stream) {
  if (B <= 0 || B > 65535 || sh.Xo <= 0 || sh.Yo <= 0 || sh.C <= 0 ||
      sh.kb <= 0 || sh.bn <= 0 || sh.nb <= 0 || sh.T <= 0 ||
      sh.Xi != sh.Xo + 2 * (1 - sh.px) || sh.Yi != sh.Yo + 2 * (1 - sh.py) ||
      (sh.px != 0 && sh.px != 1) || (sh.py != 0 && sh.py != 1) ||
      tab.n < 0 || tab.n > kMaxTaps)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < tab.n; ++i) {
    if (tab.row[i] < 0 || tab.row[i] > 2 || tab.col[i] < 0 ||
        tab.col[i] > 2 || tab.cblk[i] < 0 ||
        (tab.cblk[i] + 1) * sh.kb > sh.C || tab.oblk[i] < 0 ||
        tab.oblk[i] >= sh.nb || tab.widx[i] < 0 || tab.widx[i] >= sh.T)
      return (int)cudaErrorInvalidValue;
    // every (oblk, cblk) run is contiguous: entries are sorted
    if (i && (tab.oblk[i] < tab.oblk[i - 1] ||
              (tab.oblk[i] == tab.oblk[i - 1] &&
               tab.cblk[i] < tab.cblk[i - 1])))
      return (int)cudaErrorInvalidValue;
  }
  const long long tiles_n = (sh.bn + TN - 1) / TN;
  if (tiles_n * sh.nb > 65535) return (int)cudaErrorInvalidValue;
  const int vec = (sh.kb % 4 == 0) && (sh.C % 4 == 0) &&
                  ((reinterpret_cast<uintptr_t>(x) & 3) == 0);
  const dim3 grid(((sh.Xo + TX - 1) / TX) * ((sh.Yo + TY - 1) / TY),
                  (unsigned)(tiles_n * sh.nb), B);
  conv_taps_int8_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const int8_t*)bias, (int8_t*)out,
      sh, tab, relu, vec);
  return (int)cudaGetLastError();
}

}  // namespace
