// Kernel A: fused 3x3 / stride-1 / SAME int8 conv with the wrap epilogue.
//
// Replaces the TPU kernel ops/pallas_conv.py:_flat_kernel (via
// conv3x3_s1_int8_flat) of the JAX package.  Every layer of the int8 codec
// reduces to this contract through the rewrites of ops/conv_fast.py.
//
//   out[b,i,j,n] = epi( sum_{dx,dy,c} x[b,i+dx-1,j+dy-1,c] * w3[dx,dy,c,n] )
//   epi(acc)     = max(((acc + bias[n] + 128) & 0xFF) - 128, 0)   (relu)
//
// Layouts: x (B,X,Y,C) int8 NHWC, w3 (3,3,C,N) int8 HWIO, bias (N,) int8,
// out (B,X,Y,N) int8; all contiguous.  Accumulation is int32: |acc| <=
// 9*C*128*128 < 2^31 for C < 14,563 (the net's widest input is C = 512).
//
// Bound on an H100 SXM: compute.  Per 768x512 image the eight layer forms
// are 45.75 GMAC = 91.5 G int8 ops, ~46 us at the 1,979 TOP/s dense int8
// tensor-core rate, against ~73 MB in and out (~22 us at 3.35 TB/s).
// This first version does not reach the tensor cores: it is a direct
// implicit-GEMM on __dp4a (4 int8 MACs per instruction), tiled as
// 8x16 output pixels x 64 output channels per block, with the input halo
// tile and the weight slice for 32 input channels staged in shared memory,
// 4 pixels x 8 channels of int32 accumulators per thread.  Channel counts
// that are not a multiple of 4 are zero-padded while packing (exact).
// wgmma/mma int8 and skipping the structurally zero taps of the rewrites
// (the TPU's _sparse_kernel) are the ways to the bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__global__ void __launch_bounds__(THREADS)
conv3x3_s1_int8_kernel(const int8_t* __restrict__ x,
                       const int8_t* __restrict__ w3,
                       const int8_t* __restrict__ bias,
                       int8_t* __restrict__ out,
                       int X, int Y, int C, int N, int relu, int vec) {
  // +1 word of padding per halo pixel keeps the pixel-strided reads
  // of a warp on distinct banks.
  __shared__ int xs[HX * HY][KW + 1];
  __shared__ __align__(16) int ws[9][KW][TN];

  const int tid = threadIdx.x;
  const int pg = tid & 31;        // pixel group: pixels pg + 32*p
  const int cg = tid >> 5;        // channel group = warp: weights broadcast
  const int tiles_y = (Y + TY - 1) / TY;
  const int x0 = (blockIdx.x / tiles_y) * TX;
  const int y0 = (blockIdx.x % tiles_y) * TY;
  const int n0 = blockIdx.y * TN;
  const int b = blockIdx.z;
  const int cw = (C + 3) >> 2;    // packed channel words per pixel

  int acc[PX][NC];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[p][j] = 0;

  const int8_t* xb = x + (size_t)b * X * Y * C;

  for (int k0 = 0; k0 < cw; k0 += KW) {
    // Stage the input halo tile: (HX*HY) pixels x KW words.
    for (int i = tid; i < HX * HY * KW; i += THREADS) {
      const int hp = i / KW, kw = i % KW;
      const int gx = x0 + hp / HY - 1, gy = y0 + hp % HY - 1;
      const int c = (k0 + kw) * 4;
      int v = 0;
      if (gx >= 0 && gx < X && gy >= 0 && gy < Y && c < C) {
        const int8_t* p = xb + ((size_t)gx * Y + gy) * C + c;
        if (vec) {
          v = *reinterpret_cast<const int*>(p);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (c + q < C) v |= (int)(uint8_t)p[q] << (8 * q);
        }
      }
      xs[hp][kw] = v;
    }
    // Stage the weight slice: 9 taps x KW words x TN channels, packing
    // 4 consecutive input channels of one output channel per word.
    for (int i = tid; i < 9 * KW * TN; i += THREADS) {
      const int n = i % TN, kw = (i / TN) % KW, tap = i / (TN * KW);
      const int gn = n0 + n, c = (k0 + kw) * 4;
      int v = 0;
      if (gn < N) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c + q < C)
            v |= (int)(uint8_t)w3[((size_t)tap * C + c + q) * N + gn]
                 << (8 * q);
      }
      ws[tap][kw][n] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dx = tap / 3, dy = tap % 3;
#pragma unroll
      for (int kw = 0; kw < KW; ++kw) {
        const int4 wa = *reinterpret_cast<const int4*>(&ws[tap][kw][cg * NC]);
        const int4 wb =
            *reinterpret_cast<const int4*>(&ws[tap][kw][cg * NC + 4]);
        const int wv[NC] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int p = 0; p < PX; ++p) {
          const int pix = pg + 32 * p;
          const int xv = xs[(pix / TY + dx) * HY + pix % TY + dy][kw];
#pragma unroll
          for (int j = 0; j < NC; ++j) acc[p][j] = __dp4a(xv, wv[j], acc[p][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int pix = pg + 32 * p;
    const int gx = x0 + pix / TY, gy = y0 + pix % TY;
    if (gx >= X || gy >= Y) continue;
    int8_t* o = out + (((size_t)b * X + gx) * Y + gy) * N;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int gn = n0 + cg * NC + j;
      if (gn < N) {
        int v = ((acc[p][j] + (int)bias[gn] + 128) & 0xFF) - 128;
        if (relu && v < 0) v = 0;
        o[gn] = (int8_t)v;
      }
    }
  }
}

}  // namespace

extern "C" int sicn_conv3x3_s1_int8(const void* x, const void* w3,
                                    const void* bias, void* out, int B, int X,
                                    int Y, int C, int N, int relu,
                                    void* stream) {
  if (B <= 0 || X <= 0 || Y <= 0 || C <= 0 || N <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int vec = (C % 4 == 0) && ((reinterpret_cast<uintptr_t>(x) & 3) == 0);
  const dim3 grid(((X + TX - 1) / TX) * ((Y + TY - 1) / TY),
                  (N + TN - 1) / TN, B);
  conv3x3_s1_int8_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w3, (const int8_t*)bias, (int8_t*)out,
      X, Y, C, N, relu, vec);
  return (int)cudaGetLastError();
}
