// The int8 tap-GEMM tile shared by kernel A (conv3x3_int8.cu, a dense table
// of the 9 taps of a 3x3 conv) and kernel F (conv_sparse_int8.cu, the 25
// real (tap, phase-block) products of the s2d/d2s rewrites), on the int8
// tensor cores (mma.sync m16n8k32 s8.s8.s32).
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
// Layouts: x (B, Xi, Yi, C) int8 NHWC, bias (nb*bn,) int8, out (B, Xo, Yo,
// nb*bn) int8; all contiguous.  The weights come packed K-major by the
// wrapper (ops/cuda_conv.py:pack_taps), zero-padded to kw bytes a row:
//   im2col = 0: (T, bn, kw), row n of slice widx holds w[widx, :, n];
//   im2col = 1: (nb, bn, kw), row n of slice oblk holds, for the j-th
//     table entry of that output block in table order, w[widx_j, c, n] at
//     k = j*kb + c: each pixel's whole K is one im2col row.
// Accumulation is int32 and wraps like __dp4a's (no .satfinite); the
// wrappers keep |acc| <= taps * kb * 128 * 128 below 2^31 anyway.
//
// The implicit GEMM: M = the TX x 16 output pixels of a block (one m16
// fragment is one output row of 16 pixels), N = BN output channels of one
// output block, K = (table entry, input channel).  8 warps split the block
// WM x (8 / WM); a warp holds MF x NF int32 accumulator fragments.  The
// block walks K in steps of KC = 128 bytes: per (entry, channel chunk) one
// weight slice (BN rows x 128 bytes), and per (input block, channel chunk)
// one halo tile ((TX+2) x 18 pixels x 128 bytes) that every tap of the run
// reads shifted.  Both ride a ring of 2 stages in dynamic shared memory,
// filled with 16-byte cp.async copies (zero-filled past the edges) while
// the other stage multiplies.  A fragments come from the halo with
// ldmatrix at one pixel-row address per lane, so any tap shift is a
// different address; rows are 144 bytes apart (9 x 16 B, odd), so the 8
// rows of one ldmatrix phase hit distinct banks.  B fragments come from the
// K-major weight rows with ldmatrix too.  In im2col mode (the wrapper's
// choice when kb < 32 and C <= 64) the block stages its input halo of all
// C channels once, and each A stage is each pixel's im2col row over the
// block's entries, built from it through a table of halo offsets: L0's
// 9 x 12 = 108 (kernel A) or 25 x 3 = 75 (kernel F) real K bytes take 4 or
// 3 k-steps in place of 9 or 25 padded ones.  The epilogue goes through a
// byte tile in shared memory, so the output leaves in 16-byte stores.
//
// What bounds it on an H100: at the net's layers the MACs (the int8
// tensor-core rate gives each layer a bound of 3-29 us at B = 2), but the
// tile reaches 8-26% of that (PERF.md): mma.sync issues at about half of
// wgmma's rate, a 2-stage ring of short iterations leaves the L2 latency
// partly exposed, and every block streams its weight slices from L2
// (M*N*K / BM bytes, the largest stream).  A wgmma version of this tile (A
// from registers, B by descriptor from core-matrix-tiled shared memory) was
// exact but slower in its first form; TMA multicast of the weights across a
// cluster and a deeper ring are the next steps.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 32;     // table entries per launch
constexpr int THREADS = 256;     // 8 warps
constexpr int TY = 16;           // output columns of a block = one m16 row
constexpr int KC = 128;          // K bytes a stage holds (4 mma k-steps)
constexpr int ROWB = KC + 16;    // shared row pitch: 9 x 16 B, odd
constexpr int STAGES = 2;        // cp.async ring depth
constexpr int kIm2colMaxC = 64;  // im2col mode stages all C channels
constexpr int kIm2colMaxK = 1024;  // and rows of at most this many bytes
static_assert(kMaxTaps <= THREADS, "one thread loads one table entry");
static_assert((ROWB / 16) % 2 == 1, "odd 16-byte pitch: ldmatrix phases "
                                    "free of bank conflicts");

// Block tiles (output pixels x output channels), each a (WM, MF, NF) of
// launch_conv_taps.  The order is ops/cuda_conv.py:TILES, the wrapper's
// index; the wrapper picks the largest that fills the card.
constexpr int kNumTiles = 7;
constexpr int kTileM[kNumTiles] = {128, 128, 128, 256, 64, 64, 256};
constexpr int kTileN[kNumTiles] = {128, 64, 48, 16, 128, 64, 48};

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
  int kw;              // packed bytes per weight row (multiple of 32)
  int im2col;          // 1: A is each pixel's im2col row (see above)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte async copy; the bytes past nbytes (all 16 when 0) are zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int nbytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(nbytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}

// d += a (16x32 s8, row) * b (32x8 s8, col), int32 accumulators.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where the K walk of one output block stands: entry e of the run
// [g0, g1) of entries with one input block, channel chunk kc, and the
// count of A stages (halo or im2col tiles) begun so far.
struct Cursor {
  int e, g0, g1, kc, epoch;
};

__device__ __forceinline__ int run_end(const int* t_cblk, int g, int ee) {
  const int cb = t_cblk[g];
  int e = g + 1;
  while (e < ee && t_cblk[e] == cb) ++e;
  return e;
}

// im2col mode's shared memory past the ring: the halo of `pixels` x C
// bytes (16-byte aligned), then kIm2colMaxK + KC offsets.
__host__ __device__ constexpr int im2col_halo_bytes(int pixels, int c) {
  return (pixels * c + 15) / 16 * 16;
}

template <int WM, int MF, int NF>
__global__ void __launch_bounds__(THREADS, 2)
conv_taps_mma_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w,
                     const int8_t* __restrict__ bias,
                     int8_t* __restrict__ out, ConvShape sh, TapTable tab,
                     int relu, int vec) {
  constexpr int WN = 8 / WM;
  constexpr int BM = WM * MF * 16, BN = WN * NF * 8;
  constexpr int TX = BM / TY, HX = TX + 2, HY = TY + 2;
  constexpr int A_BYTES = HX * HY * ROWB;   // also holds BM im2col rows
  constexpr int W_BYTES = BN * ROWB;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int t_row[kMaxTaps], t_col[kMaxTaps], t_cblk[kMaxTaps],
      t_oblk[kMaxTaps], t_widx[kMaxTaps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  if (tid < tab.n) {
    t_row[tid] = tab.row[tid];
    t_col[tid] = tab.col[tid];
    t_cblk[tid] = tab.cblk[tid];
    t_oblk[tid] = tab.oblk[tid];
    t_widx[tid] = tab.widx[tid];
  }
  const int tiles_y = (sh.Yo + TY - 1) / TY;
  const int tiles_n = (sh.bn + BN - 1) / BN;
  const int x0 = (blockIdx.x / tiles_y) * TX;
  const int y0 = (blockIdx.x % tiles_y) * TY;
  const int ob = blockIdx.y / tiles_n;
  const int n0 = (blockIdx.y % tiles_n) * BN;
  const int b = blockIdx.z;
  const int8_t* xb = x + (size_t)b * sh.Xi * sh.Yi * sh.C;
  const uint32_t a_base = smem_addr(smem);
  const uint32_t w_base = a_base + STAGES * A_BYTES;
  // im2col mode: the halo, then the offset table
  uint8_t* halo = smem + STAGES * (A_BYTES + W_BYTES);
  int* koff = reinterpret_cast<int*>(halo + im2col_halo_bytes(HX * HY, sh.C));
  const bool words = sh.kb % 4 == 0 && sh.C % 4 == 0;   // 4-aligned halo
  __syncthreads();

  // this output block's entries [eb, ee) (the table is sorted by oblk)
  int eb = 0;
  while (eb < tab.n && t_oblk[eb] < ob) ++eb;
  int ee = eb;
  while (ee < tab.n && t_oblk[ee] == ob) ++ee;
  const bool im2col = sh.im2col != 0;
  const int kreal = im2col ? (ee - eb) * sh.kb : sh.kb;  // K of one slice
  const int kpad = (kreal + 31) & ~31;
  const int nk = (kpad + KC - 1) / KC;                    // chunks a slice
  const int n_it = ee == eb ? 0 : (im2col ? nk : nk * (ee - eb));

  auto advance = [&](Cursor& c) {
    if (im2col) {
      ++c.kc;
      ++c.epoch;
    } else if (++c.e == c.g1) {
      c.e = c.g0;
      ++c.epoch;
      if (++c.kc == nk) {
        c.kc = 0;
        c.g0 = c.g1;
        c.e = c.g0;
        if (c.g0 < ee) c.g1 = run_end(t_cblk, c.g0, ee);
      }
    }
  };

  // Stage iteration `c` into ring slot `slot` (its A tile only when it
  // begins one).  Threads copy 16-byte pieces: (row, quarter of KC).
  auto issue = [&](const Cursor& c, int slot) {
    const int k0 = c.kc * KC;
    if (im2col) {
      // byte k of a pixel's im2col row is halo[pixel + koff[k]] (0 where
      // koff < 0); whole words when kb and C are multiples of 4
      const uint32_t dst0 = a_base + (c.epoch % STAGES) * A_BYTES;
      for (int i = tid; i < BM * (KC / 16); i += THREADS) {
        const int m = i / (KC / 16), q = i % (KC / 16);
        const uint8_t* px = halo + ((m / TY) * HY + m % TY) * sh.C;
        const int* ko = koff + k0 + q * 16;
        uint32_t v[4];
        if (words) {
#pragma unroll
          for (int t = 0; t < 4; ++t)
            v[t] = ko[4 * t] < 0
                       ? 0u
                       : *reinterpret_cast<const uint32_t*>(px + ko[4 * t]);
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            v[t] = 0;
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (ko[4 * t + u] >= 0)
                v[t] |= (uint32_t)px[ko[4 * t + u]] << (8 * u);
          }
        }
        *reinterpret_cast<uint4*>(smem + (dst0 - a_base) + m * ROWB +
                                  q * 16) = make_uint4(v[0], v[1], v[2],
                                                       v[3]);
      }
    } else if (c.e == c.g0) {
      const uint32_t dst0 = a_base + (c.epoch % STAGES) * A_BYTES;
      const int cofs = t_cblk[c.e] * sh.kb;
      for (int i = tid; i < HX * HY * (KC / 16); i += THREADS) {
        const int r = i / (KC / 16), q = i % (KC / 16);
        const int gx = x0 + r / HY - sh.px, gy = y0 + r % HY - sh.py;
        const bool in = gx >= 0 && gx < sh.Xi && gy >= 0 && gy < sh.Yi;
        const int k = k0 + q * 16;                // channel in the block
        const int8_t* p = xb + ((size_t)gx * sh.Yi + gy) * sh.C + cofs + k;
        const uint32_t dst = dst0 + r * ROWB + q * 16;
        if (vec) {
          const int nbytes = in && k < sh.kb ? 16 : 0;   // kb % 16 == 0
          cp_async16(dst, nbytes ? (const void*)p : (const void*)x, nbytes);
        } else {
          uint32_t v[4] = {0, 0, 0, 0};
          if (in) {
#pragma unroll
            for (int t = 0; t < 16; ++t)
              if (k + t < sh.kb)
                v[t >> 2] |= (uint32_t)(uint8_t)p[t] << (8 * (t & 3));
          }
          *reinterpret_cast<uint4*>(smem + (dst - a_base)) =
              make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
    }
    const int slice = im2col ? ob : t_widx[c.e];
    const int8_t* ws = w + (size_t)slice * sh.bn * sh.kw;
    const uint32_t wdst = w_base + slot * W_BYTES;
    for (int i = tid; i < BN * (KC / 16); i += THREADS) {
      const int n = i / (KC / 16), q = i % (KC / 16);
      const int gn = n0 + n, k = k0 + q * 16;
      const int nbytes = gn < sh.bn && k < sh.kw ? 16 : 0;  // kw % 32 == 0
      cp_async16(wdst + n * ROWB + q * 16,
                 nbytes ? (const void*)(ws + (size_t)gn * sh.kw + k)
                        : (const void*)w,
                 nbytes);
    }
  };

  // im2col mode: the input halo of all C channels, staged once, and the
  // halo offset of each byte of an im2col row (zeros outside the input and
  // past the block's entries); the rows are built from them.
  if (im2col) {
    if (sh.C % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 3) == 0) {
      const int cw = sh.C / 4;
      for (int i = tid; i < HX * HY * cw; i += THREADS) {
        const int r = i / cw, ch = i - r * cw;
        const int gx = x0 + r / HY - sh.px, gy = y0 + r % HY - sh.py;
        reinterpret_cast<uint32_t*>(halo)[i] =
            gx >= 0 && gx < sh.Xi && gy >= 0 && gy < sh.Yi
                ? reinterpret_cast<const uint32_t*>(
                      xb + ((size_t)gx * sh.Yi + gy) * sh.C)[ch]
                : 0u;
      }
    } else {
      for (int i = tid; i < HX * HY * sh.C; i += THREADS) {
        const int r = i / sh.C, ch = i - r * sh.C;
        const int gx = x0 + r / HY - sh.px, gy = y0 + r % HY - sh.py;
        halo[i] = gx >= 0 && gx < sh.Xi && gy >= 0 && gy < sh.Yi
                      ? (uint8_t)xb[((size_t)gx * sh.Yi + gy) * sh.C + ch]
                      : 0;
      }
    }
    for (int k = tid; k < nk * KC; k += THREADS) {
      const int j = k / sh.kb, en = eb + j;
      koff[k] = j < ee - eb ? (t_row[en] * HY + t_col[en]) * sh.C +
                                  t_cblk[en] * sh.kb + k - j * sh.kb
                            : -1;
    }
    __syncthreads();
  }

  int acc[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  Cursor ic = {eb, eb, eb, 0, 0};
  if (n_it) ic.g1 = im2col ? eb + 1 : run_end(t_cblk, eb, ee);
  Cursor cc = ic;

#pragma unroll 1
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_it) {
      issue(ic, s);
      advance(ic);
    }
    cp_async_commit();
  }

  // lane-constant parts of the ldmatrix addresses
  const int a_lane = (lane & 15) * ROWB + ((lane >> 4) << 4);
  const int b_lane = ((lane & 7) + ((lane >> 4) << 3)) * ROWB +
                     (((lane >> 3) & 1) << 4);
  const int hys = im2col ? TY : HY;

#pragma unroll 1
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nx = it + STAGES - 1;
    if (nx < n_it) {
      issue(ic, nx % STAGES);
      advance(ic);
    }
    cp_async_commit();

    const int dx = im2col ? 0 : t_row[cc.e], dy = im2col ? 0 : t_col[cc.e];
    const uint32_t a_s = a_base + (cc.epoch % STAGES) * A_BYTES + a_lane +
                         dy * ROWB;
    const uint32_t w_s = w_base + (it % STAGES) * W_BYTES + b_lane +
                         wn * NF * 8 * ROWB;
    const int ksteps = min(KC / 32, (kpad - cc.kc * KC) >> 5);
#pragma unroll
    for (int ks = 0; ks < KC / 32; ++ks) {
      if (ks < ksteps) {
        uint32_t a[MF][4];
#pragma unroll
        for (int mf = 0; mf < MF; ++mf)
          ldsm_x4(a[mf], a_s + ((wm * MF + mf + dx) * hys) * ROWB + ks * 32);
        uint32_t bf[NF][2];
#pragma unroll
        for (int p = 0; p < NF / 2; ++p) {
          uint32_t r[4];
          ldsm_x4(r, w_s + p * 16 * ROWB + ks * 32);
          bf[2 * p][0] = r[0];
          bf[2 * p][1] = r[1];
          bf[2 * p + 1][0] = r[2];
          bf[2 * p + 1][1] = r[3];
        }
        if (NF % 2)
          ldsm_x2(bf[NF - 1][0], bf[NF - 1][1],
                  w_s + (NF - 1) * 8 * ROWB + ks * 32);
#pragma unroll
        for (int mf = 0; mf < MF; ++mf)
#pragma unroll
          for (int nf = 0; nf < NF; ++nf)
            mma_s8(acc[mf][nf], a[mf], bf[nf][0], bf[nf][1]);
      }
    }
    advance(cc);
  }
  cp_async_wait<0>();
  __syncthreads();

  // Epilogue: accumulator (row g, cols 2t, 2t+1) and (row g+8, same)
  // through a BM x BN byte tile in shared memory (the ring's A stages),
  // then out to the pixel rows in 16-byte pieces where aligned.
  constexpr int OP = BN + 16;                 // pitch of the output tile
  static_assert(BM * OP <= STAGES * A_BYTES, "output tile fits");
  const int8_t* bo = bias + (size_t)ob * sh.bn;
#pragma unroll
  for (int mf = 0; mf < MF; ++mf) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (wm * MF + mf) * TY + (lane >> 2) + 8 * h;
#pragma unroll
      for (int nf = 0; nf < NF; ++nf) {
        const int n = wn * NF * 8 + nf * 8 + (lane & 3) * 2;
        int v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int cj = min(n0 + n + j, sh.bn - 1);   // bias stays in range
          v[j] = ((acc[mf][nf][2 * h + j] + (int)bo[cj] + 128) & 0xFF) - 128;
          if (relu && v[j] < 0) v[j] = 0;
        }
        *reinterpret_cast<uint16_t*>(smem + m * OP + n) =
            (uint16_t)((uint8_t)v[0] | ((uint8_t)v[1] << 8));
      }
    }
  }
  __syncthreads();
  const int n_out = sh.nb * sh.bn;
  const int width = min(BN, sh.bn - n0);      // channels of this tile
  int8_t* ob_out = out + (size_t)b * sh.Xo * sh.Yo * n_out +
                   (size_t)ob * sh.bn + n0;
  if (n_out % 16 == 0 && (ob * sh.bn + n0) % 16 == 0 && width % 16 == 0) {
    for (int i = tid; i < BM * (BN / 16); i += THREADS) {
      const int m = i / (BN / 16), q = i % (BN / 16);
      const int gx = x0 + m / TY, gy = y0 + m % TY;
      if (q * 16 < width && gx < sh.Xo && gy < sh.Yo)
        *reinterpret_cast<uint4*>(ob_out + ((size_t)gx * sh.Yo + gy) *
                                               n_out + q * 16) =
            *reinterpret_cast<const uint4*>(smem + m * OP + q * 16);
    }
  } else {
    for (int i = tid; i < BM * BN; i += THREADS) {
      const int m = i / BN, n = i % BN;
      const int gx = x0 + m / TY, gy = y0 + m % TY;
      if (n < width && gx < sh.Xo && gy < sh.Yo)
        ob_out[((size_t)gx * sh.Yo + gy) * n_out + n] =
            (int8_t)smem[m * OP + n];
    }
  }
}

template <int TILE, int WM, int MF, int NF>
int launch_tile(const void* x, const void* w, const void* bias, void* out,
                int B, const ConvShape& sh, const TapTable& tab, int relu,
                int vec, cudaStream_t stream) {
  constexpr int BM = WM * MF * 16, BN = (8 / WM) * NF * 8;
  constexpr int TX = BM / TY;
  constexpr int HXY = (TX + 2) * (TY + 2);          // halo pixels
  constexpr int ring = STAGES * (HXY + BN) * ROWB;
  constexpr int offsets = 4 * (kIm2colMaxK + KC);    // im2col mode
  const int smem =
      ring + (sh.im2col ? im2col_halo_bytes(HXY, sh.C) + offsets : 0);
  constexpr int smem_max =
      ring + im2col_halo_bytes(HXY, kIm2colMaxC) + offsets;
  static_assert(kTileM[TILE] == BM && kTileN[TILE] == BN, "tile table");
  static_assert(BM <= HXY, "im2col rows fit the A stage");
  // above 48 KB only by this opt-in
  const cudaError_t attr = cudaFuncSetAttribute(
      conv_taps_mma_kernel<WM, MF, NF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  if (attr != cudaSuccess) return (int)attr;
  const long long tiles_n = (sh.bn + BN - 1) / BN;
  if (tiles_n * sh.nb > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(((sh.Xo + TX - 1) / TX) * ((sh.Yo + TY - 1) / TY),
                  (unsigned)(tiles_n * sh.nb), B);
  conv_taps_mma_kernel<WM, MF, NF><<<grid, THREADS, smem, stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const int8_t*)bias, (int8_t*)out,
      sh, tab, relu, vec);
  return (int)cudaGetLastError();
}

// Validate and launch on block tile `tile` (kTileM/kTileN).  Returns a
// cudaError_t.
inline int launch_conv_taps(const void* x, const void* w, const void* bias,
                            void* out, int B, const ConvShape& sh,
                            const TapTable& tab, int tile, int relu,
                            void* stream) {
  if (B <= 0 || B > 65535 || sh.Xo <= 0 || sh.Yo <= 0 || sh.C <= 0 ||
      sh.kb <= 0 || sh.bn <= 0 || sh.nb <= 0 || sh.T <= 0 ||
      sh.Xi != sh.Xo + 2 * (1 - sh.px) || sh.Yi != sh.Yo + 2 * (1 - sh.py) ||
      (sh.px != 0 && sh.px != 1) || (sh.py != 0 && sh.py != 1) ||
      tab.n < 0 || tab.n > kMaxTaps || tile < 0 || tile >= kNumTiles ||
      sh.kw <= 0 || sh.kw % 32 != 0 || (sh.im2col != 0 && sh.im2col != 1) ||
      (sh.im2col && (sh.T < sh.nb || sh.C > kIm2colMaxC)) ||
      (reinterpret_cast<uintptr_t>(w) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  int per_block = 0, run = 0;
  for (int i = 0; i < tab.n; ++i) {
    if (tab.row[i] < 0 || tab.row[i] > 2 || tab.col[i] < 0 ||
        tab.col[i] > 2 || tab.cblk[i] < 0 ||
        (tab.cblk[i] + 1) * sh.kb > sh.C || tab.oblk[i] < 0 ||
        tab.oblk[i] >= sh.nb ||
        (!sh.im2col && (tab.widx[i] < 0 || tab.widx[i] >= sh.T)))
      return (int)cudaErrorInvalidValue;
    // every (oblk, cblk) run is contiguous: entries are sorted
    if (i && (tab.oblk[i] < tab.oblk[i - 1] ||
              (tab.oblk[i] == tab.oblk[i - 1] &&
               tab.cblk[i] < tab.cblk[i - 1])))
      return (int)cudaErrorInvalidValue;
    run = i && tab.oblk[i] == tab.oblk[i - 1] ? run + 1 : 1;
    per_block = run > per_block ? run : per_block;
  }
  // the packed rows hold the K they are read for
  if (sh.kw < (sh.im2col ? per_block * sh.kb : sh.kb) ||
      (sh.im2col && per_block * sh.kb > kIm2colMaxK))
    return (int)cudaErrorInvalidValue;
  const int vec = (sh.kb % 16 == 0) && (sh.C % 16 == 0) &&
                  ((reinterpret_cast<uintptr_t>(x) & 15) == 0);
  cudaStream_t s = (cudaStream_t)stream;
  switch (tile) {
    case 0: return launch_tile<0, 4, 2, 8>(x, w, bias, out, B, sh, tab,
                                           relu, vec, s);
    case 1: return launch_tile<1, 4, 2, 4>(x, w, bias, out, B, sh, tab,
                                           relu, vec, s);
    case 2: return launch_tile<2, 4, 2, 3>(x, w, bias, out, B, sh, tab,
                                           relu, vec, s);
    case 3: return launch_tile<3, 8, 2, 2>(x, w, bias, out, B, sh, tab,
                                           relu, vec, s);
    case 4: return launch_tile<4, 2, 2, 4>(x, w, bias, out, B, sh, tab,
                                           relu, vec, s);
    case 6: return launch_tile<6, 4, 4, 3>(x, w, bias, out, B, sh, tab,
                                           relu, vec, s);
    default: return launch_tile<5, 2, 2, 2>(x, w, bias, out, B, sh, tab,
                                            relu, vec, s);
  }
}

}  // namespace
