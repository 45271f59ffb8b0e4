// Kernel F: block-sparse tap int8 conv with the wrap epilogue.
//
// Replaces the TPU kernel ops/pallas_conv.py:_sparse_kernel (via
// _sparse_call, conv2d_int8_pallas3 and deconv2d_int8_pallas3) of the JAX
// package.  The s2d/d2s rewrites of a 5x5/s2 layer into a 3x3/s1 conv
// (kernel A) leave 11 of the 36 (tap, phase-block) products structurally
// zero: the 5-tap kernel has no (m = 2, phase = 1) row or column.  This
// kernel runs only the 25 real ones, from a tap table the wrapper builds
// (ops/cuda_conv.py):
//   conv (s2d input, 4 input phase blocks of ci channels, 1 output block):
//     entry (mx, my, a*2+b, 0, w) for 2mx+a < 5 and 2my+b < 5;
//   deconv (1 input block, 4 output phase blocks of o channels, 9/6/6/4
//     taps each): entry (d+1, e+1, 0, px*2+py, w).
// Contract, tiling and epilogue: conv_taps.cuh.  The halo modes are those
// of kernel A: with x_valid/y_valid the (s2d) input carries a 1-pixel halo
// and the conv is VALID on that axis.
//
// Bound on an H100 SXM: compute.  At 768x512 the 25 real products are
// 28.9 GMAC per image in all eight layers, against 45.75 GMAC for kernel
// A's dense forms of the default plan.  The kernel is the tensor-core
// implicit GEMM of conv_taps.cuh (mma.sync m16n8k32, cp.async ring), with
// two thin cases chosen by the wrapper from the shapes: input blocks under
// 32 channels (L0's 3-channel phase blocks) run as one im2col K of 75
// bytes, and output blocks under 8 channels (L7's 4 phases of 3) arrive
// merged into one block of 12 columns over the 9 tap positions, so the
// halo is staged once for all four phases.

#include "conv_taps.cuh"

// taps: n entries of 5 ints (row, col, cblk, oblk, widx), host memory.
// wp: the packed weights (T slices of (bn, kw), conv_taps.cuh).
extern "C" int sicn_conv_sparse_int8(const void* x, const void* wp,
                                     const void* bias, void* out,
                                     const int* taps, int n, int B, int X,
                                     int Y, int C, int kb, int bn, int nb,
                                     int T, int kw, int im2col, int tile,
                                     int relu, int x_valid, int y_valid,
                                     void* stream) {
  if (taps == nullptr || n < 0 || n > kMaxTaps)
    return (int)cudaErrorInvalidValue;
  ConvShape sh;
  sh.Xi = X;
  sh.Yi = Y;
  sh.C = C;
  sh.px = x_valid ? 0 : 1;
  sh.py = y_valid ? 0 : 1;
  sh.Xo = X - 2 * (1 - sh.px);
  sh.Yo = Y - 2 * (1 - sh.py);
  sh.kb = kb;
  sh.bn = bn;
  sh.nb = nb;
  sh.T = T;
  sh.kw = kw;
  sh.im2col = im2col;
  TapTable tab;
  tab.n = n;
  for (int i = 0; i < n; ++i) {
    tab.row[i] = taps[5 * i];
    tab.col[i] = taps[5 * i + 1];
    tab.cblk[i] = taps[5 * i + 2];
    tab.oblk[i] = taps[5 * i + 3];
    tab.widx[i] = taps[5 * i + 4];
  }
  return launch_conv_taps(x, wp, bias, out, B, sh, tab, tile, relu, stream);
}
