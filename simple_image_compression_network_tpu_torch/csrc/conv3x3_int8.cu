// Kernel A: fused 3x3 / stride-1 int8 conv with the wrap epilogue.
//
// Replaces two TPU kernels of the JAX package, which share one contract and
// differ only in their TPU memory layout: ops/pallas_conv.py:_flat_kernel
// (via conv3x3_s1_int8_flat; pixels flattened onto sublanes) and
// ops/pallas_conv.py:_conv3x3_kernel (via conv3x3_s1_int8 and
// conv3x3_s1_int8_any; (X, (Y+2)*Cp) lane layout).  On the card both are
// this one NHWC kernel.  Every layer of the int8 codec reduces to this
// contract through the rewrites of ops/conv_fast.py.
//
//   out[b,i,j,n] = epi( sum_{dx,dy,c} x[b,i+dx-px,j+dy-py,c] * w3[dx,dy,c,n] )
//   epi(acc)     = max(((acc + bias[n] + 128) & 0xFF) - 128, 0)   (relu)
//
// px = py = 1 is SAME padding.  With x_valid (px = 0) the input already
// carries a 1-pixel halo on X (the spatially sharded net's exchange) and
// the conv is VALID there: the output has X - 2 rows; y_valid likewise.
// Layouts: x (B,X,Y,C) int8 NHWC, bias (N,) int8, out (B,Xo,Yo,N) int8; the
// weights w3 (3,3,C,N) HWIO come packed K-major by the wrapper
// (ops/cuda_conv.py:pack_taps): (9, N, kw) with kw = C rounded up to 32,
// or, when C < 32 (im2col), (1, N, kw) with k = (dx*3+dy)*C + c and kw =
// 9C rounded up to 32.  Accumulation is int32: |acc| <= 9*C*128*128 < 2^31
// for C < 14,563 (the net's widest input is C = 512).
//
// Bound on an H100 SXM: compute.  Per 768x512 image the eight layer forms
// of the default plan are 45.75 GMAC = 91.5 G int8 ops, ~46 us at the
// 1,979 TOP/s dense int8 tensor-core rate, against ~73 MB in and out
// (~22 us at 3.35 TB/s).  The kernel is the implicit GEMM of conv_taps.cuh
// with the dense table of the 9 taps: mma.sync m16n8k32 on the int8 tensor
// cores, halo and weight slices staged by cp.async in a 2-stage ring, the
// 9 taps read from one staged halo at shifted ldmatrix addresses, and L0's
// 12 channels as one 108-byte im2col K.  It reaches about a fifth of the
// bound (PERF.md); what holds it back is in conv_taps.cuh.

#include "conv_taps.cuh"

extern "C" int sicn_conv3x3_s1_int8(const void* x, const void* wp,
                                    const void* bias, void* out, int B, int X,
                                    int Y, int C, int N, int kw, int im2col,
                                    int tile, int relu, int x_valid,
                                    int y_valid, void* stream) {
  ConvShape sh;
  sh.Xi = X;
  sh.Yi = Y;
  sh.C = C;
  sh.px = x_valid ? 0 : 1;
  sh.py = y_valid ? 0 : 1;
  sh.Xo = X - 2 * (1 - sh.px);
  sh.Yo = Y - 2 * (1 - sh.py);
  sh.kb = C;
  sh.bn = N;
  sh.nb = 1;
  sh.T = im2col ? 1 : 9;
  sh.kw = kw;
  sh.im2col = im2col;
  TapTable tab;
  tab.n = 9;
  for (int t = 0; t < 9; ++t) {
    tab.row[t] = t / 3;
    tab.col[t] = t % 3;
    tab.cblk[t] = 0;
    tab.oblk[t] = 0;
    tab.widx[t] = t;
  }
  return launch_conv_taps(x, wp, bias, out, B, sh, tab, tile, relu, stream);
}
