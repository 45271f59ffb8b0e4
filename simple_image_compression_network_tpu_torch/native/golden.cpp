// Scalar integer golden model in C++ — an independent implementation of the
// reference's integer contract, cross-checked against the NumPy golden
// (ops/integer.py) and the port's int8 layers in tests.
//
// The port's own copy of the JAX package's native/golden.cpp, built at first
// use by utils/native_golden.py (g++, no PyTorch header) and loaded with
// ctypes.
//
// Semantics implemented exactly as the reference testbench computes them
// (conv3_nonsquare_tb.cpp:530-748 / conv.hpp:105-123): uint8 activations,
// int4 weights, accumulation wrapping in int8 (done here as wide accumulate
// + wrap, which is equivalent mod 256), bias add wrapping in int8, then
// ReLU on the signed value.
//
// Layout: feature maps [N][X][Y][C] row-major; weights [O][kx][ky][I].

#include <cstdint>
#include <cstring>

namespace {

inline int8_t wrap8(int64_t v) {
  return static_cast<int8_t>(static_cast<uint8_t>(v & 0xff));
}

}  // namespace

extern "C" {

// Strided conv k5/s2/p2 (conv2d, conv_nonsquare_top.cpp:216-280).
// x: uint8 [n][ix][iy][ci]; w: int8 [o][5][5][ci]; bias: int8 [o];
// out: int8 [n][ox][oy][o] with ox=ix/2, oy=iy/2.
void golden_conv2d(const uint8_t* x, const int8_t* w, const int8_t* bias,
                   int8_t* out, int64_t n, int64_t ix, int64_t iy, int64_t ci,
                   int64_t co) {
  const int64_t k = 5, s = 2, p = 2;
  const int64_t ox = (ix + 2 * p - k) / s + 1;
  const int64_t oy = (iy + 2 * p - k) / s + 1;
  for (int64_t ni = 0; ni < n; ++ni) {
    for (int64_t xi = 0; xi < ox; ++xi) {
      for (int64_t yi = 0; yi < oy; ++yi) {
        for (int64_t h = 0; h < co; ++h) {
          int64_t acc = 0;
          for (int64_t kx = 0; kx < k; ++kx) {
            const int64_t ux = xi * s + kx - p;
            if (ux < 0 || ux >= ix) continue;
            for (int64_t ky = 0; ky < k; ++ky) {
              const int64_t uy = yi * s + ky - p;
              if (uy < 0 || uy >= iy) continue;
              const uint8_t* xp = x + ((ni * ix + ux) * iy + uy) * ci;
              const int8_t* wp = w + ((h * k + kx) * k + ky) * ci;
              for (int64_t c = 0; c < ci; ++c) {
                acc += static_cast<int64_t>(xp[c]) * wp[c];
              }
            }
          }
          int8_t v = wrap8(acc + bias[h]);
          out[((ni * ox + xi) * oy + yi) * co + h] = v < 0 ? 0 : v;
        }
      }
    }
  }
}

// Transposed conv deconv522 (conv_nonsquare_top.cpp:82-195): zero-insertion
// to 2D + outer pad k-p-1, then VALID stride-1 conv.  out dims 2*ix x 2*iy.
void golden_deconv2d(const uint8_t* x, const int8_t* w, const int8_t* bias,
                     int8_t* out, int64_t n, int64_t ix, int64_t iy,
                     int64_t ci, int64_t co) {
  const int64_t k = 5, s = 2, p = 2;
  const int64_t outer = k - p - 1;  // 2
  const int64_t ox = s * ix, oy = s * iy;
  // padded dilated buffer index u holds x[i] at u = outer + s*i
  for (int64_t ni = 0; ni < n; ++ni) {
    for (int64_t xi = 0; xi < ox; ++xi) {
      for (int64_t yi = 0; yi < oy; ++yi) {
        for (int64_t h = 0; h < co; ++h) {
          int64_t acc = 0;
          for (int64_t kx = 0; kx < k; ++kx) {
            const int64_t u = xi + kx;             // position in padded buf
            if ((u - outer) % s) continue;
            const int64_t sx = (u - outer) / s;
            if (sx < 0 || sx >= ix) continue;
            for (int64_t ky = 0; ky < k; ++ky) {
              const int64_t v2 = yi + ky;
              if ((v2 - outer) % s) continue;
              const int64_t sy = (v2 - outer) / s;
              if (sy < 0 || sy >= iy) continue;
              const uint8_t* xp = x + ((ni * ix + sx) * iy + sy) * ci;
              const int8_t* wp = w + ((h * k + kx) * k + ky) * ci;
              for (int64_t c = 0; c < ci; ++c) {
                acc += static_cast<int64_t>(xp[c]) * wp[c];
              }
            }
          }
          int8_t v = wrap8(acc + bias[h]);
          out[((ni * ox + xi) * oy + yi) * co + h] = v < 0 ? 0 : v;
        }
      }
    }
  }
}

}  // extern "C"
