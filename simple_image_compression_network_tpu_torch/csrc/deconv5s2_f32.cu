// Kernel G: flax's ConvTranspose(k=5, s=2, padding="SAME") in full float32,
// the four transposed convs of the hyperpriors' synthesis transform g_s.
//
// It replaces no Pallas kernel: the JAX package left g_s to XLA (flax's
// ConvTranspose in models/hyperprior.py).  The port ran it on cuDNN's
// deterministic dgrad (dgrad2d_alg1_1), at about a sixth of the card's
// float32 bound, and that layer paced the hyperprior decode (PERF.md).
//
//   out[b, o, 2q+py, 2r+px] = bias[o] + sum_{c, dy, dx} x[b, c, q+dy, r+dx]
//                                         * w[c, o, py+1-2dy, px+1-2dx]
//
// over dy, dx in {-1, 0, 1} whose kernel index lies in 0..4: an even
// output row takes 2 input rows (ky 3, 1), an odd one 3 (ky 4, 2, 0), and
// likewise for columns.  The four output phases are dense convs over the
// input grid with 2x2, 2x3, 3x2 and 3x3 taps, 25 in all, and nothing is
// multiplied by the zeros a dilated input would hold.  x outside the image
// reads 0.  This is PyTorch's conv_transpose2d(x, w, stride=2, padding=1)
// without its last row and column: the output is exactly 2H x 2W, so the
// SAME crop costs nothing.
//
// Layouts: x (B, C, H, W) float32 NCHW, bias (O,), out (B, O, 2H, 2W)
// NCHW, all contiguous.  The weights come packed by the wrapper
// (ops/cuda_deconv.py:pack_deconv5s2) as (n_ob, Cp, 25, NG * TNP): Cp is C
// rounded up to KC with zero rows, and column g*TNP + n of row (c, ky*5 +
// kx) in output block ob holds w[c, ob*NG*TN + g*TN + n, ky, kx] (zero
// past O, and in the TNP - TN columns that pad a group to 16 bytes).
//
// The implicit GEMM: M = the input-grid positions (b, q, r), each giving
// its 4 output phases; N = the output channels; K = (c, tap).  A block
// owns TQ x TR positions of one image and NG * TN channels.  Thread (g,
// i, j) holds 4 phases x R positions (row q0 + i, columns r0 + j*R ..) x
// TN channels of accumulators in registers.  The block walks C in chunks
// of KC channels through a ring of STAGES in dynamic shared memory, each
// stage the chunk's (TQ+2) x (TR+2) input halo and its KC x 25 weight
// rows, filled by cp.async (zero past the image's edges) while the
// previous stage multiplies.  Per channel a thread reads its R+2 inputs of
// each of the 3 input rows once (16-byte loads) and applies that row's
// taps to them: 25 * R * TN FFMAs a channel from 3 input-row reads and 25
// * TNP/4 weight reads, which the lanes of a group share (broadcast).  The
// epilogue adds the bias and writes each output row's 2R values of a
// thread as 16-byte stores; a warp's stores fill whole 128-byte lines.
//
// Numbers: products and sums in float32 by fmaf (FFMA), no tensor cores
// and so no TF32 rounding of the operands.  Every output sums its channels
// in order, and within a channel its taps by dy then dx, into one
// accumulator, then adds the bias: one fixed order with no split of K and
// no atomics, the same in every variant and for every position.  The
// output is the same bits from run to run, for an image alone or in any
// batch, and for a tile of rows (the sharded codec's g_s) as for the whole
// image.
//
// What bounds it on an H100 SXM: operations.  A layer is 25 * C * O FMAs a
// position: g_s at B = 8, 768x512, is 115.7 GFMA, 3.45 ms at the 67
// TFLOP/s float32 peak of the CUDA cores, against ~1.1 GB of activations
// in and out (~0.33 ms at 3.35 TB/s).  So the tile keeps the FFMA pipe fed:
// 800 FFMAs a channel a thread against 34 shared-memory reads in the main
// form (R = 8, TN = 4: 128 accumulators, 8 warps an SM), 8 channels a
// stage, and each stage's copies issued two stages ahead.  The RGB layer
// (O = 3) has its own form: one group of 3 channels (a 16-byte weight row
// a tap) and 16 x 64 positions a block, so that 3 channels still give
// each thread 600 FFMAs a channel and its 786,432 positions at B = 8 fill
// the card.  PERF.md has each layer's time against its bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 4-byte async copy; reads nothing and writes 0 when nbytes is 0.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int nbytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(nbytes) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A block tile: TQ x TR input-grid positions, NG groups of TN output
// channels, R positions a thread, KC channels a stage, STAGES stages.
template <int TQ, int TR, int R, int TN, int NG, int KC, int STAGES>
struct Tile {
  static constexpr int THREADS = NG * TQ * (TR / R);
  static constexpr int TNP = (TN + 3) / 4 * 4;   // a group's weight columns
  static constexpr int BN = NG * TNP;            // a packed weight row
  static constexpr int COLS = TR + 2;            // halo columns
  static constexpr int ROW = (COLS + 3) / 4 * 4; // their pitch
  static constexpr int IN_CH = (TQ + 2) * ROW;   // a channel's halo
  static constexpr int X_STAGE = KC * IN_CH;
  static constexpr int W_STAGE = KC * 25 * BN;
  static constexpr int STAGE = X_STAGE + W_STAGE;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE * sizeof(float);
  static_assert(TR % R == 0 && R % 4 == 0, "16-byte input reads");
  static_assert(W_STAGE % 4 == 0 && X_STAGE % 4 == 0, "aligned stages");
};

template <int TQ, int TR, int R, int TN, int NG, int KC, int STAGES,
          int MINB>
__global__ void __launch_bounds__(NG * TQ * (TR / R), MINB)
deconv5s2_f32_kernel(const float* __restrict__ x,
                     const float* __restrict__ wp,
                     const float* __restrict__ bias,
                     float* __restrict__ out, int C, int H, int W, int O,
                     int Cp, int tiles_r, int vec) {
  using T = Tile<TQ, TR, R, TN, NG, KC, STAGES>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int j = tid % (TR / R);                 // column group
  const int i = (tid / (TR / R)) % TQ;          // row
  const int g = tid / (TQ * (TR / R));          // channel group
  const int tile_q = blockIdx.x / tiles_r, tile_r = blockIdx.x % tiles_r;
  const int q0 = tile_q * TQ, r0 = tile_r * TR;
  const int ob = blockIdx.y, b = blockIdx.z;
  const float* xb = x + (size_t)b * C * H * W;
  const float* wb = wp + (size_t)ob * Cp * 25 * T::BN;
  const int n_chunks = Cp / KC;

  // Stage s: the input halo of channels [s*KC, s*KC + KC) (rows q0-1 ..
  // q0+TQ, columns r0-1 .. r0+TR; zero outside the image and past C) and
  // their KC x 25 packed weight rows (contiguous).
  auto issue = [&](int s) {
    float* xs = smem + (s % STAGES) * T::STAGE;
    float* ws = xs + T::X_STAGE;
    const int c0 = s * KC;
    for (int e = tid; e < KC * (TQ + 2) * T::COLS; e += T::THREADS) {
      const int kc = e / ((TQ + 2) * T::COLS);
      const int rem = e - kc * ((TQ + 2) * T::COLS);
      const int row = rem / T::COLS, col = rem - row * T::COLS;
      const int c = c0 + kc, gy = q0 - 1 + row, gx = r0 - 1 + col;
      const bool ok = c < C && gy >= 0 && gy < H && gx >= 0 && gx < W;
      const float* src = ok ? xb + ((size_t)c * H + gy) * W + gx : x;
      cp_async4(smem_u32(xs + kc * T::IN_CH + row * T::ROW + col), src,
                ok ? 4 : 0);
    }
    const float* wsrc = wb + (size_t)c0 * 25 * T::BN;
    for (int e = tid; e < T::W_STAGE / 4; e += T::THREADS)
      cp_async16(smem_u32(ws + 4 * e), wsrc + 4 * e);
  };

  float acc[2][2][R][TN];
#pragma unroll
  for (int py = 0; py < 2; ++py)
#pragma unroll
    for (int px = 0; px < 2; ++px)
#pragma unroll
      for (int m = 0; m < R; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) acc[py][px][m][n] = 0.f;

#pragma unroll 1
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks) issue(s);
    cp_async_commit();
  }

#pragma unroll 1
  for (int s = 0; s < n_chunks; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (s + STAGES - 1 < n_chunks) issue(s + STAGES - 1);
    cp_async_commit();

    const float* xs = smem + (s % STAGES) * T::STAGE + i * T::ROW + j * R;
    const float* ws = smem + (s % STAGES) * T::STAGE + T::X_STAGE +
                      g * T::TNP;
#pragma unroll 1
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {             // input row q + a - 1
        float xv[R + 2];
        const float* xr = xs + kc * T::IN_CH + a * T::ROW;
#pragma unroll
        for (int k = 0; k < R; k += 4) {
          const float4 v = *reinterpret_cast<const float4*>(xr + k);
          xv[k] = v.x;
          xv[k + 1] = v.y;
          xv[k + 2] = v.z;
          xv[k + 3] = v.w;
        }
        const float2 t = *reinterpret_cast<const float2*>(xr + R);
        xv[R] = t.x;
        xv[R + 1] = t.y;
#pragma unroll
        for (int py = 0; py < 2; ++py) {
          const int ky = py + 3 - 2 * a;        // py + 1 - 2 dy
          if (ky < 0 || ky > 4) continue;
#pragma unroll
          for (int bx = 0; bx < 3; ++bx) {      // input column r + bx - 1
#pragma unroll
            for (int px = 0; px < 2; ++px) {
              const int kx = px + 3 - 2 * bx;
              if (kx < 0 || kx > 4) continue;
              float wv[T::TNP];
              const float* wr = ws + (kc * 25 + ky * 5 + kx) * T::BN;
#pragma unroll
              for (int n = 0; n < T::TNP; n += 4) {
                const float4 v = *reinterpret_cast<const float4*>(wr + n);
                wv[n] = v.x;
                wv[n + 1] = v.y;
                wv[n + 2] = v.z;
                wv[n + 3] = v.w;
              }
#pragma unroll
              for (int m = 0; m < R; ++m)
#pragma unroll
                for (int n = 0; n < TN; ++n)
                  acc[py][px][m][n] =
                      fmaf(xv[m + bx], wv[n], acc[py][px][m][n]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // Epilogue: the bias, then the thread's 2R output columns of each of its
  // two output rows per channel.
  const int q = q0 + i;
  if (q >= H) return;
  const int rb = r0 + j * R;
#pragma unroll
  for (int n = 0; n < TN; ++n) {
    const int o = (ob * NG + g) * TN + n;
    if (o >= O) break;
    const float bv = bias[o];
#pragma unroll
    for (int py = 0; py < 2; ++py) {
      float* orow = out + (((size_t)b * O + o) * 2 * H + 2 * q + py) *
                              (size_t)(2 * W);
      if (vec && rb + R <= W) {
#pragma unroll
        for (int m = 0; m < R; m += 2)
          *reinterpret_cast<float4*>(orow + 2 * (rb + m)) =
              make_float4(acc[py][0][m][n] + bv, acc[py][1][m][n] + bv,
                          acc[py][0][m + 1][n] + bv,
                          acc[py][1][m + 1][n] + bv);
      } else {
#pragma unroll
        for (int m = 0; m < R; ++m) {
          if (rb + m < W) {
            orow[2 * (rb + m)] = acc[py][0][m][n] + bv;
            orow[2 * (rb + m) + 1] = acc[py][1][m][n] + bv;
          }
        }
      }
    }
  }
}

template <int TQ, int TR, int R, int TN, int NG, int KC, int STAGES,
          int MINB>
int launch(const void* x, const void* wp, const void* bias, void* out,
           int B, int C, int H, int W, int O, cudaStream_t stream) {
  using T = Tile<TQ, TR, R, TN, NG, KC, STAGES>;
  // above 48 KB only by this opt-in
  const cudaError_t attr = cudaFuncSetAttribute(
      deconv5s2_f32_kernel<TQ, TR, R, TN, NG, KC, STAGES, MINB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const long long tiles_r = (W + TR - 1) / TR;
  const long long tiles = ((H + TQ - 1) / TQ) * tiles_r;
  const long long n_ob = (O + NG * TN - 1) / (NG * TN);
  if (tiles > 0x7fffffffLL || n_ob > 65535) return (int)cudaErrorInvalidValue;
  const int Cp = (C + KC - 1) / KC * KC;
  // 16-byte output stores: every output row starts 16-byte aligned
  const int vec = (W % 2 == 0) &&
                  ((reinterpret_cast<uintptr_t>(out) & 15) == 0);
  const dim3 grid((unsigned)tiles, (unsigned)n_ob, (unsigned)B);
  deconv5s2_f32_kernel<TQ, TR, R, TN, NG, KC, STAGES, MINB>
      <<<grid, T::THREADS, T::SMEM, stream>>>(
      (const float*)x, (const float*)wp, (const float*)bias, (float*)out, C,
      H, W, O, Cp, (int)tiles_r, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Variants, in the order of ops/cuda_deconv.py:VARIANTS (TQ, TR, R, TN,
// NG, KC): 0 for O > 3 (32 channels a block), 1 for the RGB layer (O <= 3).
// Returns a cudaError_t.
extern "C" int sicn_deconv5s2_f32(const void* x, const void* wp,
                                  const void* bias, void* out, int B, int C,
                                  int H, int W, int O, int variant,
                                  void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || H <= 0 || W <= 0 || O <= 0 ||
      (reinterpret_cast<uintptr_t>(x) & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(wp) & 15) != 0 || (variant == 1 && O > 3))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case 0: return launch<4, 32, 8, 4, 8, 8, 3, 2>(x, wp, bias, out, B, C,
                                                    H, W, O, s);
    case 1: return launch<16, 64, 8, 3, 1, 4, 3, 2>(x, wp, bias, out, B, C,
                                                     H, W, O, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
