// Kernels B and D: interleaved-rANS encode with in-kernel stream compaction.
//
// Kernel B replaces the TPU kernel codec/pallas_rans.py:_encode_compact_kernel
// (-> _compact_encode_body, via encode_batch_compact with ctx=None) of the
// JAX package: int8 symbols, one fixed CDF row per lane.
// Kernel D replaces codec/pallas_rans.py:_encode_compact_ctx_kernel (-> the
// same body, via encode_batch_compact with ctx): int32 symbols, and each
// symbol's row is ctx[s, t, k] of a shared (R, L+1) table (the hyperprior's
// 64 scale bins).  The TPU kernel built each step's rows with a one-hot MXU
// matmul at Precision.HIGHEST; here a row is a plain indexed load, and the
// 64 x 257 int32 table (65,792 bytes) stays in L1/L2 through __ldg.
// Kernel H replaces codec/pallas_rans.py:_encode_kernel (via encode_batch):
// pass 1 alone, the same state chain as B, writing each step's candidate
// word (x & 0xFFFF) and need flag densely at its (s, t, k) place and the
// final states; codec/device_rans.py:assemble_stream compacts them after
// the kernel, as the JAX package's XLA scatter does.
// Format: codec/ilrans.py (32-bit state in [2^16, 2^32), 16-bit
// renormalisation words, 16-bit CDF precision, <= 1 word per symbol).
//
// One block per stream, one thread per lane.
//   Pass 1, t descending: the reverse state recurrence
//       need = (x >> 16) >= freq;  emit x & 0xFFFF;  if need: x >>= 16
//       x = ((x / freq) << 16) + x % freq + start
//     with start/freq from the symbol's CDF row (global memory; the rows
//     stay in L2).  Each step's word, or -1 for none, goes to a scratch
//     buffer the wrapper allocates.
//   Pass 2, t ascending: a block exclusive scan of the emit flags places
//     each word at 2N + base + rank; base advances by the step's total.
//   Header: (hi, lo) of the final state per lane, then counts = 2N + total.
// The TPU kernel's carry ring and butterfly network worked around VMEM
// store costs; here compaction is one scan and direct global stores.
//
// Bound on an H100 SXM: the serial chain of t state updates per lane (96 at
// the flagship geometry), with a 32-bit division each, not bytes: per
// 768x512 image kernel B reads 294,912 int8 symbols and writes at most
// 2N + t*N u16 words (~0.6 MB together, ~0.2 us at 3.35 TB/s); kernel D
// reads int32 symbols and contexts (2.4 MB per image); kernel H moves 9
// bytes per symbol (an int32 symbol in, an int32 word and a flag out), 2.7 MB
// per image, under 1 us at 3.35 TB/s.  The grid has only B*8 blocks of 384
// threads (B blocks of 256 for the hyper-latent), so most SMs idle at small
// batch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

// One step of the reverse recurrence for symbol i of lane k:
//   need = (x >> 16) >= freq;  word = x & 0xFFFF;  if need: x >>= 16
//   x = ((x / freq) << 16) + x % freq + start
// kCtx: the row is ctx[i] of a shared (R, L1) table; else lane k's row k.
template <typename Sym, bool kCtx>
__device__ __forceinline__ bool encode_step(const Sym* __restrict__ syms,
                                            const int* __restrict__ ctx,
                                            const int* __restrict__ table,
                                            int k, size_t i, int R, int L1,
                                            uint32_t& x, uint32_t& word) {
  // out-of-range input is the caller's error; clamp only so that the row
  // read stays inside the table
  int r = k;
  if (kCtx) {
    r = __ldg(ctx + i);
    r = r < 0 ? 0 : (r > R - 1 ? R - 1 : r);
  }
  const int* row = table + (size_t)r * L1;
  int sym = (int)syms[i];
  sym = sym < 0 ? 0 : (sym > L1 - 2 ? L1 - 2 : sym);
  const uint32_t start = (uint32_t)__ldg(row + sym);
  const uint32_t freq = (uint32_t)__ldg(row + sym + 1) - start;
  const bool need = (x >> 16) >= freq;
  word = x & 0xFFFFu;
  if (need) x >>= 16;
  x = ((x / freq) << 16) + x % freq + start;
  return need;
}

template <typename Sym, bool kCtx>
__global__ void rans_encode_kernel(const Sym* __restrict__ syms,
                                   const int* __restrict__ ctx,
                                   const int* __restrict__ table,
                                   int* __restrict__ scratch,
                                   int16_t* __restrict__ words,
                                   int* __restrict__ counts, int T, int N,
                                   int R, int L1, int W) {
  __shared__ int sh[32];
  const int s = blockIdx.x;
  const int k = threadIdx.x;
  const bool active = k < N;
  const size_t off = (size_t)s * T * N;
  uint32_t x = 1u << 16;

  if (active) {
    for (int t = T - 1; t >= 0; --t) {
      const size_t i = off + (size_t)t * N + k;
      uint32_t word;
      const bool need =
          encode_step<Sym, kCtx>(syms, ctx, table, k, i, R, L1, x, word);
      scratch[i] = need ? (int)word : -1;
    }
  }

  int16_t* wo = words + (size_t)s * W;
  if (active) {
    wo[2 * k] = (int16_t)(x >> 16);
    wo[2 * k + 1] = (int16_t)(x & 0xFFFFu);
  }
  int base = 2 * N;
  for (int t = 0; t < T; ++t) {
    const int e = active ? scratch[off + (size_t)t * N + k] : -1;
    const int f = e >= 0;
    int total;
    const int r = block_exclusive_scan(f, &total, sh);
    if (f) wo[base + r] = (int16_t)e;
    base += total;
  }
  if (k == 0) counts[s] = base;
}

template <typename Sym, bool kCtx>
int launch(const void* syms, const void* ctx, const void* table,
           void* scratch, void* words, void* counts, int S, int T, int N,
           int R, int L1, int W, void* stream) {
  const int threads = ((N + 31) / 32) * 32;
  if (S <= 0 || T <= 0 || N <= 0 || threads > 1024 || R <= 0 || L1 < 2 ||
      W < 2 * N + T * N)
    return (int)cudaErrorInvalidValue;
  rans_encode_kernel<Sym, kCtx><<<S, threads, 0, (cudaStream_t)stream>>>(
      (const Sym*)syms, (const int*)ctx, (const int*)table, (int*)scratch,
      (int16_t*)words, (int*)counts, T, N, R, L1, W);
  return (int)cudaGetLastError();
}

// Kernel H: pass 1 only, dense outputs, one block per stream.
__global__ void rans_encode_dense_kernel(const int* __restrict__ syms,
                                         const int* __restrict__ lane_cdf,
                                         int* __restrict__ emit,
                                         uint8_t* __restrict__ need,
                                         int* __restrict__ x_fin, int T,
                                         int N, int L1) {
  const int s = blockIdx.x;
  const int k = threadIdx.x;
  if (k >= N) return;
  const size_t off = (size_t)s * T * N;
  uint32_t x = 1u << 16;
  for (int t = T - 1; t >= 0; --t) {
    const size_t i = off + (size_t)t * N + k;
    uint32_t word;
    need[i] = encode_step<int, false>(syms, nullptr, lane_cdf, k, i, N, L1,
                                      x, word);
    emit[i] = (int)word;
  }
  x_fin[(size_t)s * N + k] = (int)x;
}

}  // namespace

// Kernel B: int8 syms (S, T, N), lane_cdf (N, L1).
extern "C" int sicn_rans_encode(const void* syms, const void* lane_cdf,
                                void* scratch, void* words, void* counts,
                                int S, int T, int N, int L1, int W,
                                void* stream) {
  return launch<int8_t, false>(syms, nullptr, lane_cdf, scratch, words,
                               counts, S, T, N, N, L1, W, stream);
}

// Kernel D: int32 syms and ctx (S, T, N), shared table (R, L1).
extern "C" int sicn_rans_encode_ctx(const void* syms, const void* ctx,
                                    const void* table, void* scratch,
                                    void* words, void* counts, int S, int T,
                                    int N, int R, int L1, int W,
                                    void* stream) {
  return launch<int32_t, true>(syms, ctx, table, scratch, words, counts, S,
                               T, N, R, L1, W, stream);
}

// Kernel H: int32 syms (S, T, N), lane_cdf (N, L1) -> emit (S, T, N) int32,
// need (S, T, N) uint8 flags, x_fin (S, N) u32 states.
extern "C" int sicn_rans_encode_dense(const void* syms, const void* lane_cdf,
                                      void* emit, void* need, void* x_fin,
                                      int S, int T, int N, int L1,
                                      void* stream) {
  const int threads = ((N + 31) / 32) * 32;
  if (S <= 0 || T <= 0 || N <= 0 || threads > 1024 || L1 < 2)
    return (int)cudaErrorInvalidValue;
  rans_encode_dense_kernel<<<S, threads, 0, (cudaStream_t)stream>>>(
      (const int*)syms, (const int*)lane_cdf, (int*)emit, (uint8_t*)need,
      (int*)x_fin, T, N, L1);
  return (int)cudaGetLastError();
}
