// Kernels C and E: interleaved-rANS decode.
//
// Kernel C replaces the TPU kernel codec/pallas_rans.py:_decode_kernel (via
// decode) of the JAX package: one fixed CDF row per lane, int8 symbols.
// Kernel E replaces codec/pallas_rans.py:_decode_ctx_kernel (via
// decode_ctx): the row of each symbol is ctx[s, t, k] of a shared (R, L+1)
// table, and symbols are int32 (the hyperprior's y alphabet has 256).  The
// TPU kernel materialised each step's rows with a one-hot MXU matmul at
// Precision.HIGHEST; here the search runs on the row in place, through
// __ldg (the 64 x 257 int32 table stays in L1/L2).
// Format: codec/ilrans.py.
//
// One block per stream, one thread per lane.  Per step t:
//   slot  = x & 0xFFFF
//   sym   = #{j in 1..L-1 : cdf[j] <= slot}   (binary search: rows increase)
//   x     = freq * (x >> 16) + slot - start    (u32 wrap)
//   need  = x < 2^16; rank = block exclusive scan of need
//   x     = (x << 16) | words[pos + rank]     for lanes that need a word
//   pos  += block total
// Reads past the buffer's capacity give 0, so a corrupt stream cannot read
// out of bounds; it ends with consumed != count or a final state != 2^16,
// which the caller checks.  The TPU kernel's VMEM window limit
// (max_supported_cap) and its butterfly word distribution do not apply.
//
// Bound on an H100 SXM: the serial chain of t dependent steps per lane
// (96 at the flagship geometry: a search of ~8 dependent L2 loads, a block
// scan and one word load each), not bytes: per 768x512 image kernel C reads
// at most 2N + t*N u16 words and writes 294,912 int8 symbols (~0.6 MB,
// ~0.2 us at 3.35 TB/s); kernel E also reads int32 contexts and writes
// int32 symbols (2.4 MB per image).

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

// kCtx: rows from ctx into a shared (R, L1) table; else lane k's row k.
template <typename Sym, bool kCtx>
__global__ void rans_decode_kernel(const int16_t* __restrict__ words,
                                   const int* __restrict__ x0,
                                   const int* __restrict__ ctx,
                                   const int* __restrict__ table,
                                   Sym* __restrict__ syms,
                                   int* __restrict__ consumed,
                                   int* __restrict__ x_fin, int cap, int T,
                                   int N, int R, int L1) {
  __shared__ int sh[32];
  const int s = blockIdx.x;
  const int k = threadIdx.x;
  const bool active = k < N;
  const int* row = table + (size_t)(kCtx || !active ? 0 : k) * L1;
  const int16_t* w = words + (size_t)s * cap;
  uint32_t x = active ? (uint32_t)x0[(size_t)s * N + k] : 0u;
  int pos = 2 * N;

  for (int t = 0; t < T; ++t) {
    int need = 0;
    if (active) {
      const size_t i = ((size_t)s * T + t) * N + k;
      if (kCtx) {
        int c = __ldg(ctx + i);
        c = c < 0 ? 0 : (c > R - 1 ? R - 1 : c);
        row = table + (size_t)c * L1;
      }
      const int slot = (int)(x & 0xFFFFu);
      // first j in [1, L1-1) with row[j] > slot, else L1-1
      int lo = 1, hi = L1 - 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(row + mid) <= slot) lo = mid + 1; else hi = mid;
      }
      const int sym = lo - 1;
      const uint32_t start = (uint32_t)__ldg(row + sym);
      const uint32_t freq = (uint32_t)__ldg(row + sym + 1) - start;
      x = freq * (x >> 16) + (uint32_t)slot - start;
      need = x < (1u << 16);
      syms[i] = (Sym)sym;
    }
    int total;
    const int r = block_exclusive_scan(need, &total, sh);
    if (need) {
      const int i = pos + r;
      const uint32_t wv = i < cap ? (uint32_t)(uint16_t)w[i] : 0u;
      x = (x << 16) | wv;
    }
    pos += total;
  }
  if (active) x_fin[(size_t)s * N + k] = (int)x;
  if (k == 0) consumed[s] = pos;
}

template <typename Sym, bool kCtx>
int launch(const void* words, const void* x0, const void* ctx,
           const void* table, void* syms, void* consumed, void* x_fin, int S,
           int cap, int T, int N, int R, int L1, void* stream) {
  const int threads = ((N + 31) / 32) * 32;
  if (S <= 0 || T <= 0 || N <= 0 || threads > 1024 || R <= 0 || L1 < 2 ||
      cap <= 0)
    return (int)cudaErrorInvalidValue;
  rans_decode_kernel<Sym, kCtx><<<S, threads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)words, (const int*)x0, (const int*)ctx,
      (const int*)table, (Sym*)syms, (int*)consumed, (int*)x_fin, cap, T, N,
      R, L1);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel C: lane_cdf (N, L1), int8 syms (S, T, N).
extern "C" int sicn_rans_decode(const void* words, const void* x0,
                                const void* lane_cdf, void* syms,
                                void* consumed, void* x_fin, int S, int cap,
                                int T, int N, int L1, void* stream) {
  return launch<int8_t, false>(words, x0, nullptr, lane_cdf, syms, consumed,
                               x_fin, S, cap, T, N, N, L1, stream);
}

// Kernel E: int32 ctx (S, T, N) into a shared table (R, L1), int32 syms.
extern "C" int sicn_rans_decode_ctx(const void* words, const void* x0,
                                    const void* ctx, const void* table,
                                    void* syms, void* consumed, void* x_fin,
                                    int S, int cap, int T, int N, int R,
                                    int L1, void* stream) {
  return launch<int32_t, true>(words, x0, ctx, table, syms, consumed, x_fin,
                               S, cap, T, N, R, L1, stream);
}
