// Kernels C and E: interleaved-rANS decode.
//
// Kernel C replaces the TPU kernel codec/pallas_rans.py:_decode_kernel
// (:121, via decode) of the JAX package: one fixed CDF row per lane, int8
// symbols.  Kernel E replaces codec/pallas_rans.py:_decode_ctx_kernel
// (:275, via decode_ctx): the row of each symbol is ctx[s, t, k] of a
// shared (R, L+1) table, and symbols are int32 (the hyperprior's y alphabet
// has 256).  The TPU kernels compared each slot with the whole transposed
// table (E first built each step's rows with a one-hot MXU matmul) and
// spread the renorm words with a butterfly network; here each lane searches
// its row and reads its word at its rank.  Format: codec/ilrans.py.
//
// One block per stream, one thread per lane.  Per step t:
//   slot  = x & 0xFFFF
//   sym   = #{j in 1..L-1 : cdf[j] <= slot}   (rows non-decreasing)
//   x     = freq * (x >> 16) + slot - start    (u32 wrap)
//   need  = x < 2^16; rank = lanes before this one that need a word
//   x     = (x << 16) | words[pos + rank]     for lanes that need a word
//   pos  += the block's count of need
// Reads at or past the buffer's capacity give 0, so a corrupt stream cannot
// read out of bounds; it ends with consumed != count or a final state !=
// 2^16, which the caller checks.
//
// Bound on an H100 SXM: the serial chain of t dependent steps per lane (96
// at the flagship geometry), not bytes.  Per 768x512 image kernel C reads
// at most 2N + t*N u16 words and writes 294,912 int8 symbols (~0.6 MB,
// ~0.2 us at 3.35 TB/s); kernel E also reads int32 contexts and writes
// int32 symbols (2.4 MB per image, ~0.7 us).  The grid has 8 blocks an
// image (1 for the hyper-latent z), so nothing hides a step's latency: the
// time is t times the chain of one step.  The first design searched the
// CDF in global memory, 7-8 dependent __ldg probes whose 32 lanes touched
// 32 cache lines (C's rows are 520 B apart), then scanned the renorm flags
// with three barriers and loaded the word from global memory after the
// scan: ~2,900 cycles a step.
//
// This design keeps every load of the chain in shared memory and shortens
// the chain:
//  * The table is copied into shared memory once per block (16-byte
//    cp.async; the wrapper hands it over already in this layout, made once
//    per table).  C: entry j of lane k at j*npad + k (npad = N rounded up
//    to 32), so every probe of a warp hits 32 banks whatever each lane's
//    position: no bank conflict.  E: row r at r*pitch with an odd pitch
//    (L+1 | 1), chosen by scripts/rans_bank_conflicts.py at the hyper y
//    shape: 14.77 wavefronts a warp step for the search's 14 loads with
//    the trained model's contexts (14 is conflict-free) against 14.99 for
//    the transposed [j][r] layout, and 38.79 against 38.62 with uniform
//    contexts, where 3 or more rows meet in some bank by chance.
//  * The search resolves three probes a level (see `level`): 4 levels for
//    L+1 = 130, 129 or 257 where a binary search takes 7 or 8.  The first
//    level's entries do not depend on the slot, so they sit in registers
//    (C: once; E: loaded during the step before).  Then start and end are
//    one more pair of loads.
//  * The stream's words come through a ring of >= 3 chunks of npad words
//    in shared memory.  Each step, when the ring has room, every thread
//    loads one word of the next chunk into a register; it stores it one
//    step later, before that step's barrier.  A chunk loaded at step t is
//    read from step t+1 on, and the ring always holds >= N words past pos,
//    so the word a lane takes right after the barrier is in shared memory.
//  * The renorm flag is one bit: a ballot and a popcount give the rank in
//    the warp; each warp's count goes to a double-buffered slot, and after
//    the one barrier of the step two warp reductions of those slots give
//    the counts before this warp and in all.
//  * E's context for step t+1 is loaded during step t-1.
// A step is then, by its instructions' latencies, about 4 rounds of shared
// loads with their compares and selects (~300 cycles), the state update,
// ballot and count store (~120), the barrier, the load and reductions of
// the warp counts (~90) and the word's load (~70): ~600 cycles for one
// warp, more with 12 warps issuing together.  chip_smoke.py reports the
// measured time per step.
//
// Where the table and the ring do not fit one block's shared memory (N =
// 1024 lanes of 130 entries, say), the second instance searches the table
// in global memory in its own layout, with the same ring and scan.  The
// wrapper picks the instance by shape (cuda_rans.decode_staged_fits).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxDynamicSmem = 232448;  // one block's shared memory, sm_90
constexpr int kTotalsBytes = 2 * 32 * 4;  // two buffers of 32 warp counts
constexpr int kMaxDevices = 64;

// Words of the ring: a power of two of at least 3 chunks of npad words.
__host__ __device__ __forceinline__ int ring_words(int npad) {
  int r = 32;
  while (r < 3 * npad) r <<= 1;
  return r;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

template <bool kShared>
__device__ __forceinline__ int entry(const int* p) {
  if (kShared) return *p;
  return __ldg(p);
}

// One level of the search.  The row's entries are `stride` apart, p
// points at entry sym, and sym has len candidates, sym .. sym + len - 1.
// Three probes p1, p2, p3 at entries sym + q, + 2q, + 3q (q = len >> 2 >=
// 1; or q = 1 and two or one probes when len is 3 or 2, the others read as
// INT_MAX) are resolved at once: the probes <= slot are a prefix since the
// row does not decrease, and each moves sym on by q.  len - 3q candidates
// are left.
__device__ __forceinline__ void level(int v1, int v2, int v3, int slot,
                                      int q, const int* p1, const int* p2,
                                      const int* p3, const int*& p,
                                      int& sym) {
  const bool a1 = v1 <= slot, a2 = v2 <= slot, a3 = v3 <= slot;
  p = a2 ? (a3 ? p3 : p2) : (a1 ? p1 : p);
  sym = a2 ? (a3 ? sym + 3 * q : sym + 2 * q) : (a1 ? sym + q : sym);
}

// The levels that read the row at p (probes `stride` * q apart).
template <bool kShared>
__device__ __forceinline__ void probe_level(int slot, int stride, int& len,
                                            const int*& p, int& sym) {
  const int q = len >> 2, qo = q * stride;
  const int* p1 = p + qo;
  const int* p2 = p + 2 * qo;
  const int* p3 = p + 3 * qo;
  level(entry<kShared>(p1), entry<kShared>(p2), entry<kShared>(p3), slot, q,
        p1, p2, p3, p, sym);
  len -= 3 * q;
}

// kCtx: the row of each symbol is ctx[s, t, k] of a shared (R, L1) table
// (kernel E); else lane k's row k (kernel C).  kStaged: the table arrives
// in the staged layout (C: (L1, npad) lane-fastest; E: R rows of `pitch`)
// and is copied to shared memory; else it is searched in global memory in
// its (N or R, L1) layout, `pitch` = L1.
template <typename Sym, bool kCtx, bool kStaged>
__global__ void __launch_bounds__(1024, 1)
    rans_decode_kernel(const int16_t* __restrict__ words,
                       const int* __restrict__ x0,
                       const int* __restrict__ ctx,
                       const int* __restrict__ table,
                       Sym* __restrict__ syms, int* __restrict__ consumed,
                       int* __restrict__ x_fin, int cap, int T, int N, int R,
                       int L1, int pitch, int table_ints) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int npad = blockDim.x;
  const int rmask = ring_words(npad) - 1;
  const int tbl_bytes = kStaged ? 4 * table_ints : 0;
  int* tbl_s = reinterpret_cast<int*>(smem);
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem + tbl_bytes);
  int* totals = reinterpret_cast<int*>(smem + tbl_bytes + 2 * (rmask + 1));

  const int s = blockIdx.x;
  const int k = threadIdx.x;
  const int lane = k & 31;
  const int warp = k >> 5;
  const bool active = k < N;
  const int16_t* w = words + (size_t)s * cap;

  if (kStaged) {
    for (int i = k; i < table_ints / 4; i += npad)
      cp_async16(tbl_s + 4 * i, table + 4 * i);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  // the ring's first two chunks: words [2N, 2N + 2 npad)
  int pos = 2 * N;
  for (int c = 0; c < 2; ++c) {
    const int i = pos + c * npad + k;
    ring[i & rmask] = i < cap ? (uint16_t)w[i] : (uint16_t)0;
  }
  int pend = pos + 2 * npad;  // end of the words stored or in flight
  const int16_t* wnext = w + pend + k;  // this thread's word of the next
  bool in_flight = false;
  uint16_t pf = 0;  // this thread's word of the chunk in flight, if < cap
  bool pf_ok = false;
  uint32_t x = active ? (uint32_t)x0[(size_t)s * N + k] : 0u;
  Sym* out = syms + (size_t)s * T * N + k;  // this lane's symbols, N apart
  // E: this lane's contexts, N apart; the next step's is loaded a step ahead
  const int* cx = kCtx ? ctx + (size_t)s * T * N + k : ctx;
  int c_next = 0, c0 = 0;
  if (kCtx && active) {
    c0 = __ldg(cx);
    if (T > 1) c_next = __ldg(cx + N);
  }
  if (kCtx) cx += 2 * (size_t)N;

  const int* tb = kStaged ? tbl_s : table;
  const int n = L1 - 2;  // the search covers entries 1..n
  // entry j of this lane's row at tb[row + j * stride]
  const int stride = (!kCtx && kStaged) ? npad : 1;
  int row = 0;
  if (!kCtx) row = kStaged ? k : (active ? k * L1 : 0);
  // the first level's probes are the same for every slot: their entries
  // are loaded ahead, once (C) or a step ahead (E)
  const int len0 = n + 1;
  const int q0 = len0 >> 2;
  if (kStaged) asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  if (kCtx) row = min(max(c0, 0), R - 1) * pitch;
  int f1 = 0, f2 = 0, f3 = 0;
  if (q0 > 0) {
    f1 = entry<kStaged>(tb + row + q0 * stride);
    f2 = entry<kStaged>(tb + row + 2 * q0 * stride);
    f3 = entry<kStaged>(tb + row + 3 * q0 * stride);
  }

  for (int t = 0; t < T; ++t) {
    const int slot = (int)(x & 0xFFFFu);
    int sym = 0, len = len0;
    const int* p = tb + row;
    if (q0 > 0) {
      const int qo = q0 * stride;
      level(f1, f2, f3, slot, q0, p + qo, p + 2 * qo, p + 3 * qo, p, sym);
      len -= 3 * q0;
    }
    // rows of up to 257 entries take at most 3 more levels; wider ones loop
#pragma unroll
    for (int l = 0; l < 3; ++l)
      if (len >= 4) probe_level<kStaged>(slot, stride, len, p, sym);
    while (len >= 4) probe_level<kStaged>(slot, stride, len, p, sym);
    if (len > 1)  // 2 or 3 candidates: one level of 1 or 2 probes
      level(entry<kStaged>(p + stride),
            len > 2 ? entry<kStaged>(p + 2 * stride) : INT_MAX, INT_MAX,
            slot, 1, p + stride, p + 2 * stride, p, p, sym);
    const int start = entry<kStaged>(p);
    const int end = entry<kStaged>(p + stride);
    x = (uint32_t)(end - start) * (x >> 16) + (uint32_t)slot -
        (uint32_t)start;
    if (kCtx && t + 1 < T) {
      // the next step's row: its first probes load during this step
      row = min(max(c_next, 0), R - 1) * pitch;
      if (active && t + 2 < T) c_next = __ldg(cx);
      cx += N;
      if (q0 > 0) {
        f1 = entry<kStaged>(tb + row + q0);
        f2 = entry<kStaged>(tb + row + 2 * q0);
        f3 = entry<kStaged>(tb + row + 3 * q0);
      }
    }
    const bool need = active && x < (1u << 16);
    if (active) *out = (Sym)sym;
    out += N;
    const unsigned ballot = __ballot_sync(0xffffffffu, need);
    const int rank = __popc(ballot & ((1u << lane) - 1u));
    int* tot = totals + (t & 1) * 32;
    tot[warp] = __popc(ballot);
    // the chunk loaded at the last step goes into the ring; the next is
    // loaded when the ring has room for it beside every word a thread may
    // still read (from this step's pos on).  The load stays inside the
    // buffer (past cap it reads word 0 and stores 0), and its value is used
    // a step later, so nothing waits on it.
    if (in_flight) ring[(pend - npad + k) & rmask] = pf_ok ? pf : 0;
    in_flight = pend - pos + npad <= rmask + 1;
    if (in_flight) {
      pf_ok = pend + k < cap;
      pf = (uint16_t)*(pf_ok ? wnext : w);
      pend += npad;
      wnext += npad;
    }
    __syncthreads();
    const int cw = lane < (npad >> 5) ? tot[lane] : 0;
    const int total = __reduce_add_sync(0xffffffffu, cw);
    const int before = __reduce_add_sync(0xffffffffu, lane < warp ? cw : 0);
    const uint32_t word = ring[(pos + before + rank) & rmask];
    x = need ? (x << 16) | word : x;
    pos += total;
  }
  if (active) x_fin[(size_t)s * N + k] = (int)x;
  if (k == 0) consumed[s] = pos;
}

int staged_ints(bool ctx_rows, int npad, int R, int L1, int pitch) {
  return ctx_rows ? (R * pitch + 3) / 4 * 4 : L1 * npad;
}

template <typename Sym, bool kCtx, bool kStaged>
int launch(const void* words, const void* x0, const void* ctx,
           const void* table, void* syms, void* consumed, void* x_fin, int S,
           int cap, int T, int N, int R, int L1, int pitch, void* stream) {
  const int npad = ((N + 31) / 32) * 32;
  if (S <= 0 || T <= 0 || N <= 0 || npad > 1024 || R <= 0 || L1 < 2 ||
      cap <= 0 || pitch < L1)
    return (int)cudaErrorInvalidValue;
  const int tints = kStaged ? staged_ints(kCtx, npad, R, L1, pitch) : 0;
  const int bytes = 4 * tints + 2 * ring_words(npad) + kTotalsBytes;
  if (bytes > kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  auto kernel = rans_decode_kernel<Sym, kCtx, kStaged>;
  if (bytes > 48 * 1024) {
    static bool raised[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices || !raised[dev]) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kMaxDynamicSmem);
      if (err != cudaSuccess) return (int)err;
      if (dev < kMaxDevices) raised[dev] = true;
    }
  }
  kernel<<<S, npad, bytes, (cudaStream_t)stream>>>(
      (const int16_t*)words, (const int*)x0, (const int*)ctx,
      (const int*)table, (Sym*)syms, (int*)consumed, (int*)x_fin, cap, T, N,
      R, L1, pitch, tints);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel C: int8 syms (S, T, N).  staged: `table` is the (L1, npad)
// lane-fastest layout; else the (N, L1) lane table.
extern "C" int sicn_rans_decode(const void* words, const void* x0,
                                const void* table, void* syms,
                                void* consumed, void* x_fin, int S, int cap,
                                int T, int N, int L1, int staged,
                                void* stream) {
  return staged ? launch<int8_t, false, true>(words, x0, nullptr, table, syms,
                                              consumed, x_fin, S, cap, T, N,
                                              N, L1, L1, stream)
                : launch<int8_t, false, false>(words, x0, nullptr, table,
                                               syms, consumed, x_fin, S, cap,
                                               T, N, N, L1, L1, stream);
}

// Kernel E: int32 ctx (S, T, N) into a shared table of R rows, int32 syms.
// staged: `table` holds R rows of `pitch` entries (padded to 4 entries);
// else the (R, L1) table, and pitch is L1.
extern "C" int sicn_rans_decode_ctx(const void* words, const void* x0,
                                    const void* ctx, const void* table,
                                    void* syms, void* consumed, void* x_fin,
                                    int S, int cap, int T, int N, int R,
                                    int L1, int pitch, int staged,
                                    void* stream) {
  return staged ? launch<int32_t, true, true>(words, x0, ctx, table, syms,
                                              consumed, x_fin, S, cap, T, N,
                                              R, L1, pitch, stream)
                : launch<int32_t, true, false>(words, x0, ctx, table, syms,
                                               consumed, x_fin, S, cap, T, N,
                                               R, L1, L1, stream);
}
