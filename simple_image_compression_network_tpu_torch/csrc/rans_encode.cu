// Kernels B and D: interleaved-rANS encode with in-kernel stream compaction.
//
// Kernel B replaces the TPU kernel codec/pallas_rans.py:_encode_compact_kernel
// (-> _compact_encode_body, via encode_batch_compact with ctx=None) of the
// JAX package: int8 symbols, one fixed CDF row per lane.
// Kernel D replaces codec/pallas_rans.py:_encode_compact_ctx_kernel (-> the
// same body, via encode_batch_compact with ctx): int32 symbols, and each
// symbol's row is ctx[s, t, k] of a shared (R, L+1) table (the hyperprior's
// 64 scale bins).  The TPU kernel built each step's rows with a one-hot MXU
// matmul at Precision.HIGHEST, and packed the words with a butterfly network
// and a carry ring around VMEM store costs; here a row is an indexed load
// and the words are placed by one scan of ballot counts.
// Kernel H replaces codec/pallas_rans.py:_encode_kernel (via encode_batch):
// pass 1 alone, writing each step's candidate word (x & 0xFFFF) and need
// flag densely at its (s, t, k) place and the final states;
// codec/device_rans.py:assemble_stream compacts them after the kernel, as
// the JAX package's XLA scatter does.
// Format: codec/ilrans.py (32-bit state in [2^16, 2^32), 16-bit
// renormalisation words, 16-bit CDF precision, <= 1 word per symbol).
//
// One block per stream, one thread per lane.  Pass 1, t descending, is the
// reverse state recurrence
//     need = (x >> 16) >= freq;  word = x & 0xFFFF;  if need: x >>= 16
//     x = ((x / freq) << 16) + x % freq + start
// with start and freq from the symbol's CDF row.  The stream is the 2N
// header words ((hi, lo) of each lane's final state), then the emitted
// words in t ascending, lane ascending order, then zeros to the buffer's
// width W; counts[s] = 2N + the words emitted.
//
// Bound on an H100 SXM: the serial chain of t state updates per lane (96 at
// the flagship geometry), not bytes: per 768x512 image kernel B reads
// 294,912 int8 symbols and writes at most 2N + t*N u16 words (~0.6 MB
// together, ~0.2 us at 3.35 TB/s); kernel D reads int32 symbols and
// contexts (2.4 MB per image).  The grid has 8 blocks an image (1 for the
// hyper-latent z), so nothing hides a step's latency.  The first design
// loaded the symbol (D: the context first), then two __ldg of the row that
// depend on it, divided, and stored the word to a global scratch inside
// each step, then placed the words with a block scan of three barriers a
// step: ~0.9 us, ~1,770 cycles, a step.
//
// This design leaves only the state's own arithmetic on the chain:
//  * Nothing a step loads depends on x.  The steps run in groups of kAhead;
//    a group's symbols (and D's contexts) load two groups ahead and its
//    start and freq are read from shared memory one group ahead, so a step
//    is the compare, the select, the division and the multiply-add.  A
//    group is one basic block (the T % kAhead steps above the first group
//    run first, one by one), so ptxas can interleave one step's divisor
//    reciprocal with another step's chain.
//  * The table is copied into shared memory once per block (16-byte
//    cp.async), in a layout the wrapper makes once per table tensor.  B:
//    entry j of lane k at j*npad + k as u16, 2^16 stored as 0 (99,840 bytes
//    at N = 384, L+1 = 130; every lane reads its own column, so a warp's 32
//    loads fall in 16 banks, two to a bank).  start is then exact for every
//    symbol of freq >= 1 (its start is below 2^16) and freq = ((end - start
//    - 1) & 0xFFFF) + 1 too; a symbol of freq 0 cannot be coded at all.  D:
//    row r at r*pitch, pitch = (L+1) | 1, as kernel E reads it.
//  * Each step's candidate word goes to a u16 slot (t, k) in shared memory
//    and each warp's emit mask (a ballot) to a (t, warp) entry: no barrier
//    in the step loop.  After the loop, one block scan of the T x W warp
//    counts in step-major, warp order gives each (t, warp) the offset of
//    its first word (three barriers: before, inside and after it); then
//    each lane writes its words at 2N + offset + popc(mask & lanes below
//    it), as predicated stores.  The kernel writes the zero tail itself, so
//    the wrapper allocates with torch.empty and needs no scratch.
//  * Lookups one group ahead need more than 64 registers a thread: the
//    staged instances take at most 512 lanes.
// The step's dependent chain is then 15 instructions of ptxas's own
// division (SASS); the least the recurrence needs is 8 (chip_smoke.py's
// CHAIN_CYCLES).  A step takes ~380 cycles at N = 384 (chip_smoke.py), far
// above either: 12 warps share an SM's 4 schedulers, so issue, not the
// chain, is taken to pace it (inferred from the SASS, not measured).
// Where the table, the slots and the masks do not fit one block's shared
// memory (t grows with the image: a 3840x2160 frame has t = 2,025 at N =
// 384, 1.75 MB of slots and masks), N > 512, or B's table has an entry
// outside [0, 2^16] or a last entry other than 2^16, the global instance
// keeps slots and masks in a scratch buffer the wrapper allocates and
// reads the table in global memory in its (N or R, L+1) int32 layout, with
// the same passes.  The wrapper picks the instance
// (cuda_rans.encode_kernel_table).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxDynamicSmem = 232448;  // one block's shared memory, sm_90
constexpr int kScanBytes = 32 * 4;       // one word count per warp
constexpr int kMaxDevices = 64;

// Where an instance reads its table.  kGlobal: the (N or R, L1) int32 table
// in global memory, slots and masks in the scratch.  kLaneU16 (B): the
// (L1, npad) lane-fastest entries as u16 (2^16 stored as 0) in shared
// memory.  kStaged (D): int32 rows at `pitch` in shared memory.
enum Table { kGlobal = 0, kLaneU16 = 1, kStaged = 2 };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

// Bytes of the staged table (a multiple of 16), as the wrapper makes it.
__host__ __device__ __forceinline__ int table_bytes(int tab, int npad, int R,
                                                    int L1, int pitch) {
  if (tab == kLaneU16) return 2 * L1 * npad;
  if (tab == kGlobal) return 0;
  return 4 * ((R * pitch + 3) / 4 * 4);
}

// Bytes of one stream's u16 word slots and (mask, offset) pairs.
__host__ __device__ __forceinline__ int slot_bytes(int T, int npad) {
  return 2 * T * npad + 8 * T * (npad >> 5);
}

// Where a thread reads its CDF entries: `row` points at entry 0 of its row
// (B: lane k's column; D: the table), entries `stride` apart.
template <int kTab>
struct Row {
  using E = typename std::conditional<kTab == kLaneU16, uint16_t, int>::type;
  const E* row;
  int stride;
};

// start and freq of symbol sym (D: in row r).  The u16 layout stores
// entry L1-1, 2^16, as 0: freq = ((end - start - 1) & 0xFFFF) + 1 is exact
// for every freq in 1..2^16.
template <bool kCtx, int kTab>
__device__ __forceinline__ void cdf_pair(const Row<kTab>& rw, int sym, int r,
                                         int pitch, uint32_t& start,
                                         uint32_t& freq) {
  const auto* p = rw.row + (kCtx ? r * pitch + sym : sym * rw.stride);
  const int step = kCtx ? 1 : rw.stride;
  uint32_t lo, hi;
  if constexpr (kTab == kGlobal) {
    lo = (uint32_t)__ldg(p);
    hi = (uint32_t)__ldg(p + step);
  } else {
    lo = (uint32_t)p[0];
    hi = (uint32_t)p[step];
  }
  start = lo;
  freq = kTab == kLaneU16 ? ((hi - lo - 1u) & 0xFFFFu) + 1u : hi - lo;
}

// Stores the u16 w at p where pred is non-zero, as one predicated store.
__device__ __forceinline__ void store_if(int16_t* p, uint16_t w,
                                         unsigned pred) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n"
      " @q st.global.u16 [%0], %1;\n}\n" ::"l"(__cvta_generic_to_global(p)),
      "h"(w), "r"(pred)
      : "memory");
}

// The staged instances take at most 512 threads (N <= 512), which leaves
// 128 registers a thread for the lookups a group ahead; the global instance
// takes up to 1024.
template <int kTab>
constexpr int max_threads() {
  return kTab == kGlobal ? 1024 : 512;
}

template <typename Sym, bool kCtx, int kTab>
__global__ void __launch_bounds__(max_threads<kTab>(), 1)
    rans_encode_kernel(const Sym* __restrict__ syms,
                       const int* __restrict__ ctx,
                       const void* __restrict__ table,
                       unsigned char* __restrict__ scratch,
                       int16_t* __restrict__ words, int* __restrict__ counts,
                       int T, int N, int R, int L1, int pitch, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kInShared = kTab != kGlobal;
  constexpr int kAhead = kInShared ? 8 : 4;  // steps a group
  const int npad = blockDim.x;
  const int nw = npad >> 5;
  const int s = blockIdx.x;
  const int k = threadIdx.x;
  const int lane = k & 31;
  const int warp = k >> 5;
  const bool active = k < N;
  const int tbytes = table_bytes(kTab, npad, R, L1, pitch);

  // shared memory: the warp counts of the scan, then (staged) the table,
  // the slots and the pairs; the global instance's are in the scratch
  int* wsum = reinterpret_cast<int*>(smem);
  unsigned char* tab = smem + kScanBytes;
  unsigned char* area = kInShared
                            ? tab + tbytes
                            : scratch + (size_t)s * slot_bytes(T, npad);
  uint16_t* slot = reinterpret_cast<uint16_t*>(area);
  int2* pair = reinterpret_cast<int2*>(area + 2 * T * npad);  // (mask, off)

  if (kInShared) {
    const unsigned char* src = static_cast<const unsigned char*>(table);
    for (int i = k; i < tbytes / 16; i += npad)
      cp_async16(tab + 16 * i, src + 16 * i);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  // this lane's symbols (and contexts), N apart; lanes past N read lane
  // 0's, and their steps are never emitted
  const size_t first = (size_t)s * T * N + (active ? k : 0);
  const Sym* sp = syms + first;
  const int* cp = kCtx ? ctx + first : ctx;
  int nsym[kAhead], nctx[kAhead];
  auto load_group = [&](int t0) {  // the symbols of steps t0 .. t0-kAhead+1
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      nsym[j] = (int)__ldg(sp + (t0 - j) * N);
      if (kCtx) nctx[j] = __ldg(cp + (t0 - j) * N);
    }
  };
  // The full groups of kAhead steps start at t0; the T % kAhead steps
  // above them run first, one by one.  Group g's symbols load two groups
  // ahead, its start and freq one group ahead.
  int t0 = T - 1 - T % kAhead;
  if (t0 >= 0) load_group(t0);
  if (kInShared) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  }
  Row<kTab> rw;
  if constexpr (kTab == kGlobal) {
    // row k of an (N, L1) table (lanes past N: row 0); D: the (R, L1) table
    rw.row = static_cast<const int*>(table) +
             (kCtx ? 0 : (active ? k : 0) * L1);
    rw.stride = 1;
  } else {
    rw.row = reinterpret_cast<const typename Row<kTab>::E*>(tab) +
             (kCtx ? 0 : k);
    rw.stride = kCtx ? 1 : npad;
  }
  uint32_t st[kAhead], fq[kAhead];
  auto look_up = [&]() {  // start and freq of the loaded symbols
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      // out-of-range input is the caller's error; clamp only so that the
      // reads stay inside the table
      const int sym = min(max(nsym[j], 0), L1 - 2);
      const int r = kCtx ? min(max(nctx[j], 0), R - 1) : 0;
      cdf_pair<kCtx, kTab>(rw, sym, r, pitch, st[j], fq[j]);
    }
  };

  // Pass 1, t descending.  Slots and masks are written at t*npad + k and
  // t*nw + warp; the pointers step back one step a step.
  uint32_t x = 1u << 16;
  uint16_t* my_slot = slot + (T - 1) * npad + k;
  int* my_mask = &pair[(T - 1) * nw + warp].x;
  auto step = [&](uint32_t start, uint32_t freq) {
    const bool need = active && (x >> 16) >= freq;
    *my_slot = (uint16_t)x;
    my_slot -= npad;
    const uint32_t y = need ? x >> 16 : x;
    x = ((y / freq) << 16) + y % freq + start;
    const unsigned m = __ballot_sync(0xffffffffu, need);
    if (lane == 0) *my_mask = (int)m;
    my_mask -= 2 * nw;
  };
  for (int t = T - 1; t > t0; --t) {
    uint32_t s1, f1;
    const int sym = min(max((int)__ldg(sp + t * N), 0), L1 - 2);
    const int r = kCtx ? min(max(__ldg(cp + t * N), 0), R - 1) : 0;
    cdf_pair<kCtx, kTab>(rw, sym, r, pitch, s1, f1);
    step(s1, f1);
  }
  if (t0 >= 0) {
    look_up();
    if (t0 >= kAhead) load_group(t0 - kAhead);
  }
  for (; t0 >= 0; t0 -= kAhead) {
    uint32_t cs[kAhead], cf[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      cs[j] = st[j];
      cf[j] = fq[j];
    }
    if (t0 >= kAhead) {  // the next group's lookups, the one after's loads
      look_up();
      if (t0 >= 2 * kAhead) load_group(t0 - 2 * kAhead);
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) step(cs[j], cf[j]);
  }
  __syncthreads();

  // One block scan of the T * nw warp counts, step-major then warp order:
  // thread k takes the entries [k * per, k * per + per).
  const int n_pairs = T * nw;
  const int per = (n_pairs + npad - 1) / npad;
  const int i0 = min(k * per, n_pairs);
  const int i1 = min(i0 + per, n_pairs);
  int own = 0;
  for (int i = i0; i < i1; ++i) own += __popc((unsigned)pair[i].x);
  int inc = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += v;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  const int cw = lane < nw ? wsum[lane] : 0;
  const int total = __reduce_add_sync(0xffffffffu, cw);
  int off = __reduce_add_sync(0xffffffffu, lane < warp ? cw : 0) + inc - own;
  for (int i = i0; i < i1; ++i) {
    const int c = __popc((unsigned)pair[i].x);
    pair[i].y = off;
    off += c;
  }
  __syncthreads();

  // Placement: lane k's word of step t at 2N + off[t][warp] + its rank
  int16_t* wo = words + (size_t)s * W;
  int16_t* payload = wo + 2 * N;
  const unsigned bit = 1u << lane, below = bit - 1u;
  const int2* pw = pair + warp;
  const uint16_t* sw = slot + k;
#pragma unroll 8
  for (int t = 0; t < T; ++t) {
    const int2 p = pw[t * nw];
    const uint16_t w = sw[t * npad];
    const unsigned m = (unsigned)p.x;
    store_if(payload + p.y + __popc(m & below), w, m & bit);
  }
  if (active) {
    wo[2 * k] = (int16_t)(x >> 16);
    wo[2 * k + 1] = (int16_t)(x & 0xFFFFu);
  }
  const int end = 2 * N + total;
  if (k == 0) counts[s] = end;
  // zeros from end to W: 16-byte stores between the aligned ends
  const size_t f0 = (size_t)s * W + end, f1 = (size_t)(s + 1) * W;
  const size_t a0 = (f0 + 7) & ~(size_t)7, a1 = f1 & ~(size_t)7;
  if (a0 >= a1) {
    for (size_t i = f0 + k; i < f1; i += npad) words[i] = 0;
  } else {
    if (f0 + k < a0) words[f0 + k] = 0;
    if (a1 + k < f1) words[a1 + k] = 0;
    uint4* body = reinterpret_cast<uint4*>(words + a0);
    const size_t n16 = (a1 - a0) >> 3;
    for (size_t i = k; i < n16; i += npad) body[i] = make_uint4(0, 0, 0, 0);
  }
}

template <typename Sym, bool kCtx, int kTab>
int launch(const void* syms, const void* ctx, const void* table,
           void* scratch, void* words, void* counts, int S, int T, int N,
           int R, int L1, int pitch, int W, void* stream) {
  const int npad = ((N + 31) / 32) * 32;
  if (S <= 0 || T <= 0 || N <= 0 || npad > 1024 || R <= 0 || L1 < 2 ||
      pitch < L1 || (long long)W < 2LL * N + (long long)T * N ||
      (kTab == kGlobal && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (npad > max_threads<kTab>()) return (int)cudaErrorInvalidValue;
  const long long bytes =
      kScanBytes + (kTab == kGlobal ? 0
                                    : (long long)table_bytes(kTab, npad, R,
                                                             L1, pitch) +
                                          slot_bytes(T, npad));
  if (bytes > kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  auto kernel = rans_encode_kernel<Sym, kCtx, kTab>;
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
  kernel<<<S, npad, (int)bytes, (cudaStream_t)stream>>>(
      (const Sym*)syms, (const int*)ctx, table, (unsigned char*)scratch,
      (int16_t*)words, (int*)counts, T, N, R, L1, pitch, W);
  return (int)cudaGetLastError();
}

// One step of the reverse recurrence for symbol i of lane k (kernel H):
//   need = (x >> 16) >= freq;  word = x & 0xFFFF;  if need: x >>= 16
//   x = ((x / freq) << 16) + x % freq + start
__device__ __forceinline__ bool encode_step(const int* __restrict__ syms,
                                            const int* __restrict__ table,
                                            int k, size_t i, int L1,
                                            uint32_t& x, uint32_t& word) {
  // out-of-range input is the caller's error; clamp only so that the row
  // read stays inside the table
  const int* row = table + (size_t)k * L1;
  int sym = syms[i];
  sym = sym < 0 ? 0 : (sym > L1 - 2 ? L1 - 2 : sym);
  const uint32_t start = (uint32_t)__ldg(row + sym);
  const uint32_t freq = (uint32_t)__ldg(row + sym + 1) - start;
  const bool need = (x >> 16) >= freq;
  word = x & 0xFFFFu;
  if (need) x >>= 16;
  x = ((x / freq) << 16) + x % freq + start;
  return need;
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
    need[i] = encode_step(syms, lane_cdf, k, i, L1, x, word);
    emit[i] = (int)word;
  }
  x_fin[(size_t)s * N + k] = (int)x;
}

}  // namespace

// Kernel B: int8 syms (S, T, N).  mode 0: `table` is the (N, L1) lane
// table, `scratch` holds S * (2 T npad + 8 T npad / 32) bytes; mode 1: the
// u16 (L1, npad) lane-fastest layout.  words (S, W) int16, counts (S,)
// int32.
extern "C" int sicn_rans_encode(const void* syms, const void* table,
                                void* scratch, void* words, void* counts,
                                int S, int T, int N, int L1, int W, int mode,
                                void* stream) {
  switch (mode) {
    case kGlobal:
      return launch<int8_t, false, kGlobal>(syms, nullptr, table, scratch,
                                            words, counts, S, T, N, N, L1,
                                            L1, W, stream);
    case kLaneU16:
      return launch<int8_t, false, kLaneU16>(syms, nullptr, table, nullptr,
                                             words, counts, S, T, N, N, L1,
                                             L1, W, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Kernel D: int32 syms and ctx (S, T, N) into a shared table of R rows.
// mode 0: the (R, L1) table in global memory (pitch L1) and the scratch of
// mode 0 above; mode 2: R rows of `pitch` entries, padded to 4 entries.
extern "C" int sicn_rans_encode_ctx(const void* syms, const void* ctx,
                                    const void* table, void* scratch,
                                    void* words, void* counts, int S, int T,
                                    int N, int R, int L1, int pitch, int W,
                                    int mode, void* stream) {
  switch (mode) {
    case kGlobal:
      return launch<int32_t, true, kGlobal>(syms, ctx, table, scratch, words,
                                            counts, S, T, N, R, L1, L1, W,
                                            stream);
    case kStaged:
      return launch<int32_t, true, kStaged>(syms, ctx, table, nullptr, words,
                                            counts, S, T, N, R, L1, pitch, W,
                                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
