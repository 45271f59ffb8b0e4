// Kernels B and D: interleaved-rANS encode with in-kernel stream compaction;
// kernel H: the same recurrence with dense outputs.
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
// flag densely at its (s, t, k) place and the final states (its own
// design, below);
// codec/device_rans.py:assemble_stream compacts them after the kernel, as
// the JAX package's XLA scatter does.
// Format: codec/ilrans.py (32-bit state in [2^16, 2^32), 16-bit
// renormalisation words, 16-bit CDF precision, <= 1 word per symbol).
//
// B and D: one block per stream, one thread per lane.  Pass 1, t
// descending, is the reverse state recurrence
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
// division (SASS); the least the recurrence needs is 6 (chip_smoke.py's
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
//
// Kernel H writes 5 bytes a symbol (the int32 word, the flag byte) and
// reads 1 (int8) or 4: at the int8 latent (S = 16, t = 96, N = 384) its
// bytes (0.0011 ms at 3.35 TB/s) sit just below its chain of t steps
// (0.0012 ms), at a serving batch (S = 256) far above it (0.017 ms).  Its
// first design ran one block per stream (16 blocks at B = 2: 116 of 132
// SMs idle), loaded the int32 symbol and then its two CDF entries from
// global memory inside each step, and divided with ptxas's division: ~450
// cycles a step.  This design:
//  * blocks of kDenseLanes lanes (32) by `streams` streams (cuda_rans.
//    dense_streams: 4 at S = 16, 8 at S = 256), the ragged last lane block
//    and stream row masked, so any N and S run;
//  * B's lookahead: steps in groups of kDenseAhead, symbols two groups
//    ahead, the lookups one group ahead, into two buffers in turn so that
//    nothing is copied between groups;
//  * the table in shared memory as one packed 8-byte entry a (symbol,
//    lane): start, c = 2^16 - freq and freq's magic number
//    (cuda_rans.stage_lane_packed, made once per table tensor), laid out
//    so that a lane block's entries are one slab, copied by one bulk copy
//    of the Tensor Memory Accelerator; one LDS.64 a lookup, and the renorm
//    threshold one LOP3 from it.  A table without a u16 layout, or whose
//    slab does not fit, is read in global memory (its int32 rows and a
//    layout of magic numbers, cuda_rans.stage_lane_magic);
//  * the division by the magic number (dense_step): the chain is the
//    compare, the select, IMAD.HI (which can add y and carry out), IMAD.X
//    (the carry, bit 32), SHF.R.U64 and one IMAD: 6 instructions, 7 where
//    ptxas adds y by an IADD3 of its own (SASS);
//  * int8 symbols read as int8 (the Sym template), no cast before it;
//  * 32-bit offsets from each thread's bases (an address is one
//    IMAD.WIDE), and the word and the flag written by predicated stores,
//    so that a group stays one basic block.
// Measured on one H100 (scripts/torch_rans_ab.py): ~94 cycles a step at
// S = 16 (~41 instructions a step in chip_smoke.py's SASS count), ~2.7 us
// a call besides, and at S = 256 about 1.6x the byte bound.

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

// Kernel H: pass 1 alone, dense outputs.  A block is kDenseLanes threads
// by `streams` rows: thread (x, y) runs lane c * kDenseLanes + x of stream
// g * streams + y, for block g * nblk + c.  No lane depends on
// another (no compaction scan), so nothing ties a stream's lanes to one
// block; the rows of a block share its staged columns of the table.
constexpr int kDenseLanes = 32;  // lanes a block, one warp a stream row
constexpr int kDenseMaxThreads = 256;
constexpr int kDenseStaticSmem = 16;  // the bulk copy's mbarrier
constexpr int kDenseAhead = 8;  // steps a group

// One entry of the packed layout (kStaged; cuda_rans.stage_lane_packed):
// bits 0-15 start, 16-31 c = 2^16 - freq, 32-63 the magic number of freq.
// The layout is (nblk, L1 - 1, kDenseLanes): lane block c's entries are one
// contiguous slab, symbol j of its lane x at j * kDenseLanes + x.
struct __align__(8) Packed {
  uint32_t sc, m;
};

// What a lookup keeps until its step: the staged instance the packed
// entry; the global one start, freq (any u32: the row's difference) and
// the magic number.
template <int kTab>
struct Look {
  uint32_t sc, m;
};
template <>
struct Look<kGlobal> {
  uint32_t start, freq, m;
};

// start, c = 2^16 - freq, the renorm threshold thr and l = ceil(log2
// freq) of a lookup: from the lookup alone, so off the chain.
// ceil(log2 freq) from v = freq - 1: the position of v's highest set bit
// plus 1 (bfind gives 0xFFFFFFFF for v = 0, so freq = 1 gives 0).
__device__ __forceinline__ int ceil_log2_from(uint32_t v) {
  uint32_t b;
  asm("bfind.u32 %0, %1;" : "=r"(b) : "r"(v));
  return (int)(b + 1u);
}
__device__ __forceinline__ void derive(const Look<kStaged>& e,
                                       uint32_t& start, uint32_t& c,
                                       uint32_t& thr, int& l) {
  start = e.sc & 0xFFFFu;
  c = e.sc >> 16;
  thr = ~e.sc | 0xFFFFu;  // ~(c << 16): freq * 2^16 - 1, or 2^32 - 1
  l = ceil_log2_from(c ^ 0xFFFFu);  // freq - 1 = 2^16 - 1 - c
}
__device__ __forceinline__ void derive(const Look<kGlobal>& e,
                                       uint32_t& start, uint32_t& c,
                                       uint32_t& thr, int& l) {
  start = e.start;
  c = 65536u - e.freq;
  thr = e.freq >= 65536u ? 0xFFFFFFFFu : (e.freq << 16) - 1u;
  l = ceil_log2_from(e.freq - 1u);
}

// Bytes of shared memory of the staged instance: the block's part of the
// packed layout, (L1 - 1, kDenseLanes) entries of 8 bytes.
__host__ __device__ __forceinline__ int dense_table_bytes(int L1) {
  return 8 * (L1 - 1) * kDenseLanes;
}

// One bulk copy by the Tensor Memory Accelerator of `bytes` (a multiple of
// 16, both addresses 16-byte aligned) from global memory into this
// block's shared memory, completing on the mbarrier `bar`.  Issued by one
// thread; every thread then waits with bulk_wait.
__device__ __forceinline__ void bulk_copy(void* smem_dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  const uint32_t b = (uint32_t)__cvta_generic_to_shared(bar);
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(smem_dst);
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(d),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

__device__ __forceinline__ void bulk_wait(uint64_t* bar) {
  const uint32_t b = (uint32_t)__cvta_generic_to_shared(bar);
  asm volatile(
      "{\n .reg .pred p;\n"
      "wait_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
      " @!p bra wait_%=;\n}\n" ::"r"(b)
      : "memory");
}

// Stores the word w and the flag f at p and q where pred is non-zero, as
// two predicated stores (a branch would end the group's basic block).
__device__ __forceinline__ void store_word_flag(int* p, uint32_t w,
                                                uint8_t* q, uint32_t f,
                                                unsigned pred) {
  asm volatile(
      "{\n .reg .pred r;\n setp.ne.u32 r, %4, 0;\n"
      " @r st.global.b32 [%0], %1;\n @r st.global.u8 [%2], %3;\n}\n" ::"l"(
          __cvta_generic_to_global(p)),
      "r"(w), "l"(__cvta_generic_to_global(q)), "r"(f), "r"(pred)
      : "memory");
}

// One step of the reverse recurrence of kernel H with the division done by
// a magic number (Granlund and Montgomery's round-up method for 32-bit
// dividends: l = ceil(log2 freq), m = floor(2^32 (2^l - freq) / freq) + 1,
// floor(y / freq) = (hi32(y * m) + y) >> l, exact for every y < 2^32 and
// 1 <= freq < 2^32; cuda_rans.dense_quotient):
//   need = x > thr (thr = freq * 2^16 - 1, or 2^32 - 1 where freq >= 2^16)
//   y = need ? x >> 16 : x;  q = y / freq
//   x = y + q * c + start   (c = 2^16 - freq; = (q << 16) + y % freq + start)
// thr, l, c and y + start come from the lookups alone: the chain is the
// compare, the select, IMAD.HI, the 33-bit add and shift, and one IMAD.
__device__ __forceinline__ uint32_t dense_step(uint32_t x, uint32_t start,
                                               uint32_t c, uint32_t thr,
                                               int l, uint32_t m,
                                               bool& need) {
  need = x > thr;
  const uint32_t y = need ? x >> 16 : x;
  const uint32_t q =
      (uint32_t)(((unsigned long long)__umulhi(y, m) + y) >> l);
  return q * c + (y + start);
}

template <typename Sym, int kTab>
__global__ void __launch_bounds__(kDenseMaxThreads)
    rans_encode_dense_kernel(const Sym* __restrict__ syms,
                             const void* __restrict__ table,
                             const uint32_t* __restrict__ magic,
                             int* __restrict__ emit,
                             uint8_t* __restrict__ need,
                             int* __restrict__ x_fin, int S, int T, int N,
                             int L1, int nblk) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kInShared = kTab != kGlobal;
  const int npad = ((N + 31) / 32) * 32;
  const int g = blockIdx.x / nblk;
  const int c0 = (blockIdx.x - g * nblk) * kDenseLanes;
  const int tid = threadIdx.x;
  const int k = c0 + tid;
  const int s = g * blockDim.y + threadIdx.y;
  const bool active = k < N && s < S;
  // lanes past N and rows past S read lane 0 of stream S - 1
  const int kr = k < N ? k : 0;
  const int sr = s < S ? s : S - 1;

  // The staged instance copies its lane block's part of the packed layout,
  // one contiguous (L1 - 1, kDenseLanes) slab, with one bulk copy.
  __shared__ __align__(8) uint64_t bar;
  if (kInShared) {
    if (threadIdx.x == 0 && threadIdx.y == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       (uint32_t)__cvta_generic_to_shared(&bar))
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      const int bytes = dense_table_bytes(L1);
      bulk_copy(smem,
                static_cast<const unsigned char*>(table) +
                    (size_t)(blockIdx.x - g * nblk) * bytes,
                bytes, &bar);
    }
    __syncthreads();  // the barrier is initialised before anyone waits
  }
  // Each thread's inputs and outputs lie at base[t * N] from its own
  // bases: 32-bit offsets (T * N < 2^31, checked at launch), so that an
  // address is one IMAD.WIDE.
  const size_t first = (size_t)sr * T * N + kr;
  const Sym* sp = syms + first;
  // A group is kDenseAhead steps, t descending; its symbols load two
  // groups ahead and its lookups run one group ahead, into one of two
  // buffers (A for even groups, B for odd), so no value is copied.
  int symA[kDenseAhead], symB[kDenseAhead];
  Look<kTab> lkA[kDenseAhead], lkB[kDenseAhead];
  auto load = [&](int* sym, int t0) {  // steps t0 .. t0 - kDenseAhead + 1
#pragma unroll
    for (int j = 0; j < kDenseAhead; ++j)
      sym[j] = (int)__ldg(sp + ((t0 - j) * N));
  };
  const Packed* tp = reinterpret_cast<const Packed*>(smem) + tid;
  const int* row = static_cast<const int*>(table) + (size_t)kr * L1;
  auto cdf = [&](int sym) {
    // out-of-range input is the caller's error; clamp only so that the
    // reads stay inside the table
    sym = (int)min((uint32_t)sym, (uint32_t)(L1 - 2));
    Look<kTab> e;
    if constexpr (kInShared) {
      const Packed p = tp[sym * kDenseLanes];
      e.sc = p.sc;
      e.m = p.m;
    } else {
      e.start = (uint32_t)__ldg(row + sym);
      e.freq = (uint32_t)__ldg(row + sym + 1) - e.start;
      e.m = __ldg(magic + (size_t)sym * npad + kr);
    }
    return e;
  };
  auto look_up = [&](const int* sym, Look<kTab>* lk) {
#pragma unroll
    for (int j = 0; j < kDenseAhead; ++j) lk[j] = cdf(sym[j]);
  };

  uint32_t x = 1u << 16;
  int* const ep = emit + first;
  uint8_t* const fp = need + first;
  int off = (T - 1) * N;  // this step's offset
  auto step = [&](const Look<kTab>& e) {
    uint32_t start, c, thr;
    int l;
    derive(e, start, c, thr, l);
    bool nd;
    const uint32_t word = x & 0xFFFFu;
    x = dense_step(x, start, c, thr, l, e.m, nd);
    store_word_flag(ep + off, word, fp + off, nd, active);
    off -= N;
  };
  auto run = [&](const Look<kTab>* lk) {
#pragma unroll
    for (int j = 0; j < kDenseAhead; ++j) step(lk[j]);
  };

  // The full groups start at top = T - 1 - T % kDenseAhead; the steps
  // above them run first, one by one.
  const int groups = T / kDenseAhead;
  const int top = T - 1 - T % kDenseAhead;
  if (groups > 0) load(symA, top);
  if (groups > 1) load(symB, top - kDenseAhead);
  if (kInShared) bulk_wait(&bar);
  for (int t = T - 1; t > top; --t) step(cdf((int)__ldg(sp + t * N)));
  if (groups > 0) look_up(symA, lkA);
  for (int gi = 0; gi < groups; gi += 2) {
    const int t0 = top - gi * kDenseAhead;
    // group gi from A; meanwhile group gi + 1's lookups into B, group gi
    // + 2's symbols into A
    if (gi + 1 < groups) {
      look_up(symB, lkB);
      if (gi + 2 < groups) load(symA, t0 - 2 * kDenseAhead);
    }
    run(lkA);
    if (gi + 1 >= groups) break;
    // group gi + 1 from B; group gi + 2's lookups into A, gi + 3's loads
    if (gi + 2 < groups) {
      look_up(symA, lkA);
      if (gi + 3 < groups) load(symB, t0 - 3 * kDenseAhead);
    }
    run(lkB);
  }
  if (active) x_fin[(size_t)s * N + k] = (int)x;
}

template <typename Sym, int kTab>
int launch_dense(const void* syms, const void* table, const void* magic,
                 void* emit, void* need, void* x_fin, int S, int T, int N,
                 int L1, int streams, void* stream) {
  if (S <= 0 || T <= 0 || N <= 0 || L1 < 2 || streams < 1 ||
      kDenseLanes * streams > kDenseMaxThreads ||
      (long long)T * N > 0x7FFFFFFFLL ||
      (kTab == kGlobal && magic == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long nblk = (N + kDenseLanes - 1) / kDenseLanes;
  const long long blocks = (S + streams - 1) / streams * nblk;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const long long bytes =
      kTab == kGlobal ? 0 : (long long)dense_table_bytes(L1);
  // the slab beside the kernel's 16 bytes of static shared memory (its
  // mbarrier)
  if (bytes + kDenseStaticSmem > kMaxDynamicSmem)
    return (int)cudaErrorInvalidValue;
  auto kernel = rans_encode_dense_kernel<Sym, kTab>;
  if (bytes > 48 * 1024) {  // raise the limit to the largest slab seen
    static int raised[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices || raised[dev] < bytes) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return (int)err;
      if (dev < kMaxDevices) raised[dev] = (int)bytes;
    }
  }
  kernel<<<(unsigned)blocks, dim3(kDenseLanes, streams), (int)bytes,
           (cudaStream_t)stream>>>(
      (const Sym*)syms, table, (const uint32_t*)magic, (int*)emit,
      (uint8_t*)need, (int*)x_fin, S, T, N, L1, (int)nblk);
  return (int)cudaGetLastError();
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

// Kernel H: syms (S, T, N), int8 (sym_bytes 1) or int32 (4); mode 2: `table`
// is the packed (ceil(N / 32), L1 - 1, 32) layout of 8-byte entries
// (`magic` unused), mode 0: the (N, L1) int32 lane table and `magic` the
// (L1 - 1, npad) u32 magic layout; blocks of 32 lanes x `streams` threads
// (at most 8) -> emit (S, T, N)
// int32, need (S, T, N) uint8 flags, x_fin (S, N) u32 states.
extern "C" int sicn_rans_encode_dense(const void* syms, const void* table,
                                      const void* magic, void* emit,
                                      void* need, void* x_fin, int S, int T,
                                      int N, int L1, int streams,
                                      int sym_bytes, int mode, void* stream) {
  const bool wide = sym_bytes == 4;
  if ((sym_bytes != 1 && !wide) || (mode != kGlobal && mode != kStaged))
    return (int)cudaErrorInvalidValue;
  if (mode == kStaged)
    return wide ? launch_dense<int32_t, kStaged>(syms, table, magic, emit,
                                                 need, x_fin, S, T, N, L1,
                                                 streams, stream)
                : launch_dense<int8_t, kStaged>(syms, table, magic, emit,
                                                need, x_fin, S, T, N, L1,
                                                streams, stream);
  return wide ? launch_dense<int32_t, kGlobal>(syms, table, magic, emit,
                                               need, x_fin, S, T, N, L1,
                                               streams, stream)
              : launch_dense<int8_t, kGlobal>(syms, table, magic, emit, need,
                                              x_fin, S, T, N, L1, streams,
                                              stream);
}
