// rANS entropy coder: the host backend of the port's codecs.
//
// The port's own copy of the JAX package's native/rans.cpp, built at first
// use by codec/rans.py (g++, no PyTorch header) and loaded with ctypes.
// A 32-bit-state range-variant ANS with byte renormalization and 16-bit
// quantized CDFs (the standard published rANS recurrences).
//
// Model: each symbol i carries a context index ctx[i] selecting a CDF row
// (e.g. the hyperprior's per-latent scale bin).  CDF rows are int32 arrays of
// length L+1 with cdf[0]=0, cdf[L]=1<<prec, strictly increasing (produced by
// codec/entropy.py:quantize_cdf).  The last symbol of every row is an
// escape/overflow bucket: its value is followed by a raw 4 x 8-bit bypass
// encoding of the out-of-range value (zig-zag, sign folded in).
//
// Encoding is LIFO: symbols are pushed in reverse so decoding streams them in
// forward order.  The Python golden model (codec/rans.py) produces an
// identical bytestream; tests assert equality.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kRansL = 1u << 23;  // lower bound of the state interval

struct ByteSink {
  uint8_t* buf;
  int64_t cap;
  int64_t pos;  // grows downward-to-upward after reversal; here append
  bool overflow;
  inline void put(uint8_t b) {
    if (pos >= cap) { overflow = true; return; }
    buf[pos++] = b;
  }
};

inline void enc_renorm(uint32_t& x, ByteSink& sink, uint32_t freq,
                       uint32_t prec) {
  const uint32_t x_max = ((kRansL >> prec) << 8) * freq;
  while (x >= x_max) {
    sink.put(static_cast<uint8_t>(x & 0xff));
    x >>= 8;
  }
}

inline void enc_put(uint32_t& x, ByteSink& sink, uint32_t start, uint32_t freq,
                    uint32_t prec) {
  enc_renorm(x, sink, freq, prec);
  x = ((x / freq) << prec) + (x % freq) + start;
}

}  // namespace

extern "C" {

// Encode n symbols.  Returns bytestream length, or -1 on overflow/capacity.
//  syms:     int32[n], values in [0, L-1] or the escape value >= L-1 handled
//            by caller (caller maps out-of-range to escape; raw values are
//            passed via `raw` when syms[i] == escape index L-1).
//  ctx:      int32[n] CDF row per symbol.
//  cdf:      int32[n_rows][L+1] flattened.
//  raw:      int32[n] raw value used only for escape symbols (bypass coded
//            as 32 bits: zig-zag magnitude).
int64_t rans_encode(const int32_t* syms, const int32_t* ctx, int64_t n,
                    const int32_t* cdf, int32_t L, int32_t prec,
                    const int32_t* raw, uint8_t* out, int64_t out_cap) {
  ByteSink sink{out, out_cap, 0, false};
  uint32_t x = kRansL;
  const int32_t escape = L - 1;
  // LIFO: reverse order
  for (int64_t i = n - 1; i >= 0; --i) {
    const int32_t s = syms[i];
    const int32_t* row = cdf + static_cast<int64_t>(ctx[i]) * (L + 1);
    if (s == escape) {
      // bypass: 32-bit zig-zag of raw value, 8 bits at a time (uniform),
      // pushed before (decoded after) the escape symbol itself.
      uint32_t zz = (static_cast<uint32_t>(raw[i]) << 1) ^
                    static_cast<uint32_t>(raw[i] >> 31);
      for (int shift = 24; shift >= 0; shift -= 8) {
        uint32_t byte = (zz >> shift) & 0xff;
        enc_put(x, sink, byte << 8, 1u << 8, 16);  // uniform 8-bit, prec 16
      }
    }
    const uint32_t start = static_cast<uint32_t>(row[s]);
    const uint32_t freq = static_cast<uint32_t>(row[s + 1] - row[s]);
    if (freq == 0) return -2;
    enc_put(x, sink, start, freq, static_cast<uint32_t>(prec));
  }
  // flush 4 state bytes (little-endian order, reversed below)
  for (int k = 0; k < 4; ++k) {
    sink.put(static_cast<uint8_t>(x & 0xff));
    x >>= 8;
  }
  if (sink.overflow) return -1;
  // stream was built back-to-front; reverse into forward decode order
  for (int64_t a = 0, b = sink.pos - 1; a < b; ++a, --b) {
    uint8_t t = out[a];
    out[a] = out[b];
    out[b] = t;
  }
  return sink.pos;
}

// Decode n symbols; writes table indices to out_syms and raw bypass values
// to out_raw (0 unless the symbol was an escape).  Returns bytes consumed,
// -1 on malformed input.
int64_t rans_decode(const uint8_t* in, int64_t in_len, int64_t n,
                    const int32_t* ctx, const int32_t* cdf, int32_t L,
                    int32_t prec, int32_t* out_syms, int32_t* out_raw) {
  if (in_len < 4) return -1;
  int64_t pos = 0;
  uint32_t x = 0;
  for (int k = 0; k < 4; ++k) x = (x << 8) | in[pos++];
  const uint32_t mask = (1u << prec) - 1;
  const int32_t escape = L - 1;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* row = cdf + static_cast<int64_t>(ctx[i]) * (L + 1);
    const uint32_t slot = x & mask;
    // binary search: largest s with row[s] <= slot
    int32_t lo = 0, hi = L;
    while (hi - lo > 1) {
      int32_t mid = (lo + hi) >> 1;
      if (static_cast<uint32_t>(row[mid]) <= slot) lo = mid; else hi = mid;
    }
    const int32_t s = lo;
    const uint32_t start = static_cast<uint32_t>(row[s]);
    const uint32_t freq = static_cast<uint32_t>(row[s + 1] - row[s]);
    x = freq * (x >> prec) + slot - start;
    while (x < kRansL) {
      if (pos >= in_len) return -1;
      x = (x << 8) | in[pos++];
    }
    out_syms[i] = s;
    int32_t rawv = 0;
    if (s == escape) {
      // LIFO: encoder pushed the high byte first, so it pops last — the
      // decoder sees the low byte first.
      uint32_t zz = 0;
      for (int k = 0; k < 4; ++k) {
        const uint32_t bslot = x & 0xffff;
        const uint32_t byte = bslot >> 8;  // uniform: start = byte<<8, freq 256
        x = (1u << 8) * (x >> 16) + bslot - (byte << 8);
        while (x < kRansL) {
          if (pos >= in_len) return -1;
          x = (x << 8) | in[pos++];
        }
        zz |= byte << (8 * k);
      }
      rawv = static_cast<int32_t>((zz >> 1) ^ (~(zz & 1) + 1));
    }
    out_raw[i] = rawv;
  }
  return pos;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Interleaved N-lane rANS (format of codec/ilrans.py)
//
// N coder states share one u16 word stream, renormalizing round-robin.
// 32-bit state in [2^16, 2^32), 16-bit renorm words, prec <= 16: at most one
// renormalization per symbol in each direction.  Symbol j -> lane j % N at
// step j / N; the caller pads the symbol count to a multiple of N
// (ilrans.pad_to_lanes).  Streams are bit-identical with the NumPy golden
// (codec/ilrans.py) and the device coder (codec/device_rans.py, kernels B
// and C).
// ---------------------------------------------------------------------------

extern "C" {

// Encode n symbols (n % n_lanes == 0, pre-padded).  words_out must hold
// 2*n_lanes + n u16 (the hard bound).  Returns the word count, -2 on a
// zero-frequency symbol.
int64_t ilrans_encode(const int32_t* syms, const int32_t* ctx, int64_t n,
                      const int32_t* cdf, int32_t L, int32_t prec,
                      int32_t n_lanes, uint16_t* words_out) {
  const int64_t cap = 2 * n_lanes + n;
  std::vector<uint32_t> x(n_lanes, 1u << 16);
  uint16_t* w = words_out + cap;  // push downward; stream reads forward
  const int64_t t_steps = n / n_lanes;
  for (int64_t t = t_steps - 1; t >= 0; --t) {
    for (int32_t k = n_lanes - 1; k >= 0; --k) {
      const int64_t j = t * n_lanes + k;
      const int32_t* row = cdf + static_cast<int64_t>(ctx[j]) * (L + 1);
      const int32_t s = syms[j];
      const uint32_t start = static_cast<uint32_t>(row[s]);
      const uint32_t freq = static_cast<uint32_t>(row[s + 1] - row[s]);
      if (freq == 0) return -2;
      if ((x[k] >> 16) >= freq) {
        *--w = static_cast<uint16_t>(x[k] & 0xffff);
        x[k] >>= 16;
      }
      x[k] = ((x[k] / freq) << prec) + (x[k] % freq) + start;
    }
  }
  // Pushing downward reverses: to read (hi_k, lo_k) for k = 0..N-1 forward,
  // push lo_k then hi_k for k = N-1..0.
  for (int32_t k = n_lanes - 1; k >= 0; --k) {
    *--w = static_cast<uint16_t>(x[k] & 0xffff);
    *--w = static_cast<uint16_t>(x[k] >> 16);
  }
  const int64_t n_words = (words_out + cap) - w;
  std::memmove(words_out, w, n_words * sizeof(uint16_t));
  return n_words;
}

// Decode n symbols (n % n_lanes == 0; caller truncates padding).  Returns
// words consumed, or -1 on stream over/under-run.
int64_t ilrans_decode(const uint16_t* words, int64_t n_words, int64_t n,
                      const int32_t* ctx, const int32_t* cdf, int32_t L,
                      int32_t prec, int32_t n_lanes, int32_t* out_syms) {
  if (n_words < 2 * n_lanes) return -1;
  std::vector<uint32_t> x(n_lanes);
  int64_t pos = 0;
  for (int32_t k = 0; k < n_lanes; ++k) {
    const uint32_t hi = words[pos++];
    const uint32_t lo = words[pos++];
    x[k] = (hi << 16) | lo;
  }
  const uint32_t mask = (1u << prec) - 1;
  const int64_t t_steps = n / n_lanes;
  for (int64_t t = 0; t < t_steps; ++t) {
    for (int32_t k = 0; k < n_lanes; ++k) {
      const int64_t j = t * n_lanes + k;
      const int32_t* row = cdf + static_cast<int64_t>(ctx[j]) * (L + 1);
      const uint32_t slot = x[k] & mask;
      int32_t lo = 0, hi = L;
      while (hi - lo > 1) {
        const int32_t mid = (lo + hi) >> 1;
        if (static_cast<uint32_t>(row[mid]) <= slot) lo = mid; else hi = mid;
      }
      const uint32_t start = static_cast<uint32_t>(row[lo]);
      const uint32_t freq = static_cast<uint32_t>(row[lo + 1] - row[lo]);
      x[k] = freq * (x[k] >> prec) + slot - start;
      if (x[k] < (1u << 16)) {
        if (pos >= n_words) return -1;
        x[k] = (x[k] << 16) | words[pos++];
      }
      out_syms[j] = lo;
    }
  }
  for (int32_t k = 0; k < n_lanes; ++k)
    if (x[k] != (1u << 16)) return -1;
  return pos;
}

}  // extern "C"
