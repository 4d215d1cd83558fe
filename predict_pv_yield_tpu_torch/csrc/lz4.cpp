// First-party LZ4 block codec (the raw block format, not the LZ4 frame
// format) + blosc byte-shuffle kernels: a copy of the JAX package's
// native/lz4.cpp for the PyTorch port. Host code, not a device kernel.
//
// Needed to open real OCF satellite archives: zarr chunks in those stores
// are blosc-compressed with cname="lz4" + byte shuffle (numcodecs' default
// Blosc codec), and no blosc, numcodecs or lz4 Python package is needed to
// read them. The blosc FRAME layout (header, block offsets, splits) is
// parsed in Python (predict_pv_yield_tpu_torch/data/blosc.py); this file
// supplies the two hot loops: LZ4 block decompression and (un)shuffle.
//
// LZ4 block format (github.com/lz4/lz4/blob/dev/doc/lz4_Block_format.md):
// a sequence of [token][literal-len*][literals][offset u16le][match-len*]
// sequences; token high nibble = literal count (15 → extra bytes), low
// nibble = match length - 4 (15 → extra bytes). The final sequence has only
// literals. Matches may overlap forward (offset < length → byte-wise copy).
//
// The compressor is a simple greedy hash-chain matcher — correct, format-
// conformant output (used for round-trip tests and shard writing); it does
// not chase lz4hc ratios.
//
// Build: predict_pv_yield_tpu_torch/_build.py compiles it with the host
// compiler (c++ -O3 -fPIC -shared -std=c++17) into build/torch_kernels/.

#include <cstdint>
#include <cstring>

namespace {

inline uint32_t read_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;  // little-endian hosts only (x86/ARM)
}

}  // namespace

extern "C" {

// Decompress an LZ4 block. Returns bytes written, or -1 on malformed input
// (overruns are bounds-checked against both buffers).
long lz4_decompress_block(const uint8_t* src, long src_len, uint8_t* dst,
                          long dst_cap) {
  const uint8_t* ip = src;
  const uint8_t* const iend = src + src_len;
  uint8_t* op = dst;
  uint8_t* const oend = dst + dst_cap;

  while (ip < iend) {
    const uint8_t token = *ip++;

    // literals
    long lit_len = token >> 4;
    if (lit_len == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        lit_len += b;
      } while (b == 255);
    }
    if (ip + lit_len > iend || op + lit_len > oend) return -1;
    std::memcpy(op, ip, lit_len);
    ip += lit_len;
    op += lit_len;
    if (ip == iend) break;  // last sequence: literals only

    // match
    if (ip + 2 > iend) return -1;
    const long offset = ip[0] | (ip[1] << 8);
    ip += 2;
    if (offset == 0 || op - dst < offset) return -1;
    long match_len = (token & 0x0F);
    if (match_len == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        match_len += b;
      } while (b == 255);
    }
    match_len += 4;
    if (op + match_len > oend) return -1;
    const uint8_t* match = op - offset;
    if (offset >= match_len) {
      std::memcpy(op, match, match_len);
      op += match_len;
    } else {
      for (long i = 0; i < match_len; ++i) *op++ = *match++;  // overlap
    }
  }
  return op - dst;
}

// Greedy LZ4 block compressor. Returns compressed size, or -1 if dst_cap is
// too small (callers should size dst_cap >= src_len + src_len/255 + 16 and
// fall back to stored-uncompressed when output would not shrink).
long lz4_compress_block(const uint8_t* src, long src_len, uint8_t* dst,
                        long dst_cap) {
  constexpr int HASH_BITS = 16;
  constexpr long MIN_MATCH = 4;
  constexpr long MFLIMIT = 12;     // spec: last match must start 12B from end
  constexpr long LAST_LITERALS = 5;
  int32_t table[1 << HASH_BITS];
  std::memset(table, -1, sizeof(table));

  const uint8_t* ip = src;
  const uint8_t* anchor = src;
  const uint8_t* const iend = src + src_len;
  const uint8_t* const mflimit = iend - MFLIMIT;
  uint8_t* op = dst;
  uint8_t* const oend = dst + dst_cap;

  auto hash = [](uint32_t v) {
    return (v * 2654435761u) >> (32 - HASH_BITS);
  };
  auto emit = [&](const uint8_t* lit, long lit_len, long match_len,
                  long offset) -> bool {
    long need = 1 + lit_len / 255 + 1 + lit_len + 2 + match_len / 255 + 1;
    if (op + need > oend) return false;
    uint8_t* token = op++;
    long ll = lit_len;
    if (ll >= 15) {
      *token = 15 << 4;
      ll -= 15;
      while (ll >= 255) { *op++ = 255; ll -= 255; }
      *op++ = (uint8_t)ll;
    } else {
      *token = (uint8_t)(ll << 4);
    }
    std::memcpy(op, lit, lit_len);
    op += lit_len;
    if (match_len == 0) return true;  // final literals-only sequence
    *op++ = (uint8_t)(offset & 0xFF);
    *op++ = (uint8_t)(offset >> 8);
    long ml = match_len - MIN_MATCH;
    if (ml >= 15) {
      *token |= 15;
      ml -= 15;
      while (ml >= 255) { *op++ = 255; ml -= 255; }
      *op++ = (uint8_t)ml;
    } else {
      *token |= (uint8_t)ml;
    }
    return true;
  };

  if (src_len >= MFLIMIT) {
    while (ip < mflimit) {
      uint32_t seq;
      std::memcpy(&seq, ip, 4);
      uint32_t h = hash(seq);
      long cand = table[h];
      table[h] = (int32_t)(ip - src);
      uint32_t cand_seq;
      if (cand >= 0 && ip - (src + cand) <= 0xFFFF &&
          (std::memcpy(&cand_seq, src + cand, 4), cand_seq == seq)) {
        const uint8_t* match = src + cand;
        const uint8_t* mip = ip + MIN_MATCH;
        const uint8_t* mmatch = match + MIN_MATCH;
        const uint8_t* const safe_end = iend - LAST_LITERALS;
        while (mip < safe_end && *mip == *mmatch) { ++mip; ++mmatch; }
        long match_len = mip - ip;
        if (!emit(anchor, ip - anchor, match_len, ip - match)) return -1;
        ip += match_len;
        anchor = ip;
      } else {
        ++ip;
      }
    }
  }
  if (!emit(anchor, iend - anchor, 0, 0)) return -1;
  return op - dst;
}

// blosc byte shuffle: src has `n = nbytes/typesize` elements of `typesize`
// bytes; dst gets all first bytes, then all second bytes, ... (applied per
// blosc block; trailing bytes that don't fill an element are copied as-is
// by the Python caller).
void blosc_shuffle(const uint8_t* src, uint8_t* dst, long nbytes,
                   long typesize) {
  const long n = nbytes / typesize;
  for (long t = 0; t < typesize; ++t) {
    const uint8_t* s = src + t;
    uint8_t* d = dst + t * n;
    for (long i = 0; i < n; ++i) d[i] = s[i * typesize];
  }
}

void blosc_unshuffle(const uint8_t* src, uint8_t* dst, long nbytes,
                     long typesize) {
  const long n = nbytes / typesize;
  for (long t = 0; t < typesize; ++t) {
    const uint8_t* s = src + t * n;
    uint8_t* d = dst + t;
    for (long i = 0; i < n; ++i) d[i * typesize] = s[i];
  }
}

}  // extern "C"
