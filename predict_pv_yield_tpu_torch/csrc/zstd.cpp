// First-party Zstandard frame decoder (RFC 8878) and CRC-32C for the
// PyTorch port. Host code, not a device kernel.
//
// The JAX package checkpoints through orbax, which stores its OCDBT nodes
// and every zarr chunk as zstd frames. The port reads those checkpoints
// without orbax, tensorstore or a zstd Python module (Python 3.12 has
// none), so the decoder is written here from the RFC:
//
//   frames      Zstandard frames back to back, skippable frames skipped;
//               window descriptor, single-segment, optional content size
//               (checked), content checksum (XXH64 low 32 bits, checked);
//               a dictionary id other than 0 is refused.
//   blocks      raw, RLE and compressed.
//   literals    raw, RLE, Huffman with 1 or 4 streams, treeless (the
//               previous block's table); weights direct or FSE-coded.
//   sequences   FSE tables in predefined, RLE, compressed and repeat
//               modes; the three repeat offsets.
//
// Every read is bounds-checked: a corrupt or truncated frame raises (the
// C entry returns -1 with a message) and never returns a short output.
// CRC-32C (Castagnoli) is the checksum that ends each OCDBT file.
//
// Build: predict_pv_yield_tpu_torch/_build.py compiles it with the host
// compiler (c++ -O3 -fPIC -shared -std=c++17) into build/torch_kernels/.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

inline void check(bool ok, const char* what) {
  if (!ok) throw Error(what);
}

// Counts of the branches taken, read by the tests (zstd_branch_counts) to
// show that a corpus reaches every part of the format.
enum Branch {
  kRawBlock, kRleBlock, kCompressedBlock,
  kRawLiterals, kRleLiterals, kHuffman1, kHuffman4, kTreeless,
  kDirectWeights, kFseWeights,
  kPredefined, kRleTable, kFseTable, kRepeatTable,
  kRepeatOffset, kSkippable, kChecksum, kMultiFrame,
  kBranches
};
std::atomic<uint64_t> g_branches[kBranches];
inline void count(Branch b) { g_branches[b].fetch_add(1, std::memory_order_relaxed); }

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

uint32_t read_le(const uint8_t* p, int n) {
  uint32_t v = 0;
  for (int i = 0; i < n; ++i) v |= uint32_t(p[i]) << (8 * i);
  return v;
}

// ---------------------------------------------------------------------------
// XXH64 (the frame's content checksum)
// ---------------------------------------------------------------------------

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t load64(const uint8_t* p) { uint64_t v; std::memcpy(&v, p, 8); return v; }
inline uint32_t load32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }
inline uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xround(v1, load64(p)); v2 = xround(v2, load64(p + 8));
      v3 = xround(v3, load64(p + 16)); v4 = xround(v4, load64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1); h = xmerge(h, v2); h = xmerge(h, v3); h = xmerge(h, v4);
  } else {
    h = P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, load64(p)), 27) * P1 + P4;
  if (p + 4 <= end) { h = rotl(h ^ (uint64_t(load32(p)) * P1), 23) * P2 + P3; p += 4; }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33; h *= P2; h ^= h >> 29; h *= P3; h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// bit readers
// ---------------------------------------------------------------------------

// Forward, least significant bit first (FSE table descriptions).
struct ForwardBits {
  const uint8_t* data;
  size_t size;
  size_t bit = 0;
  uint32_t peek(int n) const {  // n <= 24; bits past the end read as 0
    uint32_t v = 0;
    size_t byte = bit >> 3;
    for (int i = 0; i < 4 && byte + i < size; ++i) v |= uint32_t(data[byte + i]) << (8 * i);
    return (v >> (bit & 7)) & ((1u << n) - 1);
  }
  void skip(int n) { bit += n; }
};

// Backward, from the last byte's highest set bit down (Huffman streams and
// the sequences' FSE stream). Bits below the start read as 0 and drive
// `pos` negative: the stream's "overflow".
struct BackwardBits {
  const uint8_t* data;
  int64_t pos;  // bits left to read
  void init(const uint8_t* p, size_t n) {
    check(n > 0, "empty bitstream");
    check(p[n - 1] != 0, "bitstream has no end mark");
    data = p;
    pos = int64_t(n - 1) * 8 + highbit(p[n - 1]);
  }
  uint64_t peek(int n) const {  // n <= 56
    if (n == 0) return 0;
    int64_t lo = pos - n;
    if (lo >= 0) {
      uint64_t v = 0;
      size_t byte = size_t(lo) >> 3;
      int64_t last = (pos + 7) >> 3;  // bytes that hold the window
      std::memcpy(&v, data + byte, size_t(std::min<int64_t>(8, last - int64_t(byte))));
      return (v >> (lo & 7)) & ((uint64_t(1) << n) - 1);
    }
    if (pos <= 0) return 0;
    uint64_t v = 0;
    std::memcpy(&v, data, size_t((pos + 7) >> 3));
    v &= (uint64_t(1) << pos) - 1;
    return v << (-lo);
  }
  uint64_t read(int n) { uint64_t v = peek(n); pos -= n; return v; }
};

// ---------------------------------------------------------------------------
// FSE
// ---------------------------------------------------------------------------

struct FseEntry {
  uint16_t symbol;
  uint8_t bits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> cells;
  bool ready = false;

  void build(const int16_t* norm, int n_symbols, int accuracy_log) {
    log = accuracy_log;
    const uint32_t size = 1u << accuracy_log;
    cells.assign(size, FseEntry{0, 0, 0});
    std::vector<uint32_t> next(n_symbols);
    uint32_t high = size - 1;
    for (int s = 0; s < n_symbols; ++s) {
      if (norm[s] == -1) {
        cells[high--].symbol = uint16_t(s);
        next[s] = 1;
      } else {
        next[s] = uint32_t(norm[s]);
      }
    }
    const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    uint32_t position = 0;
    for (int s = 0; s < n_symbols; ++s) {
      for (int i = 0; i < norm[s]; ++i) {
        cells[position].symbol = uint16_t(s);
        do position = (position + step) & mask; while (position > high);
      }
    }
    check(position == 0, "FSE table: probabilities do not fill the table");
    for (uint32_t u = 0; u < size; ++u) {
      uint32_t state = next[cells[u].symbol]++;
      int bits = accuracy_log - highbit(state);
      cells[u].bits = uint8_t(bits);
      cells[u].base = uint16_t((state << bits) - size);
    }
    ready = true;
  }

  void rle(int symbol) {
    log = 0;
    cells.assign(1, FseEntry{uint16_t(symbol), 0, 0});
    ready = true;
  }
};

// Reads an FSE table description; returns the bytes it took.
size_t read_fse_description(const uint8_t* p, size_t n, int max_log, int max_symbol, FseTable& table) {
  check(n > 0, "FSE description: truncated");
  ForwardBits bits{p, n};
  const int accuracy_log = int(bits.peek(4)) + 5;
  bits.skip(4);
  check(accuracy_log <= max_log, "FSE description: accuracy log too large");
  std::vector<int16_t> norm(max_symbol + 1, 0);
  int remaining = (1 << accuracy_log) + 1, threshold = 1 << accuracy_log, nbits = accuracy_log + 1;
  int symbol = 0;
  bool previous0 = false;
  while (remaining > 1) {
    check(bits.bit <= n * 8, "FSE description: truncated");
    if (previous0) {
      int repeat = symbol;
      uint32_t flag;
      while ((flag = bits.peek(2)) == 3) { repeat += 3; bits.skip(2); }
      repeat += int(flag);
      bits.skip(2);
      check(repeat <= max_symbol + 1, "FSE description: too many symbols");
      while (symbol < repeat) norm[symbol++] = 0;
      previous0 = false;
      continue;
    }
    check(symbol <= max_symbol, "FSE description: too many symbols");
    const int max = (2 * threshold - 1) - remaining;
    int value;
    uint32_t low = bits.peek(nbits - 1);
    if (int(low) < max) {
      value = int(low);
      bits.skip(nbits - 1);
    } else {
      value = int(bits.peek(nbits));
      if (value >= threshold) value -= max;
      bits.skip(nbits);
    }
    value -= 1;  // -1: "less than 1"
    remaining -= value < 0 ? -value : value;
    norm[symbol++] = int16_t(value);
    previous0 = value == 0;
    while (remaining < threshold) { --nbits; threshold >>= 1; }
  }
  check(remaining == 1, "FSE description: probabilities do not sum");
  const size_t used = (bits.bit + 7) >> 3;
  check(used <= n, "FSE description: truncated");
  table.build(norm.data(), max_symbol + 1, accuracy_log);
  return used;
}

// ---------------------------------------------------------------------------
// Huffman literals
// ---------------------------------------------------------------------------

struct HuffEntry {
  uint8_t symbol;
  uint8_t bits;
};

struct HuffTable {
  int log = 0;
  std::vector<HuffEntry> cells;
  bool ready = false;
};

// Reads a Huffman tree description; returns the bytes it took.
size_t read_huffman_description(const uint8_t* p, size_t n, HuffTable& table) {
  check(n > 0, "Huffman description: truncated");
  uint8_t weights[264] = {0};
  int n_weights = 0;
  size_t used;
  const int header = p[0];
  if (header >= 128) {
    count(kDirectWeights);
    n_weights = header - 127;
    used = 1 + (size_t(n_weights) + 1) / 2;
    check(used <= n, "Huffman description: truncated");
    for (int i = 0; i < n_weights; ++i) {
      const uint8_t b = p[1 + i / 2];
      weights[i] = (i % 2 == 0) ? (b >> 4) : (b & 15);
    }
  } else {
    count(kFseWeights);
    used = 1 + size_t(header);
    check(header > 0 && used <= n, "Huffman description: truncated");
    FseTable fse;
    const size_t table_bytes = read_fse_description(p + 1, header, 6, 255, fse);
    check(table_bytes < size_t(header), "Huffman description: no weight stream");
    BackwardBits bits;
    bits.init(p + 1 + table_bytes, header - table_bytes);
    uint32_t s1 = uint32_t(bits.read(fse.log)), s2 = uint32_t(bits.read(fse.log));
    auto step = [&](uint32_t& s) {
      const FseEntry& e = fse.cells[s];
      weights[n_weights++] = uint8_t(e.symbol);
      s = e.base + uint32_t(bits.read(e.bits));
    };
    for (;;) {
      check(n_weights < 255, "Huffman description: too many weights");
      step(s1);
      if (bits.pos < 0) { weights[n_weights++] = uint8_t(fse.cells[s2].symbol); break; }
      check(n_weights < 255, "Huffman description: too many weights");
      step(s2);
      if (bits.pos < 0) { weights[n_weights++] = uint8_t(fse.cells[s1].symbol); break; }
    }
  }
  check(n_weights <= 255, "Huffman description: too many weights");
  uint32_t total = 0;
  for (int i = 0; i < n_weights; ++i) {
    check(weights[i] <= 12, "Huffman description: weight too large");
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  check(total > 0, "Huffman description: all weights zero");
  const int log = highbit(total) + 1;
  check(log <= 11, "Huffman description: code too long");
  const uint32_t rest = (1u << log) - total;
  check((rest & (rest - 1)) == 0, "Huffman description: weights do not complete a code");
  weights[n_weights++] = uint8_t(highbit(rest) + 1);
  // cells for weight w start after all cells of lighter weights; within a
  // weight, symbols in increasing order
  uint32_t rank_start[14] = {0}, rank_count[14] = {0};
  for (int i = 0; i < n_weights; ++i) rank_count[weights[i]]++;
  uint32_t next = 0;
  for (int w = 1; w <= 12; ++w) { rank_start[w] = next; next += rank_count[w] << (w - 1); }
  table.log = log;
  table.cells.assign(size_t(1) << log, HuffEntry{0, 0});
  for (int s = 0; s < n_weights; ++s) {
    const int w = weights[s];
    if (!w) continue;
    const uint32_t length = 1u << (w - 1);
    for (uint32_t i = 0; i < length; ++i)
      table.cells[rank_start[w] + i] = HuffEntry{uint8_t(s), uint8_t(log + 1 - w)};
    rank_start[w] += length;
  }
  table.ready = true;
  return used;
}

void decode_huffman_stream(const uint8_t* p, size_t n, const HuffTable& table, uint8_t* out, size_t count_out) {
  BackwardBits bits;
  bits.init(p, n);
  for (size_t i = 0; i < count_out; ++i) {
    const HuffEntry& e = table.cells[bits.peek(table.log)];
    out[i] = e.symbol;
    bits.pos -= e.bits;
    check(bits.pos >= 0, "Huffman stream: read past its start");
  }
  check(bits.pos == 0, "Huffman stream: bits left over");
}

// ---------------------------------------------------------------------------
// sequences
// ---------------------------------------------------------------------------

const int16_t kLiteralsDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                      2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMatchDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                   1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                   1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOffsetDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kLiteralsBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                                    12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                                    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLiteralsBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                                   1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMatchBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,   14,   15,   16,
                                 17, 18, 19, 20, 21, 22, 23, 24, 25,  26,  27,   28,   29,   30,
                                 31, 32, 33, 34, 35, 37, 39, 41, 43,  47,  51,   59,   67,   83,
                                 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMatchBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// The state a frame carries from block to block.
struct FrameState {
  HuffTable huffman;
  FseTable literals, offsets, matches;
  uint32_t rep[3] = {1, 4, 8};
};

// One table of the sequences section in the mode its two bits give.
size_t read_sequence_table(int mode, const uint8_t* p, size_t n, FseTable& table, const int16_t* defaults,
                           int n_defaults, int default_log, int max_log, int max_symbol) {
  switch (mode) {
    case 0:
      count(kPredefined);
      table.build(defaults, n_defaults, default_log);
      return 0;
    case 1:
      count(kRleTable);
      check(n >= 1, "sequences: truncated RLE table");
      check(p[0] <= max_symbol, "sequences: RLE symbol out of range");
      table.rle(p[0]);
      return 1;
    case 2:
      count(kFseTable);
      return read_fse_description(p, n, max_log, max_symbol, table);
    default:
      count(kRepeatTable);
      check(table.ready, "sequences: repeat mode with no previous table");
      return 0;
  }
}

// Decodes one compressed block, appending to `out` (which holds the
// frame's output so far, the window of every match).
void decode_compressed_block(const uint8_t* p, size_t n, FrameState& fs, std::vector<uint8_t>& out) {
  check(n >= 1, "block: truncated literals header");
  // --- literals section
  const int type = p[0] & 3, format = (p[0] >> 2) & 3;
  size_t regenerated, compressed = 0, header;
  if (type <= 1) {
    if (format == 0 || format == 2) { header = 1; regenerated = p[0] >> 3; }
    else if (format == 1) { header = 2; check(n >= 2, "literals: truncated header"); regenerated = (p[0] >> 4) + (size_t(p[1]) << 4); }
    else { header = 3; check(n >= 3, "literals: truncated header"); regenerated = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12); }
  } else {
    if (format <= 1) {
      header = 3;
      check(n >= 3, "literals: truncated header");
      const uint32_t h = read_le(p, 3);
      regenerated = (h >> 4) & 0x3FF;
      compressed = (h >> 14) & 0x3FF;
    } else if (format == 2) {
      header = 4;
      check(n >= 4, "literals: truncated header");
      const uint32_t h = read_le(p, 4);
      regenerated = (h >> 4) & 0x3FFF;
      compressed = h >> 18;
    } else {
      header = 5;
      check(n >= 5, "literals: truncated header");
      const uint64_t h = read_le(p, 4) | (uint64_t(p[4]) << 32);
      regenerated = (h >> 4) & 0x3FFFF;
      compressed = (h >> 22) & 0x3FFFF;
    }
  }
  check(regenerated <= (128u << 10), "literals: larger than a block");
  std::vector<uint8_t> literals(regenerated);
  size_t at = header;
  if (type == 0) {
    count(kRawLiterals);
    check(at + regenerated <= n, "literals: truncated raw literals");
    if (regenerated) std::memcpy(literals.data(), p + at, regenerated);
    at += regenerated;
  } else if (type == 1) {
    count(kRleLiterals);
    check(at + 1 <= n, "literals: truncated RLE literal");
    std::memset(literals.data(), p[at], regenerated);
    at += 1;
  } else {
    check(at + compressed <= n, "literals: truncated Huffman literals");
    const uint8_t* q = p + at;
    size_t left = compressed;
    if (type == 2) {
      const size_t used = read_huffman_description(q, left, fs.huffman);
      q += used;
      left -= used;
    } else {
      count(kTreeless);
      check(fs.huffman.ready, "literals: treeless with no previous table");
    }
    if (format == 0) {
      count(kHuffman1);
      decode_huffman_stream(q, left, fs.huffman, literals.data(), regenerated);
    } else {
      count(kHuffman4);
      check(left >= 6, "literals: truncated jump table");
      const size_t s1 = read_le(q, 2), s2 = read_le(q + 2, 2), s3 = read_le(q + 4, 2);
      check(6 + s1 + s2 + s3 <= left, "literals: jump table past the section");
      const size_t s4 = left - 6 - s1 - s2 - s3;
      const size_t quarter = (regenerated + 3) / 4;
      check(3 * quarter <= regenerated, "literals: too few for four streams");
      const uint8_t* s = q + 6;
      decode_huffman_stream(s, s1, fs.huffman, literals.data(), quarter);
      decode_huffman_stream(s + s1, s2, fs.huffman, literals.data() + quarter, quarter);
      decode_huffman_stream(s + s1 + s2, s3, fs.huffman, literals.data() + 2 * quarter, quarter);
      decode_huffman_stream(s + s1 + s2 + s3, s4, fs.huffman, literals.data() + 3 * quarter,
                            regenerated - 3 * quarter);
    }
    at += compressed;
  }
  // --- sequences section
  check(at < n, "sequences: truncated header");
  size_t n_sequences = p[at++];
  if (n_sequences >= 128) {
    if (n_sequences < 255) {
      check(at < n, "sequences: truncated header");
      n_sequences = ((n_sequences - 128) << 8) + p[at++];
    } else {
      check(at + 2 <= n, "sequences: truncated header");
      n_sequences = p[at] + (size_t(p[at + 1]) << 8) + 0x7F00;
      at += 2;
    }
  }
  const size_t block_start = out.size();
  if (n_sequences == 0) {
    check(at == n, "sequences: bytes after an empty section");
    out.insert(out.end(), literals.begin(), literals.end());
    return;
  }
  check(at < n, "sequences: truncated modes");
  const uint8_t modes = p[at++];
  check((modes & 3) == 0, "sequences: reserved mode bits set");
  at += read_sequence_table(modes >> 6, p + at, n - at, fs.literals, kLiteralsDefault, 36, 6, 9, 35);
  at += read_sequence_table((modes >> 4) & 3, p + at, n - at, fs.offsets, kOffsetDefault, 29, 5, 8, 31);
  at += read_sequence_table((modes >> 2) & 3, p + at, n - at, fs.matches, kMatchDefault, 53, 6, 9, 52);
  check(at < n, "sequences: no bitstream");
  BackwardBits bits;
  bits.init(p + at, n - at);
  uint32_t ll_state = uint32_t(bits.read(fs.literals.log));
  uint32_t of_state = uint32_t(bits.read(fs.offsets.log));
  uint32_t ml_state = uint32_t(bits.read(fs.matches.log));
  size_t lit_at = 0;
  for (size_t i = 0; i < n_sequences; ++i) {
    const FseEntry& ll = fs.literals.cells[ll_state];
    const FseEntry& of = fs.offsets.cells[of_state];
    const FseEntry& ml = fs.matches.cells[ml_state];
    check(of.symbol <= 31, "sequences: offset code out of range");
    uint64_t offset_value = (uint64_t(1) << of.symbol) + bits.read(of.symbol);
    const size_t match = kMatchBase[ml.symbol] + size_t(bits.read(kMatchBits[ml.symbol]));
    const size_t lit = kLiteralsBase[ll.symbol] + size_t(bits.read(kLiteralsBits[ll.symbol]));
    check(bits.pos >= 0, "sequences: bitstream overread");
    uint32_t offset;
    if (offset_value > 3) {
      offset = uint32_t(offset_value - 3);
      fs.rep[2] = fs.rep[1];
      fs.rep[1] = fs.rep[0];
      fs.rep[0] = offset;
    } else {
      count(kRepeatOffset);
      const int index = int(offset_value) - 1 + (lit == 0 ? 1 : 0);
      if (index == 0) {
        offset = fs.rep[0];
      } else {
        offset = index == 3 ? fs.rep[0] - 1 : fs.rep[index];
        if (index > 1) fs.rep[2] = fs.rep[1];
        fs.rep[1] = fs.rep[0];
        fs.rep[0] = offset;
      }
    }
    if (i + 1 < n_sequences) {
      ll_state = ll.base + uint32_t(bits.read(ll.bits));
      ml_state = ml.base + uint32_t(bits.read(ml.bits));
      of_state = of.base + uint32_t(bits.read(of.bits));
      check(bits.pos >= 0, "sequences: bitstream overread");
    }
    check(lit <= literals.size() - lit_at, "sequences: more literals than decoded");
    out.insert(out.end(), literals.begin() + lit_at, literals.begin() + lit_at + lit);
    lit_at += lit;
    check(offset != 0 && offset <= out.size(), "sequences: match offset before the frame");
    check(out.size() - block_start + match <= (128u << 10), "sequences: block larger than 128 KiB");
    const size_t from = out.size() - offset;
    out.resize(out.size() + match);
    uint8_t* dst = out.data() + out.size() - match;
    const uint8_t* src = out.data() + from;
    if (offset >= match) {
      std::memcpy(dst, src, match);
    } else {
      for (size_t k = 0; k < match; ++k) dst[k] = src[k];  // overlapping: byte by byte
    }
  }
  check(bits.pos == 0, "sequences: bits left over");
  out.insert(out.end(), literals.begin() + lit_at, literals.end());
  check(out.size() - block_start <= (128u << 10), "sequences: block larger than 128 KiB");
}

// Decodes one Zstandard frame at p (its magic already checked); returns the
// bytes the frame took.
size_t decode_frame(const uint8_t* p, size_t n, std::vector<uint8_t>& out) {
  size_t at = 4;
  check(at < n, "frame: truncated header");
  const uint8_t descriptor = p[at++];
  const int fcs_flag = descriptor >> 6, single_segment = (descriptor >> 5) & 1;
  const int checksum = (descriptor >> 2) & 1, dict_flag = descriptor & 3;
  check((descriptor & 8) == 0, "frame: reserved bit set");
  if (!single_segment) {
    check(at < n, "frame: truncated header");
    const uint8_t window = p[at++];
    const int exponent = window >> 3;
    check(10 + exponent <= 41, "frame: window too large");
  }
  const int dict_bytes[4] = {0, 1, 2, 4};
  check(at + dict_bytes[dict_flag] <= n, "frame: truncated header");
  const uint32_t dict_id = read_le(p + at, dict_bytes[dict_flag]);
  at += dict_bytes[dict_flag];
  if (dict_id != 0) throw Error("frame: needs a dictionary, which is not supported");
  const int fcs_bytes[4] = {single_segment ? 1 : 0, 2, 4, 8};
  const int fcs_size = fcs_bytes[fcs_flag];
  check(at + fcs_size <= n, "frame: truncated header");
  bool has_size = fcs_size > 0;
  uint64_t content_size = 0;
  for (int i = 0; i < fcs_size; ++i) content_size |= uint64_t(p[at + i]) << (8 * i);
  if (fcs_size == 2) content_size += 256;
  at += fcs_size;

  FrameState fs;
  const size_t start = out.size();
  for (;;) {
    check(at + 3 <= n, "frame: truncated block header");
    const uint32_t block = read_le(p + at, 3);
    at += 3;
    const bool last = block & 1;
    const int type = (block >> 1) & 3;
    const size_t size = block >> 3;
    if (type == 0) {
      count(kRawBlock);
      check(size <= (128u << 10), "block: larger than 128 KiB");
      check(at + size <= n, "block: truncated raw block");
      out.insert(out.end(), p + at, p + at + size);
      at += size;
    } else if (type == 1) {
      count(kRleBlock);
      check(size <= (128u << 10), "block: larger than 128 KiB");
      check(at + 1 <= n, "block: truncated RLE block");
      out.insert(out.end(), size, p[at]);
      at += 1;
    } else if (type == 2) {
      count(kCompressedBlock);
      check(size <= (128u << 10), "block: larger than 128 KiB");
      check(at + size <= n, "block: truncated compressed block");
      decode_compressed_block(p + at, size, fs, out);
      at += size;
    } else {
      throw Error("block: reserved block type");
    }
    if (has_size) check(out.size() - start <= content_size, "frame: more content than its header says");
    if (last) break;
  }
  if (has_size) check(out.size() - start == content_size, "frame: less content than its header says");
  if (checksum) {
    count(kChecksum);
    check(at + 4 <= n, "frame: truncated checksum");
    const uint32_t stored = read_le(p + at, 4);
    at += 4;
    const uint32_t computed = uint32_t(xxh64(out.data() + start, out.size() - start));
    check(stored == computed, "frame: content checksum mismatch");
  }
  return at;
}

void decompress(const uint8_t* p, size_t n, std::vector<uint8_t>& out) {
  check(n >= 4, "not a zstd frame: fewer than 4 bytes");
  int frames = 0;
  size_t at = 0;
  while (at < n) {
    check(n - at >= 4, "trailing bytes after the last frame");
    const uint32_t magic = read_le(p + at, 4);
    if (magic == 0xFD2FB528u) {
      at += decode_frame(p + at, n - at, out);
      if (++frames > 1) count(kMultiFrame);
    } else if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      count(kSkippable);
      check(n - at >= 8, "skippable frame: truncated");
      const size_t size = read_le(p + at + 4, 4);
      check(n - at - 8 >= size, "skippable frame: truncated");
      at += 8 + size;
    } else {
      throw Error("not a zstd frame: bad magic number");
    }
  }
}

struct Crc32cTable {
  uint32_t cells[256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      cells[i] = c;
    }
  }
};

}  // namespace

extern "C" {

// Decompresses the frames in src. Returns the decoded length and sets *out
// to a buffer that zstd_free releases; on a corrupt or truncated input
// returns -1 with a message in err.
long zstd_decompress(const uint8_t* src, long src_len, uint8_t** out, char* err, long err_cap) {
  *out = nullptr;
  try {
    std::vector<uint8_t> result;
    decompress(src, size_t(src_len), result);
    uint8_t* buffer = static_cast<uint8_t*>(std::malloc(result.empty() ? 1 : result.size()));
    if (!buffer) throw Error("out of memory");
    if (!result.empty()) std::memcpy(buffer, result.data(), result.size());
    *out = buffer;
    return long(result.size());
  } catch (const std::exception& e) {
    std::snprintf(err, size_t(err_cap), "%s", e.what());
    return -1;
  }
}

void zstd_free(uint8_t* buffer) { std::free(buffer); }

// Copies the branch counts into counts[kBranches] and returns kBranches.
long zstd_branch_counts(uint64_t* counts, long cap) {
  for (long i = 0; i < cap && i < kBranches; ++i) counts[i] = g_branches[i].load();
  return kBranches;
}

// CRC-32C (Castagnoli, reflected, as OCDBT files end with).
uint32_t crc32c(const uint8_t* src, long n) {
  static const Crc32cTable table;
  uint32_t c = 0xFFFFFFFFu;
  for (long i = 0; i < n; ++i) c = table.cells[(c ^ src[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
