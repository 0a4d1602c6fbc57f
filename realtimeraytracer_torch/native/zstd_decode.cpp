// Zstandard frames (RFC 8878) for TIFF's ZSTD compression (50000): the
// fourth source of the image decoder library, decoding what libzstd 1.5.7
// decodes for libtiff, corrupt frames included.  libtiff's ZSTDDecode hands
// each strip or tile to libzstd's streaming decoder until the strip is
// full or the frame ends: libzstd decodes a whole frame in one pass where
// it can (its checksum checked) and otherwise block by block, stopping at
// the block that fills the strip; a frame that ends short of it, a checksum
// that does not match, a window above libzstd's default limit (2^27) and a
// malformed block raise.  Covered: raw, RLE and compressed blocks; raw,
// RLE, Huffman-compressed and treeless literals in one or four streams
// (libzstd's single- and double-symbol tables and its fast four-stream
// loop, which reads a corrupt stream on past its start); sequences with
// predefined, RLE, FSE-compressed and repeated tables; the repeat offsets;
// the content checksum (XXH64).  Dictionaries are not: a frame naming one
// raises, as libzstd without a dictionary does.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace zstd {

namespace {

[[noreturn]] void corrupt(const std::string& what) { throw std::runtime_error("corrupt ZSTD data in a TIFF strip or tile: " + what); }

int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// A forward little-endian bit reader over [p, p + n): bits past the end read 0.
uint64_t bits_at(const uint8_t* p, size_t n, int64_t bit, int count) {
  uint64_t v = 0;
  for (int i = 0; i < count; ++i, ++bit)
    if (bit >= 0 && size_t(bit >> 3) < n) v |= uint64_t(p[bit >> 3] >> (bit & 7) & 1) << i;
  return v;
}

// A backward bitstream (Huffman streams, FSE bitstreams): starts after the
// last byte's marker bit; reads before its start give zeros.
struct Backward {
  const uint8_t* p;
  size_t n;
  int64_t offset;
  Backward(const uint8_t* p_, size_t n_) : p(p_), n(n_) {
    if (n == 0 || p[n - 1] == 0) corrupt("a bitstream has no end marker");
    offset = int64_t(n) * 8 - (8 - highbit(p[n - 1]));
  }
  uint32_t read(int count) {
    offset -= count;
    if (count == 0) return 0;
    if (offset >= 0) return uint32_t(bits_at(p, n, offset, count));
    if (offset + count <= 0) return 0;
    return uint32_t(bits_at(p, n, 0, int(offset + count)) << -offset);
  }
};

struct FseTable {
  int log = -1;  // -1: none yet
  std::vector<uint8_t> symbol, bits;
  std::vector<uint16_t> base;
};

// The decoding table of a normalized distribution (RFC 8878 4.1.1).
void build_fse(FseTable& t, const std::vector<int16_t>& norm, int log) {
  const size_t size = size_t(1) << log;
  t.log = log;
  t.symbol.assign(size, 0), t.bits.assign(size, 0), t.base.assign(size, 0);
  std::vector<uint16_t> next(norm.size());
  size_t high = size - 1;
  for (size_t s = 0; s < norm.size(); ++s)
    if (norm[s] == -1) t.symbol[high--] = uint8_t(s), next[s] = 1;
  const size_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  size_t pos = 0;
  for (size_t s = 0; s < norm.size(); ++s) {
    if (norm[s] <= 0) continue;
    next[s] = uint16_t(norm[s]);
    for (int i = 0; i < norm[s]; ++i) {
      t.symbol[pos] = uint8_t(s);
      do pos = (pos + step) & mask; while (pos > high);
    }
  }
  if (pos != 0) corrupt("an FSE distribution does not fill its table");
  for (size_t i = 0; i < size; ++i) {
    const uint32_t ns = next[t.symbol[i]]++;
    t.bits[i] = uint8_t(log - highbit(ns));
    t.base[i] = uint16_t((ns << t.bits[i]) - size);
  }
}

// FSE_readNCount: a table description of at most `max_log` accuracy and
// `max_symbol` symbols from p; returns the bytes it took.
size_t read_ncount(const uint8_t* p, size_t n, int max_log, int max_symbol, FseTable& t) {
  if (n == 0) corrupt("no FSE table description");
  int64_t bit = 0;
  auto peek = [&](int k) { return uint32_t(bits_at(p, n, bit, k)); };
  const int log = int(peek(4)) + 5;
  bit += 4;
  if (log > max_log) corrupt("an FSE table of accuracy " + std::to_string(log));
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1, symbol = 0;
  std::vector<int16_t> norm;
  bool previous0 = false;
  while (remaining > 1 && symbol <= max_symbol) {
    if (previous0) {
      int n0 = symbol;
      while (peek(16) == 0xFFFF) n0 += 24, bit += 16;
      while (peek(2) == 3) n0 += 3, bit += 2;
      n0 += int(peek(2));
      bit += 2;
      if (n0 > max_symbol) corrupt("an FSE distribution of too many symbols");
      while (symbol < n0) norm.push_back(0), ++symbol;
      if (symbol > max_symbol) break;
    }
    const int max = (2 * threshold - 1) - remaining;
    int count;
    if (int(peek(nbits - 1)) < max) {
      count = int(peek(nbits - 1));
      bit += nbits - 1;
    } else {
      count = int(peek(nbits));
      if (count >= threshold) count -= max;
      bit += nbits;
    }
    --count;
    remaining -= count < 0 ? -count : count;
    norm.push_back(int16_t(count));
    ++symbol;
    previous0 = count == 0;
    while (remaining < threshold) --nbits, threshold >>= 1;
  }
  if (remaining != 1 || size_t((bit + 7) >> 3) > n) corrupt("an FSE distribution does not sum to its table");
  build_fse(t, norm, log);
  return size_t((bit + 7) >> 3);
}

struct Huffman {
  int max_bits = 0;  // 0: none yet
  bool x2 = false;   // libzstd built its double-symbol table (a treeless block reuses it)
  std::vector<uint8_t> symbol, bits;
};

// The Huffman tree description of the literals (4.2.1); returns its bytes.
size_t read_huffman(const uint8_t* p, size_t n, Huffman& h) {
  if (n == 0) corrupt("no Huffman tree description");
  std::vector<uint8_t> w;
  const int head = p[0];
  size_t used;
  if (head < 128) {  // FSE-compressed weights, two interleaved states
    if (size_t(head) + 1 > n) corrupt("a truncated Huffman tree description");
    FseTable t;
    const size_t hdr = read_ncount(p + 1, size_t(head), 6, 255, t);
    if (hdr >= size_t(head)) corrupt("a Huffman tree description without weights");
    Backward bs(p + 1 + hdr, size_t(head) - hdr);
    uint32_t s1 = bs.read(t.log), s2 = bs.read(t.log);
    if (bs.offset < 0) corrupt("Huffman weights whose states overrun their stream");  // FSE_decompress's init check
    auto step = [&](uint32_t& s) {
      const uint8_t sym = t.symbol[s];
      s = t.base[s] + bs.read(t.bits[s]);
      return sym;
    };
    for (;;) {  // FSE_decompress's tail: room for 255 weights, checked before each state's step
      if (w.size() > 253) corrupt("too many Huffman weights");
      w.push_back(step(s1));
      if (bs.offset < 0) {
        w.push_back(t.symbol[s2]);
        break;
      }
      if (w.size() > 253) corrupt("too many Huffman weights");
      w.push_back(step(s2));
      if (bs.offset < 0) {
        w.push_back(t.symbol[s1]);
        break;
      }
    }
    used = 1 + size_t(head);
  } else {  // direct 4-bit weights
    const size_t count = size_t(head) - 127;
    used = 1 + (count + 1) / 2;
    if (used > n) corrupt("a truncated Huffman tree description");
    for (size_t i = 0; i < count; ++i) w.push_back(uint8_t(i & 1 ? p[1 + i / 2] & 15 : p[1 + i / 2] >> 4));
  }
  // HUF_readStats' checks: libzstd takes codes of up to 12 bits (one more
  // than RFC 8878 allows) and wants an even count, 2 or more, of weight 1.
  uint32_t sum = 0;
  for (uint8_t x : w) {
    if (x > 12) corrupt("a Huffman weight above 12");
    if (x) sum += 1u << (x - 1);
  }
  if (sum == 0) corrupt("Huffman weights of no symbol");
  const int max_bits = highbit(sum) + 1;
  const uint32_t left = (1u << max_bits) - sum;
  if (max_bits > 12 || (left & (left - 1))) corrupt("Huffman weights that are no prefix code");
  w.push_back(uint8_t(highbit(left) + 1));
  const auto ones = std::count(w.begin(), w.end(), uint8_t(1));
  if (ones < 2 || (ones & 1)) corrupt("Huffman weights without an even count of the longest codes");
  // Codes from the longest (lowest weight) up, by symbol within a weight.
  h.max_bits = max_bits;
  h.symbol.assign(size_t(1) << max_bits, 0), h.bits.assign(size_t(1) << max_bits, 0);
  uint32_t rank_count[14] = {}, rank_idx[14] = {};
  for (uint8_t x : w)
    if (x) ++rank_count[max_bits + 1 - x];
  rank_idx[max_bits] = 0;
  for (int b = max_bits; b >= 1; --b) {
    rank_idx[b - 1] = rank_idx[b] + rank_count[b] * (1u << (max_bits - b));
    for (uint32_t i = rank_idx[b]; i < rank_idx[b - 1]; ++i) h.bits[i] = uint8_t(b);
  }
  for (size_t s = 0; s < w.size(); ++s) {
    if (!w[s]) continue;
    const int b = max_bits + 1 - w[s];
    const uint32_t len = 1u << (max_bits - b);
    for (uint32_t i = 0; i < len; ++i) h.symbol[rank_idx[b] + i] = uint8_t(s);
    rank_idx[b] += len;
  }
  return used;
}

// One Huffman stream of exactly `count` literals, ending on its last bit
// (libzstd's checked decoders; its fast path is huffman_4_fast).
void huffman_stream(const Huffman& h, const uint8_t* p, size_t n, uint8_t* out, size_t count) {
  Backward bs(p, n);
  const uint32_t mask = (1u << h.max_bits) - 1;
  uint32_t state = bs.read(h.max_bits);
  for (size_t k = 0; k < count; ++k) {
    if (bs.offset <= -h.max_bits) corrupt("a Huffman stream shorter than its literals");
    out[k] = h.symbol[state];
    const int b = h.bits[state];
    state = ((state << b) + bs.read(b)) & mask;
  }
  if (bs.offset != -h.max_bits) corrupt("a Huffman stream that does not end on its last bit");
}

// HUF_selectDecoder: whether libzstd decodes four streams with its
// double-symbol tables (X2, each lookup up to two symbols) rather than
// single-symbol ones (X1), from its timing table.
bool select_x2(size_t dst, size_t src) {
  static const uint32_t kTime[16][4] = {
      {0, 0, 1, 1},          {0, 0, 1, 1},          {150, 216, 381, 119},  {170, 205, 514, 112},
      {177, 199, 539, 110},  {197, 194, 644, 107},  {221, 192, 735, 107},  {256, 189, 881, 106},
      {359, 188, 1167, 109}, {582, 187, 1570, 114}, {688, 187, 1712, 122}, {825, 186, 1965, 136},
      {976, 185, 2131, 150}, {1180, 186, 2070, 175}, {1377, 185, 1731, 202}, {1412, 185, 1695, 202}};
  const uint32_t q = src >= dst ? 15 : uint32_t(src * 16 / dst), d256 = uint32_t(dst >> 8);
  const uint32_t t0 = kTime[q][0] + kTime[q][1] * d256;
  uint32_t t1 = kTime[q][2] + kTime[q][3] * d256;
  t1 += t1 >> 5;
  return t1 < t0;
}

// libzstd's fast path for four Huffman streams of 8 bytes or more each
// (HUF_decompress4X{1,2}_usingDTable_internal_fast and its C loop, then
// HUF_decodeStreamX{1,2} on each stream's tail), which checks no stream's
// end: the streams decode five lookups at a time in lockstep while stream 1
// stays 7 bytes a round above the section's start (`q`, the jump table); a
// stream that has then read 8 bytes past its own start fails; each tail
// reads as BIT_DStream_t does, from the section's start up (a stream that
// runs out reads the bytes before it, then a bit container that stops
// reloading at the section's start and wraps: libzstd's lookups shift it
// by the consumed count modulo 64).  An X2 lookup decodes a second symbol
// from the rest of its 11 bits where that symbol's code fits them and
// they are at least the shortest code long.  For a valid stream this is
// the plain decode; a corrupt one reads what libzstd reads.
void huffman_4_fast(const Huffman& h, bool x2, const uint8_t* q, size_t qn, const size_t begin[4],
                    const size_t end[4], uint8_t* out, size_t regen) {
  auto le64 = [&](int64_t at) {
    uint64_t v = 0;
    for (int k = 0; k < 8; ++k) v |= uint64_t(size_t(at + k) < qn ? q[at + k] : 0) << (8 * k);
    return v;
  };
  const int shift = 11 - h.max_bits;  // the tables' lookups are 11 bits wide
  int min_bits = h.max_bits;
  for (uint8_t b : h.bits) min_bits = std::min<int>(min_bits, b);
  // One lookup of the 11-bit window v: writes one or two symbols at out[o],
  // returns the bits it consumes; `count` gets the symbols written.
  auto lookup = [&](uint32_t v, size_t o, size_t& count) {
    const int l1 = h.bits[v >> shift];
    out[o] = h.symbol[v >> shift];
    count = 1;
    if (x2 && 11 - l1 >= min_bits) {
      const uint32_t v2 = (v << l1) & 0x7FF;
      const int l2 = h.bits[v2 >> shift];
      if (l2 <= 11 - l1) {
        if (o + 1 < regen) out[o + 1] = h.symbol[v2 >> shift];
        count = 2;
        return l1 + l2;
      }
    }
    return l1;
  };
  const size_t seg = (regen + 3) / 4;
  int64_t pos[4], ip[4];  // the next read's top bit (from q's first bit), the loaded window
  size_t op[4], stop[4];
  for (int i = 0; i < 4; ++i) {
    const uint8_t last = q[end[i] - 1];
    pos[i] = int64_t(end[i]) * 8 - (last ? 8 - highbit(last) : 0);
    op[i] = size_t(i) * seg;
    stop[i] = i < 3 ? size_t(i + 1) * seg : regen;
  }
  auto window = [&](int i) { return int64_t(end[i]) - 8 - (int64_t(end[i]) * 8 - pos[i]) / 8; };
  auto plain = [&](int i) {  // one lookup read sequentially (never below q here)
    uint32_t v = 0;
    for (int k = 0; k < 11; ++k) {
      const int64_t bit = pos[i] - 1 - k;
      v = v << 1 | (bit >= 0 ? (q[bit >> 3] >> (bit & 7) & 1) : 0);
    }
    size_t count;
    pos[i] -= lookup(v, op[i], count);
    op[i] += count;
  };
  for (int i = 0; i < 4; ++i) ip[i] = window(i);
  for (;;) {
    size_t iters = size_t(std::max<int64_t>(ip[0], 0)) / 7;
    if (x2) {
      for (int i = 0; i < 4; ++i) iters = std::min(iters, (stop[i] - op[i]) / 10);
    } else {
      iters = std::min(iters, (regen - op[3]) / 5);
    }
    const size_t olimit = op[3] + iters * 5;
    if (iters == 0) break;
    if (ip[1] < ip[0] || ip[2] < ip[1] || ip[3] < ip[2]) break;
    do {
      for (int i = 0; i < 4; ++i)
        for (int k = 0; k < 5; ++k) plain(i);
      for (int i = 0; i < 4; ++i) ip[i] = window(i);
    } while (op[3] < olimit);
  }
  for (int i = 0; i < 4; ++i) {
    if (ip[i] < int64_t(begin[i]) - 8 || op[i] > stop[i]) corrupt("a Huffman stream read past its start");
    // HUF_initRemainingDStream, then HUF_decodeStreamX1 or X2 (64-bit).
    int64_t ptr = ip[i];
    uint64_t container = le64(ptr);
    uint32_t consumed = uint32_t(int64_t(end[i]) * 8 - pos[i]) & 7;
    bool overflow = false;
    auto reload = [&]() {  // BIT_reloadDStream: 0 unfinished, 1 end of buffer or completed, 2 overflow
      if (overflow || consumed > 64) {
        overflow = true;
        return 2;
      }
      if (ptr >= 8) {
        ptr -= consumed >> 3, consumed &= 7, container = le64(ptr);
        return 0;
      }
      if (ptr == 0) return 1;
      int64_t bytes = consumed >> 3;
      int status = 0;
      if (ptr - bytes < 0) bytes = ptr, status = 1;
      ptr -= bytes, consumed -= uint32_t(bytes) * 8, container = le64(ptr);
      return status;
    };
    auto peek = [&]() { return uint32_t((container << (consumed & 63)) >> 53); };
    auto decode = [&]() {
      size_t count;
      consumed += uint32_t(lookup(peek(), op[i], count));
      op[i] += count;
    };
    const size_t p_end = stop[i];
    if (!x2) {
      if (p_end - op[i] > 3) {
        while ((reload() == 0) & (op[i] < p_end - 3))
          for (int k = 0; k < 4; ++k) decode();
      } else {
        reload();
      }
      while (op[i] < p_end) decode();
      continue;
    }
    if (p_end - op[i] >= 8) {
      while ((reload() == 0) & (op[i] < p_end - 9))
        for (int k = 0; k < 5; ++k) decode();
    } else {
      reload();
    }
    if (p_end - op[i] >= 2) {
      while ((reload() == 0) & (op[i] <= p_end - 2)) decode();
      while (op[i] <= p_end - 2) decode();
    }
    if (op[i] < p_end) out[op[i]++] = h.symbol[peek() >> shift];  // HUF_decodeLastSymbolX2
  }
}

const uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,   10,  11,  12,   13,   14,   15,   16,   18,
                              20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,   16,   17,    18,    19,   20,
                              21, 22, 23, 24, 25, 26, 27, 28,  29,  30,  31,   32,   33,   34,   35,    37,    39,   41,
                              43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// XXH64 of the content (its low 32 bits are the frame's checksum).
uint64_t xxh64(const uint8_t* p, size_t n) {
  constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull, P3 = 1609587929392839161ull,
                     P4 = 9650029242287828579ull, P5 = 2870177450012600261ull;
  auto rotl = [](uint64_t x, int r) { return (x << r) | (x >> (64 - r)); };
  auto rd64 = [&](size_t o) { uint64_t v; std::memcpy(&v, p + o, 8); return v; };
  auto rd32 = [&](size_t o) { uint32_t v; std::memcpy(&v, p + o, 4); return uint64_t(v); };
  auto round = [&](uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; };
  auto merge = [&](uint64_t acc, uint64_t v) { return (acc ^ round(0, v)) * P1 + P4; };
  size_t i = 0;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; i + 32 <= n; i += 32)
      v1 = round(v1, rd64(i)), v2 = round(v2, rd64(i + 8)), v3 = round(v3, rd64(i + 16)), v4 = round(v4, rd64(i + 24));
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge(merge(merge(merge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += uint64_t(n);
  for (; i + 8 <= n; i += 8) h = rotl(h ^ round(0, rd64(i)), 27) * P1 + P4;
  if (i + 4 <= n) h = rotl(h ^ (rd32(i) * P1), 23) * P2 + P3, i += 4;
  for (; i < n; ++i) h = rotl(h ^ (p[i] * P5), 11) * P1;
  h ^= h >> 33, h *= P2, h ^= h >> 29, h *= P3, h ^= h >> 32;
  return h;
}

struct Frame {
  std::vector<uint8_t> out;
  Huffman huf;
  FseTable ll, of, ml;
  uint64_t rep[3] = {1, 4, 8};

  // The sequences' table of `kind` in `mode` (4.1.1 / 3.1.1.3.2.1).
  size_t table(FseTable& t, int mode, const uint8_t* p, size_t n, const int16_t* dflt, int ndflt, int dlog,
               int max_log, int max_symbol) {
    switch (mode) {
      case 0: build_fse(t, std::vector<int16_t>(dflt, dflt + ndflt), dlog); return 0;
      case 1: {
        if (n < 1) corrupt("truncated sequences");
        if (p[0] > max_symbol) corrupt("an RLE sequence code out of range");
        t.log = 0, t.symbol = {p[0]}, t.bits = {0}, t.base = {0};
        return 1;
      }
      case 2: return read_ncount(p, n, max_log, max_symbol, t);
      default:
        if (t.log < 0) corrupt("a repeated sequence table with none before it");
        return 0;
    }
  }

  void block(const uint8_t* p, size_t n) {
    // Literals section.
    if (n < 1) corrupt("an empty compressed block");
    const int ltype = p[0] & 3, fmt = p[0] >> 2 & 3;
    std::vector<uint8_t> lits;
    size_t pos;
    if (ltype < 2) {
      size_t size;
      if (fmt == 0 || fmt == 2) size = p[0] >> 3, pos = 1;
      else if (fmt == 1) {
        if (n < 2) corrupt("truncated literals");
        size = (p[0] >> 4) + (size_t(p[1]) << 4), pos = 2;
      } else {
        if (n < 3) corrupt("truncated literals");
        size = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12), pos = 3;
      }
      if (size > 131072) corrupt("literals past the block size");
      if (ltype == 0) {
        if (n - pos < size) corrupt("truncated raw literals");
        lits.assign(p + pos, p + pos + size), pos += size;
      } else {
        if (n - pos < 1) corrupt("truncated RLE literals");
        lits.assign(size, p[pos]), pos += 1;
      }
    } else {
      const int hs = fmt < 2 ? 3 : fmt == 2 ? 4 : 5, nb = fmt < 2 ? 10 : fmt == 2 ? 14 : 18;
      if (n < size_t(hs)) corrupt("truncated literals");
      uint64_t v = 0;
      for (int i = 0; i < hs; ++i) v |= uint64_t(p[i]) << (8 * i);
      const size_t regen = size_t(v >> 4 & ((1u << nb) - 1)), csize = size_t(v >> (4 + nb) & ((1u << nb) - 1));
      pos = size_t(hs);
      if (regen > 131072) corrupt("literals past the block size");
      if (n - pos < csize) corrupt("truncated compressed literals");
      const uint8_t* q = p + pos;
      size_t qn = csize;
      if (ltype == 2) {
        const size_t used = read_huffman(q, qn, huf);
        huf.x2 = fmt != 0 && select_x2(regen, csize);  // one stream: always X1
        q += used, qn -= used;
      } else if (huf.max_bits == 0) {
        corrupt("treeless literals with no Huffman table before them");
      }
      lits.assign(regen, 0);
      if (fmt == 0) {
        huffman_stream(huf, q, qn, lits.data(), regen);
      } else {
        if (qn < 6) corrupt("truncated literal streams");
        const size_t s1 = q[0] | size_t(q[1]) << 8, s2 = q[2] | size_t(q[3]) << 8, s3 = q[4] | size_t(q[5]) << 8;
        if (s1 + s2 + s3 > qn - 6) corrupt("literal streams past their section");
        const size_t seg = (regen + 3) / 4;
        if (3 * seg > regen) corrupt("four literal streams of too few literals");
        const size_t sizes[4] = {s1, s2, s3, qn - 6 - s1 - s2 - s3};
        bool fast = 3 * seg < regen && huf.max_bits <= 11;  // HUF_DecompressFastArgs_init's conditions
        for (size_t z : sizes) fast = fast && z >= 8;
        if (fast) {
          const size_t begin[4] = {6, 6 + s1, 6 + s1 + s2, 6 + s1 + s2 + s3};
          const size_t end[4] = {begin[1], begin[2], begin[3], qn};
          huffman_4_fast(huf, huf.x2, q, qn, begin, end, lits.data(), regen);
        } else {
          const uint8_t* sp = q + 6;
          for (int k = 0; k < 4; ++k) {
            huffman_stream(huf, sp, sizes[k], lits.data() + k * seg, k < 3 ? seg : regen - 3 * seg);
            sp += sizes[k];
          }
        }
      }
      pos += csize;
    }
    // Sequences section.
    if (pos >= n) corrupt("a block without its sequences section");
    size_t nseq = p[pos++];
    if (nseq >= 128) {
      if (nseq < 255) {
        if (pos >= n) corrupt("truncated sequences");
        nseq = ((nseq - 128) << 8) + p[pos++];
      } else {
        if (n - pos < 2) corrupt("truncated sequences");
        nseq = p[pos] + (size_t(p[pos + 1]) << 8) + 0x7F00, pos += 2;
      }
    }
    const size_t start = out.size();
    size_t lit = 0;
    if (nseq) {
      if (pos >= n) corrupt("truncated sequences");
      const int modes = p[pos++];
      if (modes & 3) corrupt("reserved sequence mode bits set");
      pos += table(ll, modes >> 6, p + pos, n - pos, kLLDefault, 36, 6, 9, 35);
      pos += table(of, modes >> 4 & 3, p + pos, n - pos, kOFDefault, 29, 5, 8, 31);
      pos += table(ml, modes >> 2 & 3, p + pos, n - pos, kMLDefault, 53, 6, 9, 52);
      if (pos > n) corrupt("truncated sequences");
      Backward bs(p + pos, n - pos);
      uint32_t sl = bs.read(ll.log), so = bs.read(of.log), sm = bs.read(ml.log);
      for (size_t i = 0; i < nseq; ++i) {
        const int ofc = of.symbol[so], llc = ll.symbol[sl], mlc = ml.symbol[sm];
        if (llc > 35 || mlc > 52 || ofc > 31) corrupt("a sequence code out of range");
        uint64_t offset = (uint64_t(1) << ofc) + bs.read(ofc);
        const uint64_t mlen = kMLBase[mlc] + bs.read(kMLBits[mlc]);
        const uint64_t llen = kLLBase[llc] + bs.read(kLLBits[llc]);
        if (i + 1 < nseq) {
          sl = ll.base[sl] + bs.read(ll.bits[sl]);
          sm = ml.base[sm] + bs.read(ml.bits[sm]);
          so = of.base[so] + bs.read(of.bits[so]);
        }
        if (offset <= 3) {  // a repeat offset
          const uint64_t idx = offset - 1 + (llen == 0);
          if (idx == 0) {
            offset = rep[0];
          } else {
            offset = idx < 3 ? rep[idx] : rep[0] - 1;
            if (idx > 1) rep[2] = rep[1];
            rep[1] = rep[0], rep[0] = offset;
          }
        } else {
          offset -= 3;
          rep[2] = rep[1], rep[1] = rep[0], rep[0] = offset;
        }
        if (llen > lits.size() - lit) corrupt("a sequence past its literals");
        out.insert(out.end(), lits.begin() + int64_t(lit), lits.begin() + int64_t(lit + llen));
        lit += size_t(llen);
        if (offset == 0 || offset > out.size()) corrupt("a match before the frame's start");
        if (out.size() - start + mlen > 131072) corrupt("a block past the block size");
        const size_t from = out.size() - size_t(offset);
        for (uint64_t k = 0; k < mlen; ++k) out.push_back(out[from + size_t(k)]);
      }
      if (bs.offset != 0) corrupt("a sequences bitstream that does not end on its last bit");
    } else if (pos != n) {
      corrupt("bytes after a block's literals");
    }
    out.insert(out.end(), lits.begin() + int64_t(lit), lits.end());
    if (out.size() - start > 131072) corrupt("a block past the block size");
  }
};

}  // namespace

std::vector<uint8_t> decode(const uint8_t* p, size_t n, size_t need) {
  if (n < 4) corrupt("no frame");
  const uint32_t magic = uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24;
  if (magic != 0xFD2FB528u) corrupt("not a Zstandard frame");
  size_t pos = 4;
  if (pos >= n) corrupt("a truncated frame header");
  const int fhd = p[pos++];
  const int fcs_flag = fhd >> 6, single = fhd >> 5 & 1, checksum = fhd >> 2 & 1, dict_flag = fhd & 3;
  if (fhd & 8) corrupt("a reserved frame header bit set");
  uint64_t window = 0;
  if (!single) {
    if (pos >= n) corrupt("a truncated frame header");
    const int wd = p[pos++];
    const uint64_t base = uint64_t(1) << (10 + (wd >> 3));
    window = base + base / 8 * uint64_t(wd & 7);
  }
  const int dict_bytes = dict_flag == 3 ? 4 : dict_flag;
  uint64_t dict = 0;
  for (int i = 0; i < dict_bytes; ++i, ++pos) {
    if (pos >= n) corrupt("a truncated frame header");
    dict |= uint64_t(p[pos]) << (8 * i);
  }
  if (dict) corrupt("a frame that needs a dictionary");
  const int fcs_bytes = fcs_flag == 0 ? single : fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8;
  uint64_t fcs = 0;
  for (int i = 0; i < fcs_bytes; ++i, ++pos) {
    if (pos >= n) corrupt("a truncated frame header");
    fcs |= uint64_t(p[pos]) << (8 * i);
  }
  if (fcs_bytes == 2) fcs += 256;
  if (single) window = fcs;
  if (window > (uint64_t(1) << 27) + 1) corrupt("a frame window above libzstd's limit of 2^27 bytes");
  // libzstd decodes the frame in one pass when its content size is known,
  // fits the strip and the whole frame (checksum included) is at hand;
  // otherwise it streams, block by block, and stops at the block that
  // fills the strip (checking the frame's end only if that block is last).
  bool one_pass = fcs_bytes && fcs <= need;
  for (size_t q = pos;;) {
    if (!one_pass || n - q < 3) {
      one_pass = false;
      break;
    }
    const uint32_t bh = uint32_t(p[q]) | uint32_t(p[q + 1]) << 8 | uint32_t(p[q + 2]) << 16;
    const size_t body = (bh >> 1 & 3) == 1 ? 1 : (bh >> 1 & 3) == 3 ? n : bh >> 3;
    if (body > n - q - 3) {
      one_pass = false;
      break;
    }
    q += 3 + body;
    if (bh & 1) {
      one_pass = !checksum || n - q >= 4;
      break;
    }
  }
  Frame f;
  f.out.reserve(need);
  for (;;) {
    if (n - pos < 3) corrupt("a truncated block header");
    const uint32_t bh = uint32_t(p[pos]) | uint32_t(p[pos + 1]) << 8 | uint32_t(p[pos + 2]) << 16;
    pos += 3;
    const bool last = bh & 1;
    const int type = bh >> 1 & 3;
    const size_t size = bh >> 3;
    if (size > 131072 || (window && size > window && type != 1)) corrupt("a block past the block size");
    if (type == 0) {
      if (n - pos < size) corrupt("a truncated raw block");
      f.out.insert(f.out.end(), p + pos, p + pos + size), pos += size;
    } else if (type == 1) {
      if (n - pos < 1) corrupt("a truncated RLE block");
      f.out.insert(f.out.end(), size, p[pos]), pos += 1;
    } else if (type == 2) {
      if (n - pos < size) corrupt("a truncated compressed block");
      f.block(p + pos, size), pos += size;
    } else {
      corrupt("a reserved block type");
    }
    if (f.out.size() >= need && !last && !one_pass) break;  // the strip is full: no further block is read
    if (last) {
      if (fcs_bytes && f.out.size() != fcs) corrupt("a frame whose content differs from its size");
      if (checksum && (n - pos >= 4 || f.out.size() < need)) {
        if (n - pos < 4) corrupt("a truncated checksum");
        const uint32_t want = uint32_t(p[pos]) | uint32_t(p[pos + 1]) << 8 | uint32_t(p[pos + 2]) << 16 |
                              uint32_t(p[pos + 3]) << 24;
        if (uint32_t(xxh64(f.out.data(), f.out.size())) != want) corrupt("a checksum that does not match");
      }
      break;
    }
  }
  if (f.out.size() < need) throw std::runtime_error("not enough ZSTD data in a TIFF strip or tile");
  f.out.resize(need);
  return std::move(f.out);
}

}  // namespace zstd
