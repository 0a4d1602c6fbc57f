// GPU texture blocks (the library's sixth source, beside image_decode.cpp):
// the three decoders behind Pillow's DDS, FTEX and BLP openers, each
// bit-equal to Pillow 12.1's.
//
//   imgb_bcn     the C "bcn" decoder (libImaging/BcnDecode.c), which DDS and
//                FTEX use: BC1 (DXT1, 1-bit alpha), BC2 (DXT3), BC3 (DXT5),
//                BC4, BC5 unsigned and signed, BC6H unsigned and signed
//                (halves turned to bytes: clamped to [0, 1], times 255,
//                truncated), BC7 (a first byte of 0: opaque black).
//                Blocks run left to right, top to bottom; a partial block
//                at the right or bottom edge is cut.  Data short of the
//                last block: Pillow raises ("image file is truncated").
//   imgb_masked  DdsRgbDecoder, Python: 8- to 32-bit pixels under channel
//                masks padded by zeros, each channel int((v >> shift) /
//                (mask >> shift) * 255) in double arithmetic; data short of
//                the image reads as zeros.
//   imgb_blp_dxt BlpImagePlugin's Python decode_dxt1/3/5, which is another
//                DXT decoder: 5:6:5 colour widened by shifts alone (no bit
//                copies), blends rounded down; DXT1's (0, 0, 0, 0) only
//                where the file has alpha, RGB otherwise; DXT3 and DXT5
//                always four colours.  It writes whole 4 x 4 blocks, rows
//                of (w + 3) / 4 blocks, which the caller reads as the
//                image's own width (Pillow's set_as_raw).
//
// The caller (utils/image_decode.py) reads the headers and hands over the
// data's offset, the size and an output buffer of h x w x C bytes.  Every
// read of the input is bounds-checked.  Build: the library's flags
// (image_decode.cpp's header).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw Error(msg); }

struct Rgba {
  uint8_t r, g, b, a;
};

uint16_t le16(const uint8_t* p) { return uint16_t(p[0] | p[1] << 8); }
uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24;
}

// ------------------------------------------------------------ BC1 - BC5 --

// BcnDecode.c decode_565: 5:6:5 widened with the top bits copied down.
Rgba decode_565(uint16_t c) {
  const int r = (c & 0xf800) >> 8, g = (c & 0x07e0) >> 3, b = (c & 0x001f) << 3;
  return {uint8_t(r | r >> 5), uint8_t(g | g >> 6), uint8_t(b | b >> 5), 255};
}

// decode_bc1_color: BC2 and BC3 (`separate_alpha`) always take four colours.
void bc1_color(Rgba* dst, const uint8_t* src, bool separate_alpha) {
  const uint16_t c0 = le16(src), c1 = le16(src + 2);
  const uint32_t lut = le32(src + 4);
  Rgba p[4] = {decode_565(c0), decode_565(c1), {}, {}};
  const int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b, r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || separate_alpha) {
    p[2] = {uint8_t((2 * r0 + r1) / 3), uint8_t((2 * g0 + g1) / 3), uint8_t((2 * b0 + b1) / 3), 255};
    p[3] = {uint8_t((r0 + 2 * r1) / 3), uint8_t((g0 + 2 * g1) / 3), uint8_t((b0 + 2 * b1) / 3), 255};
  } else {
    p[2] = {uint8_t((r0 + r1) / 2), uint8_t((g0 + g1) / 2), uint8_t((b0 + b1) / 2), 255};
    p[3] = {0, 0, 0, 0};
  }
  for (int n = 0; n < 16; ++n) dst[n] = p[(lut >> (2 * n)) & 3];
}

// decode_bc3_alpha: eight levels where a0 > a1, else six and 0, 255; BC5S
// reads its endpoints as signed bytes plus 128.  Writes byte `o` of each
// `stride`-byte pixel.
void bc3_alpha(uint8_t* dst, const uint8_t* src, int stride, int o, bool sign) {
  int a0 = src[0], a1 = src[1];
  if (sign) a0 = int(int8_t(src[0])) + 128, a1 = int(int8_t(src[1])) + 128;
  int a[8] = {a0, a1};
  if (a0 > a1) {
    for (int i = 1; i < 7; ++i) a[i + 1] = ((7 - i) * a0 + i * a1) / 7;
  } else {
    for (int i = 1; i < 5; ++i) a[i + 1] = ((5 - i) * a0 + i * a1) / 5;
    a[6] = 0, a[7] = 255;
  }
  const uint32_t lut1 = uint32_t(src[2]) | uint32_t(src[3]) << 8 | uint32_t(src[4]) << 16;
  const uint32_t lut2 = uint32_t(src[5]) | uint32_t(src[6]) << 8 | uint32_t(src[7]) << 16;
  for (int n = 0; n < 8; ++n) dst[stride * n + o] = uint8_t(a[(lut1 >> (3 * n)) & 7]);
  for (int n = 0; n < 8; ++n) dst[stride * (8 + n) + o] = uint8_t(a[(lut2 >> (3 * n)) & 7]);
}

// -------------------------------------------------------- BC6H and BC7 --

// The bits of a 16-byte block, least significant first.
struct Bits {
  const uint8_t* p;
  int pos = 0;
  int get(int n) {
    int v = 0;
    for (int i = 0; i < n; ++i, ++pos) v |= ((p[pos >> 3] >> (pos & 7)) & 1) << i;
    return v;
  }
};

// BC7's partition sets (bit i of an entry: pixel i's subset for two
// subsets; bits 2i, 2i+1 for three) and the anchor pixels of the second
// and third subsets.  BC6H's two-region modes take the first 32.
const uint16_t kPartition2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80, 0xc800, 0xffec, 0xfe80, 0xe800, 0xffe8,
    0xff00, 0xfff0, 0xf000, 0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce, 0x088c, 0x3110,
    0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c, 0xaaaa, 0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696,
    0xa55a, 0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660, 0x0272, 0x04e4, 0x4e40, 0x2720,
    0xc936, 0x936c, 0x39c6, 0x639c, 0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22};
const uint32_t kPartition3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050, 0x5555a0a0, 0x5a5a5050,
    0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090, 0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250,
    0xa5945040, 0x0a425054, 0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414, 0x50a4a450, 0x6a5a0200,
    0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424, 0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50,
    0x500aa550, 0xaaaa4444, 0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580, 0xaa141414, 0x96960000,
    0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000, 0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254};
const uint8_t kAnchor2[64] = {15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
                              15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
                              15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
                              6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t kAnchor3a[64] = {3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
                               3,  3,  8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
                               8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
                               3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t kAnchor3b[64] = {15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
                               15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
                               15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
                               15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};

const int kWeights2[4] = {0, 21, 43, 64};
const int kWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const int kWeights4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

const int* weights(int bits) { return bits == 2 ? kWeights2 : bits == 3 ? kWeights3 : kWeights4; }

// The subset of pixel i in partition `p` of a `ns`-subset mode.
int subset(int ns, int p, int i) {
  return ns == 2 ? (kPartition2[p] >> i) & 1 : ns == 3 ? int(kPartition3[p] >> (2 * i)) & 3 : 0;
}

// Whether pixel i anchors its subset (its index has one bit less).
bool anchor(int ns, int p, int i) {
  if (i == 0) return true;
  return (ns == 2 && i == kAnchor2[p]) || (ns == 3 && (i == kAnchor3a[p] || i == kAnchor3b[p]));
}

// BC7's modes: subsets, partition bits, rotation bits, index-selection
// bits, colour and alpha endpoint bits, a p-bit an endpoint or a subset,
// primary and secondary index bits.
struct Bc7Mode {
  int ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
const Bc7Mode kBc7[8] = {{3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
                         {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
                         {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
                         {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

uint8_t expand(int v, int bits) {
  v <<= 8 - bits;
  return uint8_t(v | v >> bits);
}

void bc7_block(Rgba* col, const uint8_t* src) {
  if (!src[0]) {  // no mode bit set
    for (int i = 0; i < 16; ++i) col[i] = {0, 0, 0, 255};
    return;
  }
  int mode = 0;
  while (!(src[0] >> mode & 1)) ++mode;
  const Bc7Mode& m = kBc7[mode];
  Bits bs{src, mode + 1};
  const int partition = bs.get(m.pb), rotation = bs.get(m.rb), index_sel = bs.get(m.isb);
  const int numep = 2 * m.ns;
  int ep[6][4] = {};
  for (int ch = 0; ch < 3; ++ch)
    for (int e = 0; e < numep; ++e) ep[e][ch] = bs.get(m.cb);
  for (int e = 0; e < numep; ++e) ep[e][3] = m.ab ? bs.get(m.ab) : 255;
  int cbits = m.cb, abits = m.ab;
  if (m.epb || m.spb) {
    int p[6];
    if (m.epb) {
      for (int e = 0; e < numep; ++e) p[e] = bs.get(1);
    } else {
      for (int s = 0; s < m.ns; ++s) p[2 * s] = p[2 * s + 1] = bs.get(1);
    }
    for (int e = 0; e < numep; ++e) {
      for (int ch = 0; ch < 3; ++ch) ep[e][ch] = ep[e][ch] << 1 | p[e];
      if (m.ab) ep[e][3] = ep[e][3] << 1 | p[e];
    }
    ++cbits;
    if (m.ab) ++abits;
  }
  for (int e = 0; e < numep; ++e) {
    for (int ch = 0; ch < 3; ++ch) ep[e][ch] = expand(ep[e][ch], cbits);
    if (m.ab) ep[e][3] = expand(ep[e][3], abits);
  }
  int idx[16], idx2[16];
  for (int i = 0; i < 16; ++i) idx[i] = bs.get(m.ib - (anchor(m.ns, partition, i) ? 1 : 0));
  for (int i = 0; i < 16; ++i) idx2[i] = m.ib2 ? bs.get(m.ib2 - (i == 0 ? 1 : 0)) : idx[i];
  int cib = m.ib, aib = m.ib2 ? m.ib2 : m.ib;
  const int* ci = idx;
  const int* ai = idx2;
  if (index_sel) std::swap(cib, aib), std::swap(ci, ai);
  const int* cw = weights(cib);
  const int* aw = weights(aib);
  for (int i = 0; i < 16; ++i) {
    const int s = subset(m.ns, partition, i);
    const int* e0 = ep[2 * s];
    const int* e1 = ep[2 * s + 1];
    int v[4];
    for (int ch = 0; ch < 3; ++ch) v[ch] = ((64 - cw[ci[i]]) * e0[ch] + cw[ci[i]] * e1[ch] + 32) >> 6;
    v[3] = ((64 - aw[ai[i]]) * e0[3] + aw[ai[i]] * e1[3] + 32) >> 6;
    if (rotation) std::swap(v[3], v[rotation - 1]);
    col[i] = {uint8_t(v[0]), uint8_t(v[1]), uint8_t(v[2]), uint8_t(v[3])};
  }
}

// BC6H's modes: regions, whether x, y, z hold deltas from w, the endpoint
// bits and the delta (or endpoint) bits of red, green and blue; and the
// layout of their bits after the mode bits, in the BC6H tables' notation:
// "<channel><endpoint>[a:b]" reads bit b first, stepping toward a
// (endpoint 0-3: w, x, y, z).
struct Bc6Mode {
  int ns, tr, epb, db[3];
  const char* layout;
};
const Bc6Mode kBc6[14] = {
    {2, 1, 10, {5, 5, 5}, "g2[4] b2[4] b3[4] r0[9:0] g0[9:0] b0[9:0] r1[4:0] g3[4] g2[3:0] g1[4:0] b3[0] g3[3:0] "
                          "b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]"},
    {2, 1, 7, {6, 6, 6}, "g2[5] g3[4] g3[5] r0[6:0] b3[0] b3[1] b2[4] g0[6:0] b2[5] b3[2] g2[4] b0[6:0] b3[3] b3[5] "
                         "b3[4] r1[5:0] g2[3:0] g1[5:0] g3[3:0] b1[5:0] b2[3:0] r2[5:0] r3[5:0]"},
    {2, 1, 11, {5, 4, 4}, "r0[9:0] g0[9:0] b0[9:0] r1[4:0] r0[10] g2[3:0] g1[3:0] g0[10] b3[0] g3[3:0] b1[3:0] "
                          "b0[10] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]"},
    {2, 1, 11, {4, 5, 4}, "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10] g3[4] g2[3:0] g1[4:0] g0[10] g3[3:0] b1[3:0] "
                          "b0[10] b3[1] b2[3:0] r2[3:0] b3[0] b3[2] r3[3:0] g2[4] b3[3]"},
    {2, 1, 11, {4, 4, 5}, "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10] b2[4] g2[3:0] g1[3:0] g0[10] b3[0] g3[3:0] "
                          "b1[4:0] b0[10] b2[3:0] r2[3:0] b3[1] b3[2] r3[3:0] b3[4] b3[3]"},
    {2, 1, 9, {5, 5, 5}, "r0[8:0] b2[4] g0[8:0] g2[4] b0[8:0] b3[4] r1[4:0] g3[4] g2[3:0] g1[4:0] b3[0] g3[3:0] "
                         "b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]"},
    {2, 1, 8, {6, 5, 5}, "r0[7:0] g3[4] b2[4] g0[7:0] b3[2] g2[4] b0[7:0] b3[3] b3[4] r1[5:0] g2[3:0] g1[4:0] "
                         "b3[0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[5:0] r3[5:0]"},
    {2, 1, 8, {5, 6, 5}, "r0[7:0] b3[0] b2[4] g0[7:0] g2[5] g2[4] b0[7:0] g3[5] b3[4] r1[4:0] g3[4] g2[3:0] "
                         "g1[5:0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]"},
    {2, 1, 8, {5, 5, 6}, "r0[7:0] b3[1] b2[4] g0[7:0] b2[5] g2[4] b0[7:0] b3[5] b3[4] r1[4:0] g3[4] g2[3:0] "
                         "g1[4:0] b3[0] g3[3:0] b1[5:0] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]"},
    {2, 0, 6, {6, 6, 6}, "r0[5:0] g3[4] b3[0] b3[1] b2[4] g0[5:0] g2[5] b2[5] b3[2] g2[4] b0[5:0] g3[5] b3[3] "
                         "b3[5] b3[4] r1[5:0] g2[3:0] g1[5:0] g3[3:0] b1[5:0] b2[3:0] r2[5:0] r3[5:0]"},
    {1, 0, 10, {10, 10, 10}, "r0[9:0] g0[9:0] b0[9:0] r1[9:0] g1[9:0] b1[9:0]"},
    {1, 1, 11, {9, 9, 9}, "r0[9:0] g0[9:0] b0[9:0] r1[8:0] r0[10] g1[8:0] g0[10] b1[8:0] b0[10]"},
    {1, 1, 12, {8, 8, 8}, "r0[9:0] g0[9:0] b0[9:0] r1[7:0] r0[10:11] g1[7:0] g0[10:11] b1[7:0] b0[10:11]"},
    {1, 1, 16, {4, 4, 4}, "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10:15] g1[3:0] g0[10:15] b1[3:0] b0[10:15]"}};

// A layout's fields: (endpoint, channel, first bit, last bit).
struct Field {
  int ep, ch, first, last;
};

std::vector<Field> parse_layout(const char* s) {
  std::vector<Field> out;
  const std::string t(s);
  size_t i = 0;
  while (i < t.size()) {
    if (t[i] == ' ') {
      ++i;
      continue;
    }
    const int ch = t[i] == 'r' ? 0 : t[i] == 'g' ? 1 : 2, ep = t[i + 1] - '0';
    const size_t close = t.find(']', i);
    const std::string inner = t.substr(i + 3, close - i - 3);
    const size_t colon = inner.find(':');
    int a = std::stoi(inner.substr(0, colon)), b = colon == std::string::npos ? a : std::stoi(inner.substr(colon + 1));
    out.push_back({ep, ch, b, a});
    i = close + 1;
  }
  return out;
}

// The mode of a block's first bits: 2-bit modes 0 and 1, 5-bit modes
// 2-13, -1 reserved.
int bc6_mode(const uint8_t* src) {
  if ((src[0] & 3) < 2) return src[0] & 3;
  static const int k5[32] = {-1, -1, 2, 10, -1, -1, 3, 11, -1, -1, 4, 12, -1, -1, 5, 13,
                             -1, -1, 6, -1, -1, -1, 7, -1, -1, -1, 8, -1, -1, -1, 9, -1};
  return k5[src[0] & 31];
}

int sign_extend(int v, int bits) { return v & (1 << (bits - 1)) ? v - (1 << bits) : v; }

int bc6_unquantize(int v, int bits, bool sign) {
  if (!sign) {
    if (bits >= 15) return v;
    if (v == 0) return 0;
    if (v == (1 << bits) - 1) return 0xffff;
    return ((v << 16) + 0x8000) >> bits;
  }
  if (bits >= 16) return int16_t(v);
  const bool neg = v < 0;
  if (neg) v = -v;
  int u = v == 0 ? 0 : v >= (1 << (bits - 1)) - 1 ? 0x7fff : ((v << 15) + 0x4000) >> (bits - 1);
  return neg ? -u : u;
}

// Pillow's half_to_float (the "rygorous" conversion; an infinite or NaN
// half keeps the top exponent).
float half_to_float(uint16_t h) {
  uint32_t u = uint32_t(h & 0x7fff) << 13, mu = 0x77800000u, lim = 0x47800000u;
  float o, m, l;
  std::memcpy(&o, &u, 4);
  std::memcpy(&m, &mu, 4);
  std::memcpy(&l, &lim, 4);
  o *= m;
  std::memcpy(&u, &o, 4);
  if (o >= l) u |= 255u << 23;
  u |= uint32_t(h & 0x8000) << 16;
  std::memcpy(&o, &u, 4);
  return o;
}

float bc6_finalize(int v, bool sign) {
  if (!sign) return half_to_float(uint16_t((v * 31) >> 6));
  return v < 0 ? half_to_float(uint16_t(0x8000 | (((-v) * 31) >> 5))) : half_to_float(uint16_t((v * 31) >> 5));
}

uint8_t bc6_byte(float f) {
  if (f < 0.0f) return 0;
  if (f > 1.0f) return 255;
  return uint8_t(f * 255.0f);
}

void bc6_block(Rgba* col, const uint8_t* src, bool sign) {
  static std::vector<Field> layouts[14];
  static bool parsed = [] {
    for (int i = 0; i < 14; ++i) layouts[i] = parse_layout(kBc6[i].layout);
    return true;
  }();
  (void)parsed;
  const int mode = bc6_mode(src);
  if (mode < 0) {
    for (int i = 0; i < 16; ++i) col[i] = {0, 0, 0, 0};
    return;
  }
  const Bc6Mode& m = kBc6[mode];
  Bits bs{src, mode < 2 ? 2 : 5};
  int ep[4][3] = {};
  for (const Field& f : layouts[mode]) {
    const int step = f.last >= f.first ? 1 : -1;
    for (int b = f.first;; b += step) {
      ep[f.ep][f.ch] |= bs.get(1) << b;
      if (b == f.last) break;
    }
  }
  const int numep = 2 * m.ns;
  const int partition = m.ns == 2 ? bs.get(5) : 0;
  for (int ch = 0; ch < 3; ++ch) {
    if (sign) ep[0][ch] = sign_extend(ep[0][ch], m.epb);
    for (int e = 1; e < numep; ++e) {
      if (m.tr || sign) ep[e][ch] = sign_extend(ep[e][ch], m.db[ch]);
      if (m.tr) ep[e][ch] = (ep[0][ch] + ep[e][ch]) & ((1 << m.epb) - 1);
    }
    for (int e = 0; e < numep; ++e) ep[e][ch] = bc6_unquantize(ep[e][ch], m.epb, sign);
  }
  const int ib = m.ns == 2 ? 3 : 4;
  const int* w = weights(ib);
  for (int i = 0; i < 16; ++i) {
    const int s = m.ns == 2 ? subset(2, partition, i) : 0;
    const int k = w[bs.get(ib - (anchor(m.ns, partition, i) ? 1 : 0))];
    uint8_t v[3];
    for (int ch = 0; ch < 3; ++ch)
      v[ch] = bc6_byte(bc6_finalize((ep[2 * s][ch] * (64 - k) + ep[2 * s + 1][ch] * k) >> 6, sign));
    col[i] = {v[0], v[1], v[2], 255};
  }
}

// One block of format `n` into 16 pixels of `c` bytes.
void decode_block(int n, bool sign, const uint8_t* src, uint8_t* px, int c) {
  Rgba col[16];
  switch (n) {
    case 1: bc1_color(col, src, false); break;
    case 2:
      bc1_color(col, src + 8, true);
      for (int i = 0; i < 16; ++i) {
        const int a = (src[i / 2] >> (4 * (i & 1))) & 15;
        col[i].a = uint8_t(a << 4 | a);
      }
      break;
    case 3:
      bc1_color(col, src + 8, true);
      bc3_alpha(&col[0].a, src, 4, 0, false);
      break;
    case 4: bc3_alpha(px, src, 1, 0, false); return;
    case 5: {
      const uint8_t fill = sign ? 128 : 0;
      for (auto& p : col) p = {fill, fill, fill, fill};
      bc3_alpha(&col[0].r, src, 4, 0, sign);
      bc3_alpha(&col[0].r, src + 8, 4, 1, sign);
      break;
    }
    case 6: bc6_block(col, src, sign); break;
    case 7: bc7_block(col, src); break;
    default: fail("unknown BCn format " + std::to_string(n));
  }
  for (int i = 0; i < 16; ++i) std::memcpy(px + i * c, &col[i], size_t(c));
}

// ------------------------------------------------- BLP's Python DXT -----

void blp_565(uint16_t c, int* rgb) {
  rgb[0] = ((c >> 11) & 31) << 3, rgb[1] = ((c >> 5) & 63) << 2, rgb[2] = (c & 31) << 3;
}

// decode_dxt1/3/5 of one block into 16 pixels of `c` (3 or 4) bytes.
void blp_block(int kind, bool alpha, const uint8_t* src, uint8_t* px, int c) {
  const uint8_t* cb = kind == 1 ? src : src + 8;
  const uint16_t c0 = le16(cb), c1 = le16(cb + 2);
  const uint32_t code = le32(cb + 4);
  int p0[3], p1[3];
  blp_565(c0, p0);
  blp_565(c1, p1);
  int pal[4][4];
  const bool four = kind != 1 || c0 > c1;
  for (int k = 0; k < 3; ++k) {
    pal[0][k] = p0[k], pal[1][k] = p1[k];
    pal[2][k] = four ? (2 * p0[k] + p1[k]) / 3 : (p0[k] + p1[k]) / 2;
    pal[3][k] = four ? (2 * p1[k] + p0[k]) / 3 : 0;
  }
  pal[0][3] = pal[1][3] = pal[2][3] = 255, pal[3][3] = four ? 255 : 0;
  int a[8] = {src[0], src[1]};
  if (kind == 3) {
    const int a0 = src[0], a1 = src[1];
    for (int k = 2; k < 8; ++k)
      a[k] = a0 > a1 ? ((8 - k) * a0 + (k - 1) * a1) / 7
             : k == 6 ? 0 : k == 7 ? 255 : ((6 - k) * a0 + (k - 1) * a1) / 5;
  }
  const uint64_t alpha_bits = uint64_t(src[2]) | uint64_t(src[3]) << 8 | uint64_t(src[4]) << 16 |
                              uint64_t(src[5]) << 24 | uint64_t(src[6]) << 32 | uint64_t(src[7]) << 40;
  for (int i = 0; i < 16; ++i) {
    const int* p = pal[(code >> (2 * i)) & 3];
    uint8_t* o = px + i * c;
    o[0] = uint8_t(p[0]), o[1] = uint8_t(p[1]), o[2] = uint8_t(p[2]);
    if (c == 3) continue;
    if (kind == 1) o[3] = uint8_t(p[3]);
    else if (kind == 2) o[3] = uint8_t(((src[i / 2] >> (4 * (i & 1))) & 15) * 17);
    else o[3] = uint8_t(a[(alpha_bits >> (3 * i)) & 7]);
  }
}

void write_error(char* err, int64_t errlen, const char* msg) {
  if (err && errlen > 0) {
    std::strncpy(err, msg, size_t(errlen) - 1);
    err[errlen - 1] = 0;
  }
}

// The block grid of a w x h image from `offset`, `bsize` bytes a block,
// after checking the data holds every block.
void check_blocks(int64_t size, int64_t offset, int64_t w, int64_t h, int bsize) {
  if (w <= 0 || h <= 0 || offset < 0) fail("image has no pixels");
  const uint64_t need = uint64_t((w + 3) / 4) * uint64_t((h + 3) / 4) * uint64_t(bsize);
  if (uint64_t(offset) > uint64_t(size) || uint64_t(size) - uint64_t(offset) < need)
    fail("image file is truncated (BCn data short of the image; Pillow raises too)");
}

}  // namespace

extern "C" {

// Pillow's "bcn" decoder: format `n` 1-7 (`sign`: BC5S, BC6H SF16) of a
// w x h image from `offset` into `out`, h x w x C bytes (C: 1 for BC4, 3
// for BC5 and BC6H, else 4).  0, or -1 with the reason in err.
int imgb_bcn(const uint8_t* data, int64_t size, int64_t offset, int32_t n, int32_t sign, int64_t w, int64_t h,
             uint8_t* out, char* err, int64_t errlen) {
  try {
    const int bsize = n == 1 || n == 4 ? 8 : 16, c = n == 4 ? 1 : n == 5 || n == 6 ? 3 : 4;
    check_blocks(size, offset, w, h, bsize);
    const uint8_t* src = data + offset;
    uint8_t px[16 * 4];
    for (int64_t by = 0; by < h; by += 4) {
      for (int64_t bx = 0; bx < w; bx += 4, src += bsize) {
        decode_block(n, sign != 0, src, px, c);
        for (int j = 0; j < 4 && by + j < h; ++j) {
          const int cols = int(std::min<int64_t>(4, w - bx));
          std::memcpy(out + ((by + j) * w + bx) * c, px + j * 4 * c, size_t(cols * c));
        }
      }
    }
    return 0;
  } catch (const std::exception& e) {
    write_error(err, errlen, e.what());
  }
  return -1;
}

// DdsRgbDecoder: `nmasks` (3 or 4) channels of w x h pixels of `bytecount`
// bytes each from `offset` (bytes past the data read as zeros) into
// `out`, h x w x nmasks bytes.
void imgb_masked(const uint8_t* data, int64_t size, int64_t offset, int64_t bytecount, const uint32_t* masks,
                 int32_t nmasks, int64_t w, int64_t h, uint8_t* out) {
  int shift[4];
  uint32_t total[4];
  for (int i = 0; i < nmasks; ++i) {
    shift[i] = 0;
    if (masks[i])
      while (!(masks[i] >> shift[i] & 1)) ++shift[i];
    total[i] = masks[i] >> shift[i];
  }
  const uint64_t end = uint64_t(size < 0 ? 0 : size), npx = uint64_t(w) * uint64_t(h);
  uint64_t pos = uint64_t(offset < 0 ? 0 : offset);
  const uint64_t used = uint64_t(std::min<int64_t>(bytecount, 4));
  for (uint64_t i = 0; i < npx; ++i, pos += uint64_t(bytecount)) {
    uint32_t v = 0;
    for (uint64_t k = 0; k < used && pos + k < end; ++k) v |= uint32_t(data[pos + k]) << (8 * k);
    for (int c = 0; c < nmasks; ++c)
      out[i * uint64_t(nmasks) + uint64_t(c)] =
          total[c] ? uint8_t(int(double((v & masks[c]) >> shift[c]) / double(total[c]) * 255.0)) : 0;
    if (pos >= end) {  // the rest reads as zeros: nothing more to read
      for (uint64_t k = (i + 1) * uint64_t(nmasks); k < npx * uint64_t(nmasks); ++k) out[k] = 0;
      break;
    }
  }
}

// BLP2's DXT1 (`kind` 1; `alpha`: RGBA, else RGB), DXT3 (2) or DXT5 (3)
// blocks of a w x h image from `offset`, decoded as BlpImagePlugin's
// Python does into `out`: 4 * ((h + 3) / 4) rows of 4 * ((w + 3) / 4)
// pixels of 4 bytes (DXT1 without alpha: 3).  0, or -1 with the reason.
int imgb_blp_dxt(const uint8_t* data, int64_t size, int64_t offset, int32_t kind, int32_t alpha, int64_t w,
                 int64_t h, uint8_t* out, char* err, int64_t errlen) {
  try {
    const int bsize = kind == 1 ? 8 : 16, c = kind == 1 && !alpha ? 3 : 4;
    const int64_t bw = (w + 3) / 4, bh = (h + 3) / 4;
    if (w <= 0 || h <= 0 || offset < 0) fail("image has no pixels");
    if (uint64_t(offset) > uint64_t(size) || uint64_t(size - offset) < uint64_t(bw * bh * bsize))
      fail("Truncated File Read (BLP DXT data; Pillow raises too)");
    const uint8_t* src = data + offset;
    uint8_t px[16 * 4];
    for (int64_t by = 0; by < bh; ++by)
      for (int64_t bx = 0; bx < bw; ++bx, src += bsize) {
        blp_block(kind, alpha != 0, src, px, c);
        for (int j = 0; j < 4; ++j)
          std::memcpy(out + ((4 * by + j) * 4 * bw + 4 * bx) * c, px + j * 4 * c, size_t(4 * c));
      }
    return 0;
  } catch (const std::exception& e) {
    write_error(err, errlen, e.what());
  }
  return -1;
}

}  // extern "C"
