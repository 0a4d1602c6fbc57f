// The plain raster formats of Pillow's opener table (the library's fifth
// source, beside image_decode.cpp): PCX (and DCX's pages), QOI, SGI, Sun
// raster, MSP, XBM, XPM's pixels, IM, SPIDER, FITS, FLI/FLC, GBR, IM
// Tools, McIdas, Photo CD, PIXAR and XV thumbnails.  Their headers (text, key lines, 80-byte cards,
// page tables, colour tables) are read by the caller
// (utils/image_decode.py), which hands this file the tile Pillow's plugin
// would build: a decoder, Pillow's mode and rawmode, the data's offset and
// the decoder's arguments.  Each decoder writes Pillow's image memory as
// its C decoder does (RawDecode.c, PcxDecode.c, SgiRleDecode.c,
// SunRleDecode.c, XbmDecode.c, BitDecode.c, FliDecode.c, PcdDecode.c) or
// as its Python decoder does (QoiDecoder, MspDecoder, XpmDecoder), rows
// unpacked by Pillow's
// unpacker of that rawmode (Unpack.c); the result is then converted as the
// JAX package converts it, convert("RGBA") / convert("L"):
//
//   "1", "L", "LA", "RGB", "RGBA"  as stored;
//   "P", "PA"    expanded through the palette the caller passes (256 RGBA
//                entries, as Pillow holds them: opaque black where the file
//                gives none);
//   "CMYK"       Pillow's cmyk2rgb; "YCbCr" Pillow's ycbcr2rgb, its Y band
//                (what convert("L") keeps) in the fourth channel;
//   "I;16", "I;16L", "I;16B"  the sample's high byte (stb_image's 16-to-8
//                rule, where Pillow's convert clips at 255);
//   "I"          convert's clip to [0, 255];
//   "F"          convert's truncation toward zero and clip (NaN and -inf
//                read 0); its float32 samples are kept for a sky.
//
// Pixels come back as uint8 (H, W, C): C = 1, 2, 3 or 4 (palette, CMYK and
// YCbCr images as 4).  Malformed input throws where Pillow raises (a
// decoder's overrun, data short of the image): every read of the input is
// bounds-checked.  Build: the library's flags (image_decode.cpp's header).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw Error(msg); }

// Pillow raises DecompressionBombError above twice Image.MAX_IMAGE_PIXELS.
constexpr int64_t kMaxPixels = 2 * int64_t(89478485);

// Pillow's image memory: `bands` values a pixel (bytes; 16-bit samples;
// int32 or float32 bits), rows top down.
struct Frame {
  int64_t w = 0, h = 0;
  int bands = 1;
  std::string mode;
  std::vector<uint32_t> v;
  Frame(int64_t w_, int64_t h_, const std::string& mode_) : w(w_), h(h_), mode(mode_) {
    if (w <= 0 || h <= 0) fail("image has no pixels");
    if (w > kMaxPixels / h)
      fail("image of " + std::to_string(w) + "x" + std::to_string(h) + " pixels exceeds the limit of " +
           std::to_string(kMaxPixels));
    bands = mode == "LA" || mode == "PA" ? 2 : mode == "RGB" || mode == "YCbCr" ? 3
          : mode == "RGBA" || mode == "CMYK" ? 4 : 1;
    if (!(bands > 1 || mode == "1" || mode == "L" || mode == "P" || mode == "I" || mode == "F" || mode == "I;16" ||
          mode == "I;16L" || mode == "I;16B"))
      fail("unknown image mode " + mode);
    v.assign(size_t(w * h * bands), 0);
  }
  uint32_t* row(int64_t y) { return v.data() + size_t(y * w * bands); }
};

uint32_t fbits(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}

// The bits a pixel of `raw` takes in Pillow's unpacker table for `mode`
// (a one-letter rawmode fills one band of a byte), 0 if it has none.
int raw_bits(const std::string& mode, const std::string& raw) {
  if (raw.size() == 1 && raw != mode) {
    const bool band = mode == "1" || mode == "L" || mode == "P" || mode == "RGB" || mode == "RGBA";
    return band && mode.find(raw[0]) != std::string::npos ? (mode == "1" ? 1 : 8) : 0;
  }
  static const struct { const char *mode, *raw; int bits; } kRaw[] = {
      {"1", "1", 1}, {"1", "1;I", 1}, {"1", "1;R", 1}, {"L", "L;4", 4}, {"L", "L;16B", 16},
      {"P", "P;2", 2}, {"P", "P;4", 4}, {"P", "P;2L", 2}, {"P", "P;4L", 4}, {"LA", "LA", 16}, {"LA", "LA;L", 16}, {"PA", "PA;L", 16},
      {"RGB", "BGR", 24}, {"RGB", "RGBX", 32}, {"RGB", "BGRX", 32}, {"RGB", "RGB;L", 24}, {"RGB", "RGBX;L", 32},
      {"RGB", "RGB;16B", 48}, {"RGBA", "RGBA", 32}, {"RGBA", "RGBA;L", 32}, {"RGBA", "RGBA;16B", 64},
      {"CMYK", "CMYK", 32}, {"CMYK", "CMYK;L", 32}, {"YCbCr", "YCbCr;L", 24},
      {"I;16", "I;16", 16}, {"I;16L", "I;16L", 16}, {"I;16B", "I;16B", 16},
      {"I", "I", 32}, {"I", "I;32", 32}, {"I", "I;32S", 32}, {"I", "I;32B", 32},
      {"F", "F", 32}, {"F", "F;32F", 32}, {"F", "F;32BF", 32}, {"F", "F;8", 8}, {"F", "F;8S", 8},
      {"F", "F;16", 16}, {"F", "F;16S", 16}, {"F", "F;32", 32}, {"F", "F;32S", 32}};
  if (raw == mode && (mode == "L" || mode == "P" || mode == "RGB")) return mode == "RGB" ? 24 : 8;
  for (const auto& r : kRaw)
    if (mode == r.mode && raw == r.raw) return r.bits;
  return 0;
}

// Unpacks n pixels of `raw` from `in` into a row of `f`, as Pillow's
// unpacker of that name does; a one-letter rawmode fills its band.
void unpack(const Frame& f, const std::string& raw, const uint8_t* in, int64_t n, uint32_t* out) {
  const std::string& mode = f.mode;
  const int bands = f.bands;
  auto bit = [&](int64_t i, bool lsb) { return (in[i >> 3] >> (lsb ? i & 7 : 7 - (i & 7))) & 1; };
  auto sub = [&](int64_t i, int nb) {  // an nb-bit field, most significant first
    const int64_t b = i * nb;
    return uint32_t(in[b >> 3] >> (8 - nb - (b & 7))) & ((1u << nb) - 1);
  };
  auto le16 = [&](int64_t o) { return uint32_t(in[o]) | uint32_t(in[o + 1]) << 8; };
  auto be16 = [&](int64_t o) { return uint32_t(in[o]) << 8 | in[o + 1]; };
  auto le32 = [&](int64_t o) { return le16(o) | le16(o + 2) << 16; };
  auto be32 = [&](int64_t o) { return be16(o) << 16 | be16(o + 2); };
  if (raw.size() == 1 && raw != mode) {
    const int64_t b = int64_t(mode.find(raw[0]));
    const bool one = mode == "1";
    for (int64_t i = 0; i < n; ++i) out[i * bands + b] = one ? (bit(i, false) ? 255 : 0) : in[i];
    return;
  }
  if (mode == "1") {
    const bool lsb = raw == "1;R", inv = raw == "1;I";
    for (int64_t i = 0; i < n; ++i) out[i] = (bit(i, lsb) != 0) != inv ? 255 : 0;
  } else if (mode == "L") {
    const int kind = raw == "L;4" ? 4 : raw == "L;16B" ? 16 : 8;
    for (int64_t i = 0; i < n; ++i) out[i] = kind == 4 ? sub(i, 4) * 17 : kind == 16 ? in[2 * i] : in[i];
  } else if (mode == "P") {
    const int64_t s = (n + 7) / 8;  // unpackP2L / unpackP4L: bit planes (pixels + 7) / 8 bytes apart
    const int planes = raw == "P;2L" ? 2 : raw == "P;4L" ? 4 : 0, nb = raw == "P;2" ? 2 : raw == "P;4" ? 4 : 8;
    for (int64_t i = 0; i < n; ++i) {
      if (planes) {
        const uint8_t m = uint8_t(128 >> (i & 7));
        const int64_t j = i >> 3;
        uint32_t v = ((in[j] & m) ? 1 : 0) + ((in[j + s] & m) ? 2 : 0);
        if (planes == 4) v += ((in[j + 2 * s] & m) ? 4 : 0) + ((in[j + 3 * s] & m) ? 8 : 0);
        out[i] = v;
      } else {
        out[i] = nb == 8 ? in[i] : sub(i, nb);
      }
    }
  } else if (mode == "I;16" || mode == "I;16L" || mode == "I;16B") {
    const bool big = raw == "I;16B";
    for (int64_t i = 0; i < n; ++i) out[i] = big ? be16(2 * i) : le16(2 * i);
  } else if (mode == "I") {
    const bool big = raw == "I;32B";
    for (int64_t i = 0; i < n; ++i) out[i] = big ? be32(4 * i) : le32(4 * i);
  } else if (mode == "F") {
    enum { U8, S8, U16, S16, U32, S32, LE, BE } kind = raw == "F;8" ? U8 : raw == "F;8S" ? S8 : raw == "F;16" ? U16
        : raw == "F;16S" ? S16 : raw == "F;32" ? U32 : raw == "F;32S" ? S32 : raw == "F;32BF" ? BE : LE;
    for (int64_t i = 0; i < n; ++i) {
      switch (kind) {
        case U8: out[i] = fbits(float(in[i])); break;
        case S8: out[i] = fbits(float(int8_t(in[i]))); break;
        case U16: out[i] = fbits(float(le16(2 * i))); break;
        case S16: out[i] = fbits(float(int16_t(le16(2 * i)))); break;
        case U32: out[i] = fbits(float(le32(4 * i))); break;
        case S32: out[i] = fbits(float(int32_t(le32(4 * i)))); break;
        case BE: out[i] = be32(4 * i); break;
        default: out[i] = le32(4 * i);
      }
    }
  } else if (raw.compare(raw.size() - 2, 2, ";L") != 0) {  // interleaved bytes
    const bool wide = raw.find(";16B") != std::string::npos, bgr = raw[0] == 'B';
    const int step = raw_bits(mode, raw) / 8, take = wide ? bands : std::min(bands, step);
    for (int64_t i = 0; i < n; ++i) {
      const uint8_t* p = in + i * step;
      uint32_t* o = out + i * bands;
      for (int k = 0; k < take; ++k) o[k] = wide ? p[2 * k] : p[bgr && k < 3 ? 2 - k : k];
    }
  } else {  // ";L": one plane of n bytes a band, line interleaved
    const int planes = raw_bits(mode, raw) / 8;
    for (int64_t i = 0; i < n; ++i)
      for (int k = 0; k < std::min(bands, planes); ++k) out[i * bands + k] = in[i + k * n];
  }
}

// Pillow's raw decoder (RawDecode.c): rows of the rawmode's bytes, `stride`
// bytes apart (0: no padding; padding is skipped only between rows), from
// the bottom up where ystep is -1; data short of the last row raises.
void raw_decode(Frame& f, const uint8_t* data, size_t n, uint64_t offset, const std::string& raw, int64_t stride,
                int ystep) {
  const int bits = raw_bits(f.mode, raw);
  if (!bits) fail("unknown raw mode " + raw + " for image mode " + f.mode);
  const int64_t bytes = (f.w * bits + 7) / 8;
  const int64_t step = stride ? stride : bytes;
  if (step < bytes) fail("raw stride of " + std::to_string(stride) + " bytes is shorter than a row");
  const uint64_t need = uint64_t(step) * uint64_t(f.h - 1) + uint64_t(bytes);
  if (offset > n || need > n - offset) fail("image file is truncated");
  for (int64_t r = 0; r < f.h; ++r)
    unpack(f, raw, data + offset + uint64_t(r * step), f.w, f.row(ystep < 0 ? f.h - 1 - r : r));
}

// PcxDecode.c: byte runs (a byte 0xC0 | n, then the value) and literals
// into a line of `bytes` (planes x stride); a line whose length is no
// multiple of the width and longer than it has its planes moved together;
// bit planes are read a stride apart; a run past the line overruns.
void pcx_decode(Frame& f, const uint8_t* data, size_t n, uint64_t offset, const std::string& raw, int64_t bytes) {
  const int bits = raw_bits(f.mode, raw);
  if (!bits) fail("unknown PCX raw mode " + raw);
  if ((f.w * bits + 7) / 8 > bytes) fail("PCX line too short for the image (Pillow: buffer overrun)");
  std::vector<uint8_t> line(size_t(bytes), 0);
  const int64_t planes = raw == "P;2L" ? 2 : raw == "P;4L" ? 4 : 1;
  int64_t x = 0, y = 0;
  size_t p = offset;
  while (y < f.h) {
    if (p >= n) fail("image file is truncated (PCX data)");
    if ((data[p] & 0xC0) == 0xC0) {
      if (p + 1 >= n) fail("image file is truncated (PCX data)");
      const int count = data[p] & 0x3F;
      if (x + count > bytes) fail("PCX run past the end of a line (Pillow: buffer overrun)");
      std::memset(&line[size_t(x)], data[p + 1], size_t(count));
      x += count, p += 2;
    } else {
      line[size_t(x++)] = data[p++];
    }
    if (x >= bytes) {
      if (bytes % f.w && bytes > f.w) {
        const int64_t bands = bytes / f.w, st = bytes / bands;
        for (int64_t i = 1; i < bands; ++i) std::memmove(&line[size_t(i * f.w)], &line[size_t(i * st)], size_t(f.w));
      }
      if (planes > 1) {  // Pillow reads bit planes a stride apart, its unpacker (width + 7) / 8 apart
        const int64_t st = bytes / planes, s0 = (f.w + 7) / 8;
        for (int64_t k = 1; k < planes; ++k) std::memmove(&line[size_t(k * s0)], &line[size_t(k * st)], size_t(s0));
      }
      unpack(f, raw, line.data(), f.w, f.row(y++));
      x = 0;
    }
  }
}

// SgiRleDecode.c: the offset and length tables after the 512-byte header,
// then each row of each channel expanded (expandrow / expandrow2: the
// length counts chunks, a last chunk not 0 ends the image there, a chunk
// of count 0 ends the row, which keeps the previous row's remaining
// samples); the rows from the bottom up.  A row's length bounds only its
// count of chunks; its reads are checked one byte stricter than the data
// (a copy may not end on the file's last byte).
void sgi_rle_decode(Frame& f, const uint8_t* data, size_t n, const std::string& raw, int bpc) {
  const int64_t z = f.bands, bufsize = int64_t(n) - 512, tablen = z * f.h;
  if (bufsize < 8 * tablen) fail("SGI RLE tables past the end of the file (Pillow: buffer overrun)");
  const uint8_t* ptr = data + 512;
  const int64_t end = bufsize - 1;  // Pillow's end_of_buffer
  auto rd4 = [&](int64_t i) {
    return uint32_t(ptr[i]) << 24 | uint32_t(ptr[i + 1]) << 16 | uint32_t(ptr[i + 2]) << 8 | ptr[i + 3];
  };
  std::vector<uint8_t> buffer(size_t(f.w * z * 2), 0);
  for (int64_t rowno = 0; rowno < f.h; ++rowno) {
    for (int64_t ch = 0; ch < z; ++ch) {
      const uint32_t off = rd4(4 * (rowno + ch * f.h)), len = rd4(4 * tablen + 4 * (rowno + ch * f.h));
      if (off < 512) fail("SGI RLE row before the data (Pillow: buffer overrun)");
      int64_t s = int64_t(off) - 512, d = ch * bpc, x = 0;
      int status = 0;
      for (int32_t k = int32_t(len); k > 0; --k) {
        if (s + (bpc - 1) > end) { status = -1; break; }
        const uint8_t pixel = ptr[s + bpc - 1];
        s += bpc;
        if (k == 1 && pixel != 0) { status = 1; break; }
        const int count = pixel & 0x7F;
        if (!count) break;
        if (x + count > f.w) { status = -1; break; }
        x += count;
        if (pixel & 0x80) {
          if (s + bpc * count > end) { status = -1; break; }
          for (int c = 0; c < count; ++c, s += bpc, d += z * bpc) std::memcpy(&buffer[size_t(d)], ptr + s, size_t(bpc));
        } else {
          if (s + (bpc == 2 ? 2 : 0) > end) { status = -1; break; }
          for (int c = 0; c < count; ++c, d += z * bpc) std::memcpy(&buffer[size_t(d)], ptr + s, size_t(bpc));
          s += bpc;
        }
      }
      if (status == -1) fail("corrupt SGI RLE row (Pillow: buffer overrun)");
      if (status == 1) return;  // Pillow stops there; the rows left stay zero
    }
    unpack(f, raw, buffer.data(), f.w, f.row(f.h - 1 - rowno));
  }
}

// SunRleDecode.c: 0x80 0x00 a literal 0x80, 0x80 n v a run of n + 1,
// anything else a literal; rows of the rawmode's bytes (no 16-bit
// padding); a run past a row goes on into the next.
void sun_rle_decode(Frame& f, const uint8_t* data, size_t n, uint64_t offset, const std::string& raw) {
  const int bits = raw_bits(f.mode, raw);
  if (!bits) fail("unknown Sun raw mode " + raw);
  const int64_t bytes = (f.w * bits + 7) / 8;
  std::vector<uint8_t> line(size_t(bytes), 0);
  int64_t x = 0, y = 0;
  size_t p = offset;
  auto put = [&](int64_t count, uint8_t v) {
    while (count > 0 && y < f.h) {
      const int64_t k = std::min(count, bytes - x);
      std::memset(&line[size_t(x)], v, size_t(k));
      x += k, count -= k;
      if (x >= bytes) {
        unpack(f, raw, line.data(), f.w, f.row(y++));
        x = 0;
      }
    }
  };
  while (y < f.h) {
    if (p >= n) fail("image file is truncated (Sun RLE data)");
    if (data[p] == 0x80) {
      if (p + 1 >= n) fail("image file is truncated (Sun RLE data)");
      if (data[p + 1] == 0) {
        put(1, 0x80), p += 2;
      } else {
        if (p + 2 >= n) fail("image file is truncated (Sun RLE data)");
        put(int64_t(data[p + 1]) + 1, data[p + 2]), p += 3;
      }
    } else {
      put(1, data[p++]);
    }
  }
}

// MspDecoder (Python): the row map (one 16-bit length a row), each row's
// runs (0, count, value) and literals (count, bytes) appended to one
// buffer (an empty row is white), read as rows of the "1" rawmode.
void msp_decode(Frame& f, const uint8_t* data, size_t n) {
  const int64_t stride = (f.w + 7) / 8;
  if (32 + 2 * uint64_t(f.h) > n) fail("Truncated MSP file in row map");
  std::vector<uint8_t> img;
  size_t p = 32 + 2 * size_t(f.h);
  for (int64_t y = 0; y < f.h; ++y) {
    const size_t len = size_t(data[32 + 2 * y]) | size_t(data[33 + 2 * y]) << 8;
    if (len == 0) {
      img.insert(img.end(), size_t(stride), 0xFF);
      continue;
    }
    if (len > n - p) fail("Truncated MSP file, expected " + std::to_string(len) + " bytes on row " + std::to_string(y));
    const uint8_t* row = data + p;
    p += len;
    for (size_t i = 0; i < len;) {
      const uint8_t type = row[i++];
      if (type == 0) {
        if (i + 2 > len) fail("Corrupted MSP file in row " + std::to_string(y));
        img.insert(img.end(), row[i], row[i + 1]);
        i += 2;
      } else {
        img.insert(img.end(), row + i, row + std::min(len, i + type));
        i += type;
      }
    }
  }
  if (img.size() < size_t(stride * f.h)) fail("not enough image data (MSP)");
  for (int64_t y = 0; y < f.h; ++y) unpack(f, "1", img.data() + y * stride, f.w, f.row(y));
}

int hexval(uint8_t v) {
  return v >= '0' && v <= '9' ? v - '0' : v >= 'a' && v <= 'f' ? v - 'a' + 10 : v >= 'A' && v <= 'F' ? v - 'A' + 10 : 0;
}

// XbmDecode.c: each byte the two characters after the next 'x' (not hex
// digits: 0), rows of (width + 7) / 8 bytes, least significant bit first.
void xbm_decode(Frame& f, const uint8_t* data, size_t n, uint64_t offset) {
  const int64_t bytes = (f.w + 7) / 8;
  std::vector<uint8_t> line(size_t(bytes), 0);
  size_t p = offset;
  for (int64_t y = 0; y < f.h; ++y) {
    for (int64_t x = 0; x < bytes; ++x) {
      while (p < n && data[p] != 'x') ++p;
      if (p >= n || n - p < 3) fail("image file is truncated (XBM data)");
      line[size_t(x)] = uint8_t(hexval(data[p + 1]) << 4 | hexval(data[p + 2]));
      p += 3;
    }
    unpack(f, "1;R", line.data(), f.w, f.row(y));
  }
}

// QoiDecoder (Python): RGB, RGBA, index, diff, luma and run ops; the index
// holds what each op but a run produced (an index op's missing entry is
// 0, 0, 0, 0); a run may run past the image.
void qoi_decode(Frame& f, const uint8_t* data, size_t n, uint64_t offset) {
  const int bands = f.bands;
  const int64_t total = f.w * f.h;
  uint8_t seen[64][4] = {};
  uint8_t prev[4] = {0, 0, 0, 255};
  size_t p = offset;
  auto need = [&](size_t k) {
    if (p > n || k > n - p) fail("truncated QOI data");
  };
  for (int64_t i = 0; i < total;) {
    need(1);
    const uint8_t b = data[p++];
    uint8_t v[4];
    if (b == 0xFE) {
      need(3);
      v[0] = data[p], v[1] = data[p + 1], v[2] = data[p + 2], v[3] = prev[3];
      p += 3;
    } else if (b == 0xFF) {
      need(4);
      std::memcpy(v, data + p, 4);
      p += 4;
    } else if (b >> 6 == 0) {
      std::memcpy(v, seen[b & 63], 4);
    } else if (b >> 6 == 1) {
      v[0] = uint8_t(prev[0] + ((b >> 4) & 3) - 2), v[1] = uint8_t(prev[1] + ((b >> 2) & 3) - 2);
      v[2] = uint8_t(prev[2] + (b & 3) - 2), v[3] = prev[3];
    } else if (b >> 6 == 2) {
      need(1);
      const uint8_t s = data[p++];
      const int dg = (b & 63) - 32, dr = (s >> 4) - 8, db = (s & 15) - 8;
      v[0] = uint8_t(prev[0] + dg + dr), v[1] = uint8_t(prev[1] + dg), v[2] = uint8_t(prev[2] + dg + db);
      v[3] = prev[3];
    } else {
      for (int r = (b & 63) + 1; r > 0 && i < total; --r, ++i)
        for (int k = 0; k < bands; ++k) f.v[size_t(i * bands + k)] = prev[k];
      continue;
    }
    std::memcpy(prev, v, 4);
    std::memcpy(seen[(v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64], v, 4);
    for (int k = 0; k < bands; ++k) f.v[size_t(i * bands + k)] = v[k];
    ++i;
  }
}

// BitDecode.c with ImImagePlugin's arguments (pad 8, fill 3: bits taken
// least significant first from a buffer filled most significant first,
// unsigned, from the bottom up): `bits` a sample into a float32 image; at
// each new row the count restarts, the buffer keeps its bits.
void bit_decode(Frame& f, const uint8_t* data, size_t n, uint64_t offset, int bits) {
  if (bits < 1 || bits >= 32) fail("IM bit depth out of range");
  const uint64_t mask = (uint64_t(1) << bits) - 1;
  uint64_t buffer = 0;
  int count = 0;
  int64_t x = 0, y = f.h - 1;
  for (size_t p = offset; p < n; ++p) {
    const uint8_t byte = data[p];
    buffer |= uint64_t(byte) << count;
    count += 8;
    while (count >= bits) {
      const uint64_t v = buffer & mask;
      if (count > 32) buffer = byte >> (8 - (count - bits));
      else buffer >>= bits;
      count -= bits;
      f.v[size_t(y * f.w + x)] = fbits(float(v));
      if (++x >= f.w) {
        if (--y < 0) return;
        x = 0;
        count = 0;
      }
    }
  }
  fail("image file is truncated (IM bit data)");
}

// XpmDecoder (Python): the pixel keys of each line's quoted text, `bpp`
// characters each (a line's last key may be shorter), looked up in the
// colour table: an index (mode "P") or the colour itself ("RGB", more than
// 256 colours); a key not in the table raises.  `keys` holds the table's
// keys, `lens` their lengths; `lines` the lines' text lengths.
void xpm_decode(Frame& f, const uint8_t* text, size_t n, const uint8_t* keys, const int64_t* lens, int64_t nkeys,
                const uint8_t* rgb, const int64_t* lines, int64_t nlines, int64_t bpp) {
  if (bpp <= 0) fail("XPM of 0 characters a pixel");
  std::unordered_map<std::string, int64_t> table;
  for (int64_t k = 0, at = 0; k < nkeys; at += lens[k], ++k)
    table.emplace(std::string(reinterpret_cast<const char*>(keys + at), size_t(lens[k])), k);
  std::vector<uint32_t> out;
  out.reserve(f.v.size());
  size_t p = 0;
  for (int64_t l = 0; l < nlines; ++l) {
    const size_t len = size_t(lines[l]);
    if (len > n - p) fail("XPM line table past its text");
    for (size_t i = 0; i < len; i += size_t(bpp)) {
      const auto it = table.find(std::string(reinterpret_cast<const char*>(text + p + i),
                                             std::min(size_t(bpp), len - i)));
      if (it == table.end()) fail("XPM pixel key not in the colour table (Pillow raises too)");
      if (f.mode == "RGB") out.insert(out.end(), rgb + 3 * it->second, rgb + 3 * it->second + 3);
      else out.push_back(uint32_t(it->second));
    }
    p += len;
  }
  if (out.size() < f.v.size()) fail("not enough image data (XPM)");
  std::copy(out.begin(), out.begin() + int64_t(f.v.size()), f.v.begin());
}

// FliDecode.c on the first frame (a frame chunk, 0xF1FA, at `offset`):
// its sub-chunks BLACK, BRUN, COPY, LC (byte delta) and SS2 (word delta)
// into an image of zeros; COLOR chunks were read by the caller.  A chunk
// of another type, data short of a chunk, or a line not filled raises.
void fli_decode(Frame& f, const uint8_t* data, size_t n, uint64_t offset) {
  if (offset >= n) fail("image file is truncated (FLI frame)");
  auto i16 = [](const uint8_t* p) { return int(p[0]) | int(p[1]) << 8; };
  auto i32 = [](const uint8_t* p) { return int32_t(uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
                                                    uint32_t(p[3]) << 24); };
  const int64_t rest = int64_t(n - offset);
  if (rest < 4) fail("image file is truncated (FLI frame size)");
  const int64_t framesize = i32(data + offset);
  if (framesize == 0) fail("image file is truncated (FLI frame of 0 bytes)");
  int64_t bytes = framesize > 0 ? std::min(framesize, rest) : rest;  // Pillow reads the frame's size at once
  if (bytes + bytes % 2 < framesize) fail("image file is truncated (FLI frame)");
  if (bytes < 8) fail("FLI frame shorter than its header (Pillow: buffer overrun)");
  const uint8_t* ptr = data + offset;
  if (i16(ptr + 4) != 0xF1FA) fail("FLI frame without its frame chunk (Pillow: unknown decoder error)");
  const int chunks = i16(ptr + 6);
  ptr += 16, bytes -= 16;
  const int64_t w = f.w, h = f.h;
  auto px = [&](int64_t y) { return f.row(y); };
  for (int c = 0; c < chunks; ++c) {
    if (bytes < 10) fail("FLI chunk header past its frame (Pillow: buffer overrun)");
    const uint8_t* d = ptr + 6;
    auto oob = [&](int64_t k) {
      if (d + k > ptr + bytes) fail("FLI chunk data past its frame (Pillow: buffer overrun)");
    };
    switch (i16(ptr + 4)) {
      case 4:
      case 11:
      case 18:
        break;
      case 7: {  // SS2
        const int lines = i16(d);
        d += 2;
        int l = 0;
        int64_t y = 0;
        for (; l < lines && y < h; ++l, ++y) {
          uint32_t* row = px(y);
          oob(2);
          int packets = i16(d);
          d += 2;
          while (packets & 0x8000) {
            if (packets & 0x4000) {
              y += 65536 - packets;
              if (y >= h) fail("FLI SS2 lines skipped past the image (Pillow: buffer overrun)");
              row = px(y);
            } else {
              row[w - 1] = uint32_t(packets & 255);
            }
            oob(2);
            packets = i16(d);
            d += 2;
          }
          int p = 0;
          int64_t x = 0;
          for (; p < packets; ++p) {
            oob(2);
            x += d[0];
            if (d[1] >= 128) {
              oob(4);
              const int64_t k = 256 - d[1];
              if (x + k + k > w) break;
              for (int64_t j = 0; j < k; ++j) row[x++] = d[2], row[x++] = d[3];
              d += 4;
            } else {
              const int64_t k = 2 * int64_t(d[1]);
              if (x + k > w) break;
              oob(2 + k);
              for (int64_t j = 0; j < k; ++j) row[x + j] = d[2 + j];
              d += 2 + k, x += k;
            }
          }
          if (p < packets) break;
        }
        if (l < lines) fail("FLI SS2 chunk of unfinished lines (Pillow: buffer overrun)");
        break;
      }
      case 12: {  // LC
        int64_t y = i16(d);
        const int64_t ymax = y + i16(d + 2);
        d += 4;
        for (; y < ymax && y < h; ++y) {
          uint32_t* row = px(y);
          oob(1);
          const int packets = *d++;
          int p = 0;
          int64_t x = 0, k = 0;
          for (; p < packets; ++p, x += k) {
            oob(2);
            x += d[0];
            if (d[1] & 0x80) {
              k = 256 - d[1];
              if (x + k > w) break;
              oob(3);
              for (int64_t j = 0; j < k; ++j) row[x + j] = d[2];
              d += 3;
            } else {
              k = d[1];
              if (x + k > w) break;
              oob(2 + k);
              for (int64_t j = 0; j < k; ++j) row[x + j] = d[2 + j];
              d += 2 + k;
            }
          }
          if (p < packets) break;
        }
        if (y < ymax) fail("FLI LC chunk of unfinished lines (Pillow: buffer overrun)");
        break;
      }
      case 13:  // BLACK
        std::fill(f.v.begin(), f.v.end(), 0u);
        break;
      case 15:  // BRUN
        for (int64_t y = 0; y < h; ++y) {
          uint32_t* row = px(y);
          d += 1;
          int64_t x = 0, k = 0;
          for (; x < w; x += k) {
            oob(2);
            if (d[0] & 0x80) {
              k = 256 - d[0];
              if (x + k > w) break;
              oob(k + 1);
              for (int64_t j = 0; j < k; ++j) row[x + j] = d[1 + j];
              d += k + 1;
            } else {
              k = d[0];
              if (x + k > w) break;
              for (int64_t j = 0; j < k; ++j) row[x + j] = d[1];
              d += 2;
            }
          }
          if (x != w) fail("FLI BRUN line not filled (Pillow: buffer overrun)");
        }
        break;
      case 16:  // COPY
        if (d + w * h > ptr + bytes) fail("image file is truncated (FLI COPY chunk)");
        for (int64_t i = 0; i < w * h; ++i) f.v[size_t(i)] = d[i];
        break;
      default:
        fail("FLI chunk of type " + std::to_string(i16(ptr + 4)) + " (Pillow: unknown decoder error)");
    }
    const int64_t advance = i32(ptr);
    if (advance == 0) fail("FLI chunk of no size (Pillow: broken data stream)");
    if (advance < 0 || advance > bytes) fail("FLI chunk past its frame (Pillow: buffer overrun)");
    ptr += advance, bytes -= advance;
  }
}

// PcdDecode.c and Pillow's "YCC;P" unpacker (UnpackYCC.c: Photo CD YCC,
// its tables each (int)(k * (v - c) + 0.5)): the 768 x 512 base image
// at `offset`, two rows at a time (two luma rows, then a row of each
// chroma, one sample a 2 x 2 block).
void pcd_decode(Frame& f, const uint8_t* data, size_t n, uint64_t offset) {
  const int64_t w = f.w, chunk = 3 * w;
  if (offset > n || uint64_t(chunk) * uint64_t(f.h / 2) > n - offset) fail("image file is truncated (PCD data)");
  int L[256], CB[256], GB[256], CR[256], GR[256];
  for (int v = 0; v < 256; ++v) {
    L[v] = int(1.3584 * v + 0.5);
    CB[v] = int(2.2179 * (v - 156) + 0.5), GB[v] = int(-0.194 * 2.2179 * (v - 156) + 0.5);
    CR[v] = int(1.8215 * (v - 137) + 0.5), GR[v] = int(-0.509 * 1.8215 * (v - 137) + 0.5);
  }
  auto clip = [](int v) { return uint32_t(v <= 0 ? 0 : v >= 255 ? 255 : v); };
  const uint8_t* ptr = data + offset;
  for (int64_t y = 0; y < f.h; y += 2, ptr += chunk) {
    for (int64_t line = 0; line < 2 && y + line < f.h; ++line) {
      uint32_t* o = f.row(y + line);
      for (int64_t x = 0; x < w; ++x, o += 3) {
        const int l = L[ptr[x + line * w]], cb = ptr[(x + 4 * w) / 2], cr = ptr[(x + 5 * w) / 2];
        o[0] = clip(l + CR[cr]), o[1] = clip(l + GB[cb] + GR[cr]), o[2] = clip(l + CB[cb]);
      }
    }
  }
}

// Pillow's ycbcr2rgb (ConvertYCbCr.c: tables of 6 fractional bits, each
// entry (int)(k * 64 * (v - 128) + 0.5)).
void ycbcr_to_rgb(int y, int cb, int cr, uint8_t* o) {
  auto t = [](double k, int v) { return int(k * 64 * (v - 128) + 0.5); };
  const int r = y + (t(1.40200, cr) >> 6), g = y + ((t(-0.34414, cb) + t(-0.71414, cr)) >> 6);
  const int b = y + (t(1.77200, cb) >> 6);
  o[0] = uint8_t(std::clamp(r, 0, 255)), o[1] = uint8_t(std::clamp(g, 0, 255)), o[2] = uint8_t(std::clamp(b, 0, 255));
}

struct Result {
  int64_t w = 0, h = 0, c = 0;
  std::string mode;
  std::vector<uint8_t> px;
  std::vector<float> fl;  // an "F" image's samples
};

// The frame as the JAX package's convert("RGBA") / convert("L") reads it
// (see the file's header); `pal` 256 RGBA entries for "P" and "PA".
Result convert(const Frame& f, const uint8_t* pal) {
  Result r;
  r.w = f.w, r.h = f.h, r.mode = f.mode;
  enum { kBytes, kPalette, kPaletteAlpha, kCmyk, kYCbCr, kHigh16, kInt, kFloat } kind =
      f.mode == "P" ? kPalette : f.mode == "PA" ? kPaletteAlpha : f.mode == "CMYK" ? kCmyk : f.mode == "YCbCr" ? kYCbCr
      : f.mode.compare(0, 3, "I;1") == 0 ? kHigh16 : f.mode == "I" ? kInt : f.mode == "F" ? kFloat : kBytes;
  r.c = kind == kPalette || kind == kPaletteAlpha || kind == kCmyk || kind == kYCbCr ? 4 : f.bands;
  r.px.assign(size_t(r.w * r.h * r.c), 0);
  if (kind == kFloat) r.fl.resize(f.v.size());
  const size_t npx = size_t(f.w * f.h);
  for (size_t i = 0; i < npx; ++i) {
    const uint32_t* s = f.v.data() + i * size_t(f.bands);
    uint8_t* o = r.px.data() + i * size_t(r.c);
    switch (kind) {
      case kPalette: std::memcpy(o, pal + 4 * (s[0] & 255), 4); break;
      case kPaletteAlpha: std::memcpy(o, pal + 4 * (s[0] & 255), 4), o[3] = uint8_t(s[1]); break;
      case kCmyk: {  // Pillow's cmyk2rgb
        const int nk = 255 - int(s[3]);
        for (int k = 0; k < 3; ++k) {
          const int t = int(s[k]) * nk + 128;
          o[k] = uint8_t(std::clamp(nk - (((t >> 8) + t) >> 8), 0, 255));
        }
        o[3] = 255;
        break;
      }
      case kYCbCr: ycbcr_to_rgb(int(s[0]), int(s[1]), int(s[2]), o), o[3] = uint8_t(s[0]); break;
      case kHigh16: o[0] = uint8_t((s[0] & 0xFFFF) >> 8); break;
      case kInt: {
        const int32_t v = int32_t(s[0]);
        o[0] = uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
        break;
      }
      case kFloat: {
        float v;
        std::memcpy(&v, s, 4);
        r.fl[i] = v;
        o[0] = !(v > 0.0f) ? 0 : v >= 255.0f ? 255 : uint8_t(int(v));
        break;
      }
      default:
        for (int k = 0; k < f.bands; ++k) o[k] = uint8_t(s[k]);
    }
  }
  return r;
}

void write_error(char* err, int64_t errlen, const char* msg) {
  if (err && errlen > 0) {
    std::strncpy(err, msg, size_t(errlen) - 1);
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" {

// One of Pillow's tiles: `decoder` 0 raw (args: stride, ystep; `rawmode`
// may list one rawmode a layer, comma-separated, args[2] bytes apart), 1
// pcx (args: line bytes), 2 sgi_rle (args: bytes a sample), 3 sun_rle, 4
// msp, 5 xbm, 6 qoi, 7 bit (args: bits), 8 xpm (`aux` the colour table's
// keys, then the pixel text; args: bpp, the key count, the line count,
// then the key lengths and the lines' text lengths; for "RGB" `pal` holds
// 3 bytes a key), 9 fli, 10 pcd, of a `w` x `h` image of Pillow's `mode`
// at `offset`.
// `pal` (1024 bytes) the palette of a "P" or "PA" image.  A handle, or
// NULL with the reason in err.
void* imgr_decode(const uint8_t* data, int64_t n, int32_t decoder, const char* mode, const char* rawmode,
                  int64_t offset, int64_t w, int64_t h, const int64_t* args, int64_t nargs, const uint8_t* pal,
                  int64_t npal, const uint8_t* aux, int64_t naux, char* err, int64_t errlen) {
  try {
    const size_t size = size_t(n < 0 ? 0 : n);
    if (offset < 0) fail("negative data offset");
    auto arg = [&](int64_t i) { return i < nargs ? args[i] : 0; };
    Frame f(w, h, mode);
    const std::string raw = rawmode;
    switch (decoder) {
      case 0: {
        size_t start = 0;
        for (int64_t layer = 0;; ++layer) {
          const size_t comma = raw.find(',', start);
          const std::string one = raw.substr(start, comma == std::string::npos ? std::string::npos : comma - start);
          const uint64_t at = uint64_t(offset + layer * arg(2));
          if (one.size() == 1 || raw.find(',') == std::string::npos) {
            raw_decode(f, data, size, at, one, arg(0), int(arg(1)));
          } else {  // SGI16Decoder: an "L" plane of 16-bit samples into band `layer`
            Frame band(f.w, f.h, "L");
            raw_decode(band, data, size, at, one, arg(0), int(arg(1)));
            for (size_t i = 0; i < band.v.size(); ++i) f.v[i * size_t(f.bands) + size_t(layer)] = band.v[i];
          }
          if (comma == std::string::npos) break;
          start = comma + 1;
        }
        break;
      }
      case 1: pcx_decode(f, data, size, uint64_t(offset), raw, arg(0)); break;
      case 2: sgi_rle_decode(f, data, size, raw, int(arg(0))); break;
      case 3: sun_rle_decode(f, data, size, uint64_t(offset), raw); break;
      case 4: msp_decode(f, data, size); break;
      case 5: xbm_decode(f, data, size, uint64_t(offset)); break;
      case 6: qoi_decode(f, data, size, uint64_t(offset)); break;
      case 7: bit_decode(f, data, size, uint64_t(offset), int(arg(0))); break;
      case 9: fli_decode(f, data, size, uint64_t(offset)); break;
      case 10: pcd_decode(f, data, size, uint64_t(offset)); break;
      case 8: {
        const int64_t nkeys = arg(1), nlines = arg(2);
        if (nkeys < 0 || nlines < 0 || nargs < 3 + nkeys + nlines) fail("XPM tables short");
        int64_t keybytes = 0;
        for (int64_t k = 0; k < nkeys; ++k) keybytes += args[3 + k];
        if (keybytes > naux || (f.mode == "RGB" && 3 * nkeys > npal)) fail("XPM key table short");
        xpm_decode(f, aux + keybytes, size_t(naux - keybytes), aux, args + 3, nkeys, pal, args + 3 + nkeys, nlines,
                   arg(0));
        break;
      }
      default: fail("unknown raster decoder " + std::to_string(decoder));
    }
    if ((f.mode == "P" || f.mode == "PA") && (!pal || npal < 1024)) fail("palette image without its palette");
    return new Result(convert(f, pal));
  } catch (const std::exception& e) {
    write_error(err, errlen, e.what());
  }
  return nullptr;
}

int64_t imgr_width(void* r) { return static_cast<Result*>(r)->w; }
int64_t imgr_height(void* r) { return static_cast<Result*>(r)->h; }
int64_t imgr_channels(void* r) { return static_cast<Result*>(r)->c; }
const char* imgr_mode(void* r) { return static_cast<Result*>(r)->mode.c_str(); }
const uint8_t* imgr_pixels(void* r) { return static_cast<Result*>(r)->px.data(); }
// An "F" image's float32 samples (h x w, top row first), NULL for any other.
const float* imgr_floats(void* r) {
  const Result* res = static_cast<Result*>(r);
  return res->fl.empty() ? nullptr : res->fl.data();
}
void imgr_free(void* r) { delete static_cast<Result*>(r); }

}  // extern "C"
