// Texture image decoders of the port: JPEG, PNG reconstruction, TGA, BMP,
// GIF, PNM, PSD, TIFF; and WebP, from webp_decode.cpp (the second source
// of this library).
//
// The JAX package reads texture files with Pillow (Image.open, then
// convert("RGBA") or convert("L")); the reference C++ with stb_image.  This
// library returns what Pillow returns, pixel for pixel, in Pillow's mode:
//
//   JPEG  8-bit, 1, 3 or 4 components (CMYK, or YCCK by the Adobe
//         transform, read inverted as Pillow's "CMYK;I"), any integral
//         sampling, restart intervals: baseline, extended and progressive
//         Huffman, sequential and progressive arithmetic coding (jdarith.c,
//         DAC conditioning), lossless (SOF3: predictors 1-7, point
//         transform; jdlossls.c); decoded as libjpeg-turbo 3.1 decodes by
//         default: the ISLOW integer IDCT as its x86-64 SIMD code computes
//         it (equal to jidctint.c but where a corrupt file's coefficients
//         overflow its 16-bit lanes), block smoothing of an incomplete
//         progressive file (jdcoefct.c), "fancy" triangle upsampling of
//         each component (jdsample.c: h2v1, h1v2, h2v2; a component 2
//         samples wide or narrower takes the box filter), the integer
//         YCbCr->RGB and YCCK->CMYK tables (jdcolor.c); corrupt data
//         recovered from as libjpeg does (jdhuff.c, jdphuff.c, jdarith.c,
//         jdmarker.c: zeros after a marker inside a scan, a bad code read
//         as 0, a run past the band written to coefficient 63, the restart
//         resync), a file's end inside a scan an error, as Pillow makes it.
//   PNG   unfiltering, Adam7 de-interlacing and unpacking of every colour
//         type and depth; the inflate is zlib's, done by the caller.
//   TGA   types 1, 2, 3, 9, 10, 11 at 1 (grey), 8, 16, 24 and 32 bits,
//         16-, 24- and 32-bit colour maps, the origin bits.
//   BMP   1/4/8-bit palette (RLE8 and RLE4 too), 16-bit (5-5-5 and 5-6-5),
//         24- and 32-bit, BI_RGB and BI_BITFIELDS, bottom-up and top-down.
//   GIF   the first frame: LZW, interlace, local and global colour tables,
//         the transparent index, a frame offset inside the screen.
//   PNM   P1-P6 (ASCII and binary, any maxval) and Pf.
//   PSD   the composite image: raw or PackBits; bitmap, grey, indexed, RGB,
//         RGBA, CMYK.
//   WebP  (webp_decode.cpp) lossy and lossless, as Pillow reads it.
//   TIFF  the first directory, as Pillow reads it: its mode table
//         (TiffImagePlugin.OPEN_INFO); uncompressed files through Pillow's
//         own unpackers (a planar file by each band's letter), compressed
//         ones as libtiff decodes them (PackBits, LZW, Deflate inflated by
//         the caller, JPEG through the decoder above; predictors 2 and 3;
//         host-order samples) and Pillow unpacks them; YCbCr without JPEG
//         through libtiff's TIFFRGBAImage (its float-built tables, its
//         block walk); Orientation as Pillow 12's load applies it.
//
// Pixels come back as uint8 (H, W, C): C = 1 grey, 2 grey + alpha, 3 RGB,
// 4 RGBA (palette and CMYK images are expanded to RGBA); a float TIFF also
// keeps its float32 samples.  Anything malformed or not ported (where
// Pillow raises: 12-bit, hierarchical and arithmetic-coded lossless JPEG,
// a JPEG height in a DNL marker) throws, and the C entry points turn that
// into an error message: every read of the input is bounds-checked.
//
// Build: c++ -O2 -fPIC -std=c++17 -shared (no -march=native: the decode is
// integer arithmetic, and the same bytes must come out on every host; the
// only floating point, PNM's maxval scaling, PFM's and TIFF's float
// comparisons and libtiff's YCbCr table init (float operations in
// libtiff's order, no contraction under -std=c++17), is correctly rounded
// IEEE arithmetic or exact, the same everywhere).

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <stdexcept>
#include <string>
#include <vector>

namespace webp {  // webp_decode.cpp
void decode(const uint8_t* data, size_t n, int64_t max_pixels, int64_t& width, int64_t& height,
            bool& alpha, std::vector<uint8_t>& rgba);
}

namespace {

struct DecodeError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw DecodeError(msg); }

// Pillow raises DecompressionBombError above twice Image.MAX_IMAGE_PIXELS.
constexpr int64_t kMaxPixels = 2 * int64_t(89478485);

void check_size(int64_t w, int64_t h) {
  if (w <= 0 || h <= 0) fail("image has no pixels");
  if (w > kMaxPixels / h)
    fail("image of " + std::to_string(w) + "x" + std::to_string(h) +
         " pixels exceeds the limit of " + std::to_string(kMaxPixels));
}

struct Image {
  int64_t w = 0, h = 0, c = 0;
  std::string mode;
  std::vector<uint8_t> px;
  std::vector<float> fl;  // TIFF F or PFM: the float samples, fh x fw (px holds convert's bytes)
  int64_t fw = 0, fh = 0;

  void alloc(int64_t w_, int64_t h_, int64_t c_, const char* mode_) {
    check_size(w_, h_);
    w = w_, h = h_, c = c_, mode = mode_;
    px.assign(size_t(w * h * c), 0);
  }
  uint8_t* at(int64_t y, int64_t x) { return px.data() + (y * w + x) * c; }
};

struct Bytes {
  const uint8_t* p;
  size_t n;
  void need(size_t off, size_t len, const char* what) const {
    if (off > n || len > n - off) fail(std::string("truncated ") + what);
  }
  uint8_t u8(size_t o, const char* what) const { need(o, 1, what); return p[o]; }
  uint32_t le16(size_t o, const char* what) const {
    need(o, 2, what);
    return uint32_t(p[o]) | uint32_t(p[o + 1]) << 8;
  }
  uint32_t le32(size_t o, const char* what) const {
    need(o, 4, what);
    return uint32_t(p[o]) | uint32_t(p[o + 1]) << 8 | uint32_t(p[o + 2]) << 16 |
           uint32_t(p[o + 3]) << 24;
  }
  uint32_t be16(size_t o, const char* what) const {
    need(o, 2, what);
    return uint32_t(p[o]) << 8 | uint32_t(p[o + 1]);
  }
};

// A palette as Pillow holds it: 256 RGBA entries, opaque black where the
// file gives none.
struct Palette {
  uint8_t e[256][4];
  Palette() {
    for (auto& x : e) x[0] = x[1] = x[2] = 0, x[3] = 255;
  }
};

// Pillow's cmyk2rgb (Convert.c) of one pixel, alpha 255.
void cmyk_to_rgba(int c, int m, int y, int k, uint8_t* o) {
  const int nk = 255 - k;
  const int cmy[3] = {c, m, y};
  for (int i = 0; i < 3; ++i) {
    const int t = cmy[i] * nk + 128;
    o[i] = uint8_t(std::clamp(nk - (((t >> 8) + t) >> 8), 0, 255));
  }
  o[3] = 255;
}

// ---------------------------------------------------------------- JPEG ----

// Zigzag index -> natural (row-major) position of a coefficient, with
// libjpeg's 16 extra entries: a corrupt run past coefficient 63 (up to
// index 78) lands on coefficient 63 (jutils.c jpeg_natural_order).
constexpr uint8_t kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// T.81 Table D.2 as jaricom.c packs it: Qe << 16 | next index after an MPS
// << 8 | switch-MPS << 7 | next index after an LPS.  Entry 113 is the
// fixed 0.5 estimate (T.851) that signs and DC refinement bits use.
#define QM(qe, lps, mps, sw) (int64_t(qe) << 16 | (mps) << 8 | (sw) << 7 | (lps))
constexpr int64_t kQM[114] = {
    QM(0x5a1d, 1, 1, 1),     QM(0x2586, 14, 2, 0),    QM(0x1114, 16, 3, 0),    QM(0x080b, 18, 4, 0),
    QM(0x03d8, 20, 5, 0),    QM(0x01da, 23, 6, 0),    QM(0x00e5, 25, 7, 0),    QM(0x006f, 28, 8, 0),
    QM(0x0036, 30, 9, 0),    QM(0x001a, 33, 10, 0),   QM(0x000d, 35, 11, 0),   QM(0x0006, 9, 12, 0),
    QM(0x0003, 10, 13, 0),   QM(0x0001, 12, 13, 0),   QM(0x5a7f, 15, 15, 1),   QM(0x3f25, 36, 16, 0),
    QM(0x2cf2, 38, 17, 0),   QM(0x207c, 39, 18, 0),   QM(0x17b9, 40, 19, 0),   QM(0x1182, 42, 20, 0),
    QM(0x0cef, 43, 21, 0),   QM(0x09a1, 45, 22, 0),   QM(0x072f, 46, 23, 0),   QM(0x055c, 48, 24, 0),
    QM(0x0406, 49, 25, 0),   QM(0x0303, 51, 26, 0),   QM(0x0240, 52, 27, 0),   QM(0x01b1, 54, 28, 0),
    QM(0x0144, 56, 29, 0),   QM(0x00f5, 57, 30, 0),   QM(0x00b7, 59, 31, 0),   QM(0x008a, 60, 32, 0),
    QM(0x0068, 62, 33, 0),   QM(0x004e, 63, 34, 0),   QM(0x003b, 32, 35, 0),   QM(0x002c, 33, 9, 0),
    QM(0x5ae1, 37, 37, 1),   QM(0x484c, 64, 38, 0),   QM(0x3a0d, 65, 39, 0),   QM(0x2ef1, 67, 40, 0),
    QM(0x261f, 68, 41, 0),   QM(0x1f33, 69, 42, 0),   QM(0x19a8, 70, 43, 0),   QM(0x1518, 72, 44, 0),
    QM(0x1177, 73, 45, 0),   QM(0x0e74, 74, 46, 0),   QM(0x0bfb, 75, 47, 0),   QM(0x09f8, 77, 48, 0),
    QM(0x0861, 78, 49, 0),   QM(0x0706, 79, 50, 0),   QM(0x05cd, 48, 51, 0),   QM(0x04de, 50, 52, 0),
    QM(0x040f, 50, 53, 0),   QM(0x0363, 51, 54, 0),   QM(0x02d4, 52, 55, 0),   QM(0x025c, 53, 56, 0),
    QM(0x01f8, 54, 57, 0),   QM(0x01a4, 55, 58, 0),   QM(0x0160, 56, 59, 0),   QM(0x0125, 57, 60, 0),
    QM(0x00f6, 58, 61, 0),   QM(0x00cb, 59, 62, 0),   QM(0x00ab, 61, 63, 0),   QM(0x008f, 61, 32, 0),
    QM(0x5b12, 65, 65, 1),   QM(0x4d04, 80, 66, 0),   QM(0x412c, 81, 67, 0),   QM(0x37d8, 82, 68, 0),
    QM(0x2fe8, 83, 69, 0),   QM(0x293c, 84, 70, 0),   QM(0x2379, 86, 71, 0),   QM(0x1edf, 87, 72, 0),
    QM(0x1aa9, 87, 73, 0),   QM(0x174e, 72, 74, 0),   QM(0x1424, 72, 75, 0),   QM(0x119c, 74, 76, 0),
    QM(0x0f6b, 74, 77, 0),   QM(0x0d51, 75, 78, 0),   QM(0x0bb6, 77, 79, 0),   QM(0x0a40, 77, 48, 0),
    QM(0x5832, 80, 81, 1),   QM(0x4d1c, 88, 82, 0),   QM(0x438e, 89, 83, 0),   QM(0x3bdd, 90, 84, 0),
    QM(0x34ee, 91, 85, 0),   QM(0x2eae, 92, 86, 0),   QM(0x299a, 93, 87, 0),   QM(0x2516, 86, 71, 0),
    QM(0x5570, 88, 89, 1),   QM(0x4ca9, 95, 90, 0),   QM(0x44d9, 96, 91, 0),   QM(0x3e22, 97, 92, 0),
    QM(0x3824, 99, 93, 0),   QM(0x32b4, 99, 94, 0),   QM(0x2e17, 93, 86, 0),   QM(0x56a8, 95, 96, 1),
    QM(0x4f46, 101, 97, 0),  QM(0x47e5, 102, 98, 0),  QM(0x41cf, 103, 99, 0),  QM(0x3c3d, 104, 100, 0),
    QM(0x375e, 99, 93, 0),   QM(0x5231, 105, 102, 0), QM(0x4c0f, 106, 103, 0), QM(0x4639, 107, 104, 0),
    QM(0x415e, 103, 99, 0),  QM(0x5627, 105, 106, 1), QM(0x50e7, 108, 107, 0), QM(0x4b85, 109, 103, 0),
    QM(0x5597, 110, 109, 0), QM(0x504f, 111, 107, 0), QM(0x5a10, 110, 111, 1), QM(0x5522, 112, 109, 0),
    QM(0x59eb, 112, 111, 1), QM(0x5a1d, 113, 113, 0)};
#undef QM

// The K.3 tables libjpeg-turbo installs for a Huffman table a scan uses but
// no DHT defined (jstdhuff.c, for Motion-JPEG): ids 0 and 1.
constexpr uint8_t kStdBits[4][16] = {{0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
                                     {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},
                                     {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
                                     {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
constexpr uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kStdAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22,
     0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33,
     0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34,
     0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55,
     0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76,
     0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96,
     0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5,
     0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4,
     0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1,
     0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13,
     0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62,
     0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29,
     0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54,
     0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94,
     0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3,
     0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2,
     0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea,
     0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

// A Huffman table as jdhuff.c derives it.  A DHT only stores it; libjpeg
// checks it (jpeg_make_d_derived_tbl) when a scan uses it.
struct Huffman {
  bool defined = false, bad = false;
  uint16_t look[256];  // 8-bit lookahead -> (length << 8) | symbol; 0: a longer code
  int32_t maxcode[18], valoffset[17];
  uint8_t vals[256];
  int nvals = 0;

  void build(const uint8_t counts[16], const uint8_t* symbols, int n) {
    std::memset(look, 0, sizeof look);
    std::memcpy(vals, symbols, size_t(n));
    nvals = n, defined = true, bad = false;
    int32_t code = 0, p = 0;
    for (int len = 1; len <= 16; ++len) {
      const int k = counts[len - 1];
      if (k) {
        valoffset[len] = p - code;
        for (int i = 0; i < k; ++i, ++p, ++code) {
          if (code >= (int32_t(1) << len)) {
            bad = true;
            return;
          }
          if (len <= 8)
            for (int s = 0; s < 1 << (8 - len); ++s) look[(code << (8 - len)) | s] = uint16_t(len << 8 | symbols[p]);
        }
        maxcode[len] = code - 1;
        if (code >= (int32_t(1) << len)) bad = true;  // no code may be all ones
      } else {
        maxcode[len] = -1;
      }
      code <<= 1;
    }
    maxcode[17] = 0xFFFFF;
  }
  // At a scan's start: the table must exist (a sequential DCT file may
  // leave ids 0 and 1 to the standard tables, jdhuff.c jinit_huff_decoder),
  // be a valid code, and hold DC categories up to `max_dc`.
  void use(bool dc, int id, int max_dc, bool std_ok) {
    if (!defined) {
      if (id > 1 || !std_ok) fail("corrupt JPEG: Huffman table missing");
      const uint8_t* bits = kStdBits[(dc ? 0 : 2) + id];
      build(bits, dc ? kStdDcVals : kStdAcVals[id], dc ? 12 : 162);
    }
    if (bad) fail("corrupt JPEG: bad Huffman table");
    if (dc)
      for (int k = 0; k < nvals; ++k)
        if (vals[k] > max_dc) fail("corrupt JPEG: bad Huffman table");
  }
};

// libjpeg suspended: Pillow's source ran out of data.  Where every row is
// out (after a single sequential scan) Pillow keeps the image; elsewhere
// it raises "image file is truncated".
struct Truncated : DecodeError {
  Truncated() : DecodeError("truncated JPEG file") {}
};

// The bytes as libjpeg's source manager hands them on: Pillow's suspends
// at the end of its data; libtiff's (a TIFF's JPEG strip or tile) reads a
// fake EOI past the end, each time it is asked.  Pillow feeds its decoder
// 64 KiB reads, and an arithmetic decoder cannot suspend (jdarith.c
// get_byte: JERR_CANT_SUSPEND): inside an arithmetic-coded scan a byte
// past the reads so far, `limit`, raises.
struct Source {
  const uint8_t* d;
  size_t n;
  bool eoi_past_end = false;
  size_t limit = SIZE_MAX;
  int byte(size_t i) const {
    if (i >= limit) fail("arithmetic-coded JPEG data past a 64 KiB read (Pillow's decoder cannot suspend it)");
    if (i < n) return d[i];
    if (eoi_past_end) return (i - n) & 1 ? 0xD9 : 0xFF;
    throw Truncated{};
  }
};

// jdmarker.c next_marker from `pos`: skips data bytes and FF 00 pairs; the
// marker's code, `pos` just past it.
int next_marker(const Source& src, size_t& pos) {
  for (;;) {
    int c = src.byte(pos++);
    while (c != 0xFF) c = src.byte(pos++);
    do c = src.byte(pos++);
    while (c == 0xFF);
    if (c != 0) return c;
  }
}

// jdmarker.c read_restart_marker with jpeg_resync_to_restart's actions:
// the expected RSTn is swallowed (marker = 0); another marker is left for
// the entropy decoder, which then reads zeros (a valid marker, or one of
// the next two restarts), skipped to the next marker (an invalid one, or
// one of the two before), or discarded (any other restart).
void read_restart_marker(const Source& src, size_t& pos, int& marker, int& next_rst) {
  if (marker == 0) marker = next_marker(src, pos);
  if (marker == 0xD0 + next_rst) {
    marker = 0;
  } else {
    for (;;) {
      int action;
      if (marker < 0xC0) action = 2;
      else if (marker < 0xD0 || marker > 0xD7) action = 3;
      else if (marker == 0xD0 + ((next_rst + 1) & 7) || marker == 0xD0 + ((next_rst + 2) & 7)) action = 3;
      else if (marker == 0xD0 + ((next_rst - 1) & 7) || marker == 0xD0 + ((next_rst - 2) & 7)) action = 2;
      else action = 1;
      if (action == 1) { marker = 0; break; }
      if (action == 3) break;
      marker = next_marker(src, pos);
    }
  }
  next_rst = (next_rst + 1) & 7;
}

// jdhuff.c's bit reader, its slow path: a 64-bit buffer filled to 57 bits
// when a request finds fewer.  At a marker it stops reading; a request
// beyond the bits left is met with zero bits and sets `insufficient`
// (JWRN_HIT_MARKER), after which the entropy decoders decode no more MCUs
// of the segment.
struct BitReader {
  const Source& src;
  size_t pos;
  uint64_t buf = 0;
  int bits = 0;
  int marker = 0;  // libjpeg's unread_marker
  bool insufficient = false;

  void fill(int nbits) {
    if (marker == 0) {
      while (bits < 57) {
        int c = src.byte(pos++);
        if (c == 0xFF) {
          do c = src.byte(pos++);
          while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            marker = c;
            break;
          }
        }
        buf = buf << 8 | uint64_t(c);
        bits += 8;
      }
      if (marker == 0) return;
    }
    if (nbits > bits) {
      insufficient = true;
      buf <<= 57 - bits;
      bits = 57;
    }
  }
  int get(int k) {  // 0 <= k <= 16
    if (bits < k) fill(k);
    bits -= k;
    return int((buf >> bits) & ((uint64_t(1) << k) - 1));
  }
  int extend(int s) {  // HUFF_EXTEND of the s bits that follow a category
    if (s == 0) return 0;
    int v = get(s);
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }
  int decode(const Huffman& t) {  // HUFF_DECODE and jpeg_huff_decode
    int l = 9;
    if (bits < 8) {
      fill(0);
      if (bits < 8) l = 1;
    }
    if (l == 9) {
      const uint16_t e = t.look[(buf >> (bits - 8)) & 0xFF];
      if (e) {
        bits -= e >> 8;
        return e & 0xFF;
      }
    }
    int32_t code = get(l);
    while (code > t.maxcode[l]) code = code << 1 | get(1), ++l;
    if (l > 16) return 0;  // JWRN_HUFF_BAD_CODE: a zero, 17 bits read
    return t.vals[code + t.valoffset[l]];
  }
  // jdhuff.c process_restart: the buffer's bits are dropped, the marker read.
  void restart(int& next_rst) {
    bits = 0;
    read_restart_marker(src, pos, marker, next_rst);
    if (marker == 0) insufficient = false;
  }
};

// jdarith.c's QM decoder.  At a marker it reads zeros until the scan ends
// (legal in arithmetic coding); ct = -1 marks a code error
// (JWRN_ARITH_BAD_CODE), after which no MCU of the segment is decoded.
struct ArithReader {
  const Source& src;
  size_t pos;
  int marker = 0;
  int64_t c = 0, a = 0;
  int ct = -16;

  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int data = 0;
        if (marker == 0) {
          data = src.byte(pos++);
          if (data == 0xFF) {
            do data = src.byte(pos++);
            while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              marker = data;
              data = 0;
            }
          }
        }
        c = c << 8 | data;
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kQM[sv & 0x7F];
    const int nl = int(qe & 0xFF);
    qe >>= 8;
    const int nm = int(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  void restart(int& next_rst) {
    read_restart_marker(src, pos, marker, next_rst);
    c = 0, a = 0, ct = -16;
  }
};

// The bytes of a marker segment, read one by one from the source (libjpeg
// reads a segment's declared contents, not bounded by its length).
struct Cursor {
  const Source& src;
  size_t p;
  int u8() { return src.byte(p++); }
  int u16() {
    const int a = u8();
    return a << 8 | u8();
  }
  void skip(int64_t k) {
    if (k <= 0) return;
    if (!src.eoi_past_end && size_t(k) > src.n - std::min(p, src.n)) throw Truncated{};
    p += size_t(k);
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;        // downsampled width and height in samples
  int bw = 0, bh = 0;        // blocks holding them (lossless: samples)
  int bw_pad = 0, bh_pad = 0;  // blocks (samples) of whole MCUs
  bool latched = false;
  int32_t q[64] = {};        // quantization table, natural order (zero until latched)
  std::vector<int16_t> coef;  // bw_pad * bh_pad blocks of 64, natural order
  std::vector<uint8_t> lossless;  // lossless: bw_pad * bh_pad samples
  // Progressive: the bit each coefficient (zigzag) is known down to, -1
  // unseen; and coefficients 0-9 as they were before the component's last
  // scan (jdphuff.c, for block smoothing).
  int coef_bits[64], prev_bits[10];
  int16_t* block(int bx, int by) { return coef.data() + (size_t(by) * bw_pad + bx) * 64; }
};

struct Jpeg {
  Bytes in;
  Source src;
  int width = 0, height = 0, maxh = 1, maxv = 1, mcux = 0, mcuy = 0;
  bool progressive = false, arith = false, lossless = false;
  bool have_frame = false, saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0, restart_interval = 0;
  std::vector<Component> comps;
  int32_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  uint8_t dc_l[16], dc_u[16], ac_k[16];  // DAC conditioning (jdmarker.c get_soi's defaults)
  int scans = 0;                // libjpeg's input_scan_number
  bool multi_scan = false;      // has_multiple_scans: a progressive file, or a first scan without every component
  int last_good_row = 0;        // jdcoefct.c last_good_iMCU_row
  bool smooth = false;          // jdcoefct.c decompress_smooth_data on this output pass
  int latch[4][2][10];          // its coef_bits_latch: [component][current, before the last scan][coefficient]

  // `tiff`: a TIFF's strip or tile, read through libtiff's source (a fake
  // EOI past the end) without Pillow's JPEG parser.
  explicit Jpeg(Bytes b, bool tiff = false) : in(b), src{b.p, b.n, tiff} {
    std::fill(dc_l, dc_l + 16, 0), std::fill(dc_u, dc_u + 16, 1), std::fill(ac_k, ac_k + 16, 5);
  }

  // Marker segments, read as libjpeg's jdmarker.c reads them: byte by byte,
  // each check where libjpeg makes it, and a Truncated where its source
  // would run dry.
  void read_dqt(Cursor& c) {
    int64_t length = c.u16() - 2;
    while (length > 0) {
      const int n = c.u8(), tq = n & 15;
      if (tq > 3) fail("corrupt JPEG: bad DQT table id");
      for (int k = 0; k < 64; ++k) qt[tq][kNatural[k]] = n >> 4 ? c.u16() : c.u8();  // any precision but 0: 16-bit
      qt_defined[tq] = true;
      length -= n >> 4 ? 129 : 65;
    }
    if (length != 0) fail("corrupt JPEG: bad DQT segment length");
  }

  void read_dht(Cursor& c) {
    int64_t length = c.u16() - 2;
    while (length > 16) {
      const int index = c.u8();
      uint8_t counts[16], vals[256];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = uint8_t(c.u8());
      length -= 17;
      if (total > 256 || total > length) fail("corrupt JPEG: bad DHT counts");
      for (int i = 0; i < total; ++i) vals[i] = uint8_t(c.u8());
      length -= total;
      const int tc = index >> 4, th = index & 15;
      if (tc > 1 || th > 3) fail("corrupt JPEG: bad DHT table id");
      (tc ? ac : dc)[th].build(counts, vals, total);
    }
    if (length != 0) fail("corrupt JPEG: bad DHT segment length");
  }

  void read_dac(Cursor& c) {
    int64_t length = c.u16() - 2;
    while (length > 0) {
      const int index = c.u8(), val = c.u8();
      length -= 2;
      if (index >= 32) fail("corrupt JPEG: bad DAC table index");
      if (index >= 16) {
        ac_k[index - 16] = uint8_t(val);
      } else {
        dc_l[index] = uint8_t(val & 15), dc_u[index] = uint8_t(val >> 4);
        if (dc_l[index] > dc_u[index]) fail("corrupt JPEG: bad DAC value");
      }
    }
    if (length != 0) fail("corrupt JPEG: bad DAC segment length");
  }

  void read_sof(int code, Cursor& cur) {
    const int64_t length = cur.u16();
    const int precision = cur.u8();
    height = cur.u16();
    width = cur.u16();
    const int nc = cur.u8();
    if (precision != 8)
      fail(std::to_string(precision) + "-bit JPEG is not supported (8-bit only)");
    if (height == 0) fail("JPEG with its height in a DNL marker is not supported");
    if (width == 0) fail("corrupt JPEG: width 0");
    if (width > 65500 || height > 65500) fail("JPEG dimensions exceed 65500");
    if (nc < 1 || nc > 4) fail("JPEG with " + std::to_string(nc) + " components is not supported");
    if (length != 8 + 3 * nc) fail("corrupt JPEG: bad SOF segment length");
    progressive = code == 0xC2 || code == 0xCA;
    arith = code >= 0xC9;
    lossless = code == 0xC3;
    const int unit = lossless ? 1 : 8;  // a lossless "block" is one sample
    comps.resize(size_t(nc));
    for (int i = 0; i < nc; ++i) {
      Component& c = comps[size_t(i)];
      c.id = cur.u8();
      const int hv = cur.u8();
      c.h = hv >> 4, c.v = hv & 15;
      c.tq = cur.u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail("corrupt JPEG: bad sampling factors");
      if (c.tq > 3) fail("corrupt JPEG: bad quantization table id");
      maxh = std::max(maxh, c.h), maxv = std::max(maxv, c.v);
    }
    check_size(width, height);  // before the coefficient buffers
    mcux = (width + unit * maxh - 1) / (unit * maxh);
    mcuy = (height + unit * maxv - 1) / (unit * maxv);
    for (Component& c : comps) {
      c.dw = int((int64_t(width) * c.h + maxh - 1) / maxh);
      c.dh = int((int64_t(height) * c.v + maxv - 1) / maxv);
      c.bw = (c.dw + unit - 1) / unit, c.bh = (c.dh + unit - 1) / unit;
      c.bw_pad = mcux * c.h, c.bh_pad = mcuy * c.v;
      if (lossless) c.lossless.assign(size_t(c.bw_pad) * c.bh_pad, 0);
      else c.coef.assign(size_t(c.bw_pad) * c.bh_pad * 64, 0);
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
    have_frame = true;
  }

  // One scan: its SOS segment from `cur` (at the length), then its data.
  // Returns the code of the marker its entropy decoder stopped at, `p` just
  // past that code; or 0, `p` past the data it read.
  int read_scan(Cursor& cur, size_t& p) {
    if (!have_frame) fail("corrupt JPEG: SOS before SOF");
    const int64_t length = cur.u16();
    const int ns = cur.u8();
    if (ns < 1 || ns > 4 || length != 6 + 2 * ns) fail("corrupt JPEG: bad SOS segment");
    std::vector<Component*> sc;
    std::vector<int> td, ta;
    int blocks = 0;
    for (int i = 0; i < ns; ++i) {
      const int id = cur.u8(), t = cur.u8();
      Component* c = nullptr;
      for (Component& k : comps)
        if (k.id == id) c = &k;
      if (!c || std::find(sc.begin(), sc.end(), c) != sc.end())
        fail("corrupt JPEG: bad component in SOS");
      sc.push_back(c);
      td.push_back(t >> 4), ta.push_back(t & 15);
      blocks += c->h * c->v;
    }
    if (ns > 1 && blocks > 10) fail("corrupt JPEG: more than 10 blocks in an MCU");
    const int ss = cur.u8(), se = cur.u8(), a = cur.u8(), ah = a >> 4, al = a & 15;
    if (scans > 0 && !multi_scan) fail("corrupt JPEG: a second scan after the only one expected");
    if (progressive) {
      bool bad = ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1);
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) fail("corrupt JPEG: bad progressive scan parameters");
    } else if (lossless && (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= 8)) {
      fail("corrupt JPEG: bad lossless scan parameters");
    }  // a sequential scan's Ss, Se, Ah, Al only draw a warning (JWRN_NOT_SEQUENTIAL)
    if (++scans == 1) multi_scan = progressive || ns < int(comps.size());
    const bool dc_scan = !progressive || (ss == 0 && ah == 0), ac_scan = !progressive || ss > 0;
    for (size_t i = 0; i < sc.size(); ++i) {
      Component& c = *sc[i];
      if (!c.latched && !lossless) {  // jdinput.c latches a table at the component's first scan
        if (!qt_defined[c.tq]) fail("corrupt JPEG: quantization table missing");
        std::memcpy(c.q, qt[c.tq], sizeof c.q);
        c.latched = true;
      }
      if (!arith) {  // an arithmetic scan may name any of its 16 conditioning tables
        if ((dc_scan && td[i] > 3) || (ac_scan && !lossless && ta[i] > 3))
          fail("corrupt JPEG: Huffman table missing");
        const bool std_ok = !progressive && !lossless;
        if (dc_scan) dc[td[i]].use(true, td[i], lossless ? 16 : 15, std_ok);
        if (ac_scan && !lossless) ac[ta[i]].use(false, ta[i], 255, std_ok);
      }
      if (progressive) {  // jdphuff.c / jdarith.c start_pass
        for (int k = ss == 0 ? 0 : 1; k <= 9; ++k) c.prev_bits[k] = scans > 1 ? c.coef_bits[k] : 0;
        for (int k = ss; k <= se; ++k) c.coef_bits[k] = al;
      }
    }
    const size_t sos_end = cur.p;
    p = cur.p;
    if (lossless) return lossless_scan(sc, td, ss, al, p);
    int pred[4] = {0, 0, 0, 0};
    const int64_t total = ns == 1 ? int64_t(sc[0]->bw) * sc[0]->bh : int64_t(mcux) * mcuy;
    // The MCU's blocks, and its iMCU row (for last_good_iMCU_row).
    std::vector<std::pair<int, int16_t*>> mcu;
    auto blocks_of = [&](int64_t m) {
      mcu.clear();
      if (ns == 1) {
        Component& c = *sc[0];
        const int by = int(m / c.bw);
        mcu.emplace_back(0, c.block(int(m % c.bw), by));
        return by / c.v;
      }
      const int mx = int(m % mcux), my = int(m / mcux);
      for (int i = 0; i < ns; ++i) {
        Component& c = *sc[size_t(i)];
        for (int y = 0; y < c.v; ++y)
          for (int x = 0; x < c.h; ++x) mcu.emplace_back(i, c.block(mx * c.h + x, my * c.v + y));
      }
      return my;
    };
    int restarts_to_go = restart_interval, next_rst = 0;
    if (arith) {
      // jdarith.c: statistics areas, reset at the scan's start and at each restart.
      uint8_t dcs[16][64], acs[16][256], fixed = 113;
      int ctx[4] = {0, 0, 0, 0};
      auto reset = [&] {
        for (int i = 0; i < ns; ++i) {
          if (dc_scan) std::memset(dcs[td[size_t(i)]], 0, 64), pred[i] = 0, ctx[i] = 0;
          if (ac_scan) std::memset(acs[ta[size_t(i)]], 0, 256);
        }
      };
      reset();
      if (!src.eoi_past_end) src.limit = std::max<size_t>(65536, (sos_end + 65535) / 65536 * 65536);
      ArithReader ar{src, p};
      for (int64_t m = 0; m < total; ++m) {
        const int row = blocks_of(m);
        if (restart_interval) {
          if (restarts_to_go == 0) ar.restart(next_rst), reset(), restarts_to_go = restart_interval;
          --restarts_to_go;
        }
        last_good_row = row;
        if (ar.ct == -1 && !(progressive && ss == 0 && ah != 0)) continue;  // JWRN_ARITH_BAD_CODE
        for (auto& [i, blk] : mcu) {
          const int dt = td[size_t(i)], at = ta[size_t(i)];
          if (!progressive) {
            if (!arith_dc(ar, dcs[dt], dt, pred[i], ctx[i], 0, blk) ||
                !arith_ac(ar, acs[at], at, &fixed, 1, 63, 0, blk))
              break;
          } else if (ss == 0 && ah == 0) {
            if (!arith_dc(ar, dcs[dt], dt, pred[i], ctx[i], al, blk)) break;
          } else if (ss == 0) {
            if (ar.decode(&fixed)) blk[0] = int16_t(blk[0] | (1 << al));
          } else if (ah == 0) {
            if (!arith_ac(ar, acs[at], at, &fixed, ss, se, al, blk)) break;
          } else if (!arith_ac_refine(ar, acs[at], &fixed, ss, se, al, blk)) {
            break;
          }
        }
      }
      src.limit = SIZE_MAX;
      p = ar.pos;
      return ar.marker;
    }
    BitReader br{src, p};
    int eobrun = 0;
    for (int64_t m = 0; m < total; ++m) {
      const int row = blocks_of(m);
      if (!br.insufficient) last_good_row = row;
      if (restart_interval) {
        if (restarts_to_go == 0) {
          br.restart(next_rst);
          std::fill(pred, pred + 4, 0);
          eobrun = 0, restarts_to_go = restart_interval;
        }
        --restarts_to_go;
      }
      if (br.insufficient && !(progressive && ss == 0 && ah != 0)) continue;  // the segment's data ran out
      for (auto& [i, blk] : mcu) {
        if (!progressive) {
          decode_sequential(br, dc[td[size_t(i)]], ac[ta[size_t(i)]], pred[i], blk);
        } else if (ss == 0 && ah == 0) {
          const int s = br.extend(br.decode(dc[td[size_t(i)]]));
          if ((pred[i] >= 0 && s > INT32_MAX - pred[i]) || (pred[i] < 0 && s < INT32_MIN - pred[i]))
            fail("corrupt JPEG data: DC coefficient out of range");
          pred[i] += s;
          blk[0] = int16_t(uint32_t(pred[i]) << al);
        } else if (ss == 0) {  // DC refinement reads its bits even past a marker: zeros change nothing
          if (br.get(1)) blk[0] = int16_t(blk[0] | (1 << al));
        } else if (ah == 0) {
          decode_ac_first(br, ac[ta[size_t(i)]], ss, se, al, eobrun, blk);
        } else {
          decode_ac_refine(br, ac[ta[size_t(i)]], ss, se, al, eobrun, blk);
        }
      }
    }
    p = br.pos;
    return br.marker;
  }

  // jdhuff.c decode_mcu_slow, one block.
  static void decode_sequential(BitReader& br, const Huffman& dct, const Huffman& act, int& pred,
                                int16_t* blk) {
    const int s = br.extend(br.decode(dct));
    pred = int(uint32_t(pred) + uint32_t(s));  // wraps, as libjpeg's int does in practice
    blk[0] = int16_t(pred);
    for (int k = 1; k < 64; ++k) {
      int rs = br.decode(act), r = rs >> 4, s2 = rs & 15;
      if (s2) {
        k += r;
        blk[kNatural[k]] = int16_t(br.extend(s2));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // jdphuff.c decode_mcu_AC_first, one block.
  static void decode_ac_first(BitReader& br, const Huffman& act, int ss, int se, int al,
                              int& eobrun, int16_t* blk) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int rs = br.decode(act), r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(uint32_t(br.extend(s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.get(r);
        --eobrun;
        break;
      }
    }
  }

  // jdphuff.c decode_mcu_AC_refine, one block (a new coefficient of a size
  // other than 1 draws only a warning).
  static void decode_ac_refine(BitReader& br, const Huffman& act, int ss, int se, int al,
                               int& eobrun, int16_t* blk) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    auto correct = [&](int16_t& c) {
      if (br.get(1) && (c & p1) == 0) c = int16_t(c >= 0 ? c + p1 : c + m1);
    };
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = br.decode(act), r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t& c = blk[kNatural[k]];
          if (c != 0) {
            correct(c);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t& c = blk[kNatural[k]];
        if (c != 0) correct(c);
      }
      --eobrun;
    }
  }

  // jdarith.c: a DC difference (sequential and the first DC scan), added
  // to the 16-bit predictor; false on a code error (ct = -1).
  bool arith_dc(ArithReader& ar, uint8_t* stats, int tbl, int& pred, int& ctx, int al, int16_t* blk) {
    uint8_t* st = stats + ctx;
    if (ar.decode(st) == 0) {
      ctx = 0;
    } else {
      const int sign = ar.decode(st + 1);
      st += 2 + sign;
      int m = ar.decode(st);
      if (m != 0) {
        st = stats + 20;
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ar.ct = -1;
            return false;
          }
          ++st;
        }
      }
      if (m < (1 << dc_l[tbl]) >> 1) ctx = 0;
      else if (m > (1 << dc_u[tbl]) >> 1) ctx = 12 + sign * 4;
      else ctx = 4 + sign * 4;
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      pred = (pred + v) & 0xFFFF;
    }
    blk[0] = int16_t(uint32_t(pred) << al);
    return true;
  }

  // jdarith.c: AC coefficients ss..se (sequential and first AC scans).
  bool arith_ac(ArithReader& ar, uint8_t* stats, int tbl, uint8_t* fixed, int ss, int se, int al, int16_t* blk) {
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (ar.decode(st)) break;  // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) {
          ar.ct = -1;  // spectral overflow
          return false;
        }
      }
      const int sign = ar.decode(fixed);
      st += 2;
      int m = ar.decode(st);
      if (m != 0 && ar.decode(st)) {
        m <<= 1;
        st = stats + (k <= ac_k[tbl] ? 189 : 217);
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ar.ct = -1;
            return false;
          }
          ++st;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = int16_t(uint32_t(v) << al);
    }
    return true;
  }

  // jdarith.c decode_mcu_AC_refine, one block.
  static bool arith_ac_refine(ArithReader& ar, uint8_t* stats, uint8_t* fixed, int ss, int se, int al,
                              int16_t* blk) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int kex = se;
    for (; kex > 0; --kex)
      if (blk[kNatural[kex]]) break;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (k > kex && ar.decode(st)) break;  // EOB
      for (;;) {
        int16_t& c = blk[kNatural[k]];
        if (c) {
          if (ar.decode(st + 2)) c = int16_t(c < 0 ? c + m1 : c + p1);
          break;
        }
        if (ar.decode(st + 1)) {
          c = int16_t(ar.decode(fixed) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) {
          ar.ct = -1;
          return false;
        }
      }
    }
    return true;
  }

  // A lossless scan (jdlhuff.c, jddiffct.c, jdlossls.c): Huffman-coded
  // differences, undifferenced row by row with predictor `psv` (the first
  // row of the scan, of each restart interval and after the data ran out
  // from 2^(7 - pt) and the left neighbour, the first column from the row
  // above) in 16 bits, shifted left by the point transform `pt` into 8-bit
  // samples.
  int lossless_scan(const std::vector<Component*>& sc, const std::vector<int>& td, int psv, int pt, size_t& p) {
    const int ns = int(sc.size());
    const bool one = ns == 1;
    const int per_row = one ? sc[0]->bw : mcux;  // MCUs_per_row
    const int rows = one ? sc[0]->bh : mcuy;     // MCU rows
    if (restart_interval % per_row) fail("corrupt JPEG: lossless restart interval is not a whole number of rows");
    const int restart_rows = restart_interval / per_row;
    // Each component's differences of one iMCU row (v rows, or one for a
    // single-component scan's MCU row), then its undifferenced values.
    std::vector<std::vector<int32_t>> diff, undiff;
    for (const Component* c : sc)
      diff.emplace_back(size_t(c->bw_pad) * size_t(c->v), 0), undiff.emplace_back(size_t(c->bw_pad) * size_t(c->v), 0);
    std::vector<bool> first(size_t(ns), true);
    BitReader br{src, p};
    int next_rst = 0, rows_to_go = restart_rows;
    const int imcu_rows = one ? (sc[0]->bh + sc[0]->v - 1) / sc[0]->v : mcuy;
    for (int r = 0; r < imcu_rows; ++r) {
      // The MCU rows of this iMCU row: one (interleaved) or v (one component).
      const int mrows = one ? std::min(sc[0]->v, rows - r * sc[0]->v) : 1;
      for (int y = 0; y < mrows; ++y) {
        if (restart_interval) {
          if (rows_to_go == 0) {
            br.restart(next_rst);
            std::fill(first.begin(), first.end(), true);
            rows_to_go = restart_rows;
          }
        }
        if (br.insufficient) {  // zeros, and the undifferencer starts again
          for (int i = 0; i < ns; ++i) {
            const Component& c = *sc[size_t(i)];
            for (int yy = one ? y : 0; yy < (one ? y + 1 : c.v); ++yy)
              std::fill_n(diff[size_t(i)].begin() + size_t(yy) * c.bw_pad, c.bw_pad, 0);
          }
          std::fill(first.begin(), first.end(), true);
        } else {
          for (int mx = 0; mx < per_row; ++mx)
            for (int i = 0; i < ns; ++i) {
              const Component& c = *sc[size_t(i)];
              const int bh = one ? 1 : c.v, bwid = one ? 1 : c.h;
              for (int yy = 0; yy < bh; ++yy)
                for (int xx = 0; xx < bwid; ++xx) {
                  int s = br.decode(dc[td[size_t(i)]]);
                  if (s == 16) s = 32768;
                  else s = br.extend(s);
                  diff[size_t(i)][size_t(one ? y : yy) * c.bw_pad + size_t(mx * bwid + xx)] = s;
                }
            }
        }
        if (restart_interval) --rows_to_go;
      }
      for (int i = 0; i < ns; ++i) {
        Component& c = *sc[size_t(i)];
        const int nrow = std::min(c.v, c.bh - r * c.v);
        const size_t W = size_t(c.bw_pad);
        for (int row = 0, prev = c.v - 1; row < nrow; prev = row, ++row) {
          const int32_t* d = diff[size_t(i)].data() + size_t(row) * W;
          const int32_t* up = undiff[size_t(i)].data() + size_t(prev) * W;
          int32_t* u = undiff[size_t(i)].data() + size_t(row) * W;
          // Rb and Rc in registers, as jdlossls.c keeps them: with one
          // row a component, `up` and `u` are the same buffer row.
          int32_t rb = up[0], rc = 0;
          for (int x = 0; x < c.bw; ++x) {
            int32_t pr;
            if (x > 0) rc = rb, rb = up[x];
            if (first[size_t(i)]) {
              pr = x == 0 ? 1 << (7 - pt) : u[x - 1];
            } else if (x == 0) {
              pr = rb;
            } else {
              const int32_t ra = u[x - 1];
              switch (psv) {
                case 1: pr = ra; break;
                case 2: pr = rb; break;
                case 3: pr = rc; break;
                case 4: pr = ra + rb - rc; break;
                case 5: pr = ra + ((rb - rc) >> 1); break;
                case 6: pr = rb + ((ra - rc) >> 1); break;
                default: pr = (ra + rb) >> 1; break;
              }
            }
            u[x] = (d[x] + pr) & 0xFFFF;
          }
          first[size_t(i)] = false;
          uint8_t* o = c.lossless.data() + size_t(r * c.v + row) * W;
          for (int x = 0; x < c.bw; ++x) o[x] = uint8_t(uint32_t(u[x]) << pt);
        }
      }
    }
    p = br.pos;
    return br.marker;
  }


  // libjpeg-turbo's ISLOW IDCT as its x86-64 SIMD code computes it
  // (jidctint-sse2.asm and jidctint-avx2.asm give the same bytes), which
  // is what Pillow's bundled libjpeg-turbo runs on every x86-64 host.  On
  // coefficients an encoder writes it equals the C code (jidctint.c); on
  // corrupt ones it differs where 16-bit lanes wrap or saturate:
  //   - dequantization is a 16-bit multiply (pmullw: the product's low 16
  //     bits);
  //   - in0 + in4, in0 - in4 and the odd part's z3 = in7 + in3 and
  //     z4 = in5 + in1 are 16-bit sums; the products (pmaddwd) and every
  //     later sum are 32-bit, wrapping;
  //   - pass 1 descales by 11 and saturates to 16 bits (packssdw); where
  //     rows 1-7 of the whole block are zero it takes the DC-only path
  //     instead, (in0 << 2) in 16 bits, for all eight columns;
  //   - pass 2 descales by 18, saturates to 16 and then 8 bits (packssdw,
  //     packsswb) and adds 128 in 8 bits.
  static void idct_islow(const int16_t* in, const int32_t* q, uint8_t* out, size_t stride) {
    auto w16 = [](uint32_t v) { return int32_t(int16_t(uint16_t(v))); };  // wrap to 16 bits
    auto sat16 = [](int32_t v) { return v < -32768 ? -32768 : v > 32767 ? 32767 : v; };
    auto add = [](int32_t a, int32_t b) { return int32_t(uint32_t(a) + uint32_t(b)); };
    auto sub = [](int32_t a, int32_t b) { return int32_t(uint32_t(a) - uint32_t(b)); };
    auto mul = [](int32_t a, int32_t c) { return int32_t(uint32_t(a) * uint32_t(c)); };
    // One 8-point pass over x[0..7] (16-bit values); the eight sums before
    // the descale, outputs 0..7.
    auto pass = [&](const int32_t* x, int32_t* o) {
      int32_t tmp3 = add(mul(x[2], 10703), mul(x[6], 4433));   // F0541 + F0765, F0541
      int32_t tmp2 = add(mul(x[2], 4433), mul(x[6], -10704));  // F0541, F0541 - F1847
      int32_t tmp0 = mul(w16(uint32_t(x[0] + x[4])), 8192), tmp1 = mul(w16(uint32_t(x[0] - x[4])), 8192);
      int32_t t10 = add(tmp0, tmp3), t13 = sub(tmp0, tmp3), t11 = add(tmp1, tmp2), t12 = sub(tmp1, tmp2);
      int32_t z3 = w16(uint32_t(x[7] + x[3])), z4 = w16(uint32_t(x[5] + x[1]));
      int32_t z3m = add(mul(z3, -6436), mul(z4, 9633));        // F1175 - F1961, F1175
      int32_t z4m = add(mul(z3, 9633), mul(z4, 6437));         // F1175, F1175 - F0390
      int32_t o0 = add(add(mul(x[7], -4927), mul(x[1], -7373)), z3m);
      int32_t o3 = add(add(mul(x[7], -7373), mul(x[1], 4926)), z4m);
      int32_t o1 = add(add(mul(x[5], -4176), mul(x[3], -20995)), z4m);
      int32_t o2 = add(add(mul(x[5], -20995), mul(x[3], 4177)), z3m);
      o[0] = add(t10, o3), o[7] = sub(t10, o3), o[1] = add(t11, o2), o[6] = sub(t11, o2);
      o[2] = add(t12, o1), o[5] = sub(t12, o1), o[3] = add(t13, o0), o[4] = sub(t13, o0);
    };
    int32_t dq[64], ws[64], x[8], o[8];
    for (int k = 0; k < 64; ++k) dq[k] = w16(uint32_t(in[k]) * uint32_t(q[k]));
    bool dc_only = true;
    for (int k = 8; k < 64 && dc_only; ++k) dc_only = in[k] == 0;
    // Shortcuts below give what the full pass gives: a column or row
    // whose inputs 1-7 are zero has every output x0 * 8192 before the
    // descale.
    auto sample = [&](int32_t sum) {
      const int32_t v = sat16(add(sum, 1 << 17) >> 18);
      return uint8_t((v < -128 ? -128 : v > 127 ? 127 : v) + 128);
    };
    for (int col = 0; col < 8; ++col) {
      if (dc_only) {
        for (int r = 0; r < 8; ++r) ws[8 * r + col] = w16(uint32_t(dq[col]) << 2);
        continue;
      }
      for (int r = 0; r < 8; ++r) x[r] = dq[8 * r + col];
      if (!x[1] && !x[2] && !x[3] && !x[4] && !x[5] && !x[6] && !x[7]) {
        for (int r = 0; r < 8; ++r) ws[8 * r + col] = sat16(x[0] * 4);
        continue;
      }
      pass(x, o);
      for (int r = 0; r < 8; ++r) ws[8 * r + col] = sat16(add(o[r], 1 << 10) >> 11);
    }
    for (int row = 0; row < 8; ++row) {
      const int32_t* wp = ws + 8 * row;
      uint8_t* op = out + row * stride;
      if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
        std::memset(op, sample(wp[0] * 8192), 8);
        continue;
      }
      pass(wp, o);
      for (int i = 0; i < 8; ++i) op[i] = sample(o[i]);
    }
  }

  // jdcoefct.c smoothing_ok, as libjpeg-turbo runs it after the last scan
  // (Pillow decodes with do_block_smoothing on): a progressive file whose
  // coefficients 1-9 are not all known in full is block-smoothed, if every
  // component had a DC scan and the first ten quantizers are non-zero.
  bool smoothing_ok() {
    if (!progressive) return false;
    bool useful = false;
    for (size_t ci = 0; ci < comps.size(); ++ci) {
      const Component& c = comps[ci];
      if (!c.latched) return false;
      for (int pos : {0, 1, 8, 16, 9, 2, 3, 10, 17, 24})
        if (c.q[pos] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      latch[ci][0][0] = c.coef_bits[0];
      for (int k = 1; k < 10; ++k) {
        latch[ci][1][k] = scans > 1 ? c.prev_bits[k] : -1;
        latch[ci][0][k] = c.coef_bits[k];
        if (c.coef_bits[k] != 0) useful = true;
      }
    }
    return useful;
  }

  // jdcoefct.c decompress_smooth_data for block row `by` of component `ci`:
  // each block's coefficients 1-9 that are still zero and not known to be,
  // estimated from the DC values of the 5x5 blocks around it (and its DC
  // too, where no AC coefficient has been seen yet), then its IDCT.
  void smooth_row(int ci, int by, uint8_t* out, size_t stride) {
    Component& c = comps[size_t(ci)];
    const int T = mcuy, r = by / c.v, block_row = by - r * c.v;
    const int block_rows = r < T - 1 ? c.v : (c.bh % c.v ? c.bh % c.v : c.v);
    const int ibr = r * block_rows + block_row, ibrs = block_rows * T;
    const int prev = ibr > 0 ? by - 1 : by, next = ibr < ibrs - 1 ? by + 1 : by;
    const int prev2 = ibr > 1 ? by - 2 : prev, next2 = ibr < ibrs - 2 ? by + 2 : next;
    const int* bits = latch[ci][r > last_good_row ? 1 : 0];
    bool change_dc = true;
    for (int k = 1; k < 10; ++k) change_dc = change_dc && bits[k] == -1;
    const int64_t Q00 = c.q[0], Q01 = c.q[1], Q10 = c.q[8], Q20 = c.q[16], Q11 = c.q[9], Q02 = c.q[2],
                  Q03 = c.q[3], Q12 = c.q[10], Q21 = c.q[17], Q30 = c.q[24];
    auto dcv = [&](int row, int bx) { return int(c.block(bx, row)[0]); };
    int DC[26];  // DC[1 + 5 * i + k]: row i, column k of the 5x5 window (1-based, libjpeg's DC01-DC25)
    const int last = c.bw - 1;
    const int rows5[5] = {prev2, prev, by, next, next2};
    int16_t ws[64];
    auto estimate = [&](int k, int pos, int64_t q, int64_t sum) {
      const int al = bits[k];
      if (al == 0 || ws[pos] != 0) return;
      const int64_t num = Q00 * sum;
      int pred;
      if (num >= 0) {
        pred = int(((q << 7) + num) / (q << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      } else {
        pred = int(((q << 7) - num) / (q << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        pred = -pred;
      }
      ws[pos] = int16_t(pred);
    };
    for (int bx = 0; bx <= last; ++bx) {
      std::memcpy(ws, c.block(bx, by), sizeof ws);
      for (int i = 0; i < 5; ++i)
        for (int k = 0; k < 5; ++k) DC[1 + k + 5 * i] = dcv(rows5[i], std::clamp(bx + k - 2, 0, last));
      const int* d = DC;
      if (change_dc) {
        estimate(1, 1, Q01, -d[1] - d[2] + d[4] + d[5] - 3 * d[6] + 13 * d[7] - 13 * d[9] + 3 * d[10] -
                                3 * d[11] + 38 * d[12] - 38 * d[14] + 3 * d[15] - 3 * d[16] + 13 * d[17] -
                                13 * d[19] + 3 * d[20] - d[21] - d[22] + d[24] + d[25]);
        estimate(2, 8, Q10, -d[1] - 3 * d[2] - 3 * d[3] - 3 * d[4] - d[5] - d[6] + 13 * d[7] + 38 * d[8] +
                                13 * d[9] - d[10] + d[16] - 13 * d[17] - 38 * d[18] - 13 * d[19] + d[20] +
                                d[21] + 3 * d[22] + 3 * d[23] + 3 * d[24] + d[25]);
        estimate(3, 16, Q20, d[3] + 2 * d[7] + 7 * d[8] + 2 * d[9] - 5 * d[12] - 14 * d[13] - 5 * d[14] +
                                 2 * d[17] + 7 * d[18] + 2 * d[19] + d[23]);
        estimate(4, 9, Q11, -d[1] + d[5] + 9 * d[7] - 9 * d[9] - 9 * d[17] + 9 * d[19] + d[21] - d[25]);
        estimate(5, 2, Q02, 2 * d[7] - 5 * d[8] + 2 * d[9] + d[11] + 7 * d[12] - 14 * d[13] + 7 * d[14] +
                                d[15] + 2 * d[17] - 5 * d[18] + 2 * d[19]);
        estimate(6, 3, Q03, d[7] - d[9] + 2 * d[12] - 2 * d[14] + d[17] - d[19]);
        estimate(7, 10, Q12, d[7] - 3 * d[8] + d[9] - d[17] + 3 * d[18] - d[19]);
        estimate(8, 17, Q21, d[7] - d[9] - 3 * d[12] + 3 * d[14] + d[17] - d[19]);
        estimate(9, 24, Q30, d[7] + 2 * d[8] + d[9] - d[17] - 2 * d[18] - d[19]);
        const int64_t num = Q00 * (-2 * d[1] - 6 * d[2] - 8 * d[3] - 6 * d[4] - 2 * d[5] - 6 * d[6] + 6 * d[7] +
                                   42 * d[8] + 6 * d[9] - 6 * d[10] - 8 * d[11] + 42 * d[12] + 152 * d[13] +
                                   42 * d[14] - 8 * d[15] - 6 * d[16] + 6 * d[17] + 42 * d[18] + 6 * d[19] -
                                   6 * d[20] - 2 * d[21] - 6 * d[22] - 8 * d[23] - 6 * d[24] - 2 * d[25]);
        ws[0] = int16_t(num >= 0 ? int(((Q00 << 7) + num) / (Q00 << 8)) : -int(((Q00 << 7) - num) / (Q00 << 8)));
      } else {
        estimate(1, 1, Q01, -7 * d[11] + 50 * d[12] - 50 * d[14] + 7 * d[15]);
        estimate(2, 8, Q10, -7 * d[3] + 50 * d[8] - 50 * d[18] + 7 * d[23]);
        estimate(3, 16, Q20, -d[3] + 13 * d[8] - 24 * d[13] + 13 * d[18] - d[23]);
        estimate(4, 9, Q11, d[10] + d[16] - 10 * d[17] + 10 * d[19] - d[2] - d[20] + d[22] - d[24] + d[4] -
                                d[6] + 10 * d[7] - 10 * d[9]);
        estimate(5, 2, Q02, -d[11] + 13 * d[12] - 24 * d[13] + 13 * d[14] - d[15]);
      }
      idct_islow(ws, c.q, out + size_t(bx) * 8, stride);
    }
  }

  // The component's samples at full size (width x height), upsampled as
  // jdsample.c does, with the vertical context of jdmainct.c (the rows
  // above the first and below the last real row repeat it).  A lossless
  // file's samples are upsampled by replication (libjpeg's fancy
  // upsampling needs a DCT scaling above 1).
  std::vector<uint8_t> full_plane(int ci) {
    Component& c = comps[size_t(ci)];
    size_t pw;
    std::vector<uint8_t> plane;
    if (lossless) {
      pw = size_t(c.bw_pad);
      plane = c.lossless;
    } else {
      pw = size_t(c.bw) * 8;
      plane.assign(pw * size_t(c.bh) * 8, 0);
      for (int by = 0; by < c.bh; ++by) {
        uint8_t* rowp = plane.data() + size_t(by) * 8 * pw;
        if (smooth) {
          smooth_row(ci, by, rowp, pw);
          continue;
        }
        for (int bx = 0; bx < c.bw; ++bx) idct_islow(c.block(bx, by), c.q, rowp + size_t(bx) * 8, pw);
      }
    }
    if (maxh % c.h || maxv % c.v) fail("JPEG with fractional sampling ratios is not supported");
    const int he = maxh / c.h, ve = maxv / c.v, dw = c.dw, dh = c.dh;
    std::vector<uint8_t> out(size_t(width) * height);
    auto row = [&](int r) { return plane.data() + size_t(std::clamp(r, 0, dh - 1)) * pw; };
    std::vector<int> up(size_t(2 * dw) + 2);
    for (int y = 0; y < height; ++y) {
      uint8_t* o = out.data() + size_t(y) * width;
      if (he == 1 && ve == 1) {
        std::memcpy(o, row(y), size_t(width));
      } else if (lossless) {  // int_upsample, h2v1_upsample, h2v2_upsample
        const uint8_t* in = row(y / ve);
        for (int x = 0; x < width; ++x) o[x] = in[x / he];
      } else if (he == 2 && ve == 1 && dw > 2) {  // h2v1_fancy_upsample
        const uint8_t* in = row(y);
        up[0] = in[0];
        up[1] = (in[0] * 3 + in[1] + 2) >> 2;
        for (int i = 1; i < dw - 1; ++i) {
          up[size_t(2 * i)] = (in[i] * 3 + in[i - 1] + 1) >> 2;
          up[size_t(2 * i + 1)] = (in[i] * 3 + in[i + 1] + 2) >> 2;
        }
        up[size_t(2 * dw - 2)] = (in[dw - 1] * 3 + in[dw - 2] + 1) >> 2;
        up[size_t(2 * dw - 1)] = in[dw - 1];
        for (int x = 0; x < width; ++x) o[x] = uint8_t(up[size_t(x)]);
      } else if (he == 1 && ve == 2) {  // h1v2_fancy_upsample
        int r = y / 2, odd = y & 1;
        const uint8_t *in0 = row(r), *in1 = row(odd ? r + 1 : r - 1);
        for (int x = 0; x < width; ++x) o[x] = uint8_t((in0[x] * 3 + in1[x] + 1 + odd) >> 2);
      } else if (he == 2 && ve == 2 && dw > 2) {  // h2v2_fancy_upsample
        int r = y / 2;
        const uint8_t *in0 = row(r), *in1 = row(y & 1 ? r + 1 : r - 1);
        auto cs = [&](int i) { return in0[i] * 3 + in1[i]; };
        up[0] = (cs(0) * 4 + 8) >> 4;
        up[1] = (cs(0) * 3 + cs(1) + 7) >> 4;
        for (int i = 1; i < dw - 1; ++i) {
          up[size_t(2 * i)] = (cs(i) * 3 + cs(i - 1) + 8) >> 4;
          up[size_t(2 * i + 1)] = (cs(i) * 3 + cs(i + 1) + 7) >> 4;
        }
        up[size_t(2 * dw - 2)] = (cs(dw - 1) * 3 + cs(dw - 2) + 8) >> 4;
        up[size_t(2 * dw - 1)] = (cs(dw - 1) * 4 + 7) >> 4;
        for (int x = 0; x < width; ++x) o[x] = uint8_t(up[size_t(x)]);
      } else {  // h2v1 / h2v2 box filter, int_upsample
        const uint8_t* in = row(y / ve);
        for (int x = 0; x < width; ++x) o[x] = in[x / he];
      }
    }
    return out;
  }

  // Reads the markers from SOI to EOI as libjpeg does (and, before the
  // first scan of a file, Pillow's own parser).  A tables-only stream (a
  // TIFF's JPEGTables) holds no frame and no scan; an abbreviated stream (a
  // TIFF strip or tile) may use tables an earlier stream defined.  Between
  // markers, data bytes are skipped (JWRN_EXTRANEOUS_DATA).  A file of one
  // sequential scan with every component may end without EOI anywhere after
  // that scan: Pillow has every row by then and keeps the image.
  void read_stream(bool tables_only) {
    if (in.n < 2 || in.p[0] != 0xFF || in.p[1] != 0xD8) fail("not a JPEG file");
    size_t p = 2;
    int code = 0;  // a marker the last scan ended at, `p` past its code
    for (;;) {
      // After a single scan with every component, Pillow has every row and
      // keeps the image wherever the file ends (libjpeg suspends); libtiff
      // ignores any error of jpeg_finish_decompress (tif_jpeg.c CALLJPEG's
      // -1 reads as success).
      const bool ends = scans > 0 && !multi_scan && !tables_only && !src.eoi_past_end;
      const bool lenient = scans > 0 && !multi_scan && !tables_only && src.eoi_past_end;
      try {
        if (code == 0) {
          try {
            code = next_marker(src, p);
          } catch (const Truncated&) {
            if (ends) return end_stream();
            fail("truncated JPEG file");
          }
        }
        const int m = code;
        code = 0;
        if (m == 0xD9) break;  // EOI
        if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {  // RSTn and TEM carry no segment
          if (m == 0x01 && scans == 0 && !src.eoi_past_end) fail("corrupt JPEG: TEM marker before the first scan");
          continue;
        }
        const bool sof = m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC;
        if (m == 0xD8) fail("corrupt JPEG: unexpected marker");
        if (m == 0xC5 || m == 0xC6 || m == 0xC7 || m == 0xCD || m == 0xCE || m == 0xCF)
          fail("hierarchical JPEG is not supported");
        if (m == 0xC8) fail("corrupt JPEG: JPG marker");
        if (sof && have_frame) fail("corrupt JPEG: two frames");
        if (!sof && m != 0xC4 && m != 0xCC && !(m >= 0xDA && m <= 0xDD) && !(m >= 0xE0 && m <= 0xEF) && m != 0xFE)
          fail("corrupt JPEG: unknown marker " + std::to_string(m));
        if (tables_only && (m == 0xDA || sof)) fail("corrupt JPEG tables: a frame or scan in JPEGTables");
        Cursor cur{src, p};
        try {
          if (sof) {
            if (m == 0xCB) fail("arithmetic-coded lossless JPEG is not supported (libjpeg-turbo refuses it)");
            read_sof(m, cur);
          } else if (m == 0xC4) {
            read_dht(cur);
          } else if (m == 0xCC) {
            read_dac(cur);
          } else if (m == 0xDB) {
            read_dqt(cur);
          } else if (m == 0xDD) {
            if (cur.u16() != 4) fail("corrupt JPEG: bad DRI segment");
            restart_interval = cur.u16();
          } else if (m == 0xDA) {
            code = read_scan(cur, p);
            continue;
          } else {  // APPn, COM, DNL (which libjpeg skips; a height of 0 in the frame is refused above)
            const int64_t length = cur.u16() - 2;
            const int64_t look = m == 0xE0 || m == 0xEE ? std::clamp<int64_t>(length, 0, 14) : 0;
            uint8_t head[14];
            for (int64_t i = 0; i < look; ++i) head[i] = uint8_t(cur.u8());
            // Pillow's parser reads a JFIF or Adobe segment's version (bytes 5-6).
            if (scans == 0 && !src.eoi_past_end && look < 7 &&
                ((m == 0xE0 && look >= 4 && !std::memcmp(head, "JFIF", 4)) ||
                 (m == 0xEE && look >= 5 && !std::memcmp(head, "Adobe", 5))))
              fail("corrupt JPEG: JFIF or Adobe segment too short");
            if (m == 0xE0 && look >= 14 && !std::memcmp(head, "JFIF\0", 5)) saw_jfif = true;
            if (m == 0xEE && look >= 12 && !std::memcmp(head, "Adobe", 5)) saw_adobe = true, adobe_transform = head[11];
            cur.skip(length - look);
          }
        } catch (const Truncated&) {
          if (ends) return end_stream();
          fail("truncated JPEG file");
        }
        p = cur.p;
      } catch (const DecodeError&) {
        if (lenient) return end_stream();
        throw;
      }
    }
    if (tables_only) return;
    end_stream();
  }

  void end_stream() {
    if (!have_frame || scans == 0) fail("corrupt JPEG: no frame or no scan");
    smooth = smoothing_ok();
  }

  // The tables a TIFF's JPEG streams share (libjpeg keeps them in its
  // decompressor from one stream to the next).
  void take_tables(const Jpeg& o) {
    std::memcpy(qt, o.qt, sizeof qt);
    std::memcpy(qt_defined, o.qt_defined, sizeof qt_defined);
    for (int i = 0; i < 4; ++i) dc[i] = o.dc[i], ac[i] = o.ac[i];
  }

  // How the samples become colours, as libjpeg's jpeg_color_space: from
  // the markers (jdapimin.c default_decompress_parms), none (JCS_UNKNOWN:
  // the components as they are), or YCbCr.
  enum class Colour { FromMarkers, None, YCbCr };

  // The full-size planes converted as `colour` says, interleaved: 1 grey,
  // 3 RGB, 4 CMYK (YCCK converted, not inverted); None keeps the samples.
  // A lossless file takes no conversion (JERR_CONVERSION_NOTIMPL), and
  // reads three components as RGB unless a JFIF or an Adobe marker says
  // YCbCr.
  std::vector<uint8_t> samples(Colour colour) {
    const int nc = int(comps.size());
    bool ycc = false;
    if (colour == Colour::YCbCr) {
      if (nc != 3) fail("corrupt JPEG: YCbCr with " + std::to_string(nc) + " components");
      ycc = true;
    } else if (colour == Colour::FromMarkers && nc == 3) {
      ycc = !lossless;
      if (saw_jfif) ycc = true;
      else if (saw_adobe) ycc = adobe_transform != 0;
      else if (comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66) ycc = false;
    } else if (colour == Colour::FromMarkers && nc == 4) {
      ycc = saw_adobe && adobe_transform != 0;  // YCCK, else CMYK
    }
    if (ycc && lossless) fail("lossless JPEG in YCbCr is not supported (libjpeg converts no lossless colours)");
    std::vector<std::vector<uint8_t>> planes;
    for (int ci = 0; ci < nc; ++ci) planes.push_back(full_plane(ci));
    const size_t npx = size_t(width) * height;
    std::vector<uint8_t> out(npx * size_t(nc));
    if (!ycc) {
      for (size_t i = 0; i < npx; ++i)
        for (int k = 0; k < nc; ++k) out[i * size_t(nc) + size_t(k)] = planes[size_t(k)][i];
      return out;
    }
    // jdcolor.c build_ycc_rgb_table, ycc_rgb_convert and ycck_cmyk_convert.
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    constexpr int SB = 16;
    constexpr int64_t HALF = int64_t(1) << (SB - 1);
    auto fix = [](double x) { return int64_t(x * (1 << SB) + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = int((fix(1.40200) * x + HALF) >> SB);
      cb_b[i] = int((fix(1.77200) * x + HALF) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + HALF;
    }
    auto clamp8 = [](int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); };
    uint8_t* o = out.data();
    for (size_t i = 0; i < npx; ++i, o += nc) {
      int y = planes[0][i], cb = planes[1][i], cr = planes[2][i];
      int rgb[3] = {y + cr_r[cr], y + int((cb_g[cb] + cr_g[cr]) >> SB), y + cb_b[cb]};
      for (int k = 0; k < 3; ++k) o[k] = clamp8(nc == 4 ? 255 - rgb[k] : rgb[k]);
      if (nc == 4) o[3] = planes[3][i];
    }
    return out;
  }

  Image decode() {
    read_stream(false);
    const int nc = int(comps.size());
    if (nc == 2) fail("JPEG with 2 components is not supported");
    std::vector<uint8_t> px = samples(Colour::FromMarkers);
    Image img;
    if (nc != 4) {
      img.alloc(width, height, nc, nc == 1 ? "L" : "RGB");
      img.px = std::move(px);
      return img;
    }
    // Pillow reads every CMYK JPEG with rawmode "CMYK;I" (Adobe's inverted
    // samples), then convert("RGBA").
    img.alloc(width, height, 4, "CMYK");
    for (size_t i = 0; i < img.px.size(); i += 4)
      cmyk_to_rgba(255 - px[i], 255 - px[i + 1], 255 - px[i + 2], 255 - px[i + 3], img.px.data() + i);
    return img;
  }
};

// ----------------------------------------------------------------- PNG ----

// Reconstructs a PNG's pixels from its inflated image data, as Pillow's
// PngImagePlugin reads them (its _MODES table):
//   grey 1 -> "1" (0/255), 2/4 -> "L" scaled to 0-255, 8 -> "L";
//   grey 16 -> "I;16", returned as v >> 8 (stb_image's 16-to-8 bit rule);
//   grey with tRNS -> grey + alpha, alpha 0 where the sample, scaled to
//     0-255, equals the key as Pillow holds it (1-bit: 255 for any key but
//     0; 2/4/8-bit: the raw key), 16-bit: where the raw sample equals it;
//   RGB 8/16 -> "RGB" (16-bit: the high byte; tRNS ignored, as Pillow keeps
//     the mode RGB);
//   palette 1/2/4/8 -> "P", expanded to RGBA with tRNS alpha;
//   grey + alpha 8 -> "LA", 16 -> "RGBA" (high bytes), both as grey + alpha;
//   RGBA 8/16 -> "RGBA" (16-bit: high bytes).
Image png_reconstruct(Bytes raw, int64_t w, int64_t h, int depth, int ctype, int interlace,
                      Bytes plte, Bytes trns) {
  int spp;
  bool ok;
  switch (ctype) {
    case 0: spp = 1, ok = depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16; break;
    case 2: spp = 3, ok = depth == 8 || depth == 16; break;
    case 3: spp = 1, ok = depth == 1 || depth == 2 || depth == 4 || depth == 8; break;
    case 4: spp = 2, ok = depth == 8 || depth == 16; break;
    case 6: spp = 4, ok = depth == 8 || depth == 16; break;
    default: fail("PNG colour type " + std::to_string(ctype) + " does not exist");
  }
  if (!ok) fail("PNG bit depth " + std::to_string(depth) + " is invalid for colour type " + std::to_string(ctype));
  if (interlace != 0 && interlace != 1) fail("PNG interlace method " + std::to_string(interlace) + " does not exist");
  if (w <= 0 || h <= 0 || w > 0x7FFFFFFF || h > 0x7FFFFFFF) fail("PNG has bad dimensions");
  Palette pal;
  if (ctype == 3) {
    if (plte.n == 0) fail("palette PNG has no PLTE chunk");
    if (plte.n % 3 || plte.n > 768) fail("PNG PLTE chunk has a bad length");
    for (size_t i = 0; i < plte.n / 3; ++i)
      for (int k = 0; k < 3; ++k) pal.e[i][k] = plte.p[3 * i + size_t(k)];
    for (size_t i = 0; i < std::min<size_t>(trns.n, 256); ++i) pal.e[i][3] = trns.p[i];
  }
  const bool grey_key = ctype == 0 && trns.n > 0;
  if (grey_key && trns.n < 2) fail("PNG tRNS chunk too short");
  uint32_t key = grey_key ? trns.be16(0, "tRNS") : 0;
  if (grey_key && depth == 1) key = key ? 255 : 0;  // PngImagePlugin.chunk_tRNS, mode "1"
  static const char* modes[] = {"", "1", "L", "", "L", "", "", "", "L"};
  const char* mode = ctype == 0 ? (depth == 16 ? "I;16" : modes[depth])
                     : ctype == 2 ? "RGB" : ctype == 3 ? "P" : ctype == 4 ? (depth == 8 ? "LA" : "RGBA")
                     : "RGBA";
  const int channels = ctype == 0 ? (grey_key ? 2 : 1) : ctype == 2 ? 3 : ctype == 4 ? 2 : 4;
  Image img;
  img.alloc(w, h, channels, mode);

  static const int kPass[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                  {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
  static const int kWhole[1][4] = {{0, 0, 1, 1}};
  const int (*passes)[4] = interlace ? kPass : kWhole;
  const int npass = interlace ? 7 : 1;
  const int bits_pp = spp * depth, bpp = std::max(1, bits_pp / 8);
  // The exact size of the image data.
  size_t expect = 0;
  for (int i = 0; i < npass; ++i) {
    int64_t pw = (w - passes[i][0] + passes[i][2] - 1) / passes[i][2];
    int64_t ph = (h - passes[i][1] + passes[i][3] - 1) / passes[i][3];
    if (pw > 0 && ph > 0) expect += size_t(ph) * (1 + size_t((pw * bits_pp + 7) / 8));
  }
  if (raw.n != expect)
    fail("PNG image data holds " + std::to_string(raw.n) + " bytes, expected " + std::to_string(expect));

  const int scale = depth == 1 ? 255 : depth == 2 ? 85 : depth == 4 ? 17 : 1;
  size_t off = 0;
  std::vector<uint8_t> cur, prior;
  for (int i = 0; i < npass; ++i) {
    const int x0 = passes[i][0], y0 = passes[i][1], dx = passes[i][2], dy = passes[i][3];
    int64_t pw = (w - x0 + dx - 1) / dx, ph = (h - y0 + dy - 1) / dy;
    if (pw <= 0 || ph <= 0) continue;
    const size_t rb = size_t((pw * bits_pp + 7) / 8);
    prior.assign(rb, 0);
    cur.assign(rb, 0);
    for (int64_t r = 0; r < ph; ++r) {
      const int f = raw.p[off];
      const uint8_t* src = raw.p + off + 1;
      off += 1 + rb;
      const size_t b = size_t(bpp);
      switch (f) {
        case 0: std::memcpy(cur.data(), src, rb); break;
        case 1:
          for (size_t j = 0; j < rb; ++j) cur[j] = uint8_t(src[j] + (j >= b ? cur[j - b] : 0));
          break;
        case 2:
          for (size_t j = 0; j < rb; ++j) cur[j] = uint8_t(src[j] + prior[j]);
          break;
        case 3:
          for (size_t j = 0; j < rb; ++j)
            cur[j] = uint8_t(src[j] + (((j >= b ? cur[j - b] : 0) + prior[j]) >> 1));
          break;
        case 4:  // Paeth; left and upper-left are 0 in the first pixel
          for (size_t j = 0; j < std::min(b, rb); ++j) cur[j] = uint8_t(src[j] + prior[j]);
          for (size_t j = b; j < rb; ++j) {
            const int a = cur[j - b], up = prior[j], c = prior[j - b];
            const int pa = std::abs(up - c), pb = std::abs(a - c), pc = std::abs(a + up - 2 * c);
            cur[j] = uint8_t(src[j] + (pa <= pb && pa <= pc ? a : pb <= pc ? up : c));
          }
          break;
        default: fail("PNG row filter " + std::to_string(f) + " does not exist (0-4)");
      }
      const int64_t y = y0 + r * dy;
      if (depth == 8 && dx == 1 && (ctype == 2 || ctype == 4 || ctype == 6 || (ctype == 0 && !grey_key))) {
        std::memcpy(img.at(y, 0), cur.data(), rb);  // the samples are the pixels
        std::swap(cur, prior);
        continue;
      }
      for (int64_t xi = 0; xi < pw; ++xi) {
        uint8_t* o = img.at(y, x0 + xi * dx);
        auto sample = [&](int k) -> uint32_t {
          if (depth == 8) return cur[size_t(xi * spp + k)];
          if (depth == 16) {
            size_t q = size_t(2 * (xi * spp + k));
            return uint32_t(cur[q]) << 8 | cur[q + 1];
          }
          size_t bit = size_t(xi) * size_t(depth);
          return (cur[bit >> 3] >> (8 - depth - int(bit & 7))) & ((1u << depth) - 1);
        };
        switch (ctype) {
          case 0: {
            uint32_t s = sample(0);
            uint32_t v = depth == 16 ? s >> 8 : s * uint32_t(scale);
            o[0] = uint8_t(v);
            if (grey_key) o[1] = (depth == 16 ? s : v) == key ? 0 : 255;
            break;
          }
          case 3:
            std::memcpy(o, pal.e[sample(0) & 255], 4);
            break;
          default:
            for (int k = 0; k < spp; ++k) o[k] = uint8_t(depth == 16 ? sample(k) >> 8 : sample(k));
        }
      }
      std::swap(cur, prior);
    }
  }
  return img;
}

// ----------------------------------------------------------------- TGA ----

// As Pillow's TgaImagePlugin: types 1/9 (colour-mapped, 8-bit indexes; a
// 16-, 24- or 32-bit map whose first `start` entries are zero) -> "P";
// 3/11 (grey) 1-bit -> "1", 8-bit -> "L", 16-bit -> "LA"; 2/10 (true
// colour) 16-bit -> "RGBA" (Pillow's "BGRA;15Z": 5 bits a channel scaled
// by 255/31, alpha 0 where the top bit is set), 24-bit -> "RGB", 32-bit ->
// "RGBA"; origin bit 0x20 top, 0x10 right.  A 1-bit RLE file raises, as
// Pillow's decoder never finishes one.  A grey image's colour map is
// skipped, as stb_image skips it (Pillow's convert("RGBA") would look the
// grey values up in it).  Beyond what Pillow 12 reads, as stb_image does:
// RLE packets that cross rows, a 32-bit colour map (its alpha kept), a
// colour map beside a true-colour image (skipped).
Image tga(Bytes in) {
  if (in.n < 18) fail("truncated TGA header");
  const int id_len = in.p[0], cmap_type = in.p[1], type = in.p[2];
  const int cmap_start = int(in.le16(3, "TGA")), cmap_len = int(in.le16(5, "TGA")), cmap_depth = in.p[7];
  const int w = int(in.le16(12, "TGA")), h = int(in.le16(14, "TGA")), depth = in.p[16], flags = in.p[17];
  if (cmap_type > 1 || w <= 0 || h <= 0 ||
      !(depth == 1 || depth == 8 || depth == 16 || depth == 24 || depth == 32))
    fail("not a TGA file");
  const int base = type & 7;
  if (!(type == 1 || type == 2 || type == 3 || type == 9 || type == 10 || type == 11))
    fail("unknown TGA image type " + std::to_string(type));
  const bool ok = base == 1 ? depth == 8 : base == 3 ? depth == 1 || depth == 8 || depth == 16 : depth != 1 && depth != 8;
  if (!ok) fail(std::to_string(depth) + "-bit TGA of type " + std::to_string(type) + " does not exist");
  if (base == 1 && cmap_type != 1) fail("corrupt TGA: colour-mapped image without a colour map");
  if (type == 11 && depth == 1) fail("RLE-compressed 1-bit TGA cannot be read (Pillow's decoder stalls on it)");
  size_t p = 18 + size_t(id_len);
  Palette pal;
  if (cmap_type == 1) {
    if (cmap_depth != 16 && cmap_depth != 24 && cmap_depth != 32) fail("unknown TGA map depth");
    if (cmap_start + cmap_len > 256) fail("TGA colour map of more than 256 entries (Pillow: invalid palette size)");
    const int eb = cmap_depth / 8;
    in.need(p, size_t(cmap_len) * size_t(eb), "TGA colour map");
    for (int i = 0; i < cmap_start + cmap_len; ++i) {
      uint8_t* e = pal.e[i];
      if (i < cmap_start) {
        e[0] = e[1] = e[2] = 0, e[3] = eb == 4 ? 0 : 255;
        continue;
      }
      const uint8_t* s = in.p + p + size_t(i - cmap_start) * size_t(eb);
      if (eb == 2) {
        const uint32_t v = uint32_t(s[0]) | uint32_t(s[1]) << 8;
        e[0] = uint8_t((v >> 10 & 31) * 255 / 31), e[1] = uint8_t((v >> 5 & 31) * 255 / 31);
        e[2] = uint8_t((v & 31) * 255 / 31), e[3] = v & 0x8000 ? 0 : 255;
      } else {
        e[0] = s[2], e[1] = s[1], e[2] = s[0], e[3] = eb == 4 ? s[3] : 255;
      }
    }
    p += size_t(cmap_len) * size_t(eb);
  }
  const int unit = (depth + 7) / 8;  // bytes a stored pixel (a 1-bit image: a byte)
  const size_t row_bytes = (size_t(w) * size_t(depth) + 7) / 8;
  const char* mode = base == 1 ? "P"
                     : base == 3 ? (depth == 1 ? "1" : depth == 8 ? "L" : "LA")
                     : depth == 24 ? "RGB" : "RGBA";
  const int channels = base == 1 ? 4 : base == 3 ? (depth == 16 ? 2 : 1) : depth == 24 ? 3 : 4;
  Image img;
  img.alloc(w, h, channels, mode);
  std::vector<uint8_t> flat(row_bytes * size_t(h));
  const int64_t nunits = int64_t(flat.size()) / unit;
  if (type & 8) {
    int64_t i = 0;
    while (i < nunits) {
      const int hdr = in.u8(p++, "TGA RLE data"), count = (hdr & 0x7F) + 1;
      if (hdr & 0x80) {
        if (i + count > nunits) fail("corrupt TGA: RLE run past the image");
        in.need(p, size_t(unit), "TGA RLE data");
        for (int k = 0; k < count; ++k) std::memcpy(&flat[size_t(i + k) * size_t(unit)], in.p + p, size_t(unit));
        p += size_t(unit);
      } else {  // a literal past the image is cut, as Pillow cuts it
        in.need(p, size_t(count) * size_t(unit), "TGA RLE data");
        const int64_t fit = std::min<int64_t>(count, nunits - i);
        std::memcpy(&flat[size_t(i) * size_t(unit)], in.p + p, size_t(fit) * size_t(unit));
        p += size_t(count) * size_t(unit);
      }
      i += count;
    }
  } else {
    in.need(p, flat.size(), "TGA image data");
    std::memcpy(flat.data(), in.p + p, flat.size());
  }
  const bool top = flags & 0x20, right = flags & 0x10;
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = &flat[size_t(top ? y : h - 1 - y) * row_bytes];
    for (int x = 0; x < w; ++x) {
      const int sx = right ? w - 1 - x : x;
      const uint8_t* s = row + size_t(sx) * size_t(unit);
      uint8_t* o = img.at(y, x);
      if (depth == 1) {
        o[0] = (row[sx >> 3] >> (7 - (sx & 7)) & 1) ? 255 : 0;
      } else if (base == 1) {
        std::memcpy(o, pal.e[s[0]], 4);
      } else if (base == 3) {
        o[0] = s[0];
        if (depth == 16) o[1] = s[1];
      } else if (depth == 16) {
        const uint32_t v = uint32_t(s[0]) | uint32_t(s[1]) << 8;
        o[0] = uint8_t((v >> 10 & 31) * 255 / 31), o[1] = uint8_t((v >> 5 & 31) * 255 / 31);
        o[2] = uint8_t((v & 31) * 255 / 31), o[3] = v & 0x8000 ? 0 : 255;
      } else {
        o[0] = s[2], o[1] = s[1], o[2] = s[0];
        if (depth == 32) o[3] = s[3];
      }
    }
  }
  return img;
}

// ----------------------------------------------------------------- BMP ----

// Pillow's BmpRleDecoder, quirks included: an encoded run stops at the
// row's end, an absolute run does not; an RLE4 absolute run of n pixels
// reads n / 2 bytes (an odd n drops its last pixel but counts it) and
// then skips to an even file offset; a delta escape reads two bytes and
// then takes right and up from the next two; end-of-line pads the row
// with index 0, and so do deltas.  Returns the indexes row by row in file
// order; fewer than w * h raise, as Pillow's set_as_raw does.
std::vector<uint8_t> bmp_rle(Bytes in, size_t pos, int64_t w, int64_t h, bool rle4) {
  std::vector<uint8_t> data;
  const size_t dest = size_t(w) * size_t(h);
  int64_t x = 0;
  auto read = [&](size_t k) {  // as fd.read: short at the end of the file
    const size_t got = pos < in.n ? std::min(k, in.n - pos) : 0;
    const uint8_t* s = in.p + std::min(pos, in.n);
    pos += got;
    return std::pair<const uint8_t*, size_t>(s, got);
  };
  while (data.size() < dest) {
    auto pixels = read(1), byte = read(1);
    if (!pixels.second || !byte.second) break;
    int64_t n = pixels.first[0];
    const int b = byte.first[0];
    if (n) {
      if (x + n > w) n = std::max<int64_t>(0, w - x);
      for (int64_t i = 0; i < n; ++i)
        data.push_back(uint8_t(!rle4 ? b : i % 2 == 0 ? b >> 4 : b & 15));
      x += n;
    } else if (b == 0) {
      while (data.size() % size_t(w)) data.push_back(0);
      x = 0;
    } else if (b == 1) {
      break;
    } else if (b == 2) {
      if (read(2).second < 2) break;
      auto d = read(2);
      if (d.second < 2) fail("truncated BMP RLE delta");
      data.insert(data.end(), size_t(d.first[0]) + size_t(d.first[1]) * size_t(w), 0);
      x = int64_t(data.size() % size_t(w));
    } else {
      const size_t count = rle4 ? size_t(b / 2) : size_t(b);
      auto run = read(count);
      for (size_t i = 0; i < run.second; ++i) {
        if (rle4) {
          data.push_back(run.first[i] >> 4);
          data.push_back(run.first[i] & 15);
        } else {
          data.push_back(run.first[i]);
        }
      }
      if (run.second < count) break;
      x += b;
      if (pos % 2) ++pos;  // fd.seek(1, SEEK_CUR), even past the end
    }
  }
  if (data.size() < dest) fail("BMP RLE data ends before the image does");
  return data;
}

// As Pillow's BmpImagePlugin: BITMAPCOREHEADER (12) and the 40-124 byte
// headers; 1/4/8-bit palettes -> "P", expanded, RLE8 and RLE4 included
// (bmp_rle above); a grey palette (entry i = i, i, i) -> "L" and the
// two-entry 0/255 palette -> "1", one channel, which Pillow reads as 8-bit
// (resp. 1-bit) samples whatever the depth: at a lower depth an "L" row
// is the w bytes at its file offset, rows overlapping, as Pillow's memory
// map reads them (bytes past the file's end are 0); 16-bit BI_RGB ->
// "RGB" as Pillow's "BGR;15" (5 bits a channel scaled by 255/31), 16-bit
// BI_BITFIELDS 5-6-5 -> "BGR;16" (6 bits scaled by 255/63) and 5-5-5;
// 24-bit -> "RGB"; 32-bit BI_RGB -> "RGB" (the fourth byte ignored);
// 32-bit BI_BITFIELDS -> the masks Pillow knows, "RGBA" where one is alpha.
Image bmp(Bytes in) {
  if (in.n < 18 || in.p[0] != 'B' || in.p[1] != 'M') fail("not a BMP file");
  size_t offset = in.le32(10, "BMP header");
  const uint32_t hs = in.le32(14, "BMP header");
  int64_t w, h;
  int bits, compression = 0, pad;
  uint32_t colors = 0, masks[4] = {0, 0, 0, 0};
  bool top_down = false;
  in.need(14, hs, "BMP header");
  size_t p = 14 + hs;  // the palette, or the masks of a 40-byte header
  if (hs == 12) {
    w = in.le16(18, "BMP"), h = in.le16(20, "BMP"), bits = int(in.le16(24, "BMP")), pad = 3;
  } else if (hs == 40 || hs == 52 || hs == 56 || hs == 64 || hs == 108 || hs == 124) {
    top_down = in.p[25] == 0xFF;
    w = in.le32(18, "BMP");
    const uint32_t hr = in.le32(22, "BMP");
    h = top_down ? int64_t(0x100000000) - hr : int64_t(hr);
    bits = int(in.le16(28, "BMP"));
    compression = int(in.le32(30, "BMP"));
    colors = in.le32(46, "BMP");
    pad = 4;
    if (compression == 3) {
      if (hs - 4 >= 48) {
        for (int k = 0; k < (hs - 4 >= 52 ? 4 : 3); ++k) masks[k] = in.le32(54 + 4 * size_t(k), "BMP");
      } else {  // a 40-byte header: three masks follow it
        for (int k = 0; k < 3; ++k) masks[k] = in.le32(14 + hs + 4 * size_t(k), "BMP bitfields");
        p += 12;
      }
    }
  } else {
    fail("unsupported BMP header size " + std::to_string(hs));
  }
  if (colors == 0) colors = bits < 32 ? uint32_t(1) << bits : 0;
  if (offset == 14 + hs && bits <= 8) offset += 4 * size_t(colors);
  if (bits != 1 && bits != 4 && bits != 8 && bits != 16 && bits != 24 && bits != 32)
    fail("unsupported BMP pixel depth " + std::to_string(bits));
  const bool rle = compression == 1 || compression == 2;
  if (compression != 0 && compression != 3 && !rle)
    fail("unsupported BMP compression " + std::to_string(compression));
  if (rle && bits > 8) fail("RLE-compressed BMP of " + std::to_string(bits) + " bits does not exist");
  // Channel byte offsets in a stored pixel (BGR order by default), -1: none;
  // a 16-bit pixel: 5 (5-5-5) or 6 (5-6-5), the width of its green field.
  int ch[4] = {2, 1, 0, -1}, green16 = 5;
  if (compression == 3) {
    struct Layout { uint32_t m[4]; int ch[4]; };
    static const Layout l32[] = {
        {{0xFF0000, 0xFF00, 0xFF, 0}, {2, 1, 0, -1}},                   // BGRX
        {{0xFF000000, 0xFF0000, 0xFF00, 0}, {3, 2, 1, -1}},            // XBGR
        {{0xFF000000, 0xFF00, 0xFF, 0}, {3, 1, 0, -1}},                // BGXR
        {{0xFF000000, 0xFF0000, 0xFF00, 0xFF}, {3, 2, 1, 0}},          // ABGR
        {{0xFF, 0xFF00, 0xFF0000, 0xFF000000}, {0, 1, 2, 3}},          // RGBA
        {{0xFF0000, 0xFF00, 0xFF, 0xFF000000}, {2, 1, 0, 3}},          // BGRA
        {{0xFF000000, 0xFF00, 0xFF, 0xFF0000}, {3, 1, 0, 2}},          // BGAR
        {{0, 0, 0, 0}, {2, 1, 0, 3}},                                  // BGRA
    };
    bool found = false;
    if (bits == 32) {
      for (const Layout& l : l32)
        if (!std::memcmp(l.m, masks, sizeof masks)) std::memcpy(ch, l.ch, sizeof ch), found = true;
    } else if (bits == 24) {
      found = masks[0] == 0xFF0000 && masks[1] == 0xFF00 && masks[2] == 0xFF;
    } else if (bits == 16) {  // Pillow compares the three colour masks only
      found = (masks[0] == 0xF800 && masks[1] == 0x7E0 && masks[2] == 0x1F) ||
              (masks[0] == 0x7C00 && masks[1] == 0x3E0 && masks[2] == 0x1F);
      green16 = masks[1] == 0x7E0 ? 6 : 5;
    }
    if (!found) fail("unsupported BMP bitfields layout");
  }
  Palette pal;
  bool grey = false;
  if (bits <= 8) {
    if (colors == 0 || colors > 65536) fail("unsupported BMP palette size " + std::to_string(colors));
    // Pillow reads the palette with a short read at the end of the file: an
    // entry not wholly there stays black and makes the palette no grey one.
    const size_t avail = p < in.n ? std::min(size_t(colors) * size_t(pad), in.n - p) : 0;
    grey = true;
    for (uint32_t i = 0; i < colors; ++i) {
      const uint8_t* s = in.p + p + size_t(i) * size_t(pad);
      const uint32_t want = (colors == 2 ? i * 255 : i) & 255;  // Pillow's o8
      if (size_t(i) * size_t(pad) + 3 > avail || s[0] != want || s[1] != want || s[2] != want) grey = false;
      if (i < 256 && size_t(i + 1) * size_t(pad) <= avail)
        pal.e[i][0] = s[2], pal.e[i][1] = s[1], pal.e[i][2] = s[0], pal.e[i][3] = 255;
    }
    if (!grey && avail / size_t(pad) > 256) fail("BMP palette of more than 256 colours (Pillow: invalid palette size)");
    p += avail;
  }
  if (offset == 0) offset = p;  // Pillow: the file position after the palette
  if (w <= 0 || h <= 0) fail("BMP has bad dimensions");
  const bool one = grey && colors == 2;  // mode "1"
  const char* mode = grey ? (one ? "1" : "L") : bits <= 8 ? "P" : ch[3] >= 0 ? "RGBA" : "RGB";
  const int channels = grey ? 1 : bits <= 8 ? 4 : ch[3] >= 0 ? 4 : 3;
  Image img;
  img.alloc(w, h, channels, mode);
  if (rle) {
    if (one) fail("RLE-compressed BMP with a black-and-white palette cannot be read");  // Pillow: no "1" from "P"
    const std::vector<uint8_t> idx = bmp_rle(in, offset, w, h, compression == 2);
    for (int64_t r = 0; r < h; ++r)
      for (int64_t x = 0; x < w; ++x) {
        const uint8_t v = idx[size_t(r * w + x)];
        uint8_t* o = img.at(top_down ? r : h - 1 - r, x);
        if (grey) o[0] = v;
        else std::memcpy(o, pal.e[v], 4);
      }
    return img;
  }
  const size_t stride = size_t(((w * bits + 31) >> 3) & ~int64_t(3));
  const int read_bits = grey ? (one ? 1 : 8) : bits;  // what Pillow unpacks a pixel from
  const size_t row_bytes = size_t((w * read_bits + 7) / 8);
  const size_t body = stride * size_t(h - 1) + row_bytes;
  // The raw decoder needs each row's bytes (the last row's padding may be
  // missing); an "L" row wider than its stride is read only through the
  // memory map, which needs every row's stride.
  if (row_bytes > stride ? offset > in.n || stride * size_t(h) > in.n - offset
                         : offset > in.n || body > in.n - offset)
    fail("truncated BMP pixel data");
  for (int64_t y = 0; y < h; ++y) {
    const size_t row = offset + stride * size_t(top_down ? y : h - 1 - y);
    auto byte = [&](size_t k) -> uint8_t { return row + k < in.n ? in.p[row + k] : 0; };
    for (int64_t x = 0; x < w; ++x) {
      uint8_t* o = img.at(y, x);
      if (grey && !one) {
        o[0] = byte(size_t(x));
      } else if (read_bits <= 8) {
        const size_t bit = size_t(x) * size_t(read_bits);
        const int idx = (in.p[row + (bit >> 3)] >> (8 - read_bits - int(bit & 7))) & ((1 << read_bits) - 1);
        if (one) o[0] = idx ? 255 : 0;
        else std::memcpy(o, pal.e[idx], 4);
      } else if (bits == 16) {
        const uint8_t* s = in.p + row + 2 * size_t(x);
        const uint32_t v = uint32_t(s[0]) | uint32_t(s[1]) << 8;
        if (green16 == 6) {
          o[0] = uint8_t((v >> 11 & 31) * 255 / 31), o[1] = uint8_t((v >> 5 & 63) * 255 / 63);
        } else {
          o[0] = uint8_t((v >> 10 & 31) * 255 / 31), o[1] = uint8_t((v >> 5 & 31) * 255 / 31);
        }
        o[2] = uint8_t((v & 31) * 255 / 31);
      } else {
        const uint8_t* s = in.p + row + size_t(x) * size_t(bits / 8);
        for (int k = 0; k < channels; ++k) o[k] = s[ch[k]];
      }
    }
  }
  return img;
}

// ----------------------------------------------------------------- GIF ----

// The first frame of a GIF as Pillow 12 reads it (GifImagePlugin with its
// default loading strategy, then its LZW decoder GifDecode.c):
//   - the image is the logical screen, grown to hold the frame; outside the
//     frame it holds index 0, or the frame's transparent index where its
//     Graphic Control Extension sets one;
//   - mode "P" through the frame's colour table (the local one, else the
//     global one; a table of entries i = i, i, i is dropped), "L" (the
//     indexes as grey) without one; the transparent index has alpha 0;
//   - LZW codes of 1 + (0..12) bits growing to 12, clear codes, a full table
//     with no clear (no entry is added), codes past the table raise;
//   - an end code pauses the decoder: Pillow's ImageFile.load then reads
//     the next 64 KiB of the file and the decoder goes on after the end
//     code, so a frame its codes do not fill raises, as the file ends.
Image gif(Bytes in) {
  constexpr size_t kChunk = 65536;  // ImageFile.MAXBLOCK, the load's read size
  if (in.n < 6 || (std::memcmp(in.p, "GIF87a", 6) && std::memcmp(in.p, "GIF89a", 6))) fail("not a GIF file");
  int64_t W = in.le16(6, "GIF header"), H = in.le16(8, "GIF header");
  const int gflags = in.u8(10, "GIF header");
  size_t p = 13;
  in.need(11, 2, "GIF header");
  auto table_needed = [](const uint8_t* t, size_t bytes) {
    for (size_t i = 0; i < bytes / 3; ++i)
      if (!(t[3 * i] == i && t[3 * i + 1] == i && t[3 * i + 2] == i)) return true;
    return false;
  };
  const uint8_t* table = nullptr;  // the frame's colour table, or none
  size_t table_bytes = 0;
  if (gflags & 128) {
    table_bytes = size_t(3) << ((gflags & 7) + 1);
    in.need(p, table_bytes, "GIF colour table");
    if (table_needed(in.p + p, table_bytes)) table = in.p + p;
    p += table_bytes;
  }
  auto sub_block = [&](size_t& q) -> size_t {  // GifImageFile.data(): the length read, 0 at the end
    if (q >= in.n) return 0;
    const size_t len = in.p[q++];
    const size_t got = std::min(len, in.n - q);
    q += got;
    return got;
  };
  int transparency = -1;
  int64_t x0 = 0, y0 = 0, fw = 0, fh = 0;
  bool interlace = false;
  for (;;) {
    if (p >= in.n || in.p[p] == ';') fail("GIF has no image");
    const uint8_t c = in.p[p++];
    if (c == '!') {
      const int label = in.u8(p++, "GIF extension");
      const size_t start = p;
      const size_t len = sub_block(p);
      if (label == 249 && len) {
        const uint8_t* b = in.p + start + 1;
        if (len < 3 || ((b[0] & 1) && len < 4)) fail("corrupt GIF: short graphic control extension");
        if (b[0] & 1) transparency = b[3];
      } else if (label == 254) {  // a comment's blocks, up to and with the empty one
        for (size_t l = len; l;) l = sub_block(p);
        continue;
      }
      while (sub_block(p)) {
      }
    } else if (c == ',') {
      in.need(p, 9, "GIF image descriptor");
      x0 = in.le16(p, "GIF"), y0 = in.le16(p + 2, "GIF"), fw = in.le16(p + 4, "GIF"), fh = in.le16(p + 6, "GIF");
      const int lflags = in.p[p + 8];
      p += 9;
      interlace = lflags & 64;
      if (lflags & 128) {
        table_bytes = size_t(3) << ((lflags & 7) + 1);
        in.need(p, table_bytes, "GIF local colour table");
        table = table_needed(in.p + p, table_bytes) ? in.p + p : nullptr;
        p += table_bytes;
      }
      break;
    }
  }
  const int bits = in.u8(p++, "GIF image data");
  if (bits > 12) fail("corrupt GIF: LZW code size " + std::to_string(bits));
  W = std::max(W, x0 + fw), H = std::max(H, y0 + fh);
  check_size(W, H);
  // The decoder's extents (decode.c _setimage: x0 = x1 = 0 means the image).
  int64_t xoff = x0, yoff = y0, xs = fw, ys = fh;
  if (x0 == 0 && x0 + fw == 0) xoff = yoff = 0, xs = W, ys = H;
  if (xs <= 0 || ys <= 0) fail("corrupt GIF: a frame of no pixels");
  std::vector<uint8_t> idx(size_t(W * H), uint8_t(transparency < 0 ? 0 : transparency));

  const int clear = 1 << bits, end = clear + 1;
  constexpr int kTable = 4096;
  std::vector<uint8_t> data(kTable), buffer(kTable);
  std::vector<uint16_t> link(kTable);
  int state = 1, next = 0, codesize = 0, codemask = 0, bufferindex = kTable, lastcode = 0;
  uint8_t lastdata = 0;
  uint32_t bitbuffer = 0;
  int bitcount = 0, blocksize = 0;
  int step = interlace ? 8 : 1, pass = interlace ? 1 : 0;
  int64_t x = 0, y = 0;
  size_t avail = std::min(in.n, p + kChunk);
  auto more = [&] {  // the decoder returned wanting data: the load reads on, or raises
    if (avail >= in.n) fail("truncated GIF image data");
    avail = std::min(in.n, avail + kChunk);
  };
  for (;;) {
    if (state == 1) {
      next = clear + 2, codesize = bits + 1, codemask = (1 << codesize) - 1;
      bufferindex = kTable, state = 2;
    }
    const uint8_t* str;
    int len;
    if (bufferindex < kTable) {
      str = &buffer[size_t(bufferindex)], len = kTable - bufferindex, bufferindex = kTable;
    } else {
      while (bitcount < codesize) {
        if (blocksize > 0) {
          bitbuffer |= uint32_t(in.p[p++]) << bitcount;
          bitcount += 8, --blocksize;
        } else if (p >= avail || avail - p < size_t(in.p[p]) + 1) {
          more();  // a block is decoded only once all of it is read
        } else {
          blocksize = in.p[p++];
        }
      }
      int code = int(bitbuffer & uint32_t(codemask));
      bitbuffer >>= codesize;
      bitcount -= codesize;
      if (code == clear) {
        if (state != 2) state = 1;
        continue;
      }
      if (code == end) {
        more();
        continue;
      }
      str = &lastdata, len = 1;
      if (state == 2) {
        if (code > clear) fail("corrupt GIF: bad first LZW code");
        lastdata = uint8_t(code), lastcode = code, state = 3;
      } else {
        const int thiscode = code;
        if (code > next) fail("corrupt GIF: LZW code past the table");
        if (code == next) {
          if (bufferindex <= 0) fail("corrupt GIF: LZW string too long");
          buffer[size_t(--bufferindex)] = lastdata;
          code = lastcode;
        }
        while (code >= clear) {
          if (bufferindex <= 0 || code >= kTable) fail("corrupt GIF: LZW string too long");
          buffer[size_t(--bufferindex)] = data[size_t(code)];
          code = link[size_t(code)];
        }
        lastdata = uint8_t(code);
        if (next < kTable) {
          data[size_t(next)] = uint8_t(code), link[size_t(next)] = uint16_t(lastcode);
          if (next == codemask && codesize < 12) codemask = (1 << ++codesize) - 1;
          ++next;
        }
        lastcode = thiscode;
      }
    }
    bool done = false;
    for (int k = 0; k < len && !done; ++k) {
      idx[size_t((yoff + y) * W + xoff + x)] = str[k];
      if (++x < xs) continue;
      x = 0, y += step;
      while (y >= ys && !done) {  // GifDecode.c NEWLINE: the interlace passes
        switch (pass) {
          case 1: y = 4, pass = 2; break;
          case 2: step = 4, y = 2, pass = 3; break;
          case 3: step = 2, y = 1, pass = 0; break;
          default: done = true;
        }
      }
    }
    if (done) break;
  }

  Image img;
  const bool key = transparency >= 0;
  if (table) {
    Palette pal;
    for (size_t i = 0; i < table_bytes / 3; ++i)
      for (int k = 0; k < 3; ++k) pal.e[i][k] = table[3 * i + size_t(k)];
    if (key) pal.e[transparency][3] = 0;
    img.alloc(W, H, 4, "P");
    for (size_t i = 0; i < idx.size(); ++i) std::memcpy(&img.px[4 * i], pal.e[idx[i]], 4);
  } else {
    img.alloc(W, H, key ? 2 : 1, "L");
    for (size_t i = 0; i < idx.size(); ++i) {
      img.px[size_t(img.c) * i] = idx[i];
      if (key) img.px[2 * i + 1] = idx[i] == transparency ? 0 : 255;
    }
  }
  return img;
}

// ----------------------------------------------------------------- PNM ----

// As Pillow's PpmImagePlugin: P1/P4 -> "1" (1 is black), P2/P5 -> "L",
// P3/P6 -> "RGB", Pf -> "F".  A maxval other than 255 scales each sample
// to round(v / maxval * 255) (Python's round on doubles: half to even; the
// binary decoder caps at 255); P2/P5 above 255 give "I" at round(v /
// maxval * 65535), returned as its high byte, stb_image's 16-to-8 bit rule
// (Pillow's convert would clip it to 255); P3/P6 above 255 stay "RGB".  A
// "Pf" map (little-endian for a negative scale, rows bottom-up) comes
// back as convert("L") makes it: 0 at or below 0 and for NaN, 255 from
// 255, else truncated.  The ASCII decoders work on 1 MiB blocks of the
// file as Pillow's do, comments included.
namespace pnm {

bool space(uint8_t c) { return c == ' ' || c == '\t' || c == '\n' || c == '\v' || c == '\f' || c == '\r'; }

// Python's int() of an ASCII token: a sign, digits with single underscores
// between them.
bool parse_int(const std::string& t, int64_t& v) {
  size_t i = t[0] == '+' || t[0] == '-' ? 1 : 0;
  if (i >= t.size() || !std::isdigit(static_cast<unsigned char>(t[i]))) return false;
  v = 0;
  for (; i < t.size(); ++i) {
    if (t[i] == '_') {
      if (i + 1 >= t.size() || !std::isdigit(static_cast<unsigned char>(t[i + 1]))) return false;
      continue;
    }
    if (!std::isdigit(static_cast<unsigned char>(t[i]))) return false;
    v = v * 10 + (t[i] - '0');  // at most 10 digits
  }
  if (t[0] == '-') v = -v;
  return true;
}

// Python's float() of a token: the sign and whether it is finite and
// non-zero are all the caller needs; 0 for a token float() refuses.
int parse_scale_sign(const std::string& t, bool& finite_nonzero) {
  std::string s;
  size_t i = 0;
  const int sign = t[0] == '-' ? -1 : 1;
  if (t[0] == '+' || t[0] == '-') ++i;
  std::string rest = t.substr(i), low;
  for (char c : rest) low.push_back(char(std::tolower(static_cast<unsigned char>(c))));
  if (low == "inf" || low == "infinity" || low == "nan") {
    finite_nonzero = false;
    return sign;
  }
  // digitpart ('.' digitpart?)? | '.' digitpart, then an exponent; digitpart:
  // digits with single underscores between them.
  auto digits = [&](size_t& k) {
    size_t start = k;
    while (k < rest.size()) {
      if (std::isdigit(static_cast<unsigned char>(rest[k]))) {
        s.push_back(rest[k++]);
      } else if (rest[k] == '_' && k > start && k + 1 < rest.size() &&
                 std::isdigit(static_cast<unsigned char>(rest[k + 1]))) {
        ++k;
      } else {
        break;
      }
    }
    return k > start;
  };
  size_t k = 0;
  bool whole = digits(k), frac = false;
  if (k < rest.size() && rest[k] == '.') {
    s.push_back('.');
    ++k;
    frac = digits(k);
  }
  if (!whole && !frac) return 0;
  if (k < rest.size() && (rest[k] == 'e' || rest[k] == 'E')) {
    s.push_back('e');
    ++k;
    if (k < rest.size() && (rest[k] == '+' || rest[k] == '-')) s.push_back(rest[k++]);
    if (!digits(k)) return 0;
  }
  if (k != rest.size()) return 0;
  const double v = std::strtod(s.c_str(), nullptr);
  finite_nonzero = std::isfinite(v) && v != 0.0;
  return sign;
}

// Python's round(v / maxval * top) for v in [0, n): two IEEE operations and
// a round half to even, the same on every host.
std::vector<uint32_t> scale_table(size_t n, int64_t maxval, int64_t top) {
  std::vector<uint32_t> t(n);
  for (size_t v = 0; v < n; ++v) {
    const double x = double(v) / double(maxval) * double(top);
    double r = std::floor(x);
    const double d = x - r;
    if (d > 0.5 || (d == 0.5 && std::fmod(r, 2.0) != 0.0)) r += 1.0;
    t[v] = uint32_t(r);
  }
  return t;
}

struct Plain {  // PpmPlainDecoder
  static constexpr size_t kBlock = 1 << 20;  // ImageFile.SAFEBLOCK
  Bytes in;
  size_t pos;
  bool spans = false;

  std::string block() {
    const size_t k = pos < in.n ? std::min(kBlock, in.n - pos) : 0;
    std::string b(reinterpret_cast<const char*>(in.p) + std::min(pos, in.n), k);
    pos += k;
    return b;
  }
  static int64_t comment_end(const std::string& b, size_t start) {
    const size_t a = b.find('\n', start), c = b.find('\r', start);
    const int64_t ia = a == std::string::npos ? -1 : int64_t(a), ic = c == std::string::npos ? -1 : int64_t(c);
    return ia * ic > 0 ? std::min(ia, ic) : std::max(ia, ic);
  }
  std::string strip_comments(std::string b) {
    if (spans) {
      while (!b.empty()) {
        const int64_t e = comment_end(b, 0);
        if (e != -1) {
          b = b.substr(size_t(e) + 1);
          break;
        }
        b = block();
      }
    }
    spans = false;
    for (;;) {
      const size_t s = b.find('#');
      if (s == std::string::npos) break;
      const int64_t e = comment_end(b, s);
      if (e != -1) {
        b = b.substr(0, s) + b.substr(size_t(e) + 1);
      } else {
        b = b.substr(0, s);
        spans = true;
        break;
      }
    }
    return b;
  }
  static std::vector<std::string> split(const std::string& b) {
    std::vector<std::string> out;
    size_t i = 0;
    while (i < b.size()) {
      while (i < b.size() && space(uint8_t(b[i]))) ++i;
      size_t j = i;
      while (j < b.size() && !space(uint8_t(b[j]))) ++j;
      if (j > i) out.push_back(b.substr(i, j - i));
      i = j;
    }
    return out;
  }
  // "1": '0' white, '1' black; every token of a block is checked.
  std::vector<uint8_t> bitonal(size_t total) {
    std::string data;
    while (data.size() != total) {
      std::string b = block();
      if (b.empty()) break;
      b = strip_comments(b);
      std::string tokens;
      for (char c : b)
        if (!space(uint8_t(c))) {
          if (c != '0' && c != '1') fail("PBM data holds a token other than 0 and 1");
          tokens.push_back(c);
        }
      data = (data + tokens).substr(0, total);
    }
    if (data.size() < total) fail("not enough PBM image data");
    std::vector<uint8_t> out(total);
    for (size_t i = 0; i < total; ++i) out[i] = data[i] == '0' ? 255 : 0;
    return out;
  }
  std::vector<uint32_t> samples(size_t total, int64_t maxval, int64_t top) {
    const std::vector<uint32_t> scale = scale_table(size_t(maxval) + 1, maxval, top);
    std::vector<uint32_t> data;
    std::string half;
    while (data.size() != total) {
      std::string b = block();
      if (b.empty()) {
        if (half.empty()) break;
        b = " ";
      }
      b = strip_comments(b);
      if (!half.empty()) b = half + b, half.clear();
      std::vector<std::string> tokens = split(b);
      if (!b.empty() && !space(uint8_t(b.back()))) {
        half = tokens.back();
        tokens.pop_back();
        if (half.size() > 10) fail("PNM token too long");
      }
      for (const std::string& t : tokens) {
        int64_t v;
        if (t.size() > 10) fail("PNM token too long");
        if (!parse_int(t, v)) fail("PNM data holds a token that is no number");
        if (v < 0 || v > maxval) fail("PNM sample outside 0 to maxval");
        data.push_back(scale[size_t(v)]);
        if (data.size() == total) break;
      }
    }
    if (data.size() < total) fail("not enough PNM image data");
    return data;
  }
};

}  // namespace pnm

Image pnm_decode(Bytes in) {
  using pnm::space;
  size_t pos = 0;
  std::string magic;
  for (int i = 0; i < 6 && pos < in.n; ++i) {
    const uint8_t c = in.p[pos++];
    if (space(c)) break;
    magic.push_back(char(c));
  }
  static const char* kKnown[] = {"P1", "P2", "P3", "P4", "P5", "P6", "Pf"};
  if (std::find_if(std::begin(kKnown), std::end(kKnown), [&](const char* k) { return magic == k; }) ==
      std::end(kKnown))
    fail("PNM file of magic '" + magic + "' is not supported (P1-P6, Pf)");
  auto token = [&]() {  // PpmImageFile._read_token
    std::string t;
    while (t.size() <= 10) {
      if (pos >= in.n) break;
      const uint8_t c = in.p[pos++];
      if (space(c)) {
        if (t.empty()) continue;
        break;
      }
      if (c == '#') {
        while (pos < in.n && in.p[pos] != '\r' && in.p[pos] != '\n') ++pos;
        if (pos < in.n) ++pos;
        continue;
      }
      t.push_back(char(c));
    }
    if (t.empty()) fail("truncated PNM header");
    if (t.size() > 10) fail("PNM header token too long");
    return t;
  };
  int64_t w, h;
  if (!pnm::parse_int(token(), w) || !pnm::parse_int(token(), h)) fail("PNM size is no number");
  if (w <= 0 || h <= 0) fail("PNM has bad dimensions");
  check_size(w, h);
  const char kind = magic[1];
  const bool plain = kind == '1' || kind == '2' || kind == '3';
  const int bands = kind == '3' || kind == '6' ? 3 : 1;
  const size_t npx = size_t(w) * size_t(h);
  Image img;
  if (kind == 'f') {
    bool ok = false;
    const int sign = pnm::parse_scale_sign(token(), ok);
    if (!sign) fail("PFM scale is no number");
    if (!ok) fail("PFM scale must be finite and non-zero");
    in.need(pos, npx * 4, "PFM image data");
    img.alloc(w, h, 1, "F");
    img.fl.resize(npx), img.fw = w, img.fh = h;
    for (int64_t y = 0; y < h; ++y)
      for (int64_t x = 0; x < w; ++x) {
        const uint8_t* s = in.p + pos + 4 * size_t((h - 1 - y) * w + x);
        const uint32_t bitsv = sign < 0 ? uint32_t(s[0]) | uint32_t(s[1]) << 8 | uint32_t(s[2]) << 16 | uint32_t(s[3]) << 24
                                        : uint32_t(s[3]) | uint32_t(s[2]) << 8 | uint32_t(s[1]) << 16 | uint32_t(s[0]) << 24;
        float f;
        std::memcpy(&f, &bitsv, 4);
        img.fl[size_t(y * w + x)] = f;
        img.at(y, x)[0] = !(f > 0.0f) ? 0 : f >= 255.0f ? 255 : uint8_t(int(f));
      }
    return img;
  }
  if (kind == '1' || kind == '4') {
    img.alloc(w, h, 1, "1");
    if (plain) {
      pnm::Plain rd{in, pos};
      img.px = rd.bitonal(npx);
      return img;
    }
    const size_t stride = (size_t(w) + 7) / 8;
    in.need(pos, stride * size_t(h), "PBM image data");
    for (int64_t y = 0; y < h; ++y)
      for (int64_t x = 0; x < w; ++x)
        img.at(y, x)[0] = (in.p[pos + size_t(y) * stride + size_t(x >> 3)] >> (7 - (x & 7)) & 1) ? 0 : 255;
    return img;
  }
  int64_t maxval;
  if (!pnm::parse_int(token(), maxval)) fail("PNM maxval is no number");
  if (!(maxval > 0 && maxval < 65536)) fail("PNM maxval must be greater than 0 and less than 65536");
  const bool wide = maxval > 255 && bands == 1;  // Pillow's mode "I"
  const int64_t top = wide ? 65535 : 255;
  img.alloc(w, h, bands, wide ? "I" : bands == 3 ? "RGB" : "L");
  const size_t total = npx * size_t(bands);
  std::vector<uint32_t> v;
  if (plain) {
    pnm::Plain rd{in, pos};
    v = rd.samples(total, maxval, top);
  } else {
    const int in_bytes = maxval < 256 ? 1 : 2;
    in.need(pos, total * size_t(in_bytes), "PNM image data");
    const bool raw = maxval == 255 || (maxval == 65535 && wide);
    const std::vector<uint32_t> scale = raw ? std::vector<uint32_t>() : pnm::scale_table(size_t(1) << (8 * in_bytes), maxval, top);
    v.resize(total);
    for (size_t i = 0; i < total; ++i) {
      const uint32_t s = in_bytes == 1 ? in.p[pos + i] : uint32_t(in.p[pos + 2 * i]) << 8 | in.p[pos + 2 * i + 1];
      v[i] = raw ? s : std::min<uint32_t>(uint32_t(top), scale[s]);
    }
  }
  for (size_t i = 0; i < total; ++i) img.px[i] = uint8_t(wide ? v[i] >> 8 : v[i]);
  return img;
}

// ----------------------------------------------------------------- PSD ----

// The composite image of a PSD as Pillow's PsdImagePlugin reads it: 8-bit
// (bitmap: 1-bit) channels, raw or PackBits (whose per-row byte counts
// only place the channels: each channel decodes on from its start, and a
// run past its row's end is cut), by Pillow's MODES table: bitmap -> "1",
// grey, duotone, multichannel -> "L" (the first channel), indexed -> "P"
// (a 768-byte planar colour table, else all black), RGB -> "RGB" ("RGBA"
// with exactly four channels), CMYK -> "CMYK" (stored inverted), returned
// as convert("RGBA") makes it.  16-bit, Lab, missing channels and other
// compressions raise.
Image psd(Bytes in) {
  if (in.n < 26 || std::memcmp(in.p, "8BPS", 4) || in.be16(4, "PSD") != 1) fail("not a PSD file");
  auto be32 = [&](size_t o, const char* what) { return in.be16(o, what) << 16 | in.be16(o + 2, what); };
  const int channels = int(in.be16(12, "PSD")), depth = int(in.be16(22, "PSD")), cmode = int(in.be16(24, "PSD"));
  const int64_t h = be32(14, "PSD"), w = be32(18, "PSD");
  const char* mode;
  int need;
  switch (depth == 8 ? cmode : depth == 1 && cmode == 0 ? 100 : -1) {
    case 100: mode = "1", need = 1; break;
    case 0: case 1: case 7: case 8: mode = "L", need = 1; break;
    case 2: mode = "P", need = 1; break;
    case 3: mode = "RGB", need = 3; break;
    case 4: mode = "CMYK", need = 4; break;
    case 9: fail("PSD in Lab colour is not supported");
    default:
      fail("PSD of colour mode " + std::to_string(cmode) + " at " + std::to_string(depth) + " bits is not supported");
  }
  if (need > channels) fail("PSD has not enough channels");
  if (!std::strcmp(mode, "RGB") && channels == 4) mode = "RGBA", need = 4;
  // The sections before the image data, read as Pillow reads them: a read
  // past the end of the file comes back short, a length field must be whole.
  size_t pos = 26;
  auto skip = [&](size_t k) { pos = pos < in.n ? pos + std::min(k, in.n - pos) : pos; };
  auto u32 = [&]() {
    if (pos > in.n || in.n - pos < 4) fail("truncated PSD");
    pos += 4;
    return size_t(be32(pos - 4, "PSD"));
  };
  Palette pal;
  const size_t cmd = u32();
  if (!std::strcmp(mode, "P") && cmd == 768 && pos + 768 <= in.n)
    for (int i = 0; i < 256; ++i)
      for (int k = 0; k < 3; ++k) pal.e[i][k] = in.p[pos + size_t(256 * k + i)];
  skip(cmd);
  const size_t res = u32();
  const size_t res_end = pos + res;
  while (pos < res_end) {  // image resources: signature, id, name, data
    skip(4);
    if (pos > in.n || in.n - pos < 3) fail("truncated PSD image resources");
    pos += 2;
    const size_t name_len = in.p[pos++];
    const size_t before = pos;
    skip(name_len);
    if (!((pos - before) & 1)) skip(1);
    const size_t len = u32(), start = pos;
    skip(len);
    if ((pos - start) & 1) skip(1);
  }
  const size_t layers = u32();
  if (layers) {
    const size_t end = pos + layers;
    u32();
    pos = end;
  }
  if (pos > in.n || in.n - pos < 2) fail("truncated PSD image data");
  const int compression = int(in.be16(pos, "PSD"));
  pos += 2;
  if (compression != 0 && compression != 1)
    fail("PSD image data compression " + std::to_string(compression) + " is not supported");
  check_size(w, h);
  const bool bitmap = !std::strcmp(mode, "1");
  const size_t row = bitmap ? (size_t(w) + 7) / 8 : size_t(w);
  std::vector<std::vector<uint8_t>> planes(size_t(need), std::vector<uint8_t>(row * size_t(h)));
  if (compression == 0) {
    for (int c = 0; c < need; ++c) {
      const size_t off = pos + size_t(c) * size_t(w) * size_t(h);
      in.need(off, row * size_t(h), "PSD image data");
      std::memcpy(planes[size_t(c)].data(), in.p + off, row * size_t(h));
    }
  } else {
    const size_t counts = pos;
    in.need(counts, 2 * size_t(need) * size_t(h), "PSD row byte counts");
    size_t off = counts + 2 * size_t(need) * size_t(h);  // Pillow skips `need` channels' counts
    for (int c = 0; c < need; ++c) {
      uint8_t* out = planes[size_t(c)].data();
      size_t q = off, x = 0;
      for (int64_t y = 0; y < h;) {  // PackbitsDecode.c
        if (q >= in.n) fail("truncated PSD PackBits data");
        const int b = in.p[q];
        if (b == 0x80) {
          ++q;
          continue;
        }
        if (b & 0x80) {
          if (in.n - q < 2) fail("truncated PSD PackBits data");
          for (int k = 257 - b; k > 0 && x < row; --k) out[size_t(y) * row + x++] = in.p[q + 1];
          q += 2;
        } else {
          if (in.n - q < size_t(b) + 2) fail("truncated PSD PackBits data");
          for (int k = 1; k < b + 2 && x < row; ++k) out[size_t(y) * row + x++] = in.p[q + size_t(k)];
          q += size_t(b) + 2;
        }
        if (x >= row) x = 0, ++y;
      }
      for (int64_t y = 0; y < h; ++y) off += in.be16(counts + 2 * size_t(c * h + y), "PSD");
    }
  }
  const bool cmyk = !std::strcmp(mode, "CMYK"), paletted = !std::strcmp(mode, "P");
  Image img;
  img.alloc(w, h, paletted || cmyk ? 4 : need, mode);
  for (int64_t y = 0; y < h; ++y)
    for (int64_t x = 0; x < w; ++x) {
      uint8_t* o = img.at(y, x);
      const size_t i = size_t(y) * row + size_t(x);
      if (bitmap) {
        o[0] = (planes[0][size_t(y) * row + size_t(x >> 3)] >> (7 - (x & 7)) & 1) ? 255 : 0;
      } else if (paletted) {
        std::memcpy(o, pal.e[planes[0][i]], 4);
      } else if (cmyk) {  // stored inverted
        cmyk_to_rgba(255 - planes[0][i], 255 - planes[1][i], 255 - planes[2][i], 255 - planes[3][i], o);
      } else {
        for (int k = 0; k < need; ++k) o[k] = planes[size_t(k)][i];
      }
    }
  return img;
}

// ---------------------------------------------------------------- TIFF ----

// Deflate is inflated by the caller's zlib (this library links nothing):
// inflate(src, n, dst, cap) writes at most cap bytes and returns how many,
// or -1 if the stream is corrupt.
using InflateFn = int64_t (*)(const uint8_t*, int64_t, uint8_t*, int64_t);

namespace tiff {

// Pillow's TiffImagePlugin.OPEN_INFO: (byte order, photometric, sample
// format, fill order, bits per sample, extra samples) -> (mode, rawmode).
struct OpenInfo {
  bool mm;
  int photo;
  std::vector<int> fmt;
  int fill;
  std::vector<int> bps, extra;
  const char *mode, *raw;
};

const std::vector<OpenInfo>& open_info() {
  static const std::vector<OpenInfo> table = {
  {false, 0, {1}, 1, {1}, {}, "1", "1;I"},
  {true, 0, {1}, 1, {1}, {}, "1", "1;I"},
  {false, 0, {1}, 2, {1}, {}, "1", "1;IR"},
  {true, 0, {1}, 2, {1}, {}, "1", "1;IR"},
  {false, 1, {1}, 1, {1}, {}, "1", "1"},
  {true, 1, {1}, 1, {1}, {}, "1", "1"},
  {false, 1, {1}, 2, {1}, {}, "1", "1;R"},
  {true, 1, {1}, 2, {1}, {}, "1", "1;R"},
  {false, 0, {1}, 1, {2}, {}, "L", "L;2I"},
  {true, 0, {1}, 1, {2}, {}, "L", "L;2I"},
  {false, 0, {1}, 2, {2}, {}, "L", "L;2IR"},
  {true, 0, {1}, 2, {2}, {}, "L", "L;2IR"},
  {false, 1, {1}, 1, {2}, {}, "L", "L;2"},
  {true, 1, {1}, 1, {2}, {}, "L", "L;2"},
  {false, 1, {1}, 2, {2}, {}, "L", "L;2R"},
  {true, 1, {1}, 2, {2}, {}, "L", "L;2R"},
  {false, 0, {1}, 1, {4}, {}, "L", "L;4I"},
  {true, 0, {1}, 1, {4}, {}, "L", "L;4I"},
  {false, 0, {1}, 2, {4}, {}, "L", "L;4IR"},
  {true, 0, {1}, 2, {4}, {}, "L", "L;4IR"},
  {false, 1, {1}, 1, {4}, {}, "L", "L;4"},
  {true, 1, {1}, 1, {4}, {}, "L", "L;4"},
  {false, 1, {1}, 2, {4}, {}, "L", "L;4R"},
  {true, 1, {1}, 2, {4}, {}, "L", "L;4R"},
  {false, 0, {1}, 1, {8}, {}, "L", "L;I"},
  {true, 0, {1}, 1, {8}, {}, "L", "L;I"},
  {false, 0, {1}, 2, {8}, {}, "L", "L;IR"},
  {true, 0, {1}, 2, {8}, {}, "L", "L;IR"},
  {false, 1, {1}, 1, {8}, {}, "L", "L"},
  {true, 1, {1}, 1, {8}, {}, "L", "L"},
  {false, 1, {2}, 1, {8}, {}, "L", "L"},
  {true, 1, {2}, 1, {8}, {}, "L", "L"},
  {false, 1, {1}, 2, {8}, {}, "L", "L;R"},
  {true, 1, {1}, 2, {8}, {}, "L", "L;R"},
  {false, 1, {1}, 1, {12}, {}, "I;16", "I;12"},
  {false, 0, {1}, 1, {16}, {}, "I;16", "I;16"},
  {false, 1, {1}, 1, {16}, {}, "I;16", "I;16"},
  {true, 1, {1}, 1, {16}, {}, "I;16B", "I;16B"},
  {false, 1, {1}, 2, {16}, {}, "I;16", "I;16R"},
  {false, 1, {2}, 1, {16}, {}, "I", "I;16S"},
  {true, 1, {2}, 1, {16}, {}, "I", "I;16BS"},
  {false, 0, {3}, 1, {32}, {}, "F", "F;32F"},
  {true, 0, {3}, 1, {32}, {}, "F", "F;32BF"},
  {false, 1, {1}, 1, {32}, {}, "I", "I;32N"},
  {false, 1, {2}, 1, {32}, {}, "I", "I;32S"},
  {true, 1, {2}, 1, {32}, {}, "I", "I;32BS"},
  {false, 1, {3}, 1, {32}, {}, "F", "F;32F"},
  {true, 1, {3}, 1, {32}, {}, "F", "F;32BF"},
  {false, 1, {1}, 1, {8, 8}, {2}, "LA", "LA"},
  {true, 1, {1}, 1, {8, 8}, {2}, "LA", "LA"},
  {false, 2, {1}, 1, {8, 8, 8}, {}, "RGB", "RGB"},
  {true, 2, {1}, 1, {8, 8, 8}, {}, "RGB", "RGB"},
  {false, 2, {1}, 2, {8, 8, 8}, {}, "RGB", "RGB;R"},
  {true, 2, {1}, 2, {8, 8, 8}, {}, "RGB", "RGB;R"},
  {false, 2, {1}, 1, {8, 8, 8, 8}, {}, "RGBA", "RGBA"},
  {true, 2, {1}, 1, {8, 8, 8, 8}, {}, "RGBA", "RGBA"},
  {false, 2, {1}, 1, {8, 8, 8, 8}, {0}, "RGB", "RGBX"},
  {true, 2, {1}, 1, {8, 8, 8, 8}, {0}, "RGB", "RGBX"},
  {false, 2, {1}, 1, {8, 8, 8, 8, 8}, {0, 0}, "RGB", "RGBXX"},
  {true, 2, {1}, 1, {8, 8, 8, 8, 8}, {0, 0}, "RGB", "RGBXX"},
  {false, 2, {1}, 1, {8, 8, 8, 8, 8, 8}, {0, 0, 0}, "RGB", "RGBXXX"},
  {true, 2, {1}, 1, {8, 8, 8, 8, 8, 8}, {0, 0, 0}, "RGB", "RGBXXX"},
  {false, 2, {1}, 1, {8, 8, 8, 8}, {1}, "RGBA", "RGBa"},
  {true, 2, {1}, 1, {8, 8, 8, 8}, {1}, "RGBA", "RGBa"},
  {false, 2, {1}, 1, {8, 8, 8, 8, 8}, {1, 0}, "RGBA", "RGBaX"},
  {true, 2, {1}, 1, {8, 8, 8, 8, 8}, {1, 0}, "RGBA", "RGBaX"},
  {false, 2, {1}, 1, {8, 8, 8, 8, 8, 8}, {1, 0, 0}, "RGBA", "RGBaXX"},
  {true, 2, {1}, 1, {8, 8, 8, 8, 8, 8}, {1, 0, 0}, "RGBA", "RGBaXX"},
  {false, 2, {1}, 1, {8, 8, 8, 8}, {2}, "RGBA", "RGBA"},
  {true, 2, {1}, 1, {8, 8, 8, 8}, {2}, "RGBA", "RGBA"},
  {false, 2, {1}, 1, {8, 8, 8, 8, 8}, {2, 0}, "RGBA", "RGBAX"},
  {true, 2, {1}, 1, {8, 8, 8, 8, 8}, {2, 0}, "RGBA", "RGBAX"},
  {false, 2, {1}, 1, {8, 8, 8, 8, 8, 8}, {2, 0, 0}, "RGBA", "RGBAXX"},
  {true, 2, {1}, 1, {8, 8, 8, 8, 8, 8}, {2, 0, 0}, "RGBA", "RGBAXX"},
  {false, 2, {1}, 1, {8, 8, 8, 8}, {999}, "RGBA", "RGBA"},
  {true, 2, {1}, 1, {8, 8, 8, 8}, {999}, "RGBA", "RGBA"},
  {false, 2, {1}, 1, {16, 16, 16}, {}, "RGB", "RGB;16L"},
  {true, 2, {1}, 1, {16, 16, 16}, {}, "RGB", "RGB;16B"},
  {false, 2, {1}, 1, {16, 16, 16, 16}, {}, "RGBA", "RGBA;16L"},
  {true, 2, {1}, 1, {16, 16, 16, 16}, {}, "RGBA", "RGBA;16B"},
  {false, 2, {1}, 1, {16, 16, 16, 16}, {0}, "RGB", "RGBX;16L"},
  {true, 2, {1}, 1, {16, 16, 16, 16}, {0}, "RGB", "RGBX;16B"},
  {false, 2, {1}, 1, {16, 16, 16, 16}, {1}, "RGBA", "RGBa;16L"},
  {true, 2, {1}, 1, {16, 16, 16, 16}, {1}, "RGBA", "RGBa;16B"},
  {false, 2, {1}, 1, {16, 16, 16, 16}, {2}, "RGBA", "RGBA;16L"},
  {true, 2, {1}, 1, {16, 16, 16, 16}, {2}, "RGBA", "RGBA;16B"},
  {false, 3, {1}, 1, {1}, {}, "P", "P;1"},
  {true, 3, {1}, 1, {1}, {}, "P", "P;1"},
  {false, 3, {1}, 2, {1}, {}, "P", "P;1R"},
  {true, 3, {1}, 2, {1}, {}, "P", "P;1R"},
  {false, 3, {1}, 1, {2}, {}, "P", "P;2"},
  {true, 3, {1}, 1, {2}, {}, "P", "P;2"},
  {false, 3, {1}, 2, {2}, {}, "P", "P;2R"},
  {true, 3, {1}, 2, {2}, {}, "P", "P;2R"},
  {false, 3, {1}, 1, {4}, {}, "P", "P;4"},
  {true, 3, {1}, 1, {4}, {}, "P", "P;4"},
  {false, 3, {1}, 2, {4}, {}, "P", "P;4R"},
  {true, 3, {1}, 2, {4}, {}, "P", "P;4R"},
  {false, 3, {1}, 1, {8}, {}, "P", "P"},
  {true, 3, {1}, 1, {8}, {}, "P", "P"},
  {false, 3, {1}, 1, {8, 8}, {0}, "P", "PX"},
  {true, 3, {1}, 1, {8, 8}, {0}, "P", "PX"},
  {false, 3, {1}, 1, {8, 8}, {2}, "PA", "PA"},
  {true, 3, {1}, 1, {8, 8}, {2}, "PA", "PA"},
  {false, 3, {1}, 2, {8}, {}, "P", "P;R"},
  {true, 3, {1}, 2, {8}, {}, "P", "P;R"},
  {false, 5, {1}, 1, {8, 8, 8, 8}, {}, "CMYK", "CMYK"},
  {true, 5, {1}, 1, {8, 8, 8, 8}, {}, "CMYK", "CMYK"},
  {false, 5, {1}, 1, {8, 8, 8, 8, 8}, {0}, "CMYK", "CMYKX"},
  {true, 5, {1}, 1, {8, 8, 8, 8, 8}, {0}, "CMYK", "CMYKX"},
  {false, 5, {1}, 1, {8, 8, 8, 8, 8, 8}, {0, 0}, "CMYK", "CMYKXX"},
  {true, 5, {1}, 1, {8, 8, 8, 8, 8, 8}, {0, 0}, "CMYK", "CMYKXX"},
  {false, 5, {1}, 1, {16, 16, 16, 16}, {}, "CMYK", "CMYK;16L"},
  {true, 5, {1}, 1, {16, 16, 16, 16}, {}, "CMYK", "CMYK;16B"},
  {false, 6, {1}, 1, {8}, {}, "L", "L"},
  {true, 6, {1}, 1, {8}, {}, "L", "L"},
  {false, 6, {1}, 1, {8, 8, 8}, {}, "RGB", "RGBX"},
  {true, 6, {1}, 1, {8, 8, 8}, {}, "RGB", "RGBX"},
  {false, 8, {1}, 1, {8, 8, 8}, {}, "LAB", "LAB"},
  {true, 8, {1}, 1, {8, 8, 8}, {}, "LAB", "LAB"},
  };
  return table;
}

uint8_t rev8(uint8_t b) {
  b = uint8_t((b & 0xF0) >> 4 | (b & 0x0F) << 4);
  b = uint8_t((b & 0xCC) >> 2 | (b & 0x33) << 2);
  return uint8_t((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

int bands_of(const std::string& mode) {
  if (mode == "LA" || mode == "PA") return 2;
  if (mode == "RGB" || mode == "LAB") return 3;
  if (mode == "RGBA" || mode == "CMYK") return 4;
  return 1;
}

// The bits a pixel of `raw` takes (Pillow's unpacker table), 0 if Pillow
// has no unpacker of that rawmode for `mode`.
int raw_bits(const std::string& mode, const std::string& raw) {
  if (raw.size() == 1) {  // a band of a planar image
    const size_t b = mode == "1" || mode == "L" || mode == "P" || mode == "I" || mode == "F" ? mode.find(raw[0])
                     : mode == "RGB" || mode == "RGBA" || mode == "CMYK" ? mode.find(raw[0]) : std::string::npos;
    if (b == std::string::npos) return 0;
    return mode == "1" ? 1 : mode == "I" || mode == "F" ? 32 : 8;
  }
  static const struct { const char *mode, *raw; int bits; } kRaw[] = {
      {"1", "1;I", 1}, {"1", "1;IR", 1}, {"1", "1;R", 1},
      {"L", "L;2", 2}, {"L", "L;2I", 2}, {"L", "L;2R", 2}, {"L", "L;2IR", 2},
      {"L", "L;4", 4}, {"L", "L;4I", 4}, {"L", "L;4R", 4}, {"L", "L;4IR", 4},
      {"L", "L;I", 8}, {"L", "L;R", 8},
      {"I;16", "I;16", 16}, {"I;16", "I;16N", 16}, {"I;16", "I;16R", 16}, {"I;16B", "I;16B", 16},
      {"I;16B", "I;16N", 16},
      {"I", "I;16S", 16}, {"I", "I;16BS", 16}, {"I", "I;32N", 32}, {"I", "I;32S", 32}, {"I", "I;32BS", 32},
      {"F", "F;32F", 32}, {"F", "F;32BF", 32},
      {"LA", "LA", 16}, {"PA", "PA", 16},
      {"P", "P;1", 1}, {"P", "P;2", 2}, {"P", "P;4", 4}, {"P", "P;R", 8}, {"P", "PX", 16},
      {"RGB", "RGB;R", 24}, {"RGB", "RGBX", 32}, {"RGB", "RGBXX", 40}, {"RGB", "RGBXXX", 48},
      {"RGB", "RGB;16L", 48}, {"RGB", "RGB;16B", 48}, {"RGB", "RGB;16N", 48},
      {"RGB", "RGBX;16L", 64}, {"RGB", "RGBX;16B", 64}, {"RGB", "RGBX;16N", 64},
      {"RGBA", "RGBA", 32}, {"RGBA", "RGBa", 32}, {"RGBA", "RGBAX", 40}, {"RGBA", "RGBaX", 40},
      {"RGBA", "RGBAXX", 48}, {"RGBA", "RGBaXX", 48},
      {"RGBA", "RGBA;16L", 64}, {"RGBA", "RGBA;16B", 64}, {"RGBA", "RGBA;16N", 64},
      {"RGBA", "RGBa;16L", 64}, {"RGBA", "RGBa;16B", 64}, {"RGBA", "RGBa;16N", 64},
      {"CMYK", "CMYK", 32}, {"CMYK", "CMYKX", 40}, {"CMYK", "CMYKXX", 48},
      {"CMYK", "CMYK;16L", 64}, {"CMYK", "CMYK;16B", 64}, {"CMYK", "CMYK;16N", 64},
      {"LAB", "LAB", 24}};
  if (raw == mode && (mode == "L" || mode == "P" || mode == "RGB")) return mode == "RGB" ? 24 : 8;
  for (const auto& r : kRaw)
    if (mode == r.mode && raw == r.raw) return r.bits;
  return 0;
}

// Pillow's unpackRGBa: premultiplied alpha divided out.
void unpremultiply(uint32_t* o) {
  const uint32_t a = o[3];
  if (a == 0) {
    o[0] = o[1] = o[2] = 0;
  } else if (a != 255) {
    for (int k = 0; k < 3; ++k) o[k] = std::min<uint32_t>(255, o[k] * 255 / a);
  }
}

// Unpacks n pixels of `raw` from `in` into out (`bands` values a pixel:
// bytes, 16-bit samples, int32 or float32 bits by the mode), as Pillow's
// unpacker of that name does; a one-letter rawmode fills one band.
void unpack(const std::string& mode, const std::string& raw, const uint8_t* in, int64_t n, uint32_t* out,
            int bands) {
  auto le16 = [&](size_t o) { return uint32_t(in[o]) | uint32_t(in[o + 1]) << 8; };
  auto be16 = [&](size_t o) { return uint32_t(in[o]) << 8 | in[o + 1]; };
  auto le32 = [&](size_t o) { return le16(o) | le16(o + 2) << 16; };
  auto be32 = [&](size_t o) { return be16(o) << 16 | be16(o + 2); };
  auto sub = [&](int64_t i, int nb, bool rev) {
    const size_t bit = size_t(i) * size_t(nb);
    const uint8_t byte = rev ? rev8(in[bit >> 3]) : in[bit >> 3];
    return uint32_t(byte >> (8 - nb - int(bit & 7))) & ((1u << nb) - 1);
  };
  if (raw.size() == 1) {
    const int b = int(mode.find(raw[0]));
    for (int64_t i = 0; i < n; ++i) {
      uint32_t v = mode == "1" ? (sub(i, 1, false) ? 255 : 0) : mode == "I" || mode == "F" ? le32(size_t(4 * i)) : in[i];
      out[size_t(i) * size_t(bands) + size_t(b)] = v;
    }
    return;
  }
  const bool rev = raw.size() > 1 && raw.back() == 'R' && raw != "I;16R" && raw.find(';') != std::string::npos;
  const bool inv = raw.find(";I") != std::string::npos || raw.find(";2I") != std::string::npos ||
                   raw.find(";4I") != std::string::npos;
  if (mode == "1") {
    for (int64_t i = 0; i < n; ++i) out[i] = (sub(i, 1, rev) != 0) != inv ? 255 : 0;
  } else if (mode == "L") {
    const int nb = raw.compare(0, 3, "L;2") == 0 ? 2 : raw.compare(0, 3, "L;4") == 0 ? 4 : 8;
    const uint32_t scale = nb == 2 ? 85 : nb == 4 ? 17 : 1;
    for (int64_t i = 0; i < n; ++i) {
      const uint32_t v = (nb == 8 ? uint32_t(rev ? rev8(in[i]) : in[i]) : sub(i, nb, rev)) * scale;
      out[i] = inv ? 255 - v : v;
    }
  } else if (mode == "P") {
    const int nb = raw == "P;1" ? 1 : raw == "P;2" ? 2 : raw == "P;4" ? 4 : 8;
    for (int64_t i = 0; i < n; ++i)
      out[i] = raw == "PX" ? in[2 * i] : nb == 8 ? (rev ? rev8(in[i]) : in[i]) : sub(i, nb, false);
  } else if (mode == "LA" || mode == "PA") {
    for (int64_t i = 0; i < 2 * n; ++i) out[i] = in[i];
  } else if (mode == "I;16" || mode == "I;16B") {
    for (int64_t i = 0; i < n; ++i) {
      const size_t o = size_t(2 * i);
      out[i] = raw == "I;16B" ? be16(o) : raw == "I;16R" ? uint32_t(rev8(in[o])) | uint32_t(rev8(in[o + 1])) << 8
                                                           : le16(o);
    }
  } else if (mode == "I") {
    for (int64_t i = 0; i < n; ++i) {
      if (raw == "I;16S") out[i] = uint32_t(int32_t(int16_t(le16(size_t(2 * i)))));
      else if (raw == "I;16BS") out[i] = uint32_t(int32_t(int16_t(be16(size_t(2 * i)))));
      else out[i] = raw == "I;32BS" ? be32(size_t(4 * i)) : le32(size_t(4 * i));
    }
  } else if (mode == "F") {
    for (int64_t i = 0; i < n; ++i) out[i] = raw == "F;32BF" ? be32(size_t(4 * i)) : le32(size_t(4 * i));
  } else {  // RGB, RGBA, CMYK, LAB: bytes or the high bytes of 16-bit samples
    const bool wide = raw.find(";16") != std::string::npos;
    const bool big = wide && raw.back() == 'B';
    const int step = raw_bits(mode, raw) / 8, take = bands_of(mode);
    const bool premultiplied = raw.compare(0, 4, "RGBa") == 0;
    for (int64_t i = 0; i < n; ++i) {
      const uint8_t* p = in + size_t(i) * size_t(step);
      uint32_t* o = out + size_t(i) * size_t(take);
      for (int k = 0; k < take; ++k) o[k] = wide ? p[2 * k + (big ? 0 : 1)] : rev ? rev8(p[k]) : p[k];
      if (premultiplied) unpremultiply(o);
    }
  }
}

struct Field {
  int type = 0;
  uint64_t count = 0;
  size_t off = 0;
};

constexpr int kTypeSize[17] = {0, 1, 1, 2, 4, 8, 1, 1, 2, 4, 8, 4, 8, 4, 0, 0, 8};  // Pillow's types

// The first image file directory, read as Pillow's ImageFileDirectory_v2
// reads it: a tag of a type it does not know or without values is left
// out; reading stops (keeping the tags before) at a truncated entry or at
// values outside the file; a later tag of the same number replaces an
// earlier.  `clean` is false if anything was left out or cut short: the
// libtiff path, which reads the directory again with its own checks,
// refuses such a file.
struct Dir {
  Bytes in;
  bool mm = false, big = false, libtiff_header = false, clean = true;
  std::map<int, Field> tags;

  uint64_t u(size_t o, int k) const {
    in.need(o, size_t(k), "TIFF file");
    uint64_t v = 0;
    for (int i = 0; i < k; ++i) v = mm ? v << 8 | in.p[o + size_t(i)] : v | uint64_t(in.p[o + size_t(i)]) << (8 * i);
    return v;
  }
  bool has(int tag) const { return tags.count(tag) != 0; }
  int64_t at(const Field& f, uint64_t i, const char* name) const {
    switch (f.type) {
      case 1: case 7: return int64_t(u(f.off + i, 1));
      case 6: return int64_t(int8_t(u(f.off + i, 1)));
      case 3: return int64_t(u(f.off + 2 * i, 2));
      case 8: return int64_t(int16_t(u(f.off + 2 * i, 2)));
      case 4: case 13: return int64_t(u(f.off + 4 * i, 4));
      case 9: return int64_t(int32_t(u(f.off + 4 * i, 4)));
      case 16: return int64_t(u(f.off + 8 * i, 8));
      default: fail(std::string("TIFF tag ") + name + " does not hold integers");
    }
  }
  bool scalar(int tag, int64_t& v, const char* name) const {
    auto it = tags.find(tag);
    if (it == tags.end()) return false;
    v = at(it->second, 0, name);
    return true;
  }
  int64_t get(int tag, int64_t dflt, const char* name) const {
    int64_t v = dflt;
    scalar(tag, v, name);
    return v;
  }
  std::vector<int64_t> ints(int tag, std::vector<int64_t> dflt, const char* name) const {
    auto it = tags.find(tag);
    if (it == tags.end()) return dflt;
    std::vector<int64_t> v(size_t(it->second.count));
    for (uint64_t i = 0; i < it->second.count; ++i) v[size_t(i)] = at(it->second, i, name);
    return v;
  }
  // libtiff's float of a RATIONAL, FLOAT or integer value.
  float real(int tag, uint64_t i) const {
    const Field& f = tags.at(tag);
    if (i >= f.count) fail("TIFF tag " + std::to_string(tag) + " has too few values");
    switch (f.type) {
      case 5: return float(double(u(f.off + 8 * i, 4)) / double(u(f.off + 8 * i + 4, 4)));
      case 10: return float(double(int32_t(u(f.off + 8 * i, 4))) / double(int32_t(u(f.off + 8 * i + 4, 4))));
      case 11: { uint32_t b = uint32_t(u(f.off + 4 * i, 4)); float x; std::memcpy(&x, &b, 4); return x; }
      case 12: { uint64_t b = u(f.off + 8 * i, 8); double x; std::memcpy(&x, &b, 8); return float(x); }
      default: return float(at(f, i, "ReferenceBlackWhite"));
    }
  }

  explicit Dir(Bytes b) : in(b) {
    if (in.n < 8) fail("truncated TIFF header");
    mm = in.p[0] == 'M';
    big = in.p[2] == 43;
    const uint16_t magic = uint16_t(u(2, 2));
    libtiff_header = magic == 42 || magic == 43;
    if (mm && in.p[2] == 0 && in.p[3] == 43)
      fail("big-endian BigTIFF is not supported (Pillow reads its header as a classic TIFF's)");
    const uint64_t first = big ? u(8, 8) : u(4, 4);
    const size_t esz = big ? 20 : 12, slot = big ? 8 : 4;
    if (first >= in.n) fail("truncated TIFF: the first directory lies outside the file");
    size_t pos = size_t(first);
    if (pos > in.n || in.n - pos < (big ? 8u : 2u)) fail("TIFF without dimensions");
    const uint64_t n = big ? u(pos, 8) : u(pos, 2);
    pos += big ? 8 : 2;
    for (uint64_t i = 0; i < n; ++i, pos += esz) {
      if (pos > in.n || in.n - pos < esz) {
        clean = false;  // _ensure_read fails: the directory ends here
        break;
      }
      Field f;
      const int tag = int(u(pos, 2));
      f.type = int(u(pos + 2, 2));
      f.count = big ? u(pos + 4, 8) : u(pos + 4, 4);
      const size_t val = pos + (big ? 12 : 8);
      if (f.type < 1 || f.type > 16 || kTypeSize[f.type] == 0) {
        clean = false;
        continue;
      }
      const uint64_t size = f.count > in.n ? in.n + 1 : f.count * uint64_t(kTypeSize[f.type]);
      if (size > slot) {
        const uint64_t off = u(val, int(slot));
        if (off > in.n || size > in.n - off) {
          clean = false;  // _safe_read raises: the directory ends here
          break;
        }
        f.off = size_t(off);
      } else {
        f.off = val;
      }
      // libtiff reads these as one value each and refuses another count.
      if (f.count != 1 && (tag == 256 || tag == 257 || tag == 277 || tag == 278 || tag == 284 || tag == 322 ||
                           tag == 323))
        clean = false;
      if (f.count) tags[tag] = f;
    }
    if (pos > in.n || in.n - pos < slot) clean = false;  // no next-directory pointer
  }
};

const char* compression_name(int64_t c) {
  switch (c) {
    case 2: return "CCITT RLE (2)";
    case 3: return "CCITT Group 3 fax (3)";
    case 4: return "CCITT Group 4 fax (4)";
    case 6: return "old-style JPEG (6)";
    case 32771: return "raw 16-bit padded (32771)";
    case 32809: return "ThunderScan (32809)";
    case 34676: return "SGILog (34676)";
    case 34677: return "SGILog24 (34677)";
    case 34925: return "LZMA (34925)";
    case 50000: return "ZSTD (50000)";
    case 50001: return "WebP (50001)";
    default: return nullptr;
  }
}

// libtiff's PackBitsDecode of one segment into `need` bytes.
std::vector<uint8_t> unpackbits(Bytes src, size_t need) {
  std::vector<uint8_t> out(need);
  size_t cc = src.n, occ = need, ip = 0, op = 0;
  while (cc > 0 && occ > 0) {
    int n = int(int8_t(src.p[ip++]));
    --cc;
    if (n < 0) {
      if (n == -128) continue;
      size_t k = size_t(-n + 1);
      if (occ < k) k = occ;  // "Discarding bytes to avoid buffer overrun"
      if (cc == 0) break;
      occ -= k;
      const uint8_t b = src.p[ip++];
      --cc;
      std::memset(out.data() + op, b, k);
      op += k;
    } else {
      const size_t k = std::min(size_t(n) + 1, occ);
      if (cc < k) break;
      std::memcpy(out.data() + op, src.p + ip, k);
      op += k, occ -= k, ip += k, cc -= k;
    }
  }
  if (occ > 0) fail("not enough PackBits data in a TIFF strip or tile");
  return out;
}

// libtiff's LZWDecode (codes most significant bit first, 9 to 12 bits,
// each width one code early) of one segment into `need` bytes.
std::vector<uint8_t> unlzw(Bytes src, size_t need) {
  if (src.n >= 2 && src.p[0] == 0 && (src.p[1] & 1))
    fail("old-style (LSB-first) TIFF LZW is not supported");
  struct Code { int next; uint16_t length; uint8_t value, first; };
  constexpr int kClear = 256, kEoi = 257, kFirst = 258, kSize = 4095 + 1024;
  std::vector<Code> tab(kSize);
  for (int i = 0; i < 256; ++i) tab[size_t(i)] = Code{-1, 1, uint8_t(i), uint8_t(i)};
  std::vector<uint8_t> out(need);
  size_t op = 0, bitpos = 0;
  const size_t nbits_total = src.n * 8;
  int nbits = 9, free_ent = kFirst, maxcode = 510, old = -1;
  auto next_code = [&]() -> int {
    if (nbits_total - std::min(bitpos, nbits_total) < size_t(nbits)) return kEoi;  // no EOI: stop
    int v = 0;
    for (int k = 0; k < nbits; ++k, ++bitpos) v = v << 1 | (src.p[bitpos >> 3] >> (7 - (bitpos & 7)) & 1);
    return v;
  };
  auto emit = [&](int code) {  // the string of `code`, cut at the end of the segment
    const size_t len = tab[size_t(code)].length;
    size_t k = len;
    int c = code;
    while (k > need - op) c = tab[size_t(c)].next, --k;  // skip the tail that does not fit
    for (size_t j = k; j > 0; --j) {
      out[op + j - 1] = tab[size_t(c)].value;
      c = tab[size_t(c)].next;
    }
    op += k;
  };
  while (op < need) {
    int code = next_code();
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        for (int i = kFirst; i < kSize; ++i) tab[size_t(i)].length = 0;
        free_ent = kFirst, nbits = 9, maxcode = 510;
        code = next_code();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) fail("corrupt TIFF LZW data: bad first code");
      out[op++] = uint8_t(code);
      old = code;
      continue;
    }
    if (old < 0) fail("corrupt TIFF LZW data: no clear code first");
    if (free_ent >= kSize) fail("corrupt TIFF LZW data: table overflow");
    Code& e = tab[size_t(free_ent)];
    e.next = old;
    e.first = tab[size_t(old)].first;
    e.length = uint16_t(tab[size_t(old)].length + 1);
    e.value = code < free_ent ? tab[size_t(code)].first : e.first;
    if (++free_ent > maxcode) {
      nbits = std::min(nbits + 1, 12);
      maxcode = (1 << nbits) - 2;
    }
    old = code;
    if (tab[size_t(code)].length == 0) fail("corrupt TIFF LZW data: a code not yet defined");
    emit(code);
  }
  if (op < need) fail("not enough LZW data in a TIFF strip or tile");
  return out;
}

// libtiff's TIFFYCbCrToRGBInit tables and TIFFYCbCrtoRGB (tif_color.c), in
// its float arithmetic.
struct YCbCr {
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256], y_tab[256];

  YCbCr(const float luma[3], const float rbw[6]) {
    auto fix = [](float x) { return int32_t(double(x * float(1L << 16)) + 0.5); };
    auto clampf = [](float f, float lo, float hi) { return f < lo ? lo : f > hi ? hi : f; };
    auto clampw = [](float f, float lo, float hi) { return !(f >= lo) ? lo : f > hi ? hi : f; };
    auto code2v = [](int32_t c, float rb, float rw, float cr) {
      return float(c - int32_t(rb)) * cr / (rw - rb != 0 ? rw - rb : 1.0f);
    };
    const float f1 = 2 - 2 * luma[0];
    const int32_t d1 = fix(clampf(f1, 0.0f, 2.0f));
    const float f2 = luma[0] * f1 / luma[1];
    const int32_t d2 = -fix(clampf(f2, 0.0f, 2.0f));
    const float f3 = 2 - 2 * luma[2];
    const int32_t d3 = fix(clampf(f3, 0.0f, 2.0f));
    const float f4 = luma[2] * f3 / luma[1];
    const int32_t d4 = -fix(clampf(f4, 0.0f, 2.0f));
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      const int32_t cr = int32_t(clampw(code2v(x, rbw[4] - 128.0f, rbw[5] - 128.0f, 127), -128.0f * 32, 128.0f * 32));
      const int32_t cb = int32_t(clampw(code2v(x, rbw[2] - 128.0f, rbw[3] - 128.0f, 127), -128.0f * 32, 128.0f * 32));
      cr_r[i] = (d1 * cr + (1 << 15)) >> 16;
      cb_b[i] = (d3 * cb + (1 << 15)) >> 16;
      cr_g[i] = d2 * cr;
      cb_g[i] = d4 * cb + (1 << 15);
      y_tab[i] = int32_t(clampw(code2v(x + 128, rbw[0], rbw[1], 255), -128.0f * 32, 128.0f * 32));
    }
  }
  void rgb(int y, int cb, int cr, uint32_t* o) const {
    auto c8 = [](int32_t v) { return uint32_t(v < 0 ? 0 : v > 255 ? 255 : v); };
    o[0] = c8(y_tab[y] + cr_r[cr]);
    o[1] = c8(y_tab[y] + ((cb_g[cb] + cr_g[cr]) >> 16));
    o[2] = c8(y_tab[y] + cb_b[cb]);
  }
};

// A TIFF as Pillow holds it before convert: `bands` values a pixel.
struct Raster {
  int64_t w = 0, h = 0;
  int bands = 1;
  std::vector<uint32_t> v;
  uint32_t* at(int64_t y, int64_t x) { return v.data() + (size_t(y) * size_t(w) + size_t(x)) * size_t(bands); }
};

// ImageOps.exif_transpose for Orientation 2-8 (load_end applies it).
Raster transpose(Raster& r, int64_t orientation) {
  if (orientation < 2 || orientation > 8) return std::move(r);
  const bool swap = orientation >= 5;
  Raster o;
  o.w = swap ? r.h : r.w, o.h = swap ? r.w : r.h, o.bands = r.bands;
  o.v.resize(r.v.size());
  for (int64_t y = 0; y < o.h; ++y)
    for (int64_t x = 0; x < o.w; ++x) {
      int64_t sy = y, sx = x;
      switch (orientation) {
        case 2: sx = r.w - 1 - x; break;                       // FLIP_LEFT_RIGHT
        case 3: sy = r.h - 1 - y, sx = r.w - 1 - x; break;     // ROTATE_180
        case 4: sy = r.h - 1 - y; break;                       // FLIP_TOP_BOTTOM
        case 5: sy = x, sx = y; break;                         // TRANSPOSE
        case 6: sy = r.h - 1 - x, sx = y; break;               // ROTATE_270
        case 7: sy = r.h - 1 - x, sx = r.w - 1 - y; break;     // TRANSVERSE
        case 8: sy = x, sx = r.w - 1 - y; break;               // ROTATE_90
      }
      std::memcpy(o.at(y, x), r.at(sy, sx), size_t(r.bands) * 4);
    }
  return o;
}

const OpenInfo* find_mode(bool mm, int64_t photo, const std::vector<int64_t>& fmt, int64_t fill,
                          const std::vector<int64_t>& bps, const std::vector<int64_t>& extra) {
  auto same = [](const std::vector<int>& a, const std::vector<int64_t>& b) {
    return a.size() == b.size() && std::equal(a.begin(), a.end(), b.begin());
  };
  for (const OpenInfo& k : open_info())
    if (k.mm == mm && k.photo == photo && same(k.fmt, fmt) && k.fill == fill && same(k.bps, bps) &&
        same(k.extra, extra))
      return &k;
  return nullptr;
}

// One JPEG strip or tile (compression 7) as libtiff's JPEG codec gives it:
// interleaved 8-bit samples, `rows` x `cols` of them.  Its first
// component must be sampled (h0, v0) (-1: the first stream's, which
// JPEGFixupTags reads when no YCbCrSubsampling tag gives it), the others
// 1 x 1.
std::vector<uint8_t> jpeg_segment(Bytes seg, Jpeg& tables, Jpeg::Colour colour, int64_t cols, int64_t rows,
                                  bool last_strip, int spp, int64_t& h0, int64_t& v0) {
  Jpeg j(seg, true);
  j.take_tables(tables);
  j.read_stream(false);
  tables.take_tables(j);
  if (int(j.comps.size()) != spp) fail("TIFF JPEG segment has the wrong number of components");
  if (h0 < 0) h0 = j.comps[0].h, v0 = j.comps[0].v;
  if (j.comps[0].h != h0 || j.comps[0].v != v0) fail("TIFF JPEG segment has improper sampling factors");
  for (size_t i = 1; i < j.comps.size(); ++i)
    if (j.comps[i].h != 1 || j.comps[i].v != 1) fail("TIFF JPEG segment has improper sampling factors");
  if (j.width != cols || (j.height != rows && !(last_strip && j.height > rows)))
    fail("TIFF JPEG strip or tile of " + std::to_string(j.width) + "x" + std::to_string(j.height) +
         ", expected " + std::to_string(cols) + "x" + std::to_string(rows));
  std::vector<uint8_t> px = j.samples(colour);
  px.resize(size_t(cols) * size_t(rows) * size_t(spp));
  return px;
}

Image decode(Bytes in, InflateFn inflate) {
  Dir d(in);
  if (d.has(0xBC01)) fail("Windows Media Photo in a TIFF is not supported");
  int64_t w = 0, h = 0;
  if (!d.scalar(256, w, "ImageWidth") || !d.scalar(257, h, "ImageLength")) fail("TIFF without dimensions");
  const int64_t comp = d.get(259, 1, "Compression");
  if (comp != 1 && comp != 5 && comp != 7 && comp != 8 && comp != 32773 && comp != 32946) {
    const char* name = compression_name(comp);
    fail(name ? std::string("TIFF compression ") + name + " is not supported"
              : "TIFF compression " + std::to_string(comp) + " does not exist");
  }
  const int64_t photo = d.get(262, 0, "PhotometricInterpretation");
  const int64_t fill = d.get(266, 1, "FillOrder");
  const int64_t planar = d.get(284, 1, "PlanarConfiguration");
  std::vector<int64_t> fmt = d.ints(339, {1}, "SampleFormat");
  if (fmt.size() > 1 && std::all_of(fmt.begin(), fmt.end(), [](int64_t v) { return v == 1; })) fmt = {1};
  std::vector<int64_t> bps = d.ints(258, {1}, "BitsPerSample");
  const std::vector<int64_t> extra = d.ints(338, {}, "ExtraSamples");
  const int64_t spp = d.get(277, 1, "SamplesPerPixel");
  if (spp > 6) fail("TIFF with " + std::to_string(spp) + " samples per pixel is not supported");
  if (spp < int64_t(bps.size())) bps.resize(size_t(std::max<int64_t>(spp, 0)));
  else if (spp > int64_t(bps.size()) && bps.size() == 1) bps.assign(size_t(spp), bps[0]);
  if (int64_t(bps.size()) != spp || spp < 1) fail("TIFF of an unknown data organization");
  const int bps_count = (photo == 2 || photo == 6 || photo == 8 ? 3 : photo == 5 ? 4 : 1) + int(extra.size());
  const OpenInfo* key = find_mode(d.mm, photo, fmt, fill, bps, extra);
  if (!key) fail("TIFF pixel layout (photometric " + std::to_string(photo) + ", " + std::to_string(spp) +
                 " samples of " + std::to_string(bps[0]) + " bits) has no Pillow mode");
  if (planar != 1 && planar != 2) fail("TIFF planar configuration " + std::to_string(planar) + " does not exist");
  const bool libtiff = comp != 1;
  if (libtiff && fill == 2) key = find_mode(d.mm, photo, fmt, 1, bps, extra);
  const std::string mode = key->mode;
  std::string raw = key->raw;
  if (mode == "LAB") fail("TIFF in Lab colour is not supported");
  if (libtiff) {  // libtiff hands on host-order (little-endian) 16-bit samples
    auto ends = [&](const char* t) { return raw.size() >= 4 && raw.compare(raw.size() - 4, 4, t) == 0; };
    if (photo == 6 && comp == 7 && planar == 1) raw = "RGB";
    else if (raw == "I;16") raw = "I;16N";
    else if (ends(";16B") || ends(";16L")) raw = raw.substr(0, raw.size() - 1) + "N";
  }
  if (key->raw == std::string("I;12")) fail("12-bit TIFF is not supported");
  const int64_t orientation = d.get(274, 1, "Orientation");
  check_size(w, h);
  Raster r;
  r.w = w, r.h = h, r.bands = bands_of(mode);
  r.v.assign(size_t(w) * size_t(h) * size_t(r.bands), 0);

  if (!libtiff) {
    // Pillow's own raw decoder: every offset read as its strip or tile,
    // extents placed row by row (a planar file's next plane after the
    // last row), the rawmode a band's letter in a planar file.
    const bool strips = d.has(273);
    if (!strips && !d.has(324)) fail("TIFF of an unknown data organization");
    std::vector<int64_t> offsets = d.ints(strips ? 273 : 324, {}, "StripOffsets");
    int64_t tw = w, th = 0;
    if (strips) {
      th = d.get(278, h, "RowsPerStrip");
    } else if (!d.scalar(322, tw, "TileWidth") || !d.scalar(323, th, "TileLength")) {
      fail("TIFF with invalid tile dimensions");
    }
    if (tw <= 0 || th <= 0) fail("TIFF with no rows per strip or an empty tile");
    if (tw == w && th == h && planar != 2 && !offsets.empty()) offsets = {offsets.back()};
    int64_t sum_bits = 0;
    for (int64_t b : bps) sum_bits += b;
    struct Tile { int64_t off, x0, y0, x1, y1, stride; std::string raw; };
    std::vector<Tile> tiles;
    int64_t x = 0, y = 0;
    size_t layer = 0;
    // The end of a run of `len` from `at` (< lim), kept at most `lim`: a
    // BigTIFF's LONG8 tile size would overflow the sum.
    auto end = [](int64_t at, int64_t len, int64_t lim) { return len > lim - at ? lim : at + len; };
    for (int64_t off : offsets) {
      double stride = tw > w - x ? double(tw) * double(sum_bits) / 8 : 0;
      std::string tile_raw = raw;
      if (planar == 2) {
        if (layer >= raw.size()) fail("TIFF has more planes than its mode");
        tile_raw = raw.substr(layer, 1);
        stride /= bps_count;
      }
      // Pillow hands the stride to its raw decoder as a C int.
      if (stride > 2147483647.0) fail("TIFF tile row of more than 2^31 bytes");
      tiles.push_back({off, x, y, end(x, tw, w), end(y, th, h), int64_t(stride), tile_raw});
      x = end(x, tw, w);
      if (x >= w) {
        x = 0, y = end(y, th, h);
        if (y >= h) y = 0, ++layer;
      }
    }
    // ImageFile.load memory-maps a lone tile whose rawmode is its mode: it
    // reads the whole image from the tile's offset, whatever the tile's
    // extent, rows at the tile's stride (or the image's row size), at the
    // image's size, which Orientation 5-8 has already swapped (load_end
    // then transposes what was read).  Pillow decodes as usual if the rows
    // at the tile's own stride pass the file's end, and raises if the map
    // does; where its last row runs past the end (rows that overlap, at a
    // stride below the row size), Pillow reads past the file and the port
    // raises.
    static const char* kMapModes[] = {"L", "P", "RGBX", "RGBA", "CMYK", "I;16", "I;16L", "I;16B"};
    bool mapped = false;
    if (tiles.size() == 1 && tiles[0].raw == mode &&
        std::find(std::begin(kMapModes), std::end(kMapModes), mode) != std::end(kMapModes)) {
      const Tile& t = tiles[0];
      const bool swap = orientation >= 5 && orientation <= 8;
      const int64_t mw = swap ? h : w, mh = swap ? w : h;
      const int64_t bpp = mode == "L" || mode == "P" ? 1 : mode.compare(0, 4, "I;16") == 0 ? 2 : 4;
      const int64_t step = t.stride ? t.stride : mw * bpp;
      if (t.off < 0) fail("TIFF tile offset cannot be negative");
      if (size_t(t.off) <= in.n && size_t(mh * t.stride) <= in.n - size_t(t.off)) {
        const size_t room = in.n - size_t(t.off);
        if (size_t(mh * step) > room || size_t((mh - 1) * step + mw * bpp) > room)
          fail("truncated TIFF image data");
        r.w = mw, r.h = mh;
        for (int64_t row = 0; row < mh; ++row) unpack(mode, t.raw, in.p + t.off + row * step, mw, r.at(row, 0), r.bands);
        mapped = true;
      }
    }
    std::stable_sort(tiles.begin(), tiles.end(), [](const Tile& a, const Tile& b) { return a.off < b.off; });
    for (size_t i = 0; i < (mapped ? 0 : tiles.size()); ++i) {
      const Tile& t = tiles[i];
      if (i + 1 < tiles.size()) {  // ImageFile.load keeps the last of equal neighbours
        const Tile& u = tiles[i + 1];
        if (u.x0 == t.x0 && u.y0 == t.y0 && u.x1 == t.x1 && u.y1 == t.y1 && u.stride == t.stride && u.raw == t.raw)
          continue;
      }
      const int bits = raw_bits(mode, t.raw);
      if (!bits) fail("TIFF rawmode " + t.raw + " has no unpacker for mode " + mode);
      const int64_t cols = t.x1 - t.x0, rows = t.y1 - t.y0;
      const int64_t bytes = (cols * bits + 7) / 8;
      if (t.stride && t.stride < bytes) fail("TIFF strip or tile narrower than its rows");
      const int64_t step = t.stride ? t.stride : bytes;
      if (t.off < 0 || size_t(t.off) > in.n || size_t(bytes) > in.n - size_t(t.off) ||
          (rows > 1 && size_t(step) > (in.n - size_t(t.off) - size_t(bytes)) / size_t(rows - 1)))
        fail("truncated TIFF image data");
      for (int64_t row = 0; row < rows; ++row)
        unpack(mode, t.raw, in.p + t.off + row * step, cols, r.at(t.y0 + row, t.x0), r.bands);
    }
  } else {
    if (!d.libtiff_header) fail("TIFF header in the wrong byte order: libtiff refuses it");
    if (!d.clean) fail("malformed TIFF directory: libtiff refuses it");
    if (!raw_bits(mode, raw)) fail("TIFF rawmode " + raw + " has no unpacker for mode " + mode);
    for (int64_t b : bps)
      if (b != bps[0]) fail("TIFF with different bits per sample is not supported");
    const int bits = int(bps[0]);
    const bool tiled = d.has(322);
    int64_t tw = w, th = h;
    // libtiff reads these three tags as 32-bit values; Pillow takes a tile
    // of at most INT_MAX - 1 bytes, each side at most INT_MAX.
    constexpr int64_t kIntMax = 2147483647;
    if (tiled) {
      if (!d.scalar(322, tw, "TileWidth") || !d.scalar(323, th, "TileLength") || tw <= 0 || th <= 0 ||
          tw > kIntMax || th > kIntMax)
        fail("TIFF with invalid tile dimensions");
      if ((tw * int64_t(spp) * bits + 7) / 8 > (kIntMax - 1) / th) fail("TIFF tile of more than 2^31 bytes");
    } else {
      th = d.get(278, int64_t(0xFFFFFFFF), "RowsPerStrip");
      if (th <= 0 || th > int64_t(0xFFFFFFFF)) fail("TIFF with invalid rows per strip");
      th = std::min(th, h);
    }
    const int64_t across = (w + tw - 1) / tw, down = (h + th - 1) / th;
    const int planes = planar == 2 ? int(spp) : 1;  // segments a pixel row spans
    const std::vector<int64_t> offsets = d.ints(tiled ? 324 : 273, {}, "StripOffsets");
    const std::vector<int64_t> counts = d.ints(tiled ? 325 : 279, {}, "StripByteCounts");
    const size_t nseg = size_t(across * down * planes);
    if (offsets.size() < nseg || counts.size() < nseg)
      fail("TIFF lists too few strips or tiles, or no byte counts");
    const int64_t predictor = comp == 5 || comp == 8 || comp == 32946 ? d.get(317, 1, "Predictor") : 1;
    if (predictor < 1 || predictor > 3) fail("TIFF predictor " + std::to_string(predictor) + " does not exist");
    if (predictor == 2 && bits != 8 && bits != 16 && bits != 32)
      fail("TIFF horizontal predictor with " + std::to_string(bits) + "-bit samples is not supported");
    if (predictor == 3 && (fmt[0] != 3 || bits != 32))
      fail("TIFF floating-point predictor needs 32-bit float samples");
    const bool ycbcr = photo == 6;
    if (ycbcr && (bits != 8 || spp != 3)) fail("TIFF YCbCr of this layout is not supported");
    // The compressed bytes of one segment, decoded into `need` bytes in the
    // host's (little-endian) byte order, as libtiff hands them on.
    Jpeg tables(Bytes{nullptr, 0}, true);
    if (comp == 7 && d.has(347)) {
      const Field& f = d.tags.at(347);
      Jpeg t(Bytes{in.p + f.off, size_t(f.count) * size_t(kTypeSize[f.type])}, true);
      t.read_stream(true);
      tables.take_tables(t);
    }
    int64_t h0 = 1, v0 = 1;
    if (ycbcr && comp == 7) {
      const std::vector<int64_t> sub = d.ints(530, {-1, -1}, "YCbCrSubsampling");
      if (sub.size() < 2) fail("TIFF YCbCrSubsampling needs two values");
      h0 = sub[0], v0 = sub[1];
    }
    auto segment = [&](size_t index, size_t need, int64_t cols, int64_t rows, int64_t row_bytes, int seg_spp,
                       bool last_strip) {
      const int64_t off = offsets[index], cnt = counts[index];
      if (off < 0 || cnt < 0 || size_t(off) > in.n || size_t(cnt) > in.n - size_t(off))
        fail("truncated TIFF: a strip or tile lies outside the file");
      Bytes src{in.p + off, size_t(cnt)};
      std::vector<uint8_t> flipped;
      if (fill == 2) {
        flipped.assign(src.p, src.p + src.n);
        for (uint8_t& b : flipped) b = rev8(b);
        src.p = flipped.data();
      }
      std::vector<uint8_t> out;
      if (comp == 7) {
        if (bits != 8) fail("TIFF JPEG with " + std::to_string(bits) + "-bit samples is not supported");
        int64_t one = 1;
        return jpeg_segment(src, tables, ycbcr && seg_spp == 3 ? Jpeg::Colour::YCbCr : Jpeg::Colour::None, cols,
                            rows, last_strip, seg_spp, seg_spp == 3 ? h0 : one, seg_spp == 3 ? v0 : one);
      }
      if (comp == 32773) {
        out = unpackbits(src, need);
      } else if (comp == 5) {
        out = unlzw(src, need);
      } else {
        out.resize(need);
        const int64_t got = inflate(src.p, int64_t(src.n), out.data(), int64_t(need));
        if (got < 0) fail("TIFF Deflate data does not inflate");
        if (size_t(got) < need) fail("not enough Deflate data in a TIFF strip or tile");
      }
      const int stride = planar == 2 ? 1 : int(spp);
      if (predictor != 1 && (out.size() % size_t(row_bytes) || (predictor == 3 && row_bytes % (4 * stride))))
        fail("TIFF predictor rows do not divide the strip or tile");
      for (size_t row = 0; row + size_t(row_bytes) <= out.size(); row += size_t(row_bytes)) {
        uint8_t* p = out.data() + row;
        if (predictor == 3) {  // tif_predict.c fpAcc
          for (int64_t i = stride; i < row_bytes; ++i) p[i] = uint8_t(p[i] + p[i - stride]);
          const std::vector<uint8_t> tmp(p, p + row_bytes);
          const int64_t wc = row_bytes / 4;
          for (int64_t i = 0; i < wc; ++i)
            for (int b = 0; b < 4; ++b) p[4 * i + b] = tmp[size_t((3 - b) * wc + i)];
          continue;
        }
        if (d.mm && (bits == 16 || bits == 32))  // libtiff swabs to host order
          for (int64_t i = 0; i + bits / 8 <= row_bytes; i += bits / 8) std::reverse(p + i, p + i + bits / 8);
        if (predictor == 2) {  // horAcc8/16/32
          const int k = bits / 8;
          for (int64_t i = stride; i < row_bytes / k; ++i) {
            uint64_t a = 0, b = 0;
            for (int j = 0; j < k; ++j) a |= uint64_t(p[i * k + j]) << (8 * j), b |= uint64_t(p[(i - stride) * k + j]) << (8 * j);
            a += b;
            for (int j = 0; j < k; ++j) p[i * k + j] = uint8_t(a >> (8 * j));
          }
        }
      }
      return out;
    };

    if (ycbcr && comp != 7) {
      // Pillow's _decodeAsRGBA: libtiff's TIFFRGBAImage, a block of hs x vs
      // luma samples, then Cb and Cr, for each block of pixels.
      const std::vector<int64_t> sub = d.ints(530, {2, 2}, "YCbCrSubsampling");
      if (sub.size() < 2) fail("TIFF YCbCrSubsampling needs two values");
      const int64_t hs = sub[0], vs = sub[1];
      const int64_t code = hs << 4 | vs;
      if (code != 0x44 && code != 0x42 && code != 0x41 && code != 0x22 && code != 0x21 && code != 0x12 && code != 0x11)
        fail("TIFF YCbCr subsampling " + std::to_string(hs) + "x" + std::to_string(vs) + " is not supported");
      float luma[3] = {0.299f, 0.587f, 0.114f}, rbw[6] = {0, 255, 128, 255, 128, 255};
      if (d.has(529)) for (int i = 0; i < 3; ++i) luma[i] = d.real(529, uint64_t(i));
      if (d.has(532)) for (int i = 0; i < 6; ++i) rbw[i] = d.real(532, uint64_t(i));
      if (std::isnan(luma[0]) || std::isnan(luma[1]) || std::isnan(luma[2]) || std::fabs(luma[1]) < 1e-10)
        fail("TIFF YCbCrCoefficients are invalid");
      for (float f : rbw)
        if (!(f > -2147483647.0f + 128 && f < 2147483647.0f - 128)) fail("TIFF ReferenceBlackWhite is invalid");
      const YCbCr conv(luma, rbw);
      const int64_t unit = hs * vs + 2;
      if (planar == 2) {  // putseparate8bitYCbCr11tile, libtiff's only planar case
        if (code != 0x11) fail("planar TIFF YCbCr subsampled " + std::to_string(hs) + "x" + std::to_string(vs) +
                               " is not supported");
        for (int64_t ty = 0; ty < down; ++ty)
          for (int64_t tx = 0; tx < across; ++tx) {
            const int64_t cols = tiled ? tw : w, rows = tiled ? th : std::min(th, h - ty * th);
            std::vector<uint8_t> pl[3];
            for (int p = 0; p < 3; ++p)
              pl[p] = segment(size_t(p * across * down + ty * across + tx), size_t(rows * cols), cols, rows, cols, 1,
                              !tiled && ty == down - 1);
            for (int64_t yy = 0; yy < std::min(rows, h - ty * th); ++yy)
              for (int64_t xx = 0; xx < std::min(cols, w - tx * tw); ++xx) {
                const size_t i = size_t(yy * cols + xx);
                conv.rgb(pl[0][i], pl[1][i], pl[2][i], r.at(ty * th + yy, tx * tw + xx));
              }
          }
      }
      for (int64_t ty = 0; ty < (planar == 2 ? 0 : down); ++ty)
        for (int64_t tx = 0; tx < across; ++tx) {
          const int64_t cols = tiled ? tw : w, rows = tiled ? th : std::min(th, h - ty * th);
          const int64_t bw = (cols + hs - 1) / hs;
          const int64_t scanline = bw * unit / vs;
          const int64_t blocks = (rows + vs - 1) / vs * bw * unit;  // what the put functions read
          // gtStripContig decodes whole block rows of (rounded-down)
          // scanlines into a zeroed buffer; gtTileContig whole tiles.
          const int64_t need = tiled ? blocks : std::min(blocks, (rows + vs - 1) / vs * vs * scanline);
          std::vector<uint8_t> seg = segment(size_t(ty * across + tx), size_t(need), cols, rows, scanline, 3, false);
          seg.resize(size_t(blocks), 0);
          // The putcontig8bitYCbCr*tile walk: blocks across the pixels kept,
          // then `fromskew` past the tile's right edge, which the 4x4
          // function counts in 10-byte units instead of 18.
          const int64_t npix = std::min(cols, w - tx * tw), nrow = std::min(rows, h - ty * th);
          const int64_t skip = (cols - npix) / hs * (code == 0x44 ? 10 : unit);
          size_t pp = 0;
          for (int64_t by = 0; by < nrow; by += vs) {
            for (int64_t bx = 0; bx < npix; bx += hs, pp += size_t(unit)) {
              if (pp + size_t(unit) > seg.size()) fail("TIFF YCbCr blocks run past their strip or tile");
              const uint8_t* blk = seg.data() + pp;
              for (int64_t yy = by; yy < std::min(by + vs, nrow); ++yy)
                for (int64_t xx = bx; xx < std::min(bx + hs, npix); ++xx)
                  conv.rgb(blk[(yy - by) * hs + xx - bx], blk[hs * vs], blk[hs * vs + 1],
                           r.at(ty * th + yy, tx * tw + xx));
            }
            pp += size_t(skip);
          }
        }
    } else {
      // Pillow's _decodeStrip / _decodeTile: each row unpacked by the
      // rawmode (planar: each plane into its band).
      const int seg_spp = comp == 7 && ycbcr ? 3 : planar == 2 ? 1 : int(spp);
      const int out_bits = comp == 7 ? 8 : bits;
      if (planar == 2 && r.bands != spp) fail("planar TIFF of " + std::to_string(spp) + " samples in mode " + mode);
      for (int p = 0; p < planes; ++p)
        for (int64_t ty = 0; ty < down; ++ty)
          for (int64_t tx = 0; tx < across; ++tx) {
            const int64_t rows = tiled ? th : std::min(th, h - ty * th);
            const int64_t row_bytes = (tw * seg_spp * out_bits + 7) / 8;
            const size_t index = size_t(p) * size_t(across * down) + size_t(ty * across + tx);
            const std::vector<uint8_t> seg = segment(index, size_t(rows * row_bytes), tw, rows, row_bytes, seg_spp,
                                                     !tiled && ty == down - 1);
            for (int64_t yy = 0; yy < rows && ty * th + yy < h; ++yy) {
              const int64_t cols = std::min(tw, w - tx * tw);
              const uint8_t* src = seg.data() + size_t(yy * row_bytes);
              uint32_t* dst = r.at(ty * th + yy, tx * tw);
              if (planar == 1 || spp == 1) {
                unpack(mode, raw, src, cols, dst, r.bands);
                continue;
              }
              // A plane into its band; LA and PA lose their alpha plane.
              if ((mode == "LA" || mode == "PA") && p == 1) continue;
              for (int64_t i = 0; i < cols; ++i) {
                const uint8_t* s = src + size_t(i) * size_t(bits / 8);
                dst[size_t(i) * size_t(r.bands) + size_t(p)] = bits == 16 ? s[1] : s[0];
              }
            }
          }
      // Pillow's planar RGBA treats alpha as associated unless libtiff reads
      // ExtraSamples as unassociated (2, or Corel's 999, which libtiff
      // patches to 2).
      if (planar == 2 && mode == "RGBA" && !(extra.size() == 1 && (extra[0] == 2 || extra[0] == 999)))
        for (size_t i = 0; i < r.v.size(); i += 4) unpremultiply(r.v.data() + i);
    }
  }

  // Mode F's samples as a sky's reader, imageio's bundled tifffile, gives
  // them: as stored (no Orientation), in the file's true byte order where
  // Pillow's rawmode reads a big-endian file's samples byte-swapped (the
  // libtiff path's host-order samples read as "F;32BF", or a planar raw
  // file read by the band rawmode "F").
  std::vector<float> samples;
  if (mode == "F") {
    const bool swapped = d.mm && (libtiff ? raw == "F;32BF" : planar == 2);
    samples.resize(r.v.size());
    for (size_t i = 0; i < r.v.size(); ++i) {
      uint32_t b = r.v[i];
      if (swapped) b = b >> 24 | (b >> 8 & 0xFF00) | (b << 8 & 0xFF0000) | b << 24;
      std::memcpy(&samples[i], &b, 4);
    }
  }
  const int64_t stored_w = r.w, stored_h = r.h;
  r = transpose(r, orientation);
  // Pillow's convert("RGBA") / ("L") input, in this library's channels.
  Palette pal;
  if (mode == "P" || mode == "PA") {
    const std::vector<int64_t> cm = d.ints(320, {}, "ColorMap");
    if (cm.empty()) fail("palette TIFF without a ColorMap");
    const size_t n = std::min<size_t>(cm.size() / 3, 256);
    for (size_t i = 0; i < n; ++i)
      for (int k = 0; k < 3; ++k) pal.e[i][k] = uint8_t((cm[size_t(k) * (cm.size() / 3) + i] & 0xFFFF) / 256);
  }
  enum { kBytes, kPalette, kPaletteAlpha, kCmyk, kHigh16, kInt, kFloat } kind =
      mode == "P" ? kPalette : mode == "PA" ? kPaletteAlpha : mode == "CMYK" ? kCmyk
      : mode == "I;16" || mode == "I;16B" || (mode == "I" && bps[0] == 16) ? kHigh16
      : mode == "I" ? kInt : mode == "F" ? kFloat : kBytes;
  const bool signed16 = mode == "I";
  Image img;
  img.alloc(r.w, r.h, kind == kPalette || kind == kPaletteAlpha || kind == kCmyk ? 4 : r.bands, mode.c_str());
  if (kind == kFloat) img.fl = std::move(samples), img.fw = stored_w, img.fh = stored_h;
  const size_t npx = size_t(r.w) * size_t(r.h);
  const uint32_t* s = r.v.data();
  uint8_t* o = img.px.data();
  for (size_t i = 0; i < npx; ++i, s += r.bands, o += img.c) {
    switch (kind) {
      case kPalette: std::memcpy(o, pal.e[s[0] & 255], 4); break;
      case kPaletteAlpha: std::memcpy(o, pal.e[s[0] & 255], 4), o[3] = uint8_t(s[1]); break;
      case kCmyk: cmyk_to_rgba(int(s[0]), int(s[1]), int(s[2]), int(s[3]), o); break;
      case kHigh16: {  // stb_image's 16-to-8-bit rule (a negative signed sample: 0)
        const int32_t v = signed16 ? int32_t(s[0]) : int32_t(s[0] & 0xFFFF);
        o[0] = uint8_t(v < 0 ? 0 : v >> 8);
        break;
      }
      case kInt: {  // convert("L")'s clip
        const int32_t v = int32_t(s[0]);
        o[0] = uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
        break;
      }
      case kFloat: {  // convert("L")'s truncation and clip
        float f;
        std::memcpy(&f, s, 4);
        o[0] = !(f > 0.0f) ? 0 : f >= 255.0f ? 255 : uint8_t(int(f));
        break;
      }
      default:
        for (int k = 0; k < r.bands; ++k) o[k] = uint8_t(s[k]);
    }
  }
  return img;
}

}  // namespace tiff

// WebP, as Pillow reads it (webp_decode.cpp): the canvas as RGBA, or RGB
// where Pillow's mode is "RGB" (its rawmode RGBX).
Image webp_image(Bytes in) {
  int64_t w = 0, h = 0;
  bool alpha = false;
  std::vector<uint8_t> rgba;
  webp::decode(in.p, in.n, kMaxPixels, w, h, alpha, rgba);
  Image img;
  img.alloc(w, h, alpha ? 4 : 3, alpha ? "RGBA" : "RGB");
  if (alpha) {
    img.px = std::move(rgba);
  } else {
    for (size_t i = 0, n = size_t(w * h); i < n; ++i) std::memcpy(&img.px[3 * i], &rgba[4 * i], 3);
  }
  return img;
}

void* finish(Image&& img) { return new Image(std::move(img)); }

void write_error(char* err, int64_t errlen, const char* msg) {
  if (err && errlen > 0) {
    std::strncpy(err, msg, size_t(errlen) - 1);
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" {

// format: 1 JPEG, 2 BMP, 3 TGA, 4 GIF, 5 PNM, 6 PSD, 7 WebP.  Returns a handle, or
// NULL with the reason in err.
void* imgd_decode(const uint8_t* data, int64_t n, int32_t format, char* err, int64_t errlen) {
  try {
    Bytes in{data, size_t(n < 0 ? 0 : n)};
    switch (format) {
      case 1: return finish(Jpeg(in).decode());
      case 2: return finish(bmp(in));
      case 3: return finish(tga(in));
      case 4: return finish(gif(in));
      case 5: return finish(pnm_decode(in));
      case 6: return finish(psd(in));
      case 7: return finish(webp_image(in));
      default: fail("unknown image format code " + std::to_string(format));
    }
  } catch (const std::exception& e) {
    write_error(err, errlen, e.what());
  }
  return nullptr;
}

// A TIFF, its Deflate strips and tiles inflated by `inflate`.
void* imgd_tiff(const uint8_t* data, int64_t n, InflateFn inflate, char* err, int64_t errlen) {
  try {
    return finish(tiff::decode(Bytes{data, size_t(n < 0 ? 0 : n)}, inflate));
  } catch (const std::exception& e) {
    write_error(err, errlen, e.what());
  }
  return nullptr;
}

// The pixels of a PNG from its inflated image data and its header fields;
// plte / trns may be empty (length 0).
void* imgd_png(const uint8_t* raw, int64_t nraw, int64_t w, int64_t h, int32_t depth, int32_t ctype,
               int32_t interlace, const uint8_t* plte, int64_t nplte, const uint8_t* trns,
               int64_t ntrns, char* err, int64_t errlen) {
  try {
    return finish(png_reconstruct(Bytes{raw, size_t(nraw)}, w, h, depth, ctype, interlace,
                                  Bytes{plte, size_t(nplte)}, Bytes{trns, size_t(ntrns)}));
  } catch (const std::exception& e) {
    write_error(err, errlen, e.what());
  }
  return nullptr;
}

int64_t imgd_width(void* r) { return static_cast<Image*>(r)->w; }
int64_t imgd_height(void* r) { return static_cast<Image*>(r)->h; }
int64_t imgd_channels(void* r) { return static_cast<Image*>(r)->c; }
const char* imgd_mode(void* r) { return static_cast<Image*>(r)->mode.c_str(); }
const uint8_t* imgd_pixels(void* r) { return static_cast<Image*>(r)->px.data(); }
// A TIFF of mode F or a PFM: its float32 samples (h x w, written to *h
// and *w; top row first, no Orientation applied); NULL for any other
// image.
const float* imgd_floats(void* r, int64_t* h, int64_t* w) {
  const Image* img = static_cast<Image*>(r);
  *h = img->fh, *w = img->fw;
  return img->fl.empty() ? nullptr : img->fl.data();
}
void imgd_free(void* r) { delete static_cast<Image*>(r); }

}  // extern "C"
