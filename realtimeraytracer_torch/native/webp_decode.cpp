// WebP decoder of the port: lossy VP8 key frames (RFC 6386) with their
// ALPH chunk, lossless VP8L (RFC 9649), the RIFF container (simple, VP8X,
// and an animation's first frame), as Pillow 12 reads a WebP file.
//
// Pillow opens every WebP through libwebp's animation decoder
// (PIL/WebPImagePlugin.py, _webp.c: WebPAnimDecoderNew with default
// options, WebPAnimDecoderGetNext for the first frame):
//   - the mode is "RGBA" unless WebPGetFeatures over the whole file
//     succeeds and reports no alpha, then "RGB" (read as RGBX): the VP8X
//     alpha flag for an animation, else VP8L's alpha-is-used bit or an
//     ALPH chunk; the header decides, not the pixels;
//   - the canvas (the VP8X size, else the image's) starts as zeros and the
//     first frame is decoded into it at its offset, with no blending;
//     ICCP, EXIF, XMP and unknown chunks are skipped, no Orientation;
//   - a file WebPDemux refuses (cut short, chunk sizes past the RIFF
//     size, a frame outside the canvas, a VP8X without an image) or a
//     frame WebPDecode refuses raises, as Pillow does.
// Pixels are libwebp's: the VP8 loop filters and reconstruction as
// libwebp decodes them (its end-of-data rule and its filter-strength and
// skip rules where RFC 6386 leaves room), its 14-bit YUV->RGB and its
// "fancy" upsampler (no dithering: WebPDecoderConfig's default), ALPH's
// unfiltering with libwebp's first-row and first-column rules, and
// VP8L's predictors 14 and 15 as black.
//
// The tables below are RFC 6386's (default and update coefficient
// probabilities, the key-frame sub-block mode probabilities in libwebp's
// mode order DC, TM, VE, HE, RD, VR, LD, VL, HD, HU, the DC and AC
// quantizer steps) and RFC 9649's distance map.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace webp {

void decode(const uint8_t* data, size_t n, int64_t max_pixels, int64_t& width, int64_t& height,
            bool& alpha, std::vector<uint8_t>& rgba);

namespace {

[[noreturn]] void fail(const std::string& msg) { throw std::runtime_error("WebP: " + msg); }

uint32_t le16(const uint8_t* p) { return uint32_t(p[0]) | uint32_t(p[1]) << 8; }
uint32_t le24(const uint8_t* p) { return le16(p) | uint32_t(p[2]) << 16; }
uint32_t le32(const uint8_t* p) { return le24(p) | uint32_t(p[3]) << 24; }

constexpr uint32_t kMaxChunkPayload = ~0u - 8 - 1;
constexpr uint64_t kMaxImageArea = uint64_t(1) << 32;
constexpr uint32_t kAlphaFlag = 0x10, kAnimationFlag = 0x02, kAllValidFlags = 0x3E;

constexpr uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128};
constexpr uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255};
constexpr uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24};
constexpr uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};
constexpr uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};
constexpr uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112};

// ---------------------------------------------------------------- VP8 ----

constexpr uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
constexpr uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kCat3[] = {173, 148, 140, 0}, kCat4[] = {176, 155, 140, 135, 0},
                  kCat5[] = {180, 157, 141, 134, 130, 0},
                  kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
constexpr const uint8_t* kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

// Sub-block and 16x16 / chroma modes, libwebp's numbering.
enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
enum { DC_PRED = B_DC, TM_PRED = B_TM, V_PRED = B_VE, H_PRED = B_HE,
       DC_NOTOP = 10, DC_NOLEFT, DC_NOTOPLEFT };

// RFC 6386's boolean decoder, as libwebp reads it: a read that needs bits
// past the partition's end appends one zero byte and marks the reader; the
// decoder then fails at its next check (after a macroblock's tokens, a row
// of modes, the frame header), whatever the bits gave.
struct BoolReader {
  const uint8_t* p = nullptr;
  size_t n = 0, pos = 0;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;  // the range minus 1
  bool eof = false;

  void init(const uint8_t* d, size_t len) {
    p = d, n = len, pos = 0, value = 0, bits = -8, range = 254, eof = false;
    load();
  }
  void load() {
    if (pos < n) {
      value = value << 8 | p[pos++];
      bits += 8;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int at = bits;
    const uint32_t split = (r * uint32_t(prob)) >> 8;
    const int b = uint32_t(value >> at) > split;
    if (b) {
      r -= split;
      value -= uint64_t(split + 1) << at;
    } else {
      r = split + 1;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    bits -= shift;
    range = (r << shift) - 1;
    return b;
  }
  int literal(int nbits) {
    int v = 0;
    while (nbits-- > 0) v |= bit(0x80) << nbits;
    return v;
  }
  int signed_literal(int nbits) {
    const int v = literal(nbits);
    return bit(0x80) ? -v : v;
  }
};

struct FilterInfo {
  uint8_t limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

inline uint8_t clip8(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }   // VP8ksclip1
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }       // VP8ksclip2

// dec.c's loop filters (the C versions; libwebp's SIMD ones agree).
void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}
void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}
void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}
bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}
bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}
bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}
// A simple filter along an edge of `size` pixels: hstride crosses the edge.
void simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) filter2(p, hstride);
}
void complex_edge(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hev_t,
                  bool mb_edge) {
  const int t2 = 2 * thresh + 1;
  for (; size-- > 0; p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_t)) filter2(p, hstride);
    else if (mb_edge) filter6(p, hstride);
    else filter4(p, hstride);
  }
}

// dec.c's inverse transforms.
inline int mul1(int a) { return (int32_t(uint32_t(a) * 20091u) >> 16) + a; }
inline int mul2(int a) { return int32_t(uint32_t(a) * 35468u) >> 16; }

void transform(const int16_t* in, uint8_t* dst, int bps) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[i] + in[8 + i], b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]), d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i + 0] = a + d, tmp[4 * i + 1] = b + c, tmp[4 * i + 2] = b - c, tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; ++i, dst += bps) {  // horizontal pass
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i], b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]), d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
  }
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[i] - in[12 + i];
    tmp[i] = a0 + a1, tmp[8 + i] = a0 - a1, tmp[4 + i] = a3 + a2, tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i, out += 64) {
    const int dc = tmp[4 * i] + 3;
    const int a0 = dc + tmp[4 * i + 3], a1 = tmp[4 * i + 1] + tmp[4 * i + 2];
    const int a2 = tmp[4 * i + 1] - tmp[4 * i + 2], a3 = dc - tmp[4 * i + 3];
    out[0] = int16_t((a0 + a1) >> 3), out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3), out[48] = int16_t((a3 - a2) >> 3);
  }
}

// dec.c's intra predictors, on a work buffer of stride kBps whose row -1
// and column -1 hold the neighbours (and, for 4x4 blocks, four pixels
// right of row -1).
constexpr int kBps = 32;
inline uint8_t avg3(int a, int b, int c) { return uint8_t((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return uint8_t((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - kBps;
  for (int y = 0; y < size; ++y, dst += kBps)
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - top[-1]);
}

void predict_block(uint8_t* dst, int size, int mode) {  // 16x16 luma or 8x8 chroma
  const int shift = size == 16 ? 4 : 3;
  int dc = 0;
  switch (mode) {
    case V_PRED:
      for (int y = 0; y < size; ++y) std::memcpy(dst + y * kBps, dst - kBps, size_t(size));
      return;
    case H_PRED:
      for (int y = 0; y < size; ++y) std::memset(dst + y * kBps, dst[y * kBps - 1], size_t(size));
      return;
    case TM_PRED:
      true_motion(dst, size);
      return;
    case DC_PRED:
      for (int i = 0; i < size; ++i) dc += dst[i - kBps] + dst[i * kBps - 1];
      dc = (dc + size) >> (shift + 1);
      break;
    case DC_NOTOP:
      for (int i = 0; i < size; ++i) dc += dst[i * kBps - 1];
      dc = (dc + (size >> 1)) >> shift;
      break;
    case DC_NOLEFT:
      for (int i = 0; i < size; ++i) dc += dst[i - kBps];
      dc = (dc + (size >> 1)) >> shift;
      break;
    default:  // DC_NOTOPLEFT
      dc = 0x80;
  }
  for (int y = 0; y < size; ++y) std::memset(dst + y * kBps, dc, size_t(size));
}

#define DST(x, y) dst[(x) + (y) * kBps]
void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - kBps;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5],
            G = top[6], H = top[7];
  const int I = dst[-1], J = dst[kBps - 1], K = dst[2 * kBps - 1], L = dst[3 * kBps - 1];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[i * kBps - 1];
      for (int y = 0; y < 4; ++y) std::memset(dst + y * kBps, dc >> 3, 4);
      break;
    }
    case B_TM:
      true_motion(dst, 4);
      break;
    case B_VE: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int y = 0; y < 4; ++y) std::memcpy(dst + y * kBps, v, 4);
      break;
    }
    case B_HE:
      std::memset(dst, avg3(X, I, J), 4);
      std::memset(dst + kBps, avg3(I, J, K), 4);
      std::memset(dst + 2 * kBps, avg3(J, K, L), 4);
      std::memset(dst + 3 * kBps, avg3(K, L, L), 4);
      break;
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HU:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = uint8_t(L);
      break;
    default:  // B_HD
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(X, I, J);
      DST(1, 2) = DST(3, 3) = avg3(I, J, K);
      DST(1, 3) = avg3(J, K, L);
  }
}
#undef DST

struct Planes {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  std::vector<uint8_t> y, u, v;  // macroblock-padded: 16 mb_w x 16 mb_h, chroma half that
};

// A VP8 key frame (`data`: the VP8 chunk's payload and its padding byte)
// decoded to its Y, U, V planes as libwebp's VP8Decode leaves them.
Planes decode_vp8(const uint8_t* buf, size_t size) {
  if (size < 4) fail("truncated VP8 header");
  const uint32_t bits = le24(buf);
  const bool key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const uint32_t part0 = bits >> 5;
  if (profile > 3) fail("incorrect VP8 key frame parameters");
  if (!((bits >> 4) & 1)) fail("VP8 frame not displayable");
  buf += 3, size -= 3;
  if (!key_frame) fail("VP8 frame is not a key frame");
  if (size < 7) fail("cannot parse VP8 picture header");
  if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a) fail("bad VP8 code word");
  Planes pl;
  pl.width = int(le16(buf + 3) & 0x3fff), pl.height = int(le16(buf + 5) & 0x3fff);
  buf += 7, size -= 7;
  pl.mb_w = (pl.width + 15) >> 4, pl.mb_h = (pl.height + 15) >> 4;
  if (part0 > size) fail("bad VP8 partition length");
  BoolReader br;
  br.init(buf, part0);
  br.literal(1), br.literal(1);  // colour space, clamping type (libwebp always clamps)

  // Segment header.
  bool use_segment = br.literal(1), update_map = false, absolute_delta = true;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  uint8_t seg_proba[3] = {255, 255, 255};
  if (use_segment) {
    update_map = br.literal(1);
    if (br.literal(1)) {
      absolute_delta = br.literal(1);
      for (int& q : quantizer) q = br.literal(1) ? br.signed_literal(7) : 0;
      for (int& f : filter_strength) f = br.literal(1) ? br.signed_literal(6) : 0;
    }
    if (update_map)
      for (uint8_t& p : seg_proba) p = uint8_t(br.literal(1) ? br.literal(8) : 255);
  }
  if (br.eof) fail("cannot parse VP8 segment header");
  // Filter header.
  const bool simple = br.literal(1);
  const int level = br.literal(6), sharpness = br.literal(3);
  const bool use_lf_delta = br.literal(1);
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  if (use_lf_delta && br.literal(1)) {
    for (int& d : ref_lf_delta)
      if (br.literal(1)) d = br.signed_literal(6);
    for (int& d : mode_lf_delta)
      if (br.literal(1)) d = br.signed_literal(6);
  }
  const int filter_type = level == 0 ? 0 : simple ? 1 : 2;
  if (br.eof) fail("cannot parse VP8 filter header");
  // Token partitions.
  const uint8_t* const pbuf = buf + part0;
  const size_t psize = size - part0;
  const int last_part = (1 << br.literal(2)) - 1;
  if (psize < size_t(3 * last_part)) fail("cannot parse VP8 partitions");
  std::vector<BoolReader> parts(size_t(last_part + 1));
  {
    const uint8_t* start = pbuf + 3 * last_part;
    size_t left = psize - size_t(3 * last_part);
    for (int p = 0; p < last_part; ++p) {
      size_t ps = le24(pbuf + 3 * p);
      if (ps > left) ps = left;
      parts[size_t(p)].init(start, ps);
      start += ps, left -= ps;
    }
    parts[size_t(last_part)].init(start, left);
    if (start >= pbuf + psize) fail("cannot parse VP8 partitions");
  }
  // Quantizers (VP8ParseQuant).
  const int base_q0 = br.literal(7);
  int dq[5];
  for (int& d : dq) d = br.literal(1) ? br.signed_literal(4) : 0;
  struct Quant { int y1[2], y2[2], uv[2]; } quant[4];
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  for (int s = 0; s < 4; ++s) {
    int q = base_q0;
    if (use_segment) q = quantizer[s] + (absolute_delta ? 0 : base_q0);
    else if (s > 0) { quant[s] = quant[0]; continue; }
    Quant& m = quant[s];
    m.y1[0] = kDcTable[clip(q + dq[0], 127)];
    m.y1[1] = kAcTable[clip(q, 127)];
    m.y2[0] = kDcTable[clip(q + dq[1], 127)] * 2;
    m.y2[1] = std::max((kAcTable[clip(q + dq[2], 127)] * 101581) >> 16, 8);
    m.uv[0] = kDcTable[clip(q + dq[3], 117)];
    m.uv[1] = kAcTable[clip(q + dq[4], 127)];
  }
  br.literal(1);  // refresh_entropy_probs, ignored
  // Coefficient probabilities.
  uint8_t proba[4][8][3][11];
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          proba[t][b][c][p] = uint8_t(br.bit(kCoeffsUpdateProba[t][b][c][p]) ? br.literal(8)
                                                                               : kCoeffsProba0[t][b][c][p]);
  const bool use_skip_proba = br.literal(1);
  const int skip_p = use_skip_proba ? br.literal(8) : 0;

  // Filter strengths (PrecomputeFilterStrengths).
  FilterInfo fstrengths[4][2];
  for (int s = 0; s < 4; ++s) {
    int base_level = level;
    if (use_segment) base_level = filter_strength[s] + (absolute_delta ? 0 : level);
    for (int i4 = 0; i4 <= 1; ++i4) {
      FilterInfo& f = fstrengths[s][i4];
      int lv = base_level;
      if (use_lf_delta) lv += ref_lf_delta[0] + (i4 ? mode_lf_delta[0] : 0);
      lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
      if (lv > 0) {
        int il = lv;
        if (sharpness > 0) {
          il >>= sharpness > 4 ? 2 : 1;
          if (il > 9 - sharpness) il = 9 - sharpness;
        }
        if (il < 1) il = 1;
        f.ilevel = uint8_t(il), f.limit = uint8_t(2 * lv + il);
        f.hev_thresh = uint8_t(lv >= 40 ? 2 : lv >= 15 ? 1 : 0);
      }
      f.inner = uint8_t(i4);
    }
  }

  const int mb_w = pl.mb_w, mb_h = pl.mb_h;
  const size_t ys = size_t(mb_w) * 16, uvs = size_t(mb_w) * 8;
  pl.y.assign(ys * size_t(mb_h) * 16, 0);
  pl.u.assign(uvs * size_t(mb_h) * 8, 0);
  pl.v.assign(uvs * size_t(mb_h) * 8, 0);
  std::vector<FilterInfo> finfo(size_t(mb_w) * size_t(mb_h));
  std::vector<uint8_t> intra_t(size_t(4) * mb_w, B_DC), top_nz(size_t(mb_w), 0), top_nz_dc(size_t(mb_w), 0);
  struct MB { int segment = 0, skip = 0, is_i4x4 = 0, uvmode = 0; uint8_t imodes[16] = {}; };
  std::vector<MB> row(static_cast<size_t>(mb_w));
  int16_t coeffs[384];
  uint8_t ybuf[kBps * 17], ubuf[kBps * 9], vbuf[kBps * 9];
  uint8_t* const yw = ybuf + kBps + 1;  // the 16x16 block; row -1 and column -1 around it
  uint8_t* const uw = ubuf + kBps + 1;
  uint8_t* const vw = vbuf + kBps + 1;

  // GetCoeffs: one block's tokens from position n; returns the position
  // after its last non-zero coefficient (16 if it ran to the end).
  auto get_coeffs = [&](BoolReader& tr, int t, int ctx, const int* q, int n, int16_t* out) {
    const uint8_t* p = proba[t][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!tr.bit(p[0])) return n;
      while (!tr.bit(p[1])) {
        p = proba[t][kBands[++n]][0];
        if (n == 16) return 16;
      }
      const uint8_t(*next)[11] = proba[t][kBands[n + 1]];
      int v;
      if (!tr.bit(p[2])) {
        v = 1, p = next[1];
      } else {
        if (!tr.bit(p[3])) {
          v = !tr.bit(p[4]) ? 2 : 3 + tr.bit(p[5]);
        } else if (!tr.bit(p[6])) {
          if (!tr.bit(p[7])) v = 5 + tr.bit(159);
          else v = 7 + 2 * tr.bit(165) + tr.bit(145);
        } else {
          const int b1 = tr.bit(p[8]), b0 = tr.bit(p[9 + b1]), cat = 2 * b1 + b0;
          v = 0;
          for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + tr.bit(*tab);
          v += 3 + (8 << cat);
        }
        p = next[2];
      }
      out[kZigzag[n]] = int16_t((tr.bit(0x80) ? -v : v) * q[n > 0]);
    }
    return 16;
  };
  auto nz_code = [](uint32_t codes, int nz, bool dc_nz) {
    return (codes << 2) | uint32_t(nz > 3 ? 3 : nz > 1 ? 2 : dc_nz);
  };

  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    // This row's modes (partition 0).
    uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MB& mb = row[size_t(mb_x)];
      uint8_t* top = intra_t.data() + 4 * mb_x;
      mb.segment = update_map ? (!br.bit(seg_proba[0]) ? br.bit(seg_proba[1]) : br.bit(seg_proba[2]) + 2) : 0;
      if (use_skip_proba) mb.skip = br.bit(skip_p);
      mb.is_i4x4 = !br.bit(145);
      if (!mb.is_i4x4) {
        const int ymode = br.bit(156) ? (br.bit(128) ? TM_PRED : H_PRED) : (br.bit(163) ? V_PRED : DC_PRED);
        mb.imodes[0] = uint8_t(ymode);
        std::memset(top, ymode, 4);
        std::memset(intra_l, ymode, 4);
      } else {
        for (int y = 0; y < 4; ++y) {
          int ymode = intra_l[y];
          for (int x = 0; x < 4; ++x) {
            const uint8_t* pr = kBModesProba[top[x]][ymode];
            ymode = !br.bit(pr[0]) ? B_DC
                  : !br.bit(pr[1]) ? B_TM
                  : !br.bit(pr[2]) ? B_VE
                  : !br.bit(pr[3]) ? (!br.bit(pr[4]) ? B_HE : !br.bit(pr[5]) ? B_RD : B_VR)
                  : !br.bit(pr[6]) ? B_LD
                  : !br.bit(pr[7]) ? B_VL
                  : !br.bit(pr[8]) ? B_HD : B_HU;
            top[x] = uint8_t(ymode);
          }
          std::memcpy(mb.imodes + 4 * y, top, 4);
          intra_l[y] = uint8_t(ymode);
        }
      }
      mb.uvmode = !br.bit(142) ? DC_PRED : !br.bit(114) ? V_PRED : br.bit(183) ? TM_PRED : H_PRED;
    }
    if (br.eof) fail("premature end of VP8 partition 0");

    // Tokens, reconstruction (VP8DecodeMB, ReconstructRow).
    BoolReader& tr = parts[size_t(mb_y & last_part)];
    uint8_t left_nz = 0, left_nz_dc = 0;
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MB& mb = row[size_t(mb_x)];
      const Quant& q = quant[mb.segment];
      bool skip = use_skip_proba && mb.skip;
      std::memset(coeffs, 0, sizeof coeffs);
      if (!skip) {
        int16_t* dst = coeffs;
        const int* yq = q.y1;
        int first, t;
        if (!mb.is_i4x4) {
          int16_t dc[16] = {};
          const int nz = get_coeffs(tr, 1, top_nz_dc[size_t(mb_x)] + left_nz_dc, q.y2, 0, dc);
          top_nz_dc[size_t(mb_x)] = left_nz_dc = nz > 0;
          if (nz > 1) {
            transform_wht(dc, dst);
          } else {
            const int dc0 = (dc[0] + 3) >> 3;
            for (int i = 0; i < 256; i += 16) dst[i] = int16_t(dc0);
          }
          first = 1, t = 0;
        } else {
          first = 0, t = 3;
        }
        uint8_t tnz = top_nz[size_t(mb_x)] & 0x0f, lnz = left_nz & 0x0f;
        uint32_t non_zero_y = 0, non_zero_uv = 0;
        for (int y = 0; y < 4; ++y) {
          int l = lnz & 1;
          uint32_t codes = 0;
          for (int x = 0; x < 4; ++x) {
            const int nz = get_coeffs(tr, t, l + (tnz & 1), yq, first, dst);
            l = nz > first;
            tnz = uint8_t((tnz >> 1) | (l << 7));
            codes = nz_code(codes, nz, dst[0] != 0);
            dst += 16;
          }
          tnz >>= 4;
          lnz = uint8_t((lnz >> 1) | (l << 7));
          non_zero_y = (non_zero_y << 8) | codes;
        }
        uint32_t out_t = tnz, out_l = lnz >> 4;
        for (int ch = 0; ch < 4; ch += 2) {
          uint32_t codes = 0;
          tnz = uint8_t(top_nz[size_t(mb_x)] >> (4 + ch));
          lnz = uint8_t(left_nz >> (4 + ch));
          for (int y = 0; y < 2; ++y) {
            int l = lnz & 1;
            for (int x = 0; x < 2; ++x) {
              const int nz = get_coeffs(tr, 2, l + (tnz & 1), q.uv, 0, dst);
              l = nz > 0;
              tnz = uint8_t((tnz >> 1) | (l << 3));
              codes = nz_code(codes, nz, dst[0] != 0);
              dst += 16;
            }
            tnz >>= 2;
            lnz = uint8_t((lnz >> 1) | (l << 5));
          }
          non_zero_uv |= codes << (4 * ch);
          out_t |= uint32_t(tnz << 4) << ch;
          out_l |= uint32_t(lnz & 0xf0) << ch;
        }
        top_nz[size_t(mb_x)] = uint8_t(out_t), left_nz = uint8_t(out_l);
        skip = !(non_zero_y | non_zero_uv);
      } else {
        top_nz[size_t(mb_x)] = left_nz = 0;
        if (!mb.is_i4x4) top_nz_dc[size_t(mb_x)] = left_nz_dc = 0;
      }
      if (filter_type > 0) {
        FilterInfo f = fstrengths[mb.segment][mb.is_i4x4];
        f.inner |= uint8_t(!skip);
        finfo[size_t(mb_y) * mb_w + size_t(mb_x)] = f;
      }
      if (tr.eof) fail("premature end of a VP8 token partition");

      // The neighbours: 127 above the frame, 129 left of it (and above-left
      // below the first row), the unfiltered pixels otherwise.
      const size_t y0 = size_t(mb_y) * 16, x0 = size_t(mb_x) * 16;
      for (int j = -1; j < 16; ++j) {
        uint8_t& l = yw[j * kBps - 1];
        if (j < 0) l = mb_y == 0 ? 127 : mb_x == 0 ? 129 : pl.y[(y0 - 1) * ys + x0 - 1];
        else l = mb_x == 0 ? 129 : pl.y[(y0 + size_t(j)) * ys + x0 - 1];
      }
      for (int x = 0; x < 20; ++x) {
        uint8_t& t0 = yw[x - kBps];
        if (mb_y == 0) t0 = 127;
        else if (x < 16 || mb_x < mb_w - 1) t0 = pl.y[(y0 - 1) * ys + x0 + size_t(x)];
        else t0 = pl.y[(y0 - 1) * ys + x0 + 15];
      }
      const size_t cy0 = size_t(mb_y) * 8, cx0 = size_t(mb_x) * 8;
      for (int c = 0; c < 2; ++c) {
        uint8_t* w = c ? vw : uw;
        const std::vector<uint8_t>& src = c ? pl.v : pl.u;
        for (int j = -1; j < 8; ++j) {
          uint8_t& l = w[j * kBps - 1];
          if (j < 0) l = mb_y == 0 ? 127 : mb_x == 0 ? 129 : src[(cy0 - 1) * uvs + cx0 - 1];
          else l = mb_x == 0 ? 129 : src[(cy0 + size_t(j)) * uvs + cx0 - 1];
        }
        for (int x = 0; x < 8; ++x) w[x - kBps] = mb_y == 0 ? 127 : src[(cy0 - 1) * uvs + cx0 + size_t(x)];
      }
      auto check_mode = [&](int mode) {
        if (mode != DC_PRED) return mode;
        if (mb_x == 0) return mb_y == 0 ? int(DC_NOTOPLEFT) : int(DC_NOLEFT);
        return mb_y == 0 ? int(DC_NOTOP) : int(DC_PRED);
      };
      if (mb.is_i4x4) {
        for (int k = 1; k <= 3; ++k) std::memcpy(yw + (4 * k - 1) * kBps + 16, yw - kBps + 16, 4);
        for (int n = 0; n < 16; ++n) {
          uint8_t* dst = yw + (n & 3) * 4 + (n >> 2) * 4 * kBps;
          predict4(dst, mb.imodes[n]);
          transform(coeffs + 16 * n, dst, kBps);
        }
      } else {
        predict_block(yw, 16, check_mode(mb.imodes[0]));
        for (int n = 0; n < 16; ++n) transform(coeffs + 16 * n, yw + (n & 3) * 4 + (n >> 2) * 4 * kBps, kBps);
      }
      const int uvmode = check_mode(mb.uvmode);
      predict_block(uw, 8, uvmode);
      predict_block(vw, 8, uvmode);
      for (int n = 0; n < 4; ++n) {
        const int off = (n & 1) * 4 + (n >> 1) * 4 * kBps;
        transform(coeffs + 256 + 16 * n, uw + off, kBps);
        transform(coeffs + 320 + 16 * n, vw + off, kBps);
      }
      for (int j = 0; j < 16; ++j) std::memcpy(&pl.y[(y0 + size_t(j)) * ys + x0], yw + j * kBps, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(&pl.u[(cy0 + size_t(j)) * uvs + cx0], uw + j * kBps, 8);
        std::memcpy(&pl.v[(cy0 + size_t(j)) * uvs + cx0], vw + j * kBps, 8);
      }
    }
  }

  // The loop filter, macroblock by macroblock in raster order (DoFilter).
  if (filter_type > 0) {
    for (int mb_y = 0; mb_y < mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const FilterInfo& f = finfo[size_t(mb_y) * mb_w + size_t(mb_x)];
        const int limit = f.limit;
        if (limit == 0) continue;
        const int ys_ = int(ys), uvs_ = int(uvs);
        uint8_t* yd = &pl.y[size_t(mb_y) * 16 * ys + size_t(mb_x) * 16];
        if (filter_type == 1) {
          if (mb_x > 0) simple_edge(yd, 1, ys_, limit + 4);
          if (f.inner)
            for (int k = 4; k < 16; k += 4) simple_edge(yd + k, 1, ys_, limit);
          if (mb_y > 0) simple_edge(yd, ys_, 1, limit + 4);
          if (f.inner)
            for (int k = 4; k < 16; k += 4) simple_edge(yd + k * ys_, ys_, 1, limit);
          continue;
        }
        uint8_t* ud = &pl.u[size_t(mb_y) * 8 * uvs + size_t(mb_x) * 8];
        uint8_t* vd = &pl.v[size_t(mb_y) * 8 * uvs + size_t(mb_x) * 8];
        const int il = f.ilevel, ht = f.hev_thresh;
        if (mb_x > 0) {
          complex_edge(yd, 1, ys_, 16, limit + 4, il, ht, true);
          complex_edge(ud, 1, uvs_, 8, limit + 4, il, ht, true);
          complex_edge(vd, 1, uvs_, 8, limit + 4, il, ht, true);
        }
        if (f.inner) {
          for (int k = 4; k < 16; k += 4) complex_edge(yd + k, 1, ys_, 16, limit, il, ht, false);
          complex_edge(ud + 4, 1, uvs_, 8, limit, il, ht, false);
          complex_edge(vd + 4, 1, uvs_, 8, limit, il, ht, false);
        }
        if (mb_y > 0) {
          complex_edge(yd, ys_, 1, 16, limit + 4, il, ht, true);
          complex_edge(ud, uvs_, 1, 8, limit + 4, il, ht, true);
          complex_edge(vd, uvs_, 1, 8, limit + 4, il, ht, true);
        }
        if (f.inner) {
          for (int k = 4; k < 16; k += 4) complex_edge(yd + k * ys_, ys_, 1, 16, limit, il, ht, false);
          complex_edge(ud + 4 * uvs_, uvs_, 1, 8, limit, il, ht, false);
          complex_edge(vd + 4 * uvs_, uvs_, 1, 8, limit, il, ht, false);
        }
      }
  }
  return pl;
}

// libwebp's YUV->RGB (yuv.h: 14-bit fixed point, then clipped).
inline int mult_hi(int v, int c) { return (v * c) >> 8; }
inline uint8_t yuv_clip(int v) { return uint8_t((v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255); }
inline void yuv_to_rgb(int y, int u, int v, uint8_t* o) {
  o[0] = yuv_clip(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  o[1] = yuv_clip(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  o[2] = yuv_clip(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// upsampling_dsp's UpsampleRgbaLinePair: two luma rows (bottom may be
// null) from the chroma rows above (top_*) and below (cur_*) them.
void upsample_pair(const uint8_t* top_y, const uint8_t* bot_y, const uint8_t* top_u, const uint8_t* top_v,
                   const uint8_t* cur_u, const uint8_t* cur_v, uint8_t* top_dst, uint8_t* bot_dst, int len) {
  const int last_pair = (len - 1) >> 1;
  int tl_u = top_u[0], tl_v = top_v[0], l_u = cur_u[0], l_v = cur_v[0];
  yuv_to_rgb(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
  if (bot_y) yuv_to_rgb(bot_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bot_dst);
  for (int x = 1; x <= last_pair; ++x) {
    const int t_u = top_u[x], t_v = top_v[x], u = cur_u[x], v = cur_v[x];
    const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3, d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
    yuv_to_rgb(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1, top_dst + 4 * (2 * x - 1));
    yuv_to_rgb(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, top_dst + 4 * (2 * x));
    if (bot_y) {
      yuv_to_rgb(bot_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1, bot_dst + 4 * (2 * x - 1));
      yuv_to_rgb(bot_y[2 * x], (d12_u + u) >> 1, (d12_v + v) >> 1, bot_dst + 4 * (2 * x));
    }
    tl_u = t_u, tl_v = t_v, l_u = u, l_v = v;
  }
  if (!(len & 1)) {
    yuv_to_rgb(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst + 4 * (len - 1));
    if (bot_y)
      yuv_to_rgb(bot_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bot_dst + 4 * (len - 1));
  }
}

// The frame as RGBA into `out` (stride `stride` bytes), as EmitFancyRGB
// emits it: row 0 from chroma row 0 alone, rows 2k-1 and 2k from chroma
// rows k-1 and k, an even height's last row from the last chroma row
// alone.  Alpha 255.
void emit_rgba(const Planes& pl, uint8_t* out, size_t stride) {
  const int w = pl.width, h = pl.height;
  const size_t ys = size_t(pl.mb_w) * 16, uvs = size_t(pl.mb_w) * 8;
  auto Y = [&](int r) { return pl.y.data() + size_t(r) * ys; };
  auto U = [&](int r) { return pl.u.data() + size_t(r) * uvs; };
  auto V = [&](int r) { return pl.v.data() + size_t(r) * uvs; };
  upsample_pair(Y(0), nullptr, U(0), V(0), U(0), V(0), out, nullptr, w);
  int y = 0;
  for (; y + 2 < h; y += 2)
    upsample_pair(Y(y + 1), Y(y + 2), U(y / 2), V(y / 2), U(y / 2 + 1), V(y / 2 + 1),
                  out + size_t(y + 1) * stride, out + size_t(y + 2) * stride, w);
  if (!(h & 1)) upsample_pair(Y(h - 1), nullptr, U(y / 2), V(y / 2), U(y / 2), V(y / 2),
                              out + size_t(h - 1) * stride, nullptr, w);
  for (int r = 0; r < h; ++r)
    for (int x = 0; x < w; ++x) out[size_t(r) * stride + size_t(4 * x + 3)] = 255;
}

// --------------------------------------------------------------- VP8L ----

// The lossless bit reader, least significant bit first.  Past the data it
// reads zeros; libwebp flags the end of the stream once more bits are
// consumed than it holds (or than 64, for a stream under 8 bytes), and
// each decode step below fails then.
struct LReader {
  const uint8_t* p = nullptr;
  size_t n = 0;
  uint64_t pos = 0;  // bits consumed

  bool overrun() const { return pos > 8 * uint64_t(std::max<size_t>(n, 8)); }
  uint32_t peek() const {  // the next 32 bits
    const uint64_t b = pos >> 3;
    uint64_t v = 0;
    if (b + 8 <= n) {
      for (int i = 0; i < 8; ++i) v |= uint64_t(p[b + uint64_t(i)]) << (8 * i);
    } else {
      for (int i = 0; i < 8 && b + uint64_t(i) < n; ++i) v |= uint64_t(p[b + uint64_t(i)]) << (8 * i);
    }
    return uint32_t(v >> (pos & 7));
  }
  uint32_t read(int k) {  // k <= 24
    const uint32_t v = k ? peek() & ((1u << k) - 1) : 0;
    pos += uint64_t(k);
    return v;
  }
};

// A canonical prefix code as libwebp's BuildHuffmanTable accepts it: a
// complete code, or a single symbol (read with no bits).
struct Huffman {
  int single = -1;
  uint16_t fast[256] = {};  // the next 8 bits -> (length << 12) | symbol; 0 for a longer code
  uint16_t count[16] = {};
  std::vector<uint16_t> sorted;

  bool build(const std::vector<int>& lengths, int n) {
    std::fill(count, count + 16, 0);
    int total = 0;
    for (int s = 0; s < n; ++s) {
      if (lengths[size_t(s)] > 15) return false;
      if (lengths[size_t(s)]) ++count[lengths[size_t(s)]], ++total;
    }
    if (total == 0) return false;
    for (int len = 1; len < 15; ++len)
      if (count[len] > (1 << len)) return false;
    sorted.clear();
    for (int len = 1; len <= 15; ++len)
      for (int s = 0; s < n; ++s)
        if (lengths[size_t(s)] == len) sorted.push_back(uint16_t(s));
    if (total == 1) {
      single = sorted[0];
      return true;
    }
    int64_t left = 1;  // open branches: the code must fill the tree exactly
    for (int len = 1; len <= 15; ++len) {
      left = 2 * left - count[len];
      if (left < 0) return false;
    }
    if (left != 0) return false;
    std::fill(fast, fast + 256, 0);
    uint32_t code = 0;
    size_t k = 0;
    for (int len = 1; len <= 8; ++len, code <<= 1)
      for (int i = 0; i < count[len]; ++i, ++k, ++code) {
        uint32_t rev = 0;
        for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
        for (uint32_t r = rev; r < 256; r += 1u << len) fast[r] = uint16_t(len << 12 | sorted[k]);
      }
    return true;
  }
  int read(LReader& br) const {
    if (single >= 0) return single;
    uint32_t bits = br.peek();
    const uint16_t e = fast[bits & 255];
    if (e) {
      br.pos += e >> 12;
      return e & 4095;
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= 15; ++len, bits >>= 1) {
      code |= int(bits & 1);
      const int c = count[len];
      if (code - first < c) {
        br.pos += uint64_t(len);
        return sorted[size_t(index + code - first)];
      }
      index += c, first = (first + c) << 1, code <<= 1;
    }
    return 0;  // not reached: the code is complete
  }
};

enum { kGreen = 0, kRed, kBlue, kAlpha, kDist };
constexpr int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};
constexpr int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

// ReadHuffmanCode: one prefix code of `alphabet` symbols.
Huffman read_code(LReader& br, int alphabet) {
  std::vector<int> lengths(size_t(std::max(alphabet, 256)), 0);
  if (br.read(1)) {  // simple code: one or two symbols
    const int two = br.read(1);
    lengths[br.read(br.read(1) ? 8 : 1)] = 1;
    if (two) lengths[br.read(8)] = 1;
  } else {
    std::vector<int> cl(19, 0);
    const int num = int(br.read(4)) + 4;
    for (int i = 0; i < num; ++i) cl[size_t(kCodeLengthOrder[i])] = int(br.read(3));
    Huffman clc;
    if (!clc.build(cl, 19)) fail("VP8L: bad code length code");
    int max_symbol = alphabet;
    if (br.read(1)) {
      const int nbits = 2 + 2 * int(br.read(3));
      max_symbol = 2 + int(br.read(nbits));
      if (max_symbol > alphabet) fail("VP8L: bad code length count");
    }
    int prev = 8;
    for (int s = 0; s < alphabet;) {
      if (max_symbol-- == 0) break;
      const int len = clc.read(br);
      if (len < 16) {
        lengths[size_t(s++)] = len;
        if (len) prev = len;
      } else {
        const int slot = len - 16;
        const int repeat = int(br.read(slot == 0 ? 2 : slot == 1 ? 3 : 7)) + (slot == 2 ? 11 : 3);
        if (s + repeat > alphabet) fail("VP8L: code lengths past the alphabet");
        for (int r = 0; r < repeat; ++r) lengths[size_t(s++)] = slot == 0 ? prev : 0;
      }
    }
  }
  if (br.overrun()) fail("VP8L: truncated data");
  Huffman h;
  if (!h.build(lengths, alphabet)) fail("VP8L: bad prefix code");
  return h;
}

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

struct Lossless {
  LReader br;
  std::vector<Transform> transforms;
  bool alpha_8b = false;  // ALPH: libwebp's 8-bit path (its end-of-stream rule differs)
  int coded_width = 0;    // level 0's width after its transforms

  // DecodeImageStream: the entropy-coded image of xsize x ysize (at level
  // 0 after its transforms, which may narrow it to coded_width).
  std::vector<uint32_t> stream(int xsize, int ysize, bool level0, bool is_alpha = false) {
    if (level0) {
      unsigned seen = 0;
      while (br.read(1)) {
        Transform t;
        t.type = int(br.read(2));
        if (seen & (1u << t.type)) fail("VP8L: a transform repeated");
        seen |= 1u << t.type;
        t.xsize = xsize, t.ysize = ysize;
        if (t.type == 0 || t.type == 1) {
          t.bits = int(br.read(3)) + 2;
          t.data = stream(subsample(xsize, t.bits), subsample(ysize, t.bits), false);
        } else if (t.type == 3) {
          const int ncol = int(br.read(8)) + 1;
          t.bits = ncol > 16 ? 0 : ncol > 4 ? 1 : ncol > 2 ? 2 : 3;
          xsize = subsample(xsize, t.bits);
          std::vector<uint32_t> pal = stream(ncol, 1, false);
          t.data.assign(size_t(1) << (8 >> t.bits), 0);  // transparent black past the colours
          uint8_t* d = reinterpret_cast<uint8_t*>(pal.data());
          uint8_t* o = reinterpret_cast<uint8_t*>(t.data.data());
          std::memcpy(o, d, 4);
          for (int i = 4; i < 4 * ncol; ++i) o[i] = uint8_t(d[i] + o[i - 4]);
        }
        transforms.push_back(std::move(t));
      }
    }
    if (level0) coded_width = xsize;
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = int(br.read(4));
      if (cache_bits < 1 || cache_bits > 11) fail("VP8L: bad colour cache size");
    }
    // ReadHuffmanCodes: the meta image and the groups of five codes.
    int meta_bits = 0, meta_w = 0;
    std::vector<uint32_t> meta;
    int groups_max = 1;
    if (level0 && br.read(1)) {
      meta_bits = int(br.read(3)) + 2;
      meta_w = subsample(xsize, meta_bits);
      meta = stream(meta_w, subsample(ysize, meta_bits), false);
      for (uint32_t& m : meta) {
        m = (m >> 8) & 0xffff;
        groups_max = std::max(groups_max, int(m) + 1);
      }
    }
    if (br.overrun()) fail("VP8L: truncated data");
    // libwebp keeps only the groups the meta image names when there are
    // more than 1000 or more than pixels; the rest are read and checked.
    const bool remap = groups_max > 1000 || int64_t(groups_max) > int64_t(xsize) * ysize;
    std::vector<char> used(size_t(groups_max), remap ? 0 : 1);
    if (remap)
      for (uint32_t m : meta) used[m] = 1;
    std::vector<std::vector<Huffman>> groups(static_cast<size_t>(groups_max));
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    for (int g = 0; g < groups_max; ++g)
      for (int j = 0; j < 5; ++j) {
        Huffman h = read_code(br, kAlphabet[j] + (j == 0 ? cache_size : 0));
        if (used[size_t(g)]) groups[size_t(g)].push_back(std::move(h));
      }
    if (!level0) return pixels(xsize, ysize, cache_bits, meta_bits, meta_w, meta, groups, false);
    alpha_8b = is_alpha && transforms.size() == 1 && transforms[0].type == 3 && cache_bits == 0;
    for (const auto& grp : groups)
      if (!grp.empty() && (grp[kRed].single < 0 || grp[kBlue].single < 0 || grp[kAlpha].single < 0))
        alpha_8b = false;
    return pixels(xsize, ysize, cache_bits, meta_bits, meta_w, meta, groups, alpha_8b);
  }

  static int copy_value(int sym, LReader& br) {  // GetCopyDistance / GetCopyLength
    if (sym < 4) return sym + 1;
    const int extra = (sym - 2) >> 1, offset = (2 + (sym & 1)) << extra;
    return offset + int(br.read(extra)) + 1;
  }

  // DecodeImageData (DecodeAlphaData for `eight_bit`): LZ77 and the colour
  // cache over the prefix codes.
  std::vector<uint32_t> pixels(int w, int h, int cache_bits, int meta_bits, int meta_w,
                               const std::vector<uint32_t>& meta,
                               const std::vector<std::vector<Huffman>>& groups, bool eight_bit) {
    const int64_t total = int64_t(w) * h;
    std::vector<uint32_t> px(static_cast<size_t>(total));
    std::vector<uint32_t> cache(cache_bits ? size_t(1) << cache_bits : 0);
    int64_t cached = 0;
    auto flush_cache = [&](int64_t upto) {
      for (; cached < upto; ++cached)
        cache[(0x1e35a7bdu * px[size_t(cached)]) >> (32 - cache_bits)] = px[size_t(cached)];
    };
    auto check = [&](int64_t pos) {  // the stream's end: an error, unless the 8-bit path is done
      if (br.overrun() && !(eight_bit && pos >= total)) fail("VP8L: truncated data");
    };
    int64_t pos = 0;
    while (pos < total) {
      const int x = int(pos % w), y = int(pos / w);
      const std::vector<Huffman>& g = groups[meta.empty() ? 0 : meta[size_t((y >> meta_bits) * meta_w + (x >> meta_bits))]];
      const int code = g[kGreen].read(br);
      if (code < 256) {
        uint32_t argb = uint32_t(code) << 8;
        if (!eight_bit) {
          const uint32_t r = uint32_t(g[kRed].read(br)), b = uint32_t(g[kBlue].read(br));
          argb |= uint32_t(g[kAlpha].read(br)) << 24 | r << 16 | b;
        }
        px[size_t(pos++)] = argb;
        check(pos);
      } else if (code < 256 + 24) {
        const int length = copy_value(code - 256, br);
        const int dcode = copy_value(g[kDist].read(br), br);
        int64_t dist;
        if (dcode > 120) {
          dist = dcode - 120;
        } else {
          const int v = kCodeToPlane[dcode - 1];
          dist = std::max<int64_t>(int64_t(v >> 4) * w + (8 - (v & 15)), 1);
        }
        if (!eight_bit && br.overrun()) fail("VP8L: truncated data");
        if (pos < dist || total - pos < length) fail("VP8L: a copy outside the image");
        for (int i = 0; i < length; ++i, ++pos) px[size_t(pos)] = px[size_t(pos - dist)];
        check(pos);
      } else {
        flush_cache(pos);
        px[size_t(pos)] = cache[size_t(code - 280)];
        ++pos;
        check(pos);
      }
      if (cache_bits) flush_cache(pos);
    }
    return px;
  }

  // The inverse transforms, last read first, on rows of `width` pixels.
  void inverse(std::vector<uint32_t>& px, int width, int height) {
    for (size_t k = transforms.size(); k-- > 0;) {
      const Transform& t = transforms[k];
      const int w = t.xsize;
      if (t.type == 2) {  // subtract green
        for (uint32_t& a : px) {
          const uint32_t g = (a >> 8) & 0xff;
          a = (a & 0xff00ff00u) | ((((a >> 16) + g) & 0xff) << 16) | ((a + g) & 0xff);
        }
      } else if (t.type == 3) {  // colour indexing, 1/2/4/8 pixels a byte
        std::vector<uint32_t> out(size_t(w) * height);
        const int bpp = 8 >> t.bits, ppb = 1 << t.bits, mask = (1 << bpp) - 1;
        for (int y = 0; y < height; ++y) {
          const uint32_t* in = px.data() + size_t(y) * width;
          uint32_t* o = out.data() + size_t(y) * w;
          uint32_t packed = 0;
          for (int x = 0; x < w; ++x) {
            if ((x & (ppb - 1)) == 0) packed = (*in++ >> 8) & 0xff;
            o[x] = t.data[packed & uint32_t(mask)];
            packed >>= bpp;
          }
        }
        px.swap(out);
        width = w;
      } else if (t.type == 0) {  // predictor
        const int tiles = subsample(w, t.bits);
        auto add = [](uint32_t a, uint32_t b) {
          return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
                 (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
        };
        auto avg2 = [](uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); };
        auto clip255 = [](int v) { return v < 0 ? 0 : v > 255 ? 255 : v; };
        for (int y = 0; y < height; ++y) {
          uint32_t* o = px.data() + size_t(y) * w;
          for (int x = 0; x < w; ++x) {
            uint32_t pred;
            if (y == 0) {
              pred = x == 0 ? 0xff000000u : o[x - 1];
            } else if (x == 0) {
              pred = o[x - w];
            } else {
              const uint32_t L = o[x - 1], T = o[x - w], TL = o[x - w - 1], TR = o[x - w + 1];
              const int mode = int((t.data[size_t((y >> t.bits) * tiles + (x >> t.bits))] >> 8) & 15);
              switch (mode) {
                case 1: pred = L; break;
                case 2: pred = T; break;
                case 3: pred = TR; break;
                case 4: pred = TL; break;
                case 5: pred = avg2(avg2(L, TR), T); break;
                case 6: pred = avg2(L, TL); break;
                case 7: pred = avg2(L, T); break;
                case 8: pred = avg2(TL, T); break;
                case 9: pred = avg2(T, TR); break;
                case 10: pred = avg2(avg2(L, TL), avg2(T, TR)); break;
                case 11: {  // Select
                  int d = 0;
                  for (int s = 0; s < 32; s += 8) {
                    const int a = int(T >> s) & 255, b = int(L >> s) & 255, c = int(TL >> s) & 255;
                    d += std::abs(b - c) - std::abs(a - c);
                  }
                  pred = d <= 0 ? T : L;
                  break;
                }
                case 12:  // ClampedAddSubtractFull
                  pred = 0;
                  for (int s = 0; s < 32; s += 8)
                    pred |= uint32_t(clip255(int(L >> s & 255) + int(T >> s & 255) - int(TL >> s & 255))) << s;
                  break;
                case 13: {  // ClampedAddSubtractHalf
                  const uint32_t a = avg2(L, T);
                  pred = 0;
                  for (int s = 0; s < 32; s += 8) {
                    const int av = int(a >> s & 255), c = int(TL >> s & 255);
                    pred |= uint32_t(clip255(av + (av - c) / 2)) << s;
                  }
                  break;
                }
                default: pred = 0xff000000u;  // 0, 14 and 15: black
              }
            }
            o[x] = add(o[x], pred);
          }
        }
      } else {  // colour transform
        const int tiles = subsample(w, t.bits);
        for (int y = 0; y < height; ++y)
          for (int x = 0; x < w; ++x) {
            const uint32_t m = t.data[size_t((y >> t.bits) * tiles + (x >> t.bits))];
            const int8_t g2r = int8_t(m & 255), g2b = int8_t(m >> 8 & 255), r2b = int8_t(m >> 16 & 255);
            uint32_t& a = px[size_t(y) * w + size_t(x)];
            const int8_t green = int8_t(a >> 8 & 255);
            int r = int(a >> 16 & 255), b = int(a & 255);
            r = (r + ((int(g2r) * green) >> 5)) & 255;
            b = (b + ((int(g2b) * green) >> 5) + ((int(r2b) * int8_t(r)) >> 5)) & 255;
            a = (a & 0xff00ff00u) | uint32_t(r) << 16 | uint32_t(b);
          }
      }
    }
  }
};

// A VP8L image (its 5-byte header included) as ARGB pixels.
std::vector<uint32_t> decode_vp8l(const uint8_t* data, size_t n, int& w, int& h) {
  Lossless dec;
  dec.br = LReader{data, n, 0};
  if (dec.br.read(8) != 0x2f) fail("VP8L: bad signature");
  w = int(dec.br.read(14)) + 1, h = int(dec.br.read(14)) + 1;
  dec.br.read(1);
  if (dec.br.read(3) != 0) fail("VP8L: bad version");
  std::vector<uint32_t> px = dec.stream(w, h, true);
  dec.inverse(px, dec.coded_width, h);
  return px;
}

// --------------------------------------------------------------- ALPH ----

// alpha_dec.c: the ALPH chunk's plane for a w x h frame.  Compression 0
// (raw) or 1 (a VP8L image stream without its header, green channel);
// filter none, horizontal, vertical or gradient, undone row by row from
// the previous output row (the first row from the left only, starting at
// 0; the first column from above); pre-processing (level reduction) needs
// no work without dithering.
std::vector<uint8_t> decode_alpha(const uint8_t* data, size_t n, int w, int h) {
  if (n <= 1) fail("ALPH: chunk too short");
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3, rsrv = data[0] >> 6;
  if (method > 1 || pre > 1 || rsrv != 0) fail("ALPH: bad header");
  const size_t npx = size_t(w) * size_t(h);
  std::vector<uint8_t> a(npx);
  if (method == 0) {
    if (n - 1 < npx) fail("ALPH: truncated raw data");
    std::memcpy(a.data(), data + 1, npx);
  } else {
    Lossless dec;
    dec.br = LReader{data + 1, n - 1, 0};
    std::vector<uint32_t> px = dec.stream(w, h, true, true);
    dec.inverse(px, dec.coded_width, h);
    for (size_t i = 0; i < npx; ++i) a[i] = uint8_t(px[i] >> 8);
  }
  for (int y = 0; y < h && filter != 0; ++y) {
    uint8_t* row = a.data() + size_t(y) * w;
    const uint8_t* prev = y ? row - w : nullptr;
    if (!prev || filter == 1) {  // horizontal (and every filter's first row)
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < w; ++x) pred = row[x] = uint8_t(pred + row[x]);
    } else if (filter == 2) {   // vertical
      for (int x = 0; x < w; ++x) row[x] = uint8_t(prev[x] + row[x]);
    } else {                    // gradient
      int left = prev[0], top_left = prev[0];
      for (int x = 0; x < w; ++x) {
        const int top = prev[x], g = left + top - top_left;
        left = row[x] = uint8_t(row[x] + (g < 0 ? 0 : g > 255 ? 255 : g));
        top_left = top;
      }
    }
  }
  return a;
}

// ------------------------------------------------------------ container ----

// WebPGetFeatures / WebPParseHeaders (webp_dec.c ParseHeadersInternal) of
// `data`: a RIFF file, or a frame's chunks.  `whole` is the decoder's
// call (all data present); otherwise the feature query, which reports an
// animation's VP8X alone and accepts a VP8X file cut short.
enum Status { kOk, kNotEnoughData, kError };
struct Headers {
  Status status = kOk;
  int width = 0, height = 0;
  bool has_alpha = false, animation = false, lossless = false;
  const uint8_t* alpha = nullptr;
  size_t alpha_size = 0, offset = 0, compressed_size = 0;
};

Headers parse_headers(const uint8_t* data, size_t size, bool whole) {
  Headers hd;
  const uint8_t* const start = data;
  if (size < 12) return hd.status = kNotEnoughData, hd;
  size_t riff_size = 0;
  if (!std::memcmp(data, "RIFF", 4)) {
    if (std::memcmp(data + 8, "WEBP", 4)) return hd.status = kError, hd;
    riff_size = le32(data + 4);
    if (riff_size < 12 || riff_size > kMaxChunkPayload) return hd.status = kError, hd;
    if (whole && riff_size > size - 8) return hd.status = kNotEnoughData, hd;
    data += 12, size -= 12;
  }
  const bool found_riff = riff_size > 0;
  bool found_vp8x = false;
  uint32_t flags = 0;
  int canvas_w = 0, canvas_h = 0;
  if (size < 8) return hd.status = kNotEnoughData, hd;
  if (!std::memcmp(data, "VP8X", 4)) {
    if (le32(data + 4) != 10) return hd.status = kError, hd;
    if (size < 18) return hd.status = kNotEnoughData, hd;
    flags = le32(data + 8);
    canvas_w = int(1 + le24(data + 12)), canvas_h = int(1 + le24(data + 15));
    if (uint64_t(canvas_w) * uint64_t(canvas_h) >= kMaxImageArea) return hd.status = kError, hd;
    data += 18, size -= 18;
    found_vp8x = true;
  }
  if (!found_riff && found_vp8x) return hd.status = kError, hd;
  hd.has_alpha = flags & kAlphaFlag;
  hd.animation = flags & kAnimationFlag;
  hd.width = canvas_w, hd.height = canvas_h;
  auto finish = [&](Status s) {
    if (s == kOk || (s == kNotEnoughData && found_vp8x && !whole)) {
      hd.has_alpha |= hd.alpha != nullptr;
      hd.status = kOk;
    } else {
      hd.status = s;
    }
    return hd;
  };
  if (found_vp8x && hd.animation && !whole) return finish(kOk);
  if (size < 4) return finish(kNotEnoughData);
  if ((found_riff && found_vp8x) || (!found_riff && !found_vp8x && !std::memcmp(data, "ALPH", 4))) {
    // ParseOptionalChunks: up to the VP8 / VP8L chunk; the last ALPH wins.
    uint64_t total = 4 + 8 + 10;
    for (;;) {
      if (size < 8) return finish(kNotEnoughData);
      const uint32_t csize = le32(data + 4);
      if (csize > kMaxChunkPayload) return finish(kError);
      const uint64_t disk = (uint64_t(8) + csize + 1) & ~uint64_t(1);
      total += disk;
      if (riff_size > 0 && total > riff_size) return finish(kError);
      if (!std::memcmp(data, "VP8 ", 4) || !std::memcmp(data, "VP8L", 4)) break;
      if (size < disk) return finish(kNotEnoughData);
      if (!std::memcmp(data, "ALPH", 4)) hd.alpha = data + 8, hd.alpha_size = csize;
      data += disk, size -= size_t(disk);
    }
  }
  // ParseVP8Header.
  if (size < 8) return finish(kNotEnoughData);
  const bool is_vp8 = !std::memcmp(data, "VP8 ", 4), is_vp8l = !std::memcmp(data, "VP8L", 4);
  if (is_vp8 || is_vp8l) {
    const uint32_t csize = le32(data + 4);
    if (riff_size >= 12 && csize > riff_size - 12) return finish(kError);
    if (whole && csize > size - 8) return finish(kNotEnoughData);
    hd.compressed_size = csize;
    data += 8, size -= 8;
    hd.lossless = is_vp8l;
  } else {
    hd.lossless = size >= 5 && data[0] == 0x2f && (data[4] >> 5) == 0;
    hd.compressed_size = size;
  }
  if (hd.compressed_size > kMaxChunkPayload) return hd.status = kError, hd;
  int w, h;
  if (!hd.lossless) {
    if (size < 10) return finish(kNotEnoughData);
    const uint32_t bits = le24(data);  // VP8GetInfo
    if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a || (bits & 1) || ((bits >> 1) & 7) > 3 ||
        !((bits >> 4) & 1) || (bits >> 5) >= hd.compressed_size)
      return hd.status = kError, hd;
    w = int(le16(data + 6) & 0x3fff), h = int(le16(data + 8) & 0x3fff);
    if (w == 0 || h == 0) return hd.status = kError, hd;
  } else {
    if (size < 5) return finish(kNotEnoughData);
    if (data[0] != 0x2f || (data[4] >> 5) != 0) return hd.status = kError, hd;  // VP8LGetInfo
    const uint32_t bits = le32(data + 1);
    w = int((bits & 0x3fff) + 1), h = int(((bits >> 14) & 0x3fff) + 1);
    hd.has_alpha = (bits >> 28) & 1;
  }
  if (found_vp8x && (canvas_w != w || canvas_h != h)) return hd.status = kError, hd;
  hd.width = w, hd.height = h;
  hd.offset = size_t(data - start);
  return finish(kOk);
}

// WebPDemux (demux.c) of a whole file, allow_partial off: the canvas and
// the frames, or a refusal.
struct Frame {
  int x = 0, y = 0, width = 0, height = 0, num = 0;
  bool complete = false;
  size_t img_off = 0, img_size = 0, alpha_off = 0, alpha_size = 0;
};
struct Demux {
  int canvas_w = 0, canvas_h = 0, num_frames = 0;
  uint32_t flags = 0;
  bool ext = false;
  std::vector<Frame> frames;
};

struct DemuxParser {
  enum P { kPOk, kPMore, kPError };
  const uint8_t* buf;
  size_t start = 0, end = 0, riff_end = 0;
  Demux d;

  size_t avail() const { return end - start; }
  bool invalid(uint64_t size) const { return size > riff_end - start; }
  uint32_t r8() { return buf[start++]; }
  uint32_t r24() { const uint32_t v = le24(buf + start); start += 3; return v; }
  uint32_t r32() { const uint32_t v = le32(buf + start); start += 4; return v; }

  bool add_frame(const Frame& f) {
    if (!d.frames.empty() && !d.frames.back().complete) return false;
    d.frames.push_back(f);
    return true;
  }
  // StoreFrame: an optional ALPH and the VP8 / VP8L chunk of one frame.
  P store_frame(int num, uint32_t min_size, Frame& f) {
    int alpha_chunks = 0, image_chunks = 0;
    if (avail() < 8 || avail() < min_size) return kPMore;
    P st = kPOk;
    bool done = false;
    do {
      const size_t chunk_start = start;
      start += 4;
      const uint32_t payload = r32();
      if (payload > kMaxChunkPayload) return kPError;
      const uint64_t padded = uint64_t(payload) + (payload & 1);
      const size_t avail_payload = size_t(std::min<uint64_t>(padded, avail()));
      const size_t chunk_size = 8 + avail_payload;
      if (invalid(padded)) return kPError;
      if (padded > avail()) st = kPMore;
      const char* t = reinterpret_cast<const char*>(buf + chunk_start);
      const bool is_image = !std::memcmp(t, "VP8L", 4) || !std::memcmp(t, "VP8 ", 4);
      if (!std::memcmp(t, "VP8L", 4) && alpha_chunks > 0) return kPError;  // VP8L has its own alpha
      if (!std::memcmp(t, "ALPH", 4) && alpha_chunks == 0) {
        ++alpha_chunks;
        f.alpha_off = chunk_start, f.alpha_size = chunk_size, f.num = num;
        start += avail_payload;
      } else if (is_image && image_chunks == 0) {
        const Headers ft = parse_headers(buf + chunk_start, chunk_size, false);
        if (st == kPMore && ft.status == kNotEnoughData) return kPMore;
        if (ft.status != kOk) return kPError;
        ++image_chunks;
        f.img_off = chunk_start, f.img_size = chunk_size;
        f.width = ft.width, f.height = ft.height, f.num = num;
        f.complete = st == kPOk;
        start += avail_payload;
      } else {
        start -= 8;  // not this frame's: leave it to the caller
        done = true;
      }
      if (start == riff_end) done = true;
      else if (avail() < 8) st = kPMore;
    } while (!done && st == kPOk);
    return st;
  }
  P single_image() {
    if (!d.frames.empty()) return kPError;
    if (invalid(8)) return kPError;
    if (avail() < 8) return kPMore;
    Frame f;
    const P st = store_frame(1, 0, f);
    if (st == kPError) return st;
    if (!(d.flags & kAlphaFlag) && f.alpha_size > 0) f.alpha_off = 0, f.alpha_size = 0;
    if (!d.ext && f.width > 0 && f.height > 0) d.canvas_w = f.width, d.canvas_h = f.height;
    if (!add_frame(f)) return kPError;
    d.num_frames = 1;
    return st;
  }
  P animation_frame(uint32_t frame_size) {
    const bool animation = d.flags & kAnimationFlag;
    if (invalid(16) || frame_size < 16) return kPError;
    if (avail() < 16) return kPMore;
    Frame f;
    f.x = int(2 * r24()), f.y = int(2 * r24());
    f.width = int(1 + r24()), f.height = int(1 + r24());
    r24(), r8();  // duration, dispose and blend bits
    if (uint64_t(f.width) * uint64_t(f.height) >= kMaxImageArea) return kPError;
    const size_t s0 = start;
    P st = store_frame(d.num_frames + 1, frame_size - 16, f);
    if (st != kPError && start - s0 > frame_size - 16) st = kPError;
    if (st != kPError && animation && f.num > 0) {
      if (add_frame(f)) ++d.num_frames;
      else st = kPError;
    }
    return st;
  }
  P vp8x() {
    if (avail() < 8) return kPMore;
    d.ext = true;
    start += 4;
    uint32_t size = r32();
    if (size > kMaxChunkPayload || size < 10) return kPError;
    size += size & 1;
    if (invalid(size)) return kPError;
    if (avail() < size) return kPMore;
    d.flags = r8();
    start += 3;
    d.canvas_w = int(1 + r24()), d.canvas_h = int(1 + r24());
    if (uint64_t(d.canvas_w) * uint64_t(d.canvas_h) >= kMaxImageArea) return kPError;
    start += size - 10;
    if (invalid(8)) return kPError;
    if (avail() < 8) return kPMore;
    const bool animation = d.flags & kAnimationFlag;
    int anim_chunks = 0;
    P st = kPOk;
    do {
      const size_t chunk_start = start;
      const char* t = reinterpret_cast<const char*>(buf + start);
      start += 4;
      const uint32_t csize = r32();
      if (csize > kMaxChunkPayload) return kPError;
      const uint64_t padded = uint64_t(csize) + (csize & 1);
      if (invalid(padded)) return kPError;
      if (!std::memcmp(t, "VP8X", 4)) return kPError;
      if (!std::memcmp(t, "ALPH", 4) || !std::memcmp(t, "VP8 ", 4) || !std::memcmp(t, "VP8L", 4)) {
        if (anim_chunks > 0 || animation) return kPError;
        start = chunk_start;
        st = single_image();
      } else if (!std::memcmp(t, "ANIM", 4)) {
        if (padded < 6) return kPError;
        if (avail() < padded) st = kPMore;
        else {
          ++anim_chunks;  // background colour and loop count: unused by the first frame
          start += size_t(padded);
        }
      } else if (!std::memcmp(t, "ANMF", 4)) {
        if (anim_chunks == 0) return kPError;
        st = animation_frame(uint32_t(padded));
      } else {  // ICCP, EXIF, XMP, unknown: skipped
        if (padded <= avail()) start += size_t(padded);
        else st = kPMore;
      }
      if (start == riff_end) break;
      if (avail() < 8) st = kPMore;
    } while (st == kPOk);
    return st;
  }
};

bool frame_bounds(const Frame& f, bool exact, int cw, int ch) {
  if (exact) return f.x == 0 && f.y == 0 && f.width == cw && f.height == ch;
  return f.x >= 0 && f.y >= 0 && int64_t(f.width) + f.x <= cw && int64_t(f.height) + f.y <= ch;
}

Demux demux(const uint8_t* data, size_t n) {
  const char* refuse = "WebP: WebPDemux refuses the file (truncated, bad chunk sizes or layout)";
  if (n < 20) throw std::runtime_error(refuse);
  if (std::memcmp(data, "RIFF", 4) || std::memcmp(data + 8, "WEBP", 4)) fail("not a RIFF WEBP file");
  const uint32_t riff_size = le32(data + 4);
  if (riff_size < 8 || riff_size > kMaxChunkPayload) throw std::runtime_error(refuse);
  DemuxParser p;
  p.buf = data;
  p.riff_end = size_t(riff_size) + 8;
  p.end = std::min(n, p.riff_end);
  if (p.end < p.riff_end) fail("truncated file");
  p.start = 12;
  DemuxParser::P st = DemuxParser::kPError;
  const char* t = reinterpret_cast<const char*>(data + 12);
  const bool simple = !std::memcmp(t, "VP8 ", 4) || !std::memcmp(t, "VP8L", 4);
  if (simple) st = p.single_image();
  else if (!std::memcmp(t, "VP8X", 4)) st = p.vp8x();
  if (st == DemuxParser::kPMore) st = DemuxParser::kPError;  // the whole file is here
  if (st == DemuxParser::kPError) throw std::runtime_error(refuse);
  Demux& d = p.d;
  // IsValidSimpleFormat / IsValidExtendedFormat.
  bool valid = d.canvas_w > 0 && d.canvas_h > 0 && !d.frames.empty();
  if (valid && simple) {
    valid = d.frames[0].width > 0 && d.frames[0].height > 0;
  } else if (valid) {
    const bool animation = d.flags & kAnimationFlag;
    if (d.flags & ~kAllValidFlags) valid = false;
    for (const Frame& f : d.frames) {
      if (!valid) break;
      if (!animation && f.num > 1) valid = false;
      else if (!f.complete) valid = false;  // no partial frame in a whole file
      else if (f.img_size == 0 && f.alpha_size == 0) valid = false;
      else if (f.alpha_size > 0 && f.alpha_off > f.img_off) valid = false;
      else if (f.width <= 0 || f.height <= 0) valid = false;
      else if (!frame_bounds(f, !animation, d.canvas_w, d.canvas_h)) valid = false;
    }
  }
  if (!valid) throw std::runtime_error(refuse);
  return d;
}

// WebPDecode of one frame's chunks into RGBA (w x h x 4).
std::vector<uint8_t> decode_frame(const uint8_t* data, size_t n, int& w, int& h) {
  if (parse_headers(data, n, false).status != kOk) fail("bad frame header");
  const Headers hd = parse_headers(data, n, true);
  if (hd.status != kOk) fail("bad frame header");
  const uint8_t* body = data + hd.offset;
  const size_t body_size = n - hd.offset;
  std::vector<uint8_t> rgba;
  if (hd.lossless) {
    const std::vector<uint32_t> px = decode_vp8l(body, body_size, w, h);
    rgba.resize(px.size() * 4);
    for (size_t i = 0; i < px.size(); ++i) {
      const uint32_t a = px[i];
      rgba[4 * i] = uint8_t(a >> 16), rgba[4 * i + 1] = uint8_t(a >> 8);
      rgba[4 * i + 2] = uint8_t(a), rgba[4 * i + 3] = uint8_t(a >> 24);
    }
    return rgba;
  }
  const Planes pl = decode_vp8(body, body_size);
  w = pl.width, h = pl.height;
  rgba.resize(size_t(w) * size_t(h) * 4);
  emit_rgba(pl, rgba.data(), size_t(w) * 4);
  if (hd.alpha) {
    const std::vector<uint8_t> a = decode_alpha(hd.alpha, hd.alpha_size, w, h);
    for (size_t i = 0; i < a.size(); ++i) rgba[4 * i + 3] = a[i];
  }
  return rgba;
}

}  // namespace

void decode(const uint8_t* data, size_t n, int64_t max_pixels, int64_t& width, int64_t& height,
            bool& alpha, std::vector<uint8_t>& rgba) {
  // Pillow's mode: "RGBX" only where the feature query succeeds without alpha.
  const Headers features = parse_headers(data, n, false);
  alpha = !(features.status == kOk && !features.has_alpha);
  const Demux d = demux(data, n);
  width = d.canvas_w, height = d.canvas_h;
  if (width > max_pixels / height)
    fail("image of " + std::to_string(width) + "x" + std::to_string(height) + " pixels exceeds the limit of " +
         std::to_string(max_pixels));
  const Frame* first = nullptr;
  for (const Frame& f : d.frames)
    if (f.num == 1) {
      first = &f;
      break;
    }
  if (!first) fail("no first frame");
  // GetFramePayload: from the ALPH chunk (if kept) to the image chunk's end.
  size_t off = first->img_off, size = first->img_size;
  if (first->alpha_size > 0) {
    size += first->alpha_size + (first->img_off > 0 ? first->img_off - (first->alpha_off + first->alpha_size) : 0);
    off = first->alpha_off;
  }
  int fw = 0, fh = 0;
  const std::vector<uint8_t> frame = decode_frame(data + off, size, fw, fh);
  if (fw != first->width || fh != first->height) fail("frame size differs from its header");
  rgba.assign(size_t(width) * size_t(height) * 4, 0);
  for (int y = 0; y < fh; ++y)
    std::memcpy(&rgba[((size_t(first->y) + size_t(y)) * size_t(width) + size_t(first->x)) * 4],
                &frame[size_t(y) * size_t(fw) * 4], size_t(fw) * 4);
}

}  // namespace webp
