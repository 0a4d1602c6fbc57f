"""Texture image decoding through the port's native decoder library.

No JAX counterpart: the JAX package opens texture files with Pillow
(scene/obj_loader.py::load_texture_file, ``Image.open``) and non-``.hdr``
skies with imageio; the reference C++ with stb_image (file.cppm:276-291).
The GPU machine has neither Pillow nor imageio, and a Huffman decode in
Python would take seconds a megapixel, so the port decodes in C++:
``realtimeraytracer_torch/native/image_decode.cpp`` and, for WebP, TIFF's
CCITT and TIFF's ZSTD, ``native/webp_decode.cpp``, ``fax_decode.cpp`` and
``zstd_decode.cpp``, one library bound here with ctypes.

``decode_image(data)`` identifies a file by its content, as ``Image.open``
does (``sniff``: Pillow's 43 openers in its order, each with its test of
the first bytes), and returns uint8 (H, W, C) pixels with the Pillow
mode the JAX package would see.  C is 1 (grey), 2 (grey + alpha), 3
(RGB) or 4 (RGBA); palette and CMYK images come back expanded to RGBA.
Read: JPEG (8-bit, 1, 3 or 4 components: CMYK and YCCK by the Adobe
marker; baseline and progressive Huffman, sequential and progressive
arithmetic coding, lossless; libjpeg-turbo's SIMD ISLOW IDCT, whose 16-bit
lanes wrap on corrupt coefficients; the block smoothing of an incomplete
progressive file; libjpeg's recovery from corrupt data, as Pillow returns
it), PNG (every colour type,
depth and filter, Adam7), TGA (types 1, 2, 3, 9, 10, 11 at 1, 8, 16, 24,
32 bits; 16-, 24-, 32-bit colour maps), BMP (1/4/8-bit palette, RLE8 and
RLE4, 16, 24 and 32 bits, BI_RGB and BI_BITFIELDS), GIF (the first
frame), PNM (P1-P6, any maxval; Pf), PSD (the composite image: raw or
PackBits; bitmap, grey, indexed, RGB, RGBA, CMYK, Lab), TIFF (the first
image, its directory read as Pillow reads it and again as libtiff does:
classic, BigTIFF and the "invalid" byte-order prefixes; strips and tiles,
planar or not, FillOrder 2; uncompressed, PackBits, LZW, Deflate, JPEG,
CCITT RLE, RLEW, Group 3 (1-D and 2-D) and Group 4, ThunderScan, LZMA
and ZSTD, with predictors 2 and 3, libtiff's recovery from bad CCITT data
included; every entry of Pillow's mode table that its convert accepts,
YCbCr through libtiff's RGBA rules, Lab through littleCMS's Lab -> sRGB
transform as Pillow's ImageCms runs it; Orientation applied as Pillow 12
applies it), WebP (as Pillow opens it through libwebp's
animation decoder: lossy VP8 key frames with their ALPH alpha, lossless
VP8L, the simple and the VP8X container, an animation's first frame on
its zeroed canvas; "RGBA" where libwebp's features report alpha, else
"RGB"), ICO, CUR and DIB (BMP members through the library's bitmap
reader, PNG members through the PNG path), ICNS (Apple's RLE and PNG
members); TIFF's old-style LZW and old-style JPEG.  For PNG and TIFF's Deflate, this module
inflates with ``zlib``, and TIFF's LZMA it decodes with liblzma (the
library under Python's ``lzma``, driven as libtiff drives it): the
library calls ``_decompress`` back for each strip or tile; the library
does the rest.  Values that differ from Pillow's, as stb_image (the
reference's decoder) has them: 16-bit grey PNG, PGM and TIFF samples come
back as their high byte, 12-bit grey TIFF samples as their top 8 bits,
where Pillow's convert clips them.  A Lab image comes back as "LAB",
converted to RGBA; ``obj_loader.load_texture_file`` refuses it as grey,
as Pillow's convert("L") does.  ``decode_float_samples(data)`` gives a float TIFF
(16-, 32- or 64-bit; 1, 3 or 4 channels) or a PFM as its float32 samples,
as a sky's linear radiance.

Malformed input and formats not ported (16-bit PSD, the openers of
ROADMAP's A12 still to port; and, as Pillow refuses them or cannot load
them here, EPS, WMF, the BUFR/GRIB/HDF5 stubs, MPEG, TIFF compressed by SGILog or
WebP, TIFF photometrics 9 and 10, 12-bit, hierarchical and arithmetic-
coded lossless JPEG, a JPEG height in a DNL marker, a JPEG cut inside a
scan, an arithmetic-coded scan past Pillow's first 64 KiB read) raise
``ValueError`` naming the cause; nothing falls back to another decoder.
libjpeg's and libtiff's warnings stay silent, as in Pillow.

The library is built at first use with ``$CXX`` (default g++) into the
kernels' build directory (``kernels.BUILD_DIR``), under a name that hashes
the four sources, the flags and the compiler's ``--version``; a file lock
keeps concurrent processes to one build.  Loading it also loads liblzma;
without it the call raises.  No ``-march=native``: the decode is
integer arithmetic, but for the Lab nodes (double arithmetic and libm's
``pow``, as littleCMS computes them), and gives the same bytes on every
host.  Without a
compiler, or if the build or the load fails, the call raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import ctypes.util
import fcntl
import hashlib
import lzma  # noqa: F401 - loads liblzma, which _unxz drives
import math
import os
import re
import struct
import subprocess
import threading
import zlib
from pathlib import Path

import numpy as np

from realtimeraytracer_torch.kernels import BUILD_DIR
from realtimeraytracer_torch.utils import log
from realtimeraytracer_torch.utils.native import _compiler
from realtimeraytracer_torch.utils.png import SIGNATURE as PNG_SIGNATURE

SOURCES = tuple(Path(__file__).resolve().parents[1] / "native" / name
                for name in ("image_decode.cpp", "webp_decode.cpp", "fax_decode.cpp", "zstd_decode.cpp"))
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")
# Pillow's Image.open raises DecompressionBombError above twice MAX_IMAGE_PIXELS.
MAX_PIXELS = 2 * 89478485

# The library's format codes (imgd_decode).
_CODES = {"JPEG": 1, "BMP": 2, "TGA": 3, "GIF": 4, "PNM": 5, "PSD": 6, "WEBP": 7, "DIB": 8}
# Pillow's TiffImagePlugin.PREFIXES: both byte orders, the "invalid" ones
# (magic in the other order) and BigTIFF.
TIFF_PREFIXES = (b"MM\0*", b"II*\0", b"MM*\0", b"II\0*", b"MM\0+", b"II+\0")

_lock = threading.Lock()
_lib = None

_DECOMPRESS = ctypes.CFUNCTYPE(ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                               ctypes.c_int64)


@_DECOMPRESS
def _decompress(codec, src, n, dst, cap):
    """The library's callback for TIFF's Deflate (compression 8 and 32946,
    codec 0: a zlib stream, inflated by zlib) and LZMA (34925, codec 1: an
    .xz stream, decoded by liblzma as libtiff drives it: no memory limit,
    one stream, its check verified, the output before an error kept): at most `cap` bytes of the output into
    `dst`; -1 if the stream is corrupt.  libtiff stops where the strip is
    full, so does this."""
    if cap <= 0:
        return 0
    if codec == 1:
        return _unxz(src, n, dst, cap)
    try:
        out = zlib.decompressobj().decompress(ctypes.string_at(src, n), cap)
    except zlib.error:
        return -1
    ctypes.memmove(dst, out, len(out))
    return len(out)


class _LzmaStream(ctypes.Structure):
    """liblzma's lzma_stream (lzma/base.h, 5.x)."""
    _fields_ = [("next_in", ctypes.c_void_p), ("avail_in", ctypes.c_size_t), ("total_in", ctypes.c_uint64),
                ("next_out", ctypes.c_void_p), ("avail_out", ctypes.c_size_t), ("total_out", ctypes.c_uint64),
                ("allocator", ctypes.c_void_p), ("internal", ctypes.c_void_p),
                ("reserved", ctypes.c_void_p * 4), ("reserved_int", ctypes.c_uint64 * 2),
                ("reserved_size", ctypes.c_size_t * 2), ("reserved_enum", ctypes.c_int * 2)]


_liblzma = None


def _lzma_library() -> ctypes.CDLL:
    """liblzma, the library under Python's lzma module (loaded with it);
    raises if there is none."""
    global _liblzma
    if _liblzma is None:
        for name in ("liblzma.so.5", ctypes.util.find_library("lzma")):
            try:
                lib = ctypes.CDLL(name)
                break
            except (OSError, TypeError):
                continue
        else:
            raise RuntimeError("no liblzma (the library of Python's lzma module) to decode LZMA TIFF data")
        lib.lzma_stream_decoder.argtypes = [ctypes.POINTER(_LzmaStream), ctypes.c_uint64, ctypes.c_uint32]
        lib.lzma_code.argtypes = [ctypes.POINTER(_LzmaStream), ctypes.c_int]
        lib.lzma_end.argtypes = [ctypes.POINTER(_LzmaStream)]
        _liblzma = lib
    return _liblzma


def _unxz(src, n: int, dst, cap: int) -> int:
    """libtiff's LZMADecode of one strip or tile: an .xz stream decoder with
    no memory limit, run until `cap` bytes are out, the stream ends or
    liblzma reports an error; what liblzma wrote before an error stands
    (Python's lzma drops it, so liblzma is driven here directly)."""
    lib = _lzma_library()
    stream = _LzmaStream()
    if lib.lzma_stream_decoder(ctypes.byref(stream), ctypes.c_uint64(-1).value, 0) != 0:
        raise RuntimeError("lzma_stream_decoder failed")
    try:
        stream.next_in, stream.avail_in = src, n
        stream.next_out, stream.avail_out = dst, cap
        while stream.avail_out > 0:
            if lib.lzma_code(ctypes.byref(stream), 0) != 0:     # LZMA_OK; LZMA_STREAM_END or an error ends it
                break
        return cap - stream.avail_out
    finally:
        lib.lzma_end(ctypes.byref(stream))


def library_path(cxx: list[str]) -> Path:
    """Where the library built by `cxx` goes: its name hashes the sources,
    the flags and the compiler's version."""
    version = subprocess.run([*cxx, "--version"], capture_output=True, text=True)
    if version.returncode != 0:
        raise RuntimeError(f"{' '.join(cxx)} --version failed:\n{version.stderr}")
    h = hashlib.sha256()
    for source in SOURCES:
        h.update(source.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(version.stdout.encode())
    return BUILD_DIR / f"librtrt_image-{h.hexdigest()[:16]}.so"


def build(cxx: list[str]) -> Path:
    """Compile the decoder with `cxx` unless a library of the same hash
    exists; raises with the compiler's stderr if the build fails."""
    out = library_path(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "librtrt_image.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():       # built by another process while this one waited
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([*cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building the image decoder with {' '.join(cxx)} failed:\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    log.debug("image decoder built: {}", out)
    return out


def load_library() -> ctypes.CDLL:
    """The decoder library, built on first use; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        _lzma_library()
        cxx = _compiler()
        if cxx is None:
            raise RuntimeError(f"no C++ compiler ({os.environ.get('CXX') or 'g++'}) to build the "
                               f"image decoder {SOURCES[0]}")
        path = build(cxx)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"cannot load the image decoder {path}: {e}") from e
        c = ctypes
        err = [c.c_char_p, c.c_int64]
        lib.imgd_decode.restype = c.c_void_p
        lib.imgd_decode.argtypes = [c.c_char_p, c.c_int64, c.c_int32, *err]
        for name in ("imgd_tiff", "imgd_tiff_floats"):
            getattr(lib, name).restype = c.c_void_p
            getattr(lib, name).argtypes = [c.c_char_p, c.c_int64, _DECOMPRESS, *err]
        lib.imgd_icon.restype = c.c_void_p
        lib.imgd_icon.argtypes = [c.c_char_p, c.c_int64, c.c_int32, c.c_int64, c.c_int64, c.c_int64, c.c_int64, *err]
        lib.imgd_png.restype = c.c_void_p
        lib.imgd_png.argtypes = [c.c_char_p, c.c_int64, c.c_int64, c.c_int64, c.c_int32, c.c_int32,
                                 c.c_int32, c.c_char_p, c.c_int64, c.c_char_p, c.c_int64, *err]
        for name in ("imgd_width", "imgd_height", "imgd_channels"):
            getattr(lib, name).restype = c.c_int64
            getattr(lib, name).argtypes = [c.c_void_p]
        lib.imgd_mode.restype = c.c_char_p
        lib.imgd_mode.argtypes = [c.c_void_p]
        lib.imgd_pixels.restype = c.POINTER(c.c_uint8)
        lib.imgd_pixels.argtypes = [c.c_void_p]
        lib.imgd_floats.restype = c.POINTER(c.c_float)
        lib.imgd_floats.argtypes = [c.c_void_p, *[c.POINTER(c.c_int64)] * 3]
        lib.imgd_free.argtypes = [c.c_void_p]
        _lib = lib
        return lib


@contextlib.contextmanager
def _result(lib, call, *args):
    """The handle of a decoder entry point's result (or its error raised),
    freed on exit."""
    err = ctypes.create_string_buffer(512)
    handle = call(*args, err, len(err))
    if not handle:
        raise ValueError(err.value.decode(errors="replace"))
    try:
        yield handle
    finally:
        lib.imgd_free(handle)


def _collect(lib, call, *args) -> tuple[np.ndarray, str]:
    """Run a decoder entry point and copy its pixels and mode out."""
    with _result(lib, call, *args) as handle:
        h, w, c = lib.imgd_height(handle), lib.imgd_width(handle), lib.imgd_channels(handle)
        pixels = np.ctypeslib.as_array(lib.imgd_pixels(handle), shape=(h * w * c,))
        return pixels.reshape(h, w, c).copy(), lib.imgd_mode(handle).decode()


def _decode_png(lib, data: bytes, keep_trns: bool = True) -> tuple[np.ndarray, str]:
    """A PNG through zlib and the library; `keep_trns` false ignores its
    tRNS chunk (an icon's member, whose transparency Pillow drops)."""
    pos, header, plte, trns, idat = len(PNG_SIGNATURE), None, b"", b"", []
    while True:
        if pos + 8 > len(data):
            raise ValueError("truncated PNG: no IEND chunk")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if pos + 12 + length > len(data):
            raise ValueError(f"truncated PNG chunk {kind!r}")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if crc != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        pos += 12 + length
        if header is None and kind != b"IHDR":
            raise ValueError("PNG does not start with an IHDR chunk")
        if kind == b"IHDR":
            if length != 13:
                raise ValueError("PNG IHDR chunk has a bad length")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"tRNS" and keep_trns:
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, compression, filt, interlace = header
    if compression != 0 or filt != 0:
        raise ValueError(f"PNG compression method {compression} / filter method {filt} does not exist")
    if w == 0 or h == 0 or w * h > MAX_PIXELS:
        raise ValueError(f"PNG of {w}x{h} pixels: none, or more than {MAX_PIXELS}")
    if not idat:
        raise ValueError("PNG has no IDAT chunk")
    inflate = zlib.decompressobj()
    try:
        # At most 8 bytes a pixel and a filter byte a row and pass, plus one:
        # a larger stream fails the library's exact size check.
        raw = inflate.decompress(b"".join(idat), h * (8 * w + 8) + 1)
    except zlib.error as e:
        raise ValueError(f"PNG image data does not inflate: {e}") from e
    if not inflate.eof and not inflate.unconsumed_tail:
        raise ValueError("truncated PNG image data")
    return _collect(lib, lib.imgd_png, raw, len(raw), w, h, depth, ctype, interlace,
                    plte, len(plte), trns, len(trns))


def _is_tga(head: bytes) -> bool:
    """Pillow's test of a TGA header (TgaImagePlugin._open)."""
    if len(head) < 18:
        return False
    w, h = struct.unpack("<HH", head[12:16])
    return (head[1] in (0, 1) and w > 0 and h > 0 and head[16] in (1, 8, 16, 24, 32)
            and head[2] in (1, 2, 3, 9, 10, 11))


_IM_TAGS = (b"Comment", b"Date", b"Digitalization equipment", b"File size (no of images)", b"Lut", b"Name",
            b"Scale (x,y)", b"Image size (x*y)", b"Image type")


def _is_im(data: bytes) -> bool:
    """ImImagePlugin._open's first checks, as far as a file's first line:
    a line feed in the first 100 bytes, and a first line of at most 100
    bytes that reads "Key: value" with one of its keys."""
    if b"\n" not in data[:100] or data[:1] in (b"", b"\0", b"\x1a"):
        return False
    line = data.lstrip(b"\r").split(b"\n", 1)[0]
    m = re.match(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$", line.removesuffix(b"\r"))
    return len(line) < 100 and m is not None and m.group(1) in _IM_TAGS


def _is_spider(data: bytes) -> bool:
    """SpiderImagePlugin's isSpiderHeader, big- or little-endian."""
    if len(data) < 108:
        return False
    for order in ">", "<":
        h = (99.0,) + struct.unpack(order + "27f", data[:108])
        try:
            if any(h[i] != int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
                continue
        except (ValueError, OverflowError):
            continue
        if int(h[5]) in (1, 3, -11, -12, -21, -22) and int(h[22]) == int(h[13]) * int(h[23]):
            return True
    return False


def _icon_opens(data: bytes, magic: bytes) -> bool:
    """An ICO's or a CUR's directory as its plugin's _open reads it: a
    directory short of its entries, or of none, raises IndexError,
    struct.error or TypeError there, and Image.open goes on to the next
    opener."""
    if not data.startswith(magic) or len(data) < 6:
        return False
    count = struct.unpack("<H", data[4:6])[0]
    return count > 0 and len(data) >= 6 + 16 * count


def _icns_opens(data: bytes) -> bool:
    """IcnsFile's walk of the blocks: a short block header (struct.error)
    or one of no size (SyntaxError), or no member of a known size
    (SyntaxError), sends Image.open on."""
    if not data.startswith(b"icns") or len(data) < 8:
        return False
    i, filesize, sigs = 8, struct.unpack(">I", data[4:8])[0], set()
    while i < filesize:
        if i < 0 or i + 8 > len(data):
            return False
        sig, blocksize = struct.unpack(">4sI", data[i:i + 8])
        if blocksize <= 0:
            return False
        sigs.add(sig)
        i += blocksize
    return any(s in sigs for members in _ICNS_SIZES.values() for s in members)


def _is_gbr(data: bytes) -> bool:
    """GbrImagePlugin's accept and _open checks (big-endian header of at
    least 20 bytes, version 1 or 2, a size, depth 1 or 4, version 2's
    "GIMP" magic)."""
    if len(data) < 20:
        return False
    size, version, w, h, depth = struct.unpack(">5I", data[:20])
    return (size >= 20 and version in (1, 2) and 0 < w < 1 << 31 and 0 < h < 1 << 31 and depth in (1, 4)
            and (version == 1 or data[20:24] == b"GIMP"))


def _is_wmf(data: bytes) -> bool:
    """WmfImagePlugin's accept and _open checks: a placeable metafile with
    the standard header after it, or an enhanced one."""
    if data.startswith(b"\xd7\xcd\xc6\x9a\x00\x00"):
        return data[22:26] == b"\x01\x00\t\x00"
    return data.startswith(b"\x01\x00\x00\x00") and data[40:44] == b" EMF"


def _i32(b: bytes, order: str = "<") -> int:
    return struct.unpack(order + "I", b[:4])[0] if len(b) >= 4 else -1


# Pillow's openers in the order Image.open tries them (Image.ID after
# preinit() and then init()), each with its test of the file's first bytes
# (the plugin's _accept of 16 bytes; for the openers without one, the
# checks their _open makes before it raises SyntaxError, which sends
# Image.open on to the next).  Image.open takes the first that accepts.
_OPENERS = (
    ("BMP", lambda d: d.startswith(b"BM")),
    ("DIB", lambda d: _i32(d) in (12, 40, 52, 56, 64, 108, 124)),
    ("GIF", lambda d: d[:6] in (b"GIF87a", b"GIF89a")),
    ("JPEG", lambda d: d.startswith(b"\xff\xd8\xff")),
    ("PNM", lambda d: d[:1] == b"P" and len(d) >= 2 and d[1] in b"0123456fy"),
    ("PNG", lambda d: d.startswith(PNG_SIGNATURE)),
    ("AVIF", lambda d: d[4:8] == b"ftyp" and d[8:12] in (b"avif", b"avis", b"mif1", b"msf1")),
    ("BLP", lambda d: d.startswith((b"BLP1", b"BLP2"))),
    ("BUFR", lambda d: d.startswith((b"BUFR", b"ZCZC"))),
    ("CUR", lambda d: _icon_opens(d, b"\0\0\2\0")),
    ("PCX", lambda d: len(d) >= 2 and d[0] == 10 and d[1] in (0, 2, 3, 5)),
    ("DCX", lambda d: _i32(d) == 0x3ADE68B1),
    ("DDS", lambda d: d.startswith(b"DDS ")),
    ("EPS", lambda d: d.startswith(b"%!PS") or _i32(d) == 0xC6D3D0C5),
    ("FITS", lambda d: d.startswith(b"SIMPLE")),
    ("FLI", lambda d: len(d) >= 16 and struct.unpack("<H", d[4:6])[0] in (0xAF11, 0xAF12)
     and struct.unpack("<H", d[14:16])[0] in (0, 3)),
    ("FTEX", lambda d: d.startswith(b"FTEX")),
    ("GBR", _is_gbr),
    ("GRIB", lambda d: len(d) >= 8 and d.startswith(b"GRIB") and d[7] == 1),
    ("HDF5", lambda d: d.startswith(b"\x89HDF\r\n\x1a\n")),
    ("JPEG2000", lambda d: d.startswith((b"\xff\x4f\xff\x51", b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"))),
    ("ICNS", _icns_opens),
    ("ICO", lambda d: _icon_opens(d, b"\0\0\1\0")),
    ("IM", _is_im),
    ("IMT", lambda d: b"\n" in d[:100] and d.startswith((b"width ", b"height ", b"pixel "))),
    ("IPTC", lambda d: len(d) >= 5 and d[0] == 0x1C and d[1] in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240)),
    ("MCIDAS", lambda d: d.startswith(b"\0\0\0\0\0\0\0\4")),
    ("MPEG", lambda d: d.startswith(b"\0\0\1\xb3")),
    ("TIFF", lambda d: d.startswith(TIFF_PREFIXES)),
    ("MSP", lambda d: d.startswith((b"DanM", b"LinS"))),
    ("PCD", lambda d: d[2048:2052] == b"PCD_"),
    ("PIXAR", lambda d: d.startswith(b"\200\350\000\000")),
    ("PSD", lambda d: d.startswith(b"8BPS")),
    ("QOI", lambda d: d.startswith(b"qoif")),
    ("SGI", lambda d: len(d) >= 2 and struct.unpack(">H", d[:2])[0] == 474),
    ("SPIDER", _is_spider),
    ("SUN", lambda d: _i32(d, ">") == 0x59A66A95),
    ("TGA", _is_tga),
    ("WEBP", lambda d: d[:4] == b"RIFF" and d[8:12] == b"WEBP" and d[12:16] in (b"VP8 ", b"VP8L", b"VP8X")),
    ("WMF", _is_wmf),
    ("XBM", lambda d: d[:16].lstrip().startswith(b"#define")),
    ("XPM", lambda d: d.startswith(b"/* XPM */")),
    ("XVTHUMB", lambda d: d.startswith(b"P7 332")),
)
READ = ("BMP", "DIB", "GIF", "JPEG", "PNM", "PNG", "CUR", "ICNS", "ICO", "TIFF", "PSD", "TGA", "WEBP")
# Openers Pillow finds but cannot load here either (ROADMAP, the opener
# table): the port names the cause.
_BOTH_RAISE = {
    "EPS": "EPS needs Ghostscript to render",
    "WMF": "WMF/EMF renders only on Windows",
    "BUFR": "BUFR is a stub format without a handler",
    "GRIB": "GRIB is a stub format without a handler",
    "HDF5": "HDF5 is a stub format without a handler",
    "MPEG": "MPEG is only identified, not decoded",
}


def sniff(data: bytes) -> str:
    """The format of image bytes as Pillow's Image.open finds it: the first
    of its openers, in its order, whose test accepts them (so bytes two
    openers accept go to the earlier, as in Pillow; TGA, which has no
    test, is tried after all but five).  Returns one of ``READ`` ("PNM"
    for Pillow's PPM); raises ValueError for a format not ported, one
    that Pillow cannot load either, or no image."""
    head = data[:16]
    for name, accepts in _OPENERS:
        if accepts(data if name in ("TGA", "IM", "IMT", "PCD", "SPIDER", "CUR", "ICNS", "ICO", "GBR", "WMF")
                   else head):
            if name in READ:
                return name
            if name in _BOTH_RAISE:
                raise ValueError(f"{_BOTH_RAISE[name]} (Pillow raises too)")
            raise ValueError(f"{name} image: not a format this port reads yet (ROADMAP A12)")
    raise ValueError("not an image file this port reads (" + ", ".join(READ) + ")")


def _u(fmt: str, data: bytes, at: int) -> tuple:
    """struct.unpack at `at`; ValueError where the file ends first."""
    size = struct.calcsize(fmt)
    if at < 0 or at + size > len(data):
        raise ValueError("truncated icon file")
    return struct.unpack(fmt, data[at:at + size])


def _decode_ico(lib, data: bytes) -> tuple[np.ndarray, str]:
    """IcoImagePlugin: the entry of the largest area, of those the lowest
    colour depth (bits, else log2 of the colour count, else 256), the
    first in the file of equals; a PNG member as a PNG without its tRNS
    (Pillow keeps the member's pixels and palette, not its info), any
    other through the library's icon_bitmap (RGBA)."""
    entries = []
    for i in range(_u("<H", data, 4)[0]):
        w, h, colours, _, _, bits, size, offset = _u("<BBBBHHII", data, 6 + 16 * i)
        depth = bits or (colours != 0 and math.ceil(math.log(colours, 2))) or 256
        entries.append(((w or 256) * (h or 256), depth, size, offset, bits))
    if not entries:
        raise ValueError("ICO file without images")
    entries.sort(key=lambda e: e[1])
    entries.sort(key=lambda e: e[0], reverse=True)
    _, _, size, offset, bits = entries[0]
    if data[offset:offset + 8] == PNG_SIGNATURE:
        return _decode_png(lib, data[offset:], keep_trns=False)
    return _collect(lib, lib.imgd_icon, data, len(data), 0, offset, size, bits, -1)


def _decode_cur(lib, data: bytes) -> tuple[np.ndarray, str]:
    """CurImagePlugin: the first entry unless a later one is wider and
    taller; its DIB at half height (an offset of 0 means right after the
    directory, where Pillow's file then stands)."""
    count = _u("<H", data, 4)[0]
    best = None
    for i in range(count):
        w, h = _u("<BB", data, 6 + 16 * i)
        if best is None or (w > best[0] and h > best[1]):
            best = (w, h, _u("<I", data, 6 + 16 * i + 12)[0])
    if best is None:
        raise ValueError("CUR file without cursors")
    return _collect(lib, lib.imgd_icon, data, len(data), 1, best[2] or 6 + 16 * count, 0, 0, -1)


# IcnsImagePlugin.IcnsFile.SIZES: (width, height, scale) -> its members, in
# the order Pillow reads them.
_ICNS_SIZES = {
    (512, 512, 2): (b"ic10",), (512, 512, 1): (b"ic09",), (256, 256, 2): (b"ic14",),
    (256, 256, 1): (b"ic08",), (128, 128, 2): (b"ic13",), (128, 128, 1): (b"ic07", b"it32", b"t8mk"),
    (64, 64, 1): (b"icp6",), (32, 32, 2): (b"ic12",), (48, 48, 1): (b"ih32", b"h8mk"),
    (32, 32, 1): (b"icp5", b"il32", b"l8mk"), (16, 16, 2): (b"ic11",), (16, 16, 1): (b"icp4", b"is32", b"s8mk"),
}


def _decode_icns(lib, data: bytes) -> tuple[np.ndarray, str]:
    """IcnsImagePlugin: the largest (width, height, scale) any member
    holds; every member of that size read in Pillow's order (PNG, JPEG
    2000, Apple's RLE RGB, its mask); the PNG (without its tRNS, as
    Pillow drops the member's info) if there is one, else the RGB with the
    mask as alpha.  The member's own mode: Pillow reports "RGBA" at open,
    which ``obj_loader.load_texture_file`` accounts for."""
    blocks, i = {}, 8
    filesize = _u(">I", data, 4)[0]
    while i < filesize:
        sig, blocksize = _u(">4sI", data, i)
        if blocksize <= 0:
            raise ValueError("invalid ICNS block header")
        blocks[sig] = (i + 8, blocksize - 8)
        i += blocksize
    sizes = [size for size, sigs in _ICNS_SIZES.items() if any(s in blocks for s in sigs)]
    if not sizes:
        raise ValueError("ICNS file without 32-bit icon resources")
    size = max(sizes)
    side = size[0] * size[2]
    found = {}
    for sig in _ICNS_SIZES[size]:
        if sig not in blocks:
            continue
        start, length = blocks[sig]
        if sig.endswith(b"mk"):
            if start + side * side > len(data):
                raise ValueError("truncated ICNS mask")
            found["A"] = start
        elif sig in (b"it32", b"ih32", b"il32", b"is32"):
            if sig == b"it32":
                if data[start:start + 4] != b"\0\0\0\0":
                    raise ValueError("ICNS it32 member without its zero signature")
                start, length = start + 4, length - 4
            found["RGB"] = (start, length)
        elif data[start:start + 8] == PNG_SIGNATURE:
            found["RGBA"] = _decode_png(lib, data[start:], keep_trns=False)
        elif data[start:start + 4] == b"\xff\x4f\xff\x51" or data[start:start + 4] == b"\x0d\x0a\x87\x0a" or \
                data[start:start + 12] == b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a":
            raise ValueError("ICNS member in JPEG 2000, which the port does not read yet (ROADMAP A12)")
        else:
            raise ValueError("unsupported ICNS member format")
        if "RGB" in found and sig in (b"it32", b"ih32", b"il32", b"is32"):  # read_32 runs, and may fail
            found["RGB"] = _collect(lib, lib.imgd_icon, data, len(data), 2, start, length, side, -1)
    if "RGBA" in found:
        return found["RGBA"]
    if "RGB" not in found:
        raise ValueError("ICNS icon without an RGB member")
    px = found["RGB"][0]
    if "A" not in found:
        return px, "RGB"
    alpha = np.frombuffer(data, np.uint8, side * side, found["A"]).reshape(side, side, 1)
    return np.concatenate([px, alpha], axis=2), "RGBA"


def decode_image(data: bytes) -> tuple[np.ndarray, str]:
    """(uint8 (H, W, C) pixels, Pillow mode) of image file bytes."""
    data = bytes(data)
    kind = sniff(data)
    lib = load_library()
    if kind == "PNG":
        return _decode_png(lib, data)
    if kind == "TIFF":
        return _collect(lib, lib.imgd_tiff, data, len(data), _decompress)
    if kind in ("ICO", "CUR", "ICNS"):
        return {"ICO": _decode_ico, "CUR": _decode_cur, "ICNS": _decode_icns}[kind](lib, data)
    return _collect(lib, lib.imgd_decode, data, len(data), _CODES[kind])


def decode_float_samples(data: bytes) -> np.ndarray | None:
    """The float32 (H, W, C) samples of a float TIFF (SampleFormat 3:
    16-, 32- or 64-bit samples, C 1, 3 or 4; strips or tiles, one plane
    or one a sample) or of a PFM (C 1), top row first: the linear
    radiance a sky holds, as the JAX package's imageio reads a TIFF (its
    bundled tifffile: as stored, no Orientation applied, cast to
    float32).  None for any other image, which ``decode_image`` reads."""
    data = bytes(data)
    kind = sniff(data)
    if kind not in ("TIFF", "PNM"):
        return None
    lib = load_library()
    call = (lib.imgd_tiff_floats, data, len(data), _decompress) if kind == "TIFF" else \
        (lib.imgd_decode, data, len(data), _CODES[kind])
    with _result(lib, *call) as handle:
        h, w, c = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
        floats = lib.imgd_floats(handle, ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
        if not floats:
            return None
        n = h.value * w.value * c.value
        return np.ctypeslib.as_array(floats, shape=(n,)).reshape(h.value, w.value, c.value).copy()


def pixels_digest(arr: np.ndarray) -> str:
    """SHA-256 of an array's dtype, shape and C-order bytes (the fixtures'
    ``expected.json`` holds these of ``load_texture_file``'s output)."""
    arr = np.ascontiguousarray(arr)
    h = hashlib.sha256(f"{arr.dtype.str}{arr.shape}".encode())
    h.update(arr.tobytes())
    return h.hexdigest()
