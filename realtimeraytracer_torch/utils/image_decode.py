"""Texture image decoding through the port's native decoder library.

No JAX counterpart: the JAX package opens texture files with Pillow
(scene/obj_loader.py::load_texture_file, ``Image.open``) and non-``.hdr``
skies with imageio; the reference C++ with stb_image (file.cppm:276-291).
The GPU machine has neither Pillow nor imageio, and a Huffman decode in
Python would take seconds a megapixel, so the port decodes in C++:
``realtimeraytracer_torch/native/image_decode.cpp`` and, for WebP, TIFF's
CCITT, TIFF's ZSTD, the plain raster formats and the GPU textures' blocks,
``native/webp_decode.cpp``, ``fax_decode.cpp``, ``zstd_decode.cpp``,
``raster_decode.cpp`` and ``bcn_decode.cpp``, one library bound here with
ctypes.

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
members); TIFF's old-style LZW and old-style JPEG (tiles in any number of
columns, as libtiff reads them).  The plain raster openers, each header
read here as its Pillow plugin reads it (``_X_open``, with the errors that
send ``Image.open`` on to the next opener) and its pixels in
``raster_decode.cpp``: PCX (1-bit, 2 and 4 bit planes, 8-bit grey or
palette, 24-bit planes) and DCX (its first page), QOI, SGI (raw and RLE,
8 and 16 bits), Sun raster (1, 4, 8, 24, 32 bits, raw and RLE, colour
maps), MSP (versions 1 and 2), XBM, XPM (up to 256 colours "P", more
"RGB"), IM (every type of Pillow's table that it loads: Luts, planar
RGB, bit depths, signed and float types, YCbCr), SPIDER, FITS (BITPIX 8,
16, 32, -32, -64; GZIP_1 tiles), FLI/FLC (the first frame), GBR, IM Tools,
IPTC (raw or JPEG data, through this module again), McIdas, Photo CD (the
768 x 512 base image), PIXAR and XV thumbnails.  The GPU texture
containers, their headers read here (``_dds_open``, ``_blp_open``,
``_ftex_open``) and their blocks in ``bcn_decode.cpp``: DDS (masked 8- to
32-bit RGB(A), L, LA, P, R8G8B8A8, and BC1-BC7 through Pillow's "bcn"
decoder: DXT1/3/5, BC4, BC5 unsigned and signed, BC6H UF16 and SF16 as
Pillow's bytes, BC7; the top mip level of the first surface), FTEX (DXT1,
raw RGB) and BLP (BLP1 JPEG, read as BGR, and palette; BLP2 palette and
DXT1/3/5 through BlpImagePlugin's own Python DXT decoder, which rounds
otherwise).  For PNG, TIFF's Deflate
and FITS's GZIP_1 this module inflates with ``zlib`` (``gzip``), and
TIFF's LZMA it decodes with liblzma (the library under Python's ``lzma``,
driven as libtiff drives it): the library calls ``_decompress`` back for
each strip or tile; the library does the rest.  Values that differ from
Pillow's, as stb_image (the reference's decoder) has them: 16-bit grey
PNG, PGM, TIFF, FITS, McIdas and IM samples come back as their high byte
(of the value Pillow reads), 12-bit grey TIFF samples as their top 8 bits,
where Pillow's convert clips them; 32-bit integer and float samples clip
as convert does.  A Lab image comes back as "LAB", converted to RGBA;
``obj_loader.load_texture_file`` refuses it as grey, as Pillow's
convert("L") does; a YCbCr IM comes back converted, its Y band fourth.
``decode_float_samples(data)`` gives a float TIFF (16-, 32- or 64-bit;
1, 3 or 4 channels), a PFM, an IM "F" image or a float FITS as its
float32 samples, as a sky's linear radiance.

Malformed input and formats not ported (16-bit PSD, the openers of
ROADMAP's A12 still to port: JPEG 2000 and AVIF; and, as
Pillow refuses them or cannot load them here, EPS, WMF, the BUFR/GRIB/HDF5
stubs, MPEG, TIFF compressed by SGILog or WebP, TIFF photometrics 9 and
10, 12-bit, hierarchical and arithmetic-coded lossless JPEG, a JPEG
height in a DNL marker, a JPEG cut inside a scan, an arithmetic-coded scan
past Pillow's first 64 KiB read, every raster file its plugin or decoder
refuses) raise ``ValueError`` naming the cause; nothing falls back to
another decoder.  libjpeg's and libtiff's warnings stay silent, as in
Pillow.

The library is built at first use with ``$CXX`` (default g++) into the
kernels' build directory (``kernels.BUILD_DIR``), under a name that hashes
the six sources, the flags and the compiler's ``--version``; a file lock
keeps concurrent processes to one build.  Loading it also loads liblzma;
without it the call raises.  No ``-march=native``: the decode is
integer arithmetic, but for the Lab nodes (double arithmetic and libm's
``pow``, as littleCMS computes them), the YCC tables, DDS's channel masks
(double, as Pillow's Python) and BC6H's halves (float, as Pillow's C), and
gives the same bytes on every host.  Without a compiler, or if the build or the
load fails, the call raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import ctypes.util
import fcntl
import functools
import gzip
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
from typing import NamedTuple

import numpy as np

from realtimeraytracer_torch.kernels import BUILD_DIR
from realtimeraytracer_torch.utils import log
from realtimeraytracer_torch.utils.native import _compiler
from realtimeraytracer_torch.utils.png import SIGNATURE as PNG_SIGNATURE

SOURCES = tuple(Path(__file__).resolve().parents[1] / "native" / name
                for name in ("image_decode.cpp", "webp_decode.cpp", "fax_decode.cpp", "zstd_decode.cpp",
                             "raster_decode.cpp", "bcn_decode.cpp"))
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")
# Pillow's Image.open raises DecompressionBombError above twice MAX_IMAGE_PIXELS.
MAX_PIXELS = 2 * 89478485

# The library's format codes (imgd_decode): 9 and 10 are JPEG read as BLP
# reads it (four components taken for CMYK) and with its CMYK as Pillow
# stores it (inverted, not converted).
_CODES = {"JPEG": 1, "BMP": 2, "TGA": 3, "GIF": 4, "PNM": 5, "PSD": 6, "WEBP": 7, "DIB": 8}
JPEG_AS_BLP, JPEG_CMYK_STORED = 9, 10
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
        lib.imgr_decode.restype = c.c_void_p
        lib.imgr_decode.argtypes = [c.c_char_p, c.c_int64, c.c_int32, c.c_char_p, c.c_char_p, c.c_int64, c.c_int64,
                                    c.c_int64, c.POINTER(c.c_int64), c.c_int64, c.c_char_p, c.c_int64, c.c_char_p,
                                    c.c_int64, *err]
        for name in ("imgr_width", "imgr_height", "imgr_channels"):
            getattr(lib, name).restype = c.c_int64
            getattr(lib, name).argtypes = [c.c_void_p]
        lib.imgr_mode.restype = c.c_char_p
        lib.imgr_mode.argtypes = [c.c_void_p]
        lib.imgr_pixels.restype = c.POINTER(c.c_uint8)
        lib.imgr_pixels.argtypes = [c.c_void_p]
        lib.imgr_floats.restype = c.POINTER(c.c_float)
        lib.imgr_floats.argtypes = [c.c_void_p]
        lib.imgr_free.argtypes = [c.c_void_p]
        for name, extra in (("imgb_bcn", [c.c_int32, c.c_int32]), ("imgb_blp_dxt", [c.c_int32, c.c_int32])):
            getattr(lib, name).restype = c.c_int
            getattr(lib, name).argtypes = [c.c_char_p, c.c_int64, c.c_int64, *extra, c.c_int64, c.c_int64,
                                           c.c_void_p, *err]
        lib.imgb_masked.restype = None
        lib.imgb_masked.argtypes = [c.c_char_p, c.c_int64, c.c_int64, c.c_int64, c.POINTER(c.c_uint32), c.c_int32,
                                    c.c_int64, c.c_int64, c.c_void_p]
        _lib = lib
        return lib


@contextlib.contextmanager
def _result(lib, call, *args, free=None):
    """The handle of a decoder entry point's result (or its error raised),
    freed on exit (by `free`, default imgd_free)."""
    err = ctypes.create_string_buffer(512)
    handle = call(*args, err, len(err))
    if not handle:
        raise ValueError(err.value.decode(errors="replace"))
    try:
        yield handle
    finally:
        (free or lib.imgd_free)(handle)


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


def _is_wmf(data: bytes) -> bool:
    """WmfImagePlugin's accept and _open checks: a placeable metafile with
    the standard header after it, or an enhanced one."""
    if data.startswith(b"\xd7\xcd\xc6\x9a\x00\x00"):
        return data[22:26] == b"\x01\x00\t\x00"
    return data.startswith(b"\x01\x00\x00\x00") and data[40:44] == b" EMF"


def _i32(b: bytes, order: str = "<") -> int:
    return struct.unpack(order + "I", b[:4])[0] if len(b) >= 4 else -1


# Pillow's openers in the order Image.open tries them (Image.ID after
# preinit() and then init()), each with its test of the file (the plugin's
# _accept of 16 bytes; then, where the port models it, the checks its _open
# makes before it raises SyntaxError, or one of the errors Image.open
# counts as such, which send Image.open on to the next; `_opens` for the
# openers whose _open the port reads in full).  Image.open takes the first
# that accepts.
_OPENERS = (
    ("BMP", lambda d: d.startswith(b"BM")),
    ("DIB", lambda d: _i32(d) in (12, 40, 52, 56, 64, 108, 124)),
    ("GIF", lambda d: d[:6] in (b"GIF87a", b"GIF89a")),
    ("JPEG", lambda d: d.startswith(b"\xff\xd8\xff")),
    ("PNM", lambda d: d[:1] == b"P" and len(d) >= 2 and d[1] in b"0123456fy"),
    ("PNG", lambda d: d.startswith(PNG_SIGNATURE)),
    ("AVIF", lambda d: d[4:8] == b"ftyp" and d[8:12] in (b"avif", b"avis", b"mif1", b"msf1")),
    ("BLP", lambda d: _opens(_blp_open, d)),
    ("BUFR", lambda d: d.startswith((b"BUFR", b"ZCZC"))),
    ("CUR", lambda d: _icon_opens(d, b"\0\0\2\0")),
    ("PCX", lambda d: _opens(_pcx_open, d)),
    ("DCX", lambda d: _opens(_dcx_open, d)),
    ("DDS", lambda d: _opens(_dds_open, d)),
    ("EPS", lambda d: d.startswith(b"%!PS") or _i32(d) == 0xC6D3D0C5),
    ("FITS", lambda d: _opens(_fits_open, d)),
    ("FLI", lambda d: _opens(_fli_open, d)),
    ("FTEX", lambda d: _opens(_ftex_open, d)),
    ("GBR", lambda d: _opens(_gbr_open, d)),
    ("GRIB", lambda d: len(d) >= 8 and d.startswith(b"GRIB") and d[7] == 1),
    ("HDF5", lambda d: d.startswith(b"\x89HDF\r\n\x1a\n")),
    ("JPEG2000", lambda d: d.startswith((b"\xff\x4f\xff\x51", b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"))),
    ("ICNS", _icns_opens),
    ("ICO", lambda d: _icon_opens(d, b"\0\0\1\0")),
    ("IM", lambda d: _opens(_im_open, d)),
    ("IMT", lambda d: _opens(_imt_open, d)),
    ("IPTC", lambda d: _opens(_iptc_open, d)),
    ("MCIDAS", lambda d: _opens(_mcidas_open, d)),
    ("MPEG", lambda d: d.startswith(b"\0\0\1\xb3")),
    ("TIFF", lambda d: d.startswith(TIFF_PREFIXES)),
    ("MSP", lambda d: _opens(_msp_open, d)),
    ("PCD", lambda d: _opens(_pcd_open, d)),
    ("PIXAR", lambda d: _opens(_pixar_open, d)),
    ("PSD", lambda d: d.startswith(b"8BPS")),
    ("QOI", lambda d: _opens(_qoi_open, d)),
    ("SGI", lambda d: _opens(_sgi_open, d)),
    ("SPIDER", lambda d: _opens(_spider_open, d)),
    ("SUN", lambda d: _opens(_sun_open, d)),
    ("TGA", _is_tga),
    ("WEBP", lambda d: d[:4] == b"RIFF" and d[8:12] == b"WEBP" and d[12:16] in (b"VP8 ", b"VP8L", b"VP8X")),
    ("WMF", _is_wmf),
    ("XBM", lambda d: _opens(_xbm_open, d)),
    ("XPM", lambda d: _opens(_xpm_open, d)),
    ("XVTHUMB", lambda d: _opens(_xvthumb_open, d)),
)
# The plain raster openers (native/raster_decode.cpp, their headers read
# here): each maps the file to the tile Pillow's plugin builds.
_RASTER = ("PCX", "DCX", "FITS", "FLI", "GBR", "IM", "IMT", "MCIDAS", "MSP", "PCD", "PIXAR", "QOI", "SGI", "SPIDER",
           "SUN", "XBM", "XPM", "XVTHUMB")
READ = ("BMP", "DIB", "GIF", "JPEG", "PNM", "PNG", "CUR", "ICNS", "ICO", "TIFF", "PSD", "TGA", "WEBP", "IPTC", "BLP",
        "DDS", "FTEX") + _RASTER
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
    for name, accepts in _OPENERS:
        if accepts(data):
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


# ----------------------------------------------------- plain raster formats
#
# Each `_X_open(data)` reads a file's header as Pillow's plugin does and
# returns the tile it would build (`_Tile`), None where its _open raises
# SyntaxError or one of the errors Image.open treats so (IndexError,
# TypeError, KeyError, EOFError, struct.error), or leaves the image without
# a mode or of no size: Image.open then goes on to the next opener.  Where
# Pillow raises anything else (OSError, ValueError: Image.open stops there)
# it raises ValueError.


# raster_decode.cpp's decoders (imgr_decode), and two tiles read here:
# a FITS's GZIP_1 heap (inflated, then raw) and no tile at all (Pillow's
# load raises).
RAW, PCX, SGI_RLE, SUN_RLE, MSP, XBM, QOI, BIT, XPM, FLI, PCD = range(11)
NO_DATA, FITS_GZIP = -1, -2


class _Tile(NamedTuple):
    """A tile as Pillow's plugin builds it: a decoder, Pillow's mode and
    rawmode, the data's offset, the size, the decoder's arguments, the
    palette (1024 RGBA bytes) and its other input."""
    decoder: int
    mode: str
    rawmode: str
    offset: int
    w: int
    h: int
    args: tuple = ()
    pal: bytes = b""
    aux: bytes = b""


def _opens(open_fn, data: bytes) -> bool:
    """Whether Image.open stops at this opener: its _open builds a tile,
    or raises what Image.open does not go on from."""
    try:
        return open_fn(data) is not None
    except ValueError:
        return True


def _sized(tile: _Tile | None) -> _Tile | None:
    """ImageFile's check after _open: a mode and a size of at least 1x1."""
    if tile is None or not tile.mode or tile.w <= 0 or tile.h <= 0:
        return None
    return tile


def _palette(rgb: bytes, alphas: bytes = b"") -> bytes:
    """Pillow's palette of an image given `rgb` (3 bytes an entry, at most
    256): opaque black past its entries; `alphas` put on the first entries
    (putpalettealphas)."""
    pal = bytearray(b"\0\0\0\xff" * 256)
    for i in range(min(len(rgb) // 3, 256)):
        pal[4 * i:4 * i + 3] = rgb[3 * i:3 * i + 3]
    for i, a in enumerate(alphas[:256]):
        pal[4 * i + 3] = a
    return bytes(pal)


def _planar_palette(data: bytes) -> bytes:
    """A palette of rawmode "RGB;L" (n reds, n greens, n blues) as RGB."""
    n = len(data) // 3
    return bytes(b for i in range(n) for b in (data[i], data[n + i], data[2 * n + i]))


def _pcx_open(data: bytes, at: int = 0) -> _Tile | None:
    """PcxImagePlugin: a 128-byte header at `at` (a DCX page's offset); the
    palette of an 8-bit file the 769 bytes at the file's end."""
    s = data[at:at + 68]
    if len(s) < 68 or s[0] != 10 or s[1] not in (0, 2, 3, 5):
        return None
    x0, y0, x1, y1 = struct.unpack("<4H", s[4:12])
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        return None
    version, bits, planes, provided = s[1], s[3], s[65], struct.unpack("<H", s[66:68])[0]
    pal = b""
    if bits == 1 and planes == 1:
        mode = rawmode = "1"
    elif bits == 1 and planes in (2, 4):
        mode, rawmode, pal = "P", f"P;{planes}L", _palette(s[16:64])
    elif version == 5 and bits == 8 and planes == 1:
        if len(data) < 769:
            raise ValueError("PCX file shorter than its palette (Pillow: invalid seek)")
        mode = rawmode = "L"
        tail = data[-769:]
        if tail[0] == 12 and any(tail[3 * i + 1:3 * i + 4] != bytes([i]) * 3 for i in range(256)):
            mode = rawmode = "P"
            pal = _palette(tail[1:])
    elif version == 5 and bits == 8 and planes == 3:
        mode, rawmode = "RGB", "RGB;L"
    else:
        raise ValueError("unknown PCX mode (Pillow raises too)")
    w, h = x1 + 1 - x0, y1 + 1 - y0
    stride = (w * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    return _Tile(PCX, mode, rawmode, at + 128, w, h, (planes * stride,), pal)


def _dcx_open(data: bytes) -> _Tile | None:
    """DcxImagePlugin: the page table (up to 1024 offsets, ended by 0), the
    first page read as a PCX at its offset."""
    if _i32(data) != 0x3ADE68B1:
        return None
    offsets = []
    for i in range(1024):
        if 8 + 4 * i > len(data):
            return None
        off = _i32(data[4 + 4 * i:])
        if not off:
            break
        offsets.append(off)
    return _pcx_open(data, offsets[0]) if offsets else None


def _qoi_open(data: bytes) -> _Tile | None:
    """QoiImagePlugin: "qoif", big-endian size, channels (3: RGB, anything
    else RGBA), colour space; the ops from byte 14."""
    if not data.startswith(b"qoif") or len(data) < 13:
        return None
    w, h = struct.unpack(">II", data[4:12])
    return _sized(_Tile(QOI, "RGB" if data[12] == 3 else "RGBA", "", 14, w, h))


_SGI_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L;16B", (2, 2, 1): "L;16B", (1, 3, 3): "RGB",
              (2, 3, 3): "RGB;16B", (1, 3, 4): "RGBA", (2, 3, 4): "RGBA;16B"}


def _sgi_open(data: bytes) -> _Tile | None:
    """SgiImagePlugin: raw (one plane a band, bottom up; 16-bit samples read
    for their high byte) or RLE; an unknown mode raises ValueError in
    Pillow, an unknown compression leaves no tile (its load raises)."""
    if len(data) < 12 or struct.unpack(">H", data[:2])[0] != 474:
        return None
    compression, bpc = data[2], data[3]
    dimension, w, h, z = struct.unpack(">4H", data[4:12])
    rawmode = _SGI_MODES.get((bpc, dimension, z))
    if rawmode is None:
        raise ValueError("Unsupported SGI image mode (Pillow raises too)")
    mode = rawmode.split(";")[0]
    if compression == 1:
        return _sized(_Tile(SGI_RLE, mode, rawmode, 512, w, h, (bpc,)))
    if compression != 0:
        return _sized(_Tile(NO_DATA, mode, "", 0, w, h))
    layers = ",".join(["L;16B"] * len(mode)) if bpc == 2 else ",".join(mode)
    return _sized(_Tile(RAW, mode, layers, 512, w, h, (0, -1, w * h * bpc)))


def _sun_open(data: bytes) -> _Tile | None:
    """SunImagePlugin: depth 1, 4, 8, 24 or 32; a planar colour map of at
    most 1024 bytes makes an 8- or 4-bit file "P"; raw rows padded to 16
    bits, or RLE (type 2)."""
    if len(data) < 32 or _i32(data, ">") != 0x59A66A95:
        return None
    w, h, depth, _, file_type, palette_type, palette_length = struct.unpack(">7I", data[4:32])
    modes = {1: ("1", "1;I"), 4: ("L", "L;4"), 8: ("L", "L"),
             24: ("RGB", "RGB" if file_type == 3 else "BGR"), 32: ("RGB", "RGBX" if file_type == 3 else "BGRX")}
    if depth not in modes:
        return None
    mode, rawmode = modes[depth]
    offset, pal = 32, b""
    if palette_length:
        if palette_length > 1024 or palette_type != 1:
            return None
        offset += palette_length
        if mode != "L":
            raise ValueError(f"Sun raster of mode {mode} with a colour map (Pillow: wrong mode for a palette)")
        mode, rawmode = "P", rawmode.replace("L", "P")
        pal = _palette(_planar_palette(data[32:32 + palette_length]))
    if file_type in (0, 1, 3, 4, 5):
        return _sized(_Tile(RAW, mode, rawmode, offset, w, h, (((w * depth + 15) // 16) * 2, 1), pal))
    if file_type == 2:
        return _sized(_Tile(SUN_RLE, mode, rawmode, offset, w, h, (), pal))
    return None


def _msp_open(data: bytes) -> _Tile | None:
    """MspImagePlugin: a 32-byte header whose 16-bit words XOR to 0;
    version 1 ("DanM") raw 1-bit, version 2 ("LinS") row-map RLE."""
    if len(data) < 32 or not data.startswith((b"DanM", b"LinS")):
        return None
    words = struct.unpack("<16H", data[:32])
    if functools.reduce(lambda a, b: a ^ b, words) != 0:
        return None
    if data.startswith(b"DanM"):
        return _sized(_Tile(RAW, "1", "1", 32, words[2], words[3], (0, 1)))
    return _sized(_Tile(MSP, "1", "", 32, words[2], words[3]))


_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    rb"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    rb"(?P<hotspot>"
    rb"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    rb"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    rb")?"
    rb"[\000-\377]*_bits\[]"
)


def _xbm_open(data: bytes) -> _Tile | None:
    """XbmImagePlugin: its header expression over the first 512 bytes (the
    data after the last "_bits[]" there)."""
    if not data[:16].lstrip().startswith(b"#define"):
        return None
    m = _XBM_HEAD.match(data[:512])
    return _sized(_Tile(XBM, "1", "", m.end(), int(m.group("width")), int(m.group("height")))) if m else None


class _Lines:
    """A file read by lines, as a binary file's readline reads it."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def readline(self) -> bytes:
        end = self.data.find(b"\n", self.pos)
        end = len(self.data) if end < 0 else end + 1
        line, self.pos = self.data[self.pos:end], end
        return line


_XPM_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def _xpm_open(data: bytes) -> _Tile | None:
    """XpmImagePlugin and its decoder: the values line, the colour table
    (`c #rrggbb` keys; a `None` colour is the transparency, which
    convert("RGBA") puts as the alphas of the first palette entries, one
    a byte of its key), "P" for at most 256 colours, else "RGB"; the pixel
    keys of the quoted text of the lines after it, up to the image's
    count, in the library."""
    if not data.startswith(b"/* XPM */"):
        return None
    f = _Lines(data, 9)
    while True:
        line = f.readline()
        if not line:
            return None
        m = _XPM_HEAD.match(line)
        if m:
            break
    try:
        w, h, ncolours, bpp = (int(g) for g in m.groups())
    except ValueError as e:
        raise ValueError(f"XPM values line: {e} (Pillow raises too)") from e
    palette, transparency = {}, b""
    for _ in range(ncolours):
        line = f.readline().rstrip()
        c, words = line[1:bpp + 1], line[bpp + 1:-2].split()
        for i in range(0, len(words), 2):
            if words[i] == b"c":
                if i + 1 >= len(words):
                    return None
                rgb = words[i + 1]
                if rgb == b"None":
                    transparency = c
                elif rgb.startswith(b"#"):
                    try:
                        v = int(rgb[1:], 16)
                    except ValueError as e:
                        raise ValueError(f"XPM colour {rgb!r} (Pillow raises too)") from e
                    palette[c] = bytes(((v >> 16) & 255, (v >> 8) & 255, v & 255))
                else:
                    raise ValueError("cannot read this XPM file: a colour that is not #rrggbb (Pillow raises too)")
                break
        else:
            raise ValueError("cannot read this XPM file: a colour without its c key (Pillow raises too)")
    if w <= 0 or h <= 0:
        return None
    keys = list(palette)
    mode = "RGB" if ncolours > 256 else "P"
    # XpmDecoder: lines until the image has its keys, "/* pixels */" once
    # skipped, each line's text between its first and last quote.
    texts, count, header = [], 0, False
    while count < w * h:
        line = f.readline()
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not header:
            header = True
            continue
        text = b'"'.join(line.split(b'"')[1:-1])
        if bpp == 0:
            raise ValueError("XPM of 0 characters a pixel (Pillow raises too)")
        texts.append(text)
        count += -(-len(text) // bpp) if bpp > 0 else 0
    pal = b"".join(palette.values()) if mode == "RGB" else _palette(b"".join(palette.values()), transparency)
    args = (bpp, len(keys), len(texts), *map(len, keys), *map(len, texts))
    return _Tile(XPM, mode, "", 0, w, h, args, pal, b"".join(keys) + b"".join(texts))


_IM_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_IM_TAGS = ("Comment", "Date", "Digitalization equipment", "File size (no of images)", "Lut", "Name", "Scale (x,y)",
            "Image size (x*y)", "Image type")
# ImImagePlugin.OPEN: "Image type" -> (mode, rawmode).
_IM_OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
    "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"), "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
    "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"), "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"), "RYB3 image": ("RGB", "RYB;T"),
    "LA image": ("LA", "LA;L"), "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"),
    "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"), "YCC image": ("YCbCr", "YCbCr;L"),
}
_IM_OPEN.update({f"L{sep}{i} image": ("F", f"F;{i}") for i in ("8", "8S", "16", "16S", "32", "32F") for sep in " *"})
_IM_OPEN.update({f"L{sep}{i} image": (f"I;{i}", f"I;{i}") for i in ("16", "16L", "16B") for sep in " *"})
_IM_OPEN.update({"L 32S image": ("I", "I;32S"), "L*32S image": ("I", "I;32S")})
_IM_OPEN.update({f"L*{i} image": ("F", f"F;{i}") for i in range(2, 33)})


def _im_number(s: str):
    try:
        return int(s)
    except ValueError:
        try:
            return float(s)
        except ValueError as e:
            raise ValueError(f"IM header value {s!r} (Pillow raises too)") from e


def _im_open(data: bytes) -> _Tile | None:
    """ImImagePlugin: "Key: value" lines up to a NUL or ^Z, then ^Z; a Lut
    (768 bytes, planar) makes a colour-mapped L or P file "P" (LA: "PA"),
    a grey one is ignored; raw data from the bottom up in the mode's
    rawmode (the RGB3 layouts one plane a band; an "L*n" type of other
    than 8, 16 or 32 bits through the bit decoder)."""
    if b"\n" not in data[:100]:
        return None
    info = {"Image type": "L", "Image size (x*y)": (512, 512)}
    rawmode, pos, n = "L", 0, 0
    while True:
        s = data[pos:pos + 1]
        pos += len(s)
        if s == b"\r":
            continue
        if not s or s == b"\0" or s == b"\x1a":
            break
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        s, pos = s + data[pos:end], end
        if len(s) > 100:
            return None
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = _IM_SPLIT.match(s)
        if not m:
            return None
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in ("File size (no of images)", "Scale (x,y)", "Image size (x*y)"):
            v = tuple(map(_im_number, v.replace("*", ",").split(",")))
            v = v[0] if len(v) == 1 else v
        elif k == "Image type" and v in _IM_OPEN:
            v, rawmode = _IM_OPEN[v]
        info[k] = v
        n += k in _IM_TAGS
    if not n:
        return None
    size, mode = info["Image size (x*y)"], info["Image type"]
    while s and not s.startswith(b"\x1a"):
        s = data[pos:pos + 1]
        pos += len(s)
    if not s:
        return None
    pal = b""
    if "Lut" in info:
        lut = data[pos:pos + 768]
        pos += len(lut)
        if len(lut) < 768:
            return None
        grey = all(lut[i] == lut[i + 256] == lut[i + 512] for i in range(256))
        if mode in ("L", "LA", "P", "PA") and not grey:
            mode, rawmode = ("P", "P") if mode in ("L", "P") else ("PA", "PA;L")
            pal = _palette(_planar_palette(lut))
    if not isinstance(size, tuple) or not mode or size[0] <= 0 or size[1] <= 0:
        return None
    if len(size) != 2 or not all(isinstance(x, int) for x in size):
        raise ValueError(f"IM image size {size} (Pillow raises too)")
    if mode == "P" and not pal:
        pal = _palette(b"")
    w, h = size
    if rawmode.startswith("F;") and rawmode[2:].isdigit() and int(rawmode[2:]) not in (8, 16, 32):
        return _Tile(BIT, mode, "", pos, w, h, (int(rawmode[2:]),))
    if rawmode in ("RGB;T", "RYB;T"):
        return _Tile(RAW, mode, "G,R,B", pos, w, h, (0, -1, w * h))
    return _Tile(RAW, mode, rawmode, pos, w, h, (0, -1), pal)


def _spider_header(t: tuple) -> int:
    """SpiderImagePlugin.isSpiderHeader: the header's length, 0 if not."""
    h = (99,) + t
    try:
        if any(h[i] != int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
            return 0
    except (ValueError, OverflowError):
        return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22) or int(h[22]) != int(h[13]) * int(h[23]):
        return 0
    return int(h[22])


def _spider_open(data: bytes) -> _Tile | None:
    """SpiderImagePlugin: 27 float32 header values, big-endian tried
    first; a 2D image (iform 1) of float32 samples after the header (a
    stack's first image after two)."""
    if len(data) < 108:
        return None
    for order in ">", "<":
        t = struct.unpack(order + "27f", data[:108])
        hdrlen = _spider_header(t)
        if hdrlen:
            break
    else:
        return None
    h = (99,) + t
    if int(h[5]) != 1:
        return None
    try:
        istack, imgnumber = int(h[24]), int(h[27])
        if istack > 0 and imgnumber == 0:
            int(h[26])
    except (ValueError, OverflowError) as e:
        raise ValueError(f"SPIDER header value: {e} (Pillow raises too)") from e
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        offset = hdrlen * 2
    elif istack == 0 and imgnumber > 0:
        raise ValueError("SPIDER image inside a stack, opened alone (Pillow raises AttributeError)")
    else:
        return None
    return _sized(_Tile(RAW, "F", "F;32BF" if order == ">" else "F;32F", offset, int(h[12]), int(h[2]), (0, 1)))


def _fits_open(data: bytes) -> _Tile | None:
    """FitsImagePlugin: 80-byte cards in 2880-byte units; the first unit
    whose NAXIS gives a size (or a GZIP_1 tile-compressed BINTABLE's
    ZNAXIS) is the image: BITPIX 8 "L", 16 "I;16", 32 "I", -32 and -64
    "F", each read raw in that mode's own rawmode (so big-endian samples
    come out byte-swapped, and -64 as float32 halves) from the bottom up."""
    pos, headers, in_progress, found = 0, {}, False, None

    def integer(key):
        try:
            return int(headers[key])
        except ValueError as e:
            raise ValueError(f"FITS card {key!r}: {e} (Pillow raises too)") from e

    def size_of(prefix):
        naxis = integer(prefix + b"NAXIS")
        if naxis == 0:
            return None
        return (1, integer(prefix + b"NAXIS1")) if naxis == 1 else (integer(prefix + b"NAXIS1"),
                                                                    integer(prefix + b"NAXIS2"))

    def parse():
        prefix, gz, offset = b"", False, 0
        if headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T" and \
                headers[b"ZCMPTYPE"] == b"'GZIP_1  '":
            plain = size_of(b"") or (0, 0)
            offset = plain[0] * plain[1] * (integer(b"BITPIX") // 8)
            prefix, gz = b"Z", True
        size = size_of(prefix)
        if not size:
            return None
        bits = integer(prefix + b"BITPIX")
        return gz, offset, size, bits, {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}.get(bits, "")

    try:
        while True:
            header = data[pos:pos + 80]
            pos += len(header)
            if not header:
                raise ValueError("Truncated FITS file (Pillow raises too)")
            keyword = header[:8].strip()
            if keyword in (b"SIMPLE", b"XTENSION"):
                in_progress = True
            elif headers and not in_progress:
                break
            elif keyword == b"END":
                pos = math.ceil(pos / 2880) * 2880
                if not found:
                    found = parse()
                in_progress = False
                continue
            if found:
                continue
            value = header[8:].split(b"/")[0].strip()
            if value.startswith(b"="):
                value = value[1:].strip()
            if not headers and (not keyword.startswith(b"SIMPLE") or value != b"T"):
                return None
            headers[keyword] = value
    except KeyError:
        return None
    if not found:
        raise ValueError("FITS file without image data (Pillow raises too)")
    gz, offset, (w, h), bits, mode = found
    return _sized(_Tile(FITS_GZIP if gz else RAW, mode, mode, offset + pos - 80, w, h, (bits,) if gz else (0, -1, 0, bits)))


def _fits_gzip(data: bytes, tile: _Tile) -> _Tile:
    """FitsGzipDecoder: the heap inflated as one gzip stream, each pixel
    the last min(BITPIX / 8, 4) bytes of a 4-byte word, rows bottom up,
    read raw in the mode's rawmode."""
    (bits,) = tile.args
    try:
        value = gzip.decompress(data[tile.offset:])
    except (OSError, EOFError, zlib.error) as e:
        raise ValueError(f"FITS GZIP_1 data does not inflate: {e} (Pillow raises too)") from e
    nb = min(bits // 8, 4)
    w, h = tile.w, tile.h
    if nb <= 0 or len(value) < 4 * w * h:
        raise ValueError("not enough image data (FITS GZIP_1; Pillow raises too)")
    words = np.frombuffer(value, np.uint8, 4 * w * h).reshape(h, w, 4)[::-1, :, 4 - nb:]
    return _Tile(RAW, tile.mode, tile.mode, 0, w, h, (0, 1), aux=np.ascontiguousarray(words).tobytes())


def _gbr_open(data: bytes) -> _Tile | None:
    """GbrImagePlugin: a big-endian header (size, version 1 or 2, width,
    height, depth 1 "L" or 4 "RGBA"; version 2's "GIMP" and spacing), the
    comment, then the raw pixels."""
    if len(data) < 8:
        return None
    size, version = struct.unpack(">II", data[:8])
    if size < 20 or version not in (1, 2) or len(data) < 20:
        return None
    w, h, depth = struct.unpack(">3I", data[8:20])
    if w == 0 or h == 0 or depth not in (1, 4):
        return None
    if version == 2:
        if data[20:24] != b"GIMP" or len(data) < 28:
            return None
        comment = size - 28
        pos = 28
    else:
        comment, pos = size - 20, 20
    pos = len(data) if comment < 0 else min(len(data), pos + comment)
    return _Tile(RAW, "L" if depth == 1 else "RGBA", "L" if depth == 1 else "RGBA", pos, w, h, (0, 1))


_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def _imt_open(data: bytes) -> _Tile | None:
    """ImtImagePlugin: "key value" lines ("width", "height", "pixel n8"),
    ended by a form feed; "L" raw after it (no form feed: no tile, and
    Pillow's load raises)."""
    buffer, pos = data[:100], min(len(data), 100)
    if b"\n" not in buffer:
        return None
    w = h = 0
    mode, offset = "", None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = data[pos:pos + 1]
            pos += len(s)
        if not s:
            break
        if s == b"\x0c":
            offset = pos - len(buffer)
            break
        if b"\n" not in buffer:
            more = data[pos:pos + 100]
            buffer, pos = buffer + more, pos + len(more)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                w = int(v)
            elif k == b"height":
                h = int(v)
        except ValueError as e:
            raise ValueError(f"IM Tools header value {v!r} (Pillow raises too)") from e
        if k == b"pixel" and v == b"n8":
            mode = "L"
    return _sized(_Tile(RAW if offset is not None else NO_DATA, mode, "L", offset or 0, w, h, (0, 1)))


def _mcidas_open(data: bytes) -> _Tile | None:
    """McIdasImagePlugin: a 256-byte area directory of big-endian words;
    "L", "I;16B" or "I" (rawmode "I;32B") raw, rows `stride` apart."""
    s = data[:256]
    if not s.startswith(b"\0\0\0\0\0\0\0\4") or len(s) != 256:
        return None
    w = (0, *struct.unpack("!64i", s))
    modes = {1: ("L", "L"), 2: ("I;16B", "I;16B"), 4: ("I", "I;32B")}
    if w[11] not in modes:
        return None
    mode, rawmode = modes[w[11]]
    stride = w[15] + w[10] * w[11] * w[14]
    return _sized(_Tile(RAW, mode, rawmode, w[34] + w[15], w[10], w[9], (stride, 1)))


def _pixar_open(data: bytes) -> _Tile | None:
    """PixarImagePlugin: "RGB" raw at 1024 for channel/depth (14, 2); any
    other pair has no mode in Pillow."""
    if not data.startswith(b"\200\350\000\000") or len(data) < 428:
        return None
    h, w = struct.unpack("<HH", data[416:420])
    mode = "RGB" if struct.unpack("<HH", data[424:428]) == (14, 2) else ""
    return _sized(_Tile(RAW, mode, "RGB", 1024, w, h, (0, 1)))


# XVThumbImagePlugin.PALETTE: 3-3-2 bits of red, green and blue.
_XV_PALETTE = bytes(v for r in range(8) for g in range(8) for b in range(4)
                    for v in ((r * 255) // 7, (g * 255) // 7, (b * 255) // 3))


def _xvthumb_open(data: bytes) -> _Tile | None:
    """XVThumbImagePlugin: "P7 332", comment lines, "width height ...",
    then "P" raw through the 3-3-2 palette."""
    if not data.startswith(b"P7 332"):
        return None
    f = _Lines(data, 6)
    f.readline()
    while True:
        s = f.readline()
        if not s:
            return None
        if s[0] != 35:
            break
    try:
        w, h = (int(x) for x in s.strip().split(maxsplit=2)[:2])
    except ValueError as e:
        raise ValueError(f"XV thumbnail size line {s!r} (Pillow raises too)") from e
    return _sized(_Tile(RAW, "P", "P", f.pos, w, h, (0, 1), _palette(_XV_PALETTE)))


def _fli_open(data: bytes) -> _Tile | None:
    """FliImagePlugin: the 128-byte header (its zero fields checked), the
    palette of the first frame's first COLOR chunk (256-level, or 64-level
    shifted by 2 and wrapped to a byte; a grey ramp where none), the first
    frame's chunks from byte 128 (raster_decode.cpp)."""
    s = data[:128]
    if not (len(s) >= 16 and struct.unpack("<H", s[4:6])[0] in (0xAF11, 0xAF12)
            and struct.unpack("<H", s[14:16])[0] in (0, 3)):
        return None
    if s[20:22] != b"\0\0" or s[42:80] != bytes(38) or s[88:] != bytes(40):
        return None
    w, h = struct.unpack("<HH", s[8:12])
    palette = [(a, a, a) for a in range(256)]
    pos = 128

    def read(k):
        nonlocal pos
        if pos < 0:
            raise ValueError("FLI chunk before the file's start (Pillow: invalid seek)")
        out = data[pos:pos + max(k, 0)]
        pos += len(out)
        return out

    try:
        s = read(16)
        if struct.unpack_from("<H", s, 4)[0] == 0xF100:
            pos = 128 + struct.unpack_from("<i", s)[0]
            s = read(16)
        if struct.unpack_from("<H", s, 4)[0] == 0xF1FA:
            size = None
            for _ in range(struct.unpack_from("<H", s, 6)[0]):
                if size is not None:
                    pos += size - 6
                s = read(6)
                kind = struct.unpack_from("<H", s, 4)[0]
                if kind in (4, 11):
                    shift, i = 2 if kind == 11 else 0, 0
                    for _ in range(struct.unpack("<H", read(2))[0]):
                        e = read(2)
                        i, k = i + e[0], e[1] or 256
                        rgb = read(3 * k)
                        for j in range(0, len(rgb), 3):
                            palette[i] = tuple((v << shift) & 255 for v in (rgb[j], rgb[j + 1], rgb[j + 2]))
                            i += 1
                    break
                size = struct.unpack_from("<i", s)[0]
                if not size:
                    break
        if len(data) < 132:         # the first frame's size (Pillow: EOFError or struct.error)
            return None
    except (struct.error, IndexError):
        return None
    return _sized(_Tile(FLI, "P", "", 128, w, h, (), _palette(bytes(v for e in palette for v in e))))


def _pcd_open(data: bytes) -> _Tile | None:
    """PcdImagePlugin: "PCD_" at 2048, the orientation in byte 3586; the
    768 x 512 base image from 96 * 2048 (raster_decode.cpp), turned 90
    (orientation 1) or 270 degrees (3) counter-clockwise after."""
    s = data[2048:2048 + 1539]
    if not s.startswith(b"PCD_") or len(s) < 1539:
        return None
    return _Tile(PCD, "RGB", "", 96 * 2048, 768, 512, (s[1538] & 3,))


# IptcImagePlugin.COMPRESSION
_IPTC_COMPRESSION = {1: "raw", 5: "jpeg"}


def _iptc_field(data: bytes, pos: int):
    """IptcImageFile.field at `pos`: ((record, dataset), size, next pos),
    (None, 0, pos) at the end; None where Pillow's opener goes on."""
    s = data[pos:pos + 5]
    pos += len(s)
    if not s.strip(b"\0"):
        return None, 0, pos
    if len(s) < 4 or s[0] != 0x1C or s[1] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
        return None
    size = s[3]
    if size > 132:
        raise ValueError("illegal field length in IPTC/NAA file (Pillow raises too)")
    if size == 128:
        size = 0
    elif size > 128:
        ext = data[pos:pos + size - 128]
        pos += len(ext)
        size = struct.unpack(">I", (b"\0\0\0\0" + ext)[-4:])[0]
    elif len(s) < 5:
        return None
    else:
        size = struct.unpack(">H", s[3:5])[0]
    return (s[1], s[2]), size, pos


def _iptc_open(data: bytes):
    """IptcImagePlugin: dataset records up to the first image record (8,
    10); the mode from (3, 60) (1 layer "L"; 3 "RGB", 4 "CMYK", one band
    of them, (3, 65), filled), the size from (3, 20) and (3, 30), the
    compression from (3, 120): (tag, offset, mode, band, compression, w,
    h), None where Pillow's opener goes on."""
    info, pos = {}, 0
    while True:
        offset = pos
        field = _iptc_field(data, pos)
        if field is None:
            return None
        tag, size, pos = field
        if not tag or tag == (8, 10):
            break
        value = data[pos:pos + size] if size else None
        pos += len(value or b"")
        info[tag] = [info[tag], value] if tag in info and not isinstance(info[tag], list) else \
            info[tag] + [value] if tag in info else value

    def integer(key):
        v = info[key]
        return struct.unpack(">I", (b"\0\0\0\0" + v)[-4:])[0]

    try:
        layers, component = info[(3, 60)][0], info[(3, 60)][1]
        mode, band = "", None
        if layers == 1 and not component:
            mode = "L"
        else:
            if layers == 3 and component:
                mode = "RGB"
            elif layers == 4 and component:
                mode = "CMYK"
            band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
        w, h = integer((3, 20)), integer((3, 30))
    except (KeyError, IndexError, TypeError):
        return None
    try:
        compression = _IPTC_COMPRESSION[integer((3, 120))]
    except (KeyError, TypeError) as e:
        if isinstance(e, TypeError):
            return None
        raise ValueError("Unknown IPTC image compression (Pillow raises too)") from e
    if not mode or w <= 0 or h <= 0:
        return None
    return tag, offset, mode, band, compression, w, h


class IptcImage(NamedTuple):
    """An IPTC file as Pillow holds it: the mode and size of its records,
    and the image its data decodes to (a layer merged into its band, the
    other bands 0) with that image's pixels (as ``decode_image`` gives
    them) and mode, at the data's own size."""
    mode: str
    w: int
    h: int
    px: np.ndarray
    inner: str


def iptc_image(data: bytes, stored_cmyk: bool = False) -> IptcImage:
    """IptcImageFile.load: the image records' data joined (after a P5
    header of the records' size for raw data) and opened as an image of
    its own, which Pillow keeps under the records' mode and size; a layer
    of a colour image merged into its band (Image.merge: the layer must be
    grey).  `stored_cmyk`: a CMYK JPEG's pixels as Pillow stores them
    (inverted, not converted to RGBA)."""
    lib = load_library()
    opened = _iptc_open(data)
    if opened is None:
        raise ValueError("IPTC file that Pillow's opener does not take")
    tag, pos, mode, band, compression, w, h = opened
    if tag != (8, 10):
        raise ValueError("IPTC file without image data (Pillow: cannot load this image)")
    parts = [b"P5\n%d %d\n255\n" % (w, h)] if compression == "raw" else []
    while True:
        field = _iptc_field(data, pos)
        if field is None:
            raise ValueError("invalid IPTC/NAA file (Pillow raises too)")
        tag, size, pos = field
        if tag != (8, 10):
            break
        parts.append(data[pos:pos + size])
        pos += len(parts[-1])
    stream = b"".join(parts)
    if stored_cmyk and sniff(stream) == "JPEG":
        px, inner = _collect(lib, lib.imgd_decode, stream, len(stream), JPEG_CMYK_STORED)
    else:
        px, inner = decode_image(stream)
    if band is None:
        return IptcImage("L", w, h, px, inner)
    if inner != "L":
        raise ValueError("IPTC image layer that is not grey (Pillow: images do not match)")
    if not -len(mode) <= band < len(mode):
        raise ValueError(f"IPTC image layer {band} of a {mode} image (Pillow raises too)")
    planes = [np.zeros(px.shape[:2], np.uint8) for _ in mode]
    planes[band] = px[..., 0]
    inter = np.ascontiguousarray(np.stack(planes, -1))
    merged, merged_mode = _raster_tile(lib, _Tile(RAW, mode, mode, 0, inter.shape[1], inter.shape[0], (0, 1),
                                                  aux=inter.tobytes()))
    return IptcImage(mode, w, h, merged, merged_mode)


def _decode_iptc(data: bytes) -> tuple[np.ndarray, str]:
    """The image an IPTC file holds, under its records' mode (which may
    not be that image's: ``obj_loader.load_texture_file`` converts it as
    Pillow does)."""
    held = iptc_image(data)
    return held.px, held.mode


_RASTER_OPEN = {"PCX": _pcx_open, "DCX": _dcx_open, "FITS": _fits_open, "FLI": _fli_open, "GBR": _gbr_open,
                "IM": _im_open, "IMT": _imt_open, "MCIDAS": _mcidas_open, "MSP": _msp_open, "PCD": _pcd_open,
                "PIXAR": _pixar_open, "QOI": _qoi_open, "SGI": _sgi_open, "SPIDER": _spider_open, "SUN": _sun_open,
                "XBM": _xbm_open, "XPM": _xpm_open, "XVTHUMB": _xvthumb_open}



# --------------------------------------------------- GPU texture containers
#
# DdsImagePlugin, FtexImagePlugin and BlpImagePlugin: each `_X_open(data)`
# reads the header as the plugin's _open does, None where Image.open goes
# on to the next opener (a short header: struct.error; no size: the
# ImageFile check) and ValueError where it stops (OSError,
# NotImplementedError, AssertionError, ValueError there).  The pixels come
# from bcn_decode.cpp (blocks, DDS's channel masks, BLP's own DXT) or from
# raster_decode.cpp's raw tiles.

_DDPF_ALPHAPIXELS, _DDPF_FOURCC, _DDPF_PALETTEINDEXED8, _DDPF_RGB, _DDPF_LUMINANCE = 0x1, 0x4, 0x20, 0x40, 0x20000
# FourCC -> (mode, the bcn decoder's format, signed).
_DDS_FOURCC = {b"DXT1": ("RGBA", 1, 0), b"DXT3": ("RGBA", 2, 0), b"DXT5": ("RGBA", 3, 0), b"BC4U": ("L", 4, 0),
               b"ATI1": ("L", 4, 0), b"BC5S": ("RGB", 5, 1), b"BC5U": ("RGB", 5, 0), b"ATI2": ("RGB", 5, 0)}
# The DX10 header's DXGI format -> the same (0: raw RGBA); the sRGB ones
# only set Pillow's info["gamma"].
_DXGI = {70: ("RGBA", 1, 0), 71: ("RGBA", 1, 0), 73: ("RGBA", 2, 0), 74: ("RGBA", 2, 0), 76: ("RGBA", 3, 0),
         77: ("RGBA", 3, 0), 79: ("L", 4, 0), 80: ("L", 4, 0), 82: ("RGB", 5, 0), 83: ("RGB", 5, 0),
         84: ("RGB", 5, 1), 95: ("RGB", 6, 0), 96: ("RGB", 6, 1), 97: ("RGBA", 7, 0), 98: ("RGBA", 7, 0),
         99: ("RGBA", 7, 0), 27: ("RGBA", 0, 0), 28: ("RGBA", 0, 0), 29: ("RGBA", 0, 0)}


class _Texture(NamedTuple):
    """What a texture container's _open leaves: Pillow's mode and size,
    the decoder ("bcn", "masked", "raw", "blp1", "blp2") and its
    arguments, and the data's offset."""
    decoder: str
    mode: str
    w: int
    h: int
    offset: int
    args: tuple = ()


def _texture_sized(t: _Texture) -> _Texture | None:
    """ImageFile's check after _open (a size of at least 1x1), then
    Image.open's decompression-bomb check, which stops it."""
    if t.w <= 0 or t.h <= 0:
        return None
    if t.w * t.h > MAX_PIXELS:
        raise ValueError(f"{t.w}x{t.h} image exceeds {MAX_PIXELS} pixels (Pillow: DecompressionBombError)")
    return t


def _dds_open(data: bytes) -> _Texture | None:
    """DdsImageFile._open: the 124-byte header (another size, or fewer
    bytes, raise OSError), then by pixel-format flags RGB (masks; "RGBA"
    with ALPHAPIXELS), LUMINANCE ("L" at 8 bits, "LA" at 16 with alpha),
    PALETTEINDEXED8 ("P", a 1024-byte RGBA palette after the header) or
    FOURCC (the BCn codes; DX10's extension of 20 bytes, its DXGI
    format); anything else raises NotImplementedError.  Mips, cubes and
    arrays are ignored: the first surface's top level is read."""
    if not data.startswith(b"DDS ") or len(data) < 8:
        return None
    (size,) = struct.unpack("<I", data[4:8])
    if size != 124:
        raise ValueError(f"Unsupported DDS header size {size} (Pillow raises too)")
    if len(data) < 128:
        raise ValueError(f"Incomplete DDS header: {len(data) - 8} bytes (Pillow raises too)")
    h, w = struct.unpack("<II", data[12:20])
    pfflags, fourcc, bitcount = struct.unpack("<I4sI", data[80:92])
    if pfflags & _DDPF_RGB:
        n = 4 if pfflags & _DDPF_ALPHAPIXELS else 3
        masks = struct.unpack(f"<{n}I", data[92:92 + 4 * n])
        return _texture_sized(_Texture("masked", "RGBA" if n == 4 else "RGB", w, h, 128, (bitcount, masks)))
    if pfflags & _DDPF_LUMINANCE:
        if bitcount == 8:
            mode = "L"
        elif bitcount == 16 and pfflags & _DDPF_ALPHAPIXELS:
            mode = "LA"
        else:
            raise ValueError(f"Unsupported DDS luminance bitcount {bitcount} for flags {pfflags} (Pillow raises too)")
        return _texture_sized(_Texture("raw", mode, w, h, 128))
    if pfflags & _DDPF_PALETTEINDEXED8:
        return _texture_sized(_Texture("raw", "P", w, h, 128 + 1024, (data[128:128 + 1024],)))
    if not pfflags & _DDPF_FOURCC:
        raise ValueError(f"Unknown DDS pixel format flags {pfflags} (Pillow: NotImplementedError)")
    if fourcc == b"DX10":
        if len(data) < 132:
            return None                   # struct.error: Image.open goes on
        (dxgi,) = struct.unpack("<I", data[128:132])
        if dxgi not in _DXGI:
            raise ValueError(f"Unimplemented DDS DXGI format {dxgi} (Pillow: NotImplementedError)")
        mode, n, sign = _DXGI[dxgi]
        if not n:
            return _texture_sized(_Texture("raw", mode, w, h, 148))
        return _texture_sized(_Texture("bcn", mode, w, h, 148, (n, sign)))
    if fourcc not in _DDS_FOURCC:
        raise ValueError(f"Unimplemented DDS pixel format {fourcc!r} (Pillow: NotImplementedError)")
    mode, n, sign = _DDS_FOURCC[fourcc]
    return _texture_sized(_Texture("bcn", mode, w, h, 128, (n, sign)))


def _ftex_open(data: bytes) -> _Texture | None:
    """FtexImageFile._open: version, size, mipmap and format counts (a
    format count other than 1 fails its assert), the format and its
    offset, the top mipmap's size there and its bytes (-1: the rest of the
    file; any other negative size raises): DXT1 "RGBA" through the bcn decoder, or raw
    "RGB"; any other format raises ValueError."""
    if not data.startswith(b"FTEX") or len(data) < 24:
        return None
    w, h, _, format_count = struct.unpack("<4i", data[8:24])
    if format_count != 1:
        raise ValueError(f"FTEX file of {format_count} formats (Pillow: AssertionError)")
    if len(data) < 32:
        return None
    fmt, where = struct.unpack("<2i", data[24:32])
    if where < 0:
        raise ValueError("FTEX format offset before the file's start (Pillow: invalid seek)")
    if where + 4 > len(data):
        return None
    (size,) = struct.unpack("<i", data[where:where + 4])
    if size < -1:
        raise ValueError(f"FTEX mipmap size {size} (Pillow: read length must be non-negative or -1)")
    end = len(data) if size == -1 else where + 4 + size
    if fmt not in (0, 1):
        raise ValueError(f"Invalid FTEX texture compression format {fmt} (Pillow raises too)")
    return _texture_sized(_Texture("bcn" if fmt == 0 else "raw", "RGBA" if fmt == 0 else "RGB", w, h, where + 4,
                                   (1, 0, end) if fmt == 0 else (end,)))


def _blp_open(data: bytes) -> _Texture | None:
    """BlpImageFile._open: BLP1 (compression, alpha, size, encoding) or
    BLP2 (compression, encoding, alpha, alpha encoding, size); "RGBA"
    where the alpha field is set, else "RGB".  Its decoder then reads the
    16 mip offsets and lengths."""
    if data.startswith(b"BLP1") and len(data) >= 24:
        compression, alpha, w, h, encoding = struct.unpack("<iIIIi", data[4:24])
        return _texture_sized(_Texture("blp1", "RGBA" if alpha else "RGB", w, h, 28, (compression, encoding)))
    if data.startswith(b"BLP2") and len(data) >= 20:
        compression, encoding, alpha, alpha_encoding = struct.unpack("<ibbb", data[4:11])
        w, h = struct.unpack("<II", data[12:20])
        return _texture_sized(_Texture("blp2", "RGBA" if alpha else "RGB", w, h, 20,
                                       (compression, encoding, alpha_encoding)))
    return None


def _bcn(lib, data: bytes, offset: int, n: int, sign: int, w: int, h: int, end: int | None = None) -> np.ndarray:
    """Pillow's bcn decoder of format `n` over data[offset:end]."""
    out = np.empty((h, w, 1 if n == 4 else 3 if n in (5, 6) else 4), np.uint8)
    src = data if end is None else data[:end]
    err = ctypes.create_string_buffer(512)
    if lib.imgb_bcn(src, len(src), offset, n, sign, w, h, out.ctypes.data, err, len(err)):
        raise ValueError(err.value.decode(errors="replace"))
    return out


def _raw_pixels(lib, mode: str, data: bytes, offset: int, w: int, h: int, pal: bytes = b"") -> tuple[np.ndarray, str]:
    """A raw tile in the mode's own rawmode, through raster_decode.cpp
    (short data raises, as Pillow's "image file is truncated")."""
    return _raster_tile(lib, _Tile(RAW, mode, mode, offset, w, h, (0, 1), pal), data)


def _decode_dds(lib, data: bytes) -> tuple[np.ndarray, str]:
    t = _dds_open(data)
    if t is None:
        raise ValueError("DDS header that Pillow's opener does not take")
    if t.decoder == "bcn":
        return _bcn(lib, data, t.offset, *t.args, t.w, t.h), t.mode
    if t.decoder == "masked":
        bitcount, masks = t.args
        out = np.empty((t.h, t.w, len(masks)), np.uint8)
        lib.imgb_masked(data, len(data), t.offset, bitcount // 8, (ctypes.c_uint32 * 4)(*masks), len(masks), t.w, t.h,
                        out.ctypes.data)
        return out, t.mode
    pal = t.args[0] + bytes(1024 - len(t.args[0])) if t.mode == "P" else b""
    return _raw_pixels(lib, t.mode, data, t.offset, t.w, t.h, pal)


def _decode_ftex(lib, data: bytes) -> tuple[np.ndarray, str]:
    t = _ftex_open(data)
    if t is None:
        raise ValueError("FTEX header that Pillow's opener does not take")
    if t.decoder == "bcn":
        n, sign, end = t.args
        return _bcn(lib, data, t.offset, n, sign, t.w, t.h, end), t.mode
    return _raw_pixels(lib, "RGB", data[:t.args[0]], t.offset, t.w, t.h)


def _need(data: bytes, at: int, n: int) -> bytes:
    """ImageFile._safe_read: `n` bytes at `at` or OSError ("Truncated File
    Read"), raised as ValueError."""
    if n <= 0:
        return b""
    if at + n > len(data):
        raise ValueError("Truncated File Read (BLP; Pillow raises too)")
    return data[at:at + n]


def _as_raw(stream, mode: str, w: int, h: int, rawmode: str = "") -> np.ndarray:
    """PyDecoder.set_as_raw: the bytes (or a contiguous uint8 array's)
    read as a w x h image of `mode` in `rawmode` ("BGR": 3 bytes a pixel
    swapped, alpha 255; default the mode's own), extra bytes ignored."""
    flat = np.frombuffer(stream, np.uint8)
    c = 3 if rawmode == "BGR" else len(mode)
    if flat.size < w * h * c:
        raise ValueError("not enough image data (BLP; Pillow raises too)")
    px = flat[:w * h * c].reshape(h, w, c)
    if rawmode == "BGR":
        px = px[..., ::-1]
        if mode == "RGBA":
            px = np.concatenate([px, np.full((h, w, 1), 255, np.uint8)], axis=2)
    return np.ascontiguousarray(px)


def _blp_bgra(palette: np.ndarray, indices: bytes, mode: str, w: int, h: int) -> np.ndarray:
    """_BLPBaseDecoder._read_bgra then set_as_raw: each index's palette
    entry (B, G, R, A in the file) as R, G, B (and its A for "RGBA")."""
    rgba = palette[np.frombuffer(indices, np.uint8)][:, [2, 1, 0, 3]]
    return _as_raw(np.ascontiguousarray(rgba[:, :len(mode)]), mode, w, h)


def _decode_blp(lib, data: bytes) -> tuple[np.ndarray, str]:
    """BLP1Decoder and BLP2Decoder: the mip offsets and lengths, then BLP1's
    JPEG (its shared header joined to mip 0 after a skip to its offset, read
    as libjpeg reads CMYK for this plugin, converted to RGB and read back
    as "BGR") or palette (encodings 4 and 5: the indices right after the
    palette), BLP2's palette (read whatever the encoding) then at mip 0's
    offset its indices or its DXT1/3/5 blocks (BlpImagePlugin's Python
    decoder)."""
    t = _blp_open(data)
    if t is None:
        raise ValueError("BLP header that Pillow's opener does not take")
    w, h, mode = t.w, t.h, t.mode
    offsets = struct.unpack("<16I", _need(data, t.offset, 64))
    lengths = struct.unpack("<16I", _need(data, t.offset + 64, 64))
    pos = t.offset + 128
    if t.decoder == "blp1":
        compression, encoding = t.args
        if compression == 0:
            (size,) = struct.unpack("<I", _need(data, pos, 4))
            header = _need(data, pos + 4, size)
            pos += 4 + size
            _need(data, pos, offsets[0] - pos)      # "What IS this?": a skip to mip 0, none if it lies before
            pos = max(pos, offsets[0])
            stream = header + _need(data, pos, lengths[0])
            if not stream.startswith(b"\xff\xd8\xff"):
                raise ValueError("BLP1 JPEG data is not a JPEG file (Pillow raises too)")
            px, inner = _collect(lib, lib.imgd_decode, stream, len(stream), JPEG_AS_BLP)
            rgb = np.repeat(px, 3, axis=2) if inner == "L" else px[..., :3]
            return _as_raw(np.ascontiguousarray(rgb), mode, w, h, "BGR"), mode
        if compression == 1 and encoding in (4, 5):
            palette = np.frombuffer(_need(data, pos, 1024), np.uint8).reshape(256, 4)
            return _blp_bgra(palette, _need(data, pos + 1024, lengths[0]), mode, w, h), mode
        raise ValueError(f"Unsupported BLP1 compression {compression} / encoding {encoding} (Pillow raises too)")
    compression, encoding, alpha_encoding = t.args
    palette = np.frombuffer(_need(data, pos, 1024), np.uint8).reshape(256, 4)
    if compression != 1:
        raise ValueError(f"Unknown BLP compression {compression} (Pillow raises too)")
    if encoding == 1:
        return _blp_bgra(palette, _need(data, offsets[0], lengths[0]), mode, w, h), mode
    if encoding != 2:
        raise ValueError(f"Unknown BLP encoding {encoding} (Pillow raises too)")
    kind = {0: 1, 1: 2, 7: 3}.get(alpha_encoding)
    if kind is None:
        raise ValueError(f"Unsupported BLP alpha encoding {alpha_encoding} (Pillow raises too)")
    bw, bh = (w + 3) // 4, (h + 3) // 4
    c = 3 if kind == 1 and mode == "RGB" else 4
    out = np.empty((4 * bh, 4 * bw, c), np.uint8)
    err = ctypes.create_string_buffer(512)
    if lib.imgb_blp_dxt(data, len(data), offsets[0], kind, mode == "RGBA", w, h, out.ctypes.data, err, len(err)):
        raise ValueError(err.value.decode(errors="replace"))
    return _as_raw(out, mode, w, h), mode


_TEXTURES = {"DDS": _decode_dds, "FTEX": _decode_ftex, "BLP": _decode_blp}


def _raster(lib, kind: str, data: bytes, floats: bool = False):
    """A plain raster file through the library: (pixels, mode), or with
    `floats` an "F" image's float32 (H, W) samples (None for any other)."""
    tile = _RASTER_OPEN[kind](data)
    if tile is None:
        raise ValueError(f"{kind} header that Pillow's opener does not take")
    if tile.decoder == NO_DATA:
        raise ValueError(f"{kind} image without image data (Pillow: cannot load this image)")
    if tile.decoder == FITS_GZIP:
        tile = _fits_gzip(data, tile)
    out = _raster_tile(lib, tile, data, floats)
    if tile.decoder == PCD and tile.args[0] in (1, 3):    # Image.rotate(90 or 270, expand=True): a transpose
        out = np.ascontiguousarray(np.rot90(out[0], 1 if tile.args[0] == 1 else -1)), out[1]
    return out


def _raster_tile(lib, tile: _Tile, data: bytes = b"", floats: bool = False):
    """A tile through the library (a raw tile with `aux` reads that, not
    `data`): (pixels, mode), or with `floats` an "F" image's samples."""
    decoder, mode, rawmode, offset, w, h, args, pal, aux = tile
    src = aux if decoder == RAW and aux else data
    arr = (ctypes.c_int64 * max(1, len(args)))(*args)
    call = (lib.imgr_decode, src, len(src), decoder, mode.encode(), rawmode.encode(), offset, w, h, arr, len(args),
            pal, len(pal), aux, len(aux))
    with _result(lib, *call, free=lib.imgr_free) as handle:
        if floats:
            fl = lib.imgr_floats(handle)
            return np.ctypeslib.as_array(fl, shape=(h * w,)).reshape(h, w, 1).copy() if fl else None
        h, w, c = lib.imgr_height(handle), lib.imgr_width(handle), lib.imgr_channels(handle)
        pixels = np.ctypeslib.as_array(lib.imgr_pixels(handle), shape=(h * w * c,))
        return pixels.reshape(h, w, c).copy(), lib.imgr_mode(handle).decode()


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
    if kind == "IPTC":
        return _decode_iptc(data)
    if kind in _TEXTURES:
        return _TEXTURES[kind](lib, data)
    if kind in _RASTER:
        return _raster(lib, kind, data)
    return _collect(lib, lib.imgd_decode, data, len(data), _CODES[kind])


def decode_float_samples(data: bytes) -> np.ndarray | None:
    """The float32 (H, W, C) samples of a float TIFF (SampleFormat 3:
    16-, 32- or 64-bit samples, C 1, 3 or 4; strips or tiles, one plane
    or one a sample), of a PFM, of an IM "F" image or of a float FITS
    (BITPIX -32 or -64, its big-endian samples as stored, where Pillow
    reads them byte-swapped) (C 1), top row first: the linear radiance a
    sky holds, as the JAX package's imageio reads a TIFF (its bundled
    tifffile: as stored, no Orientation applied, cast to float32).  None
    for any other image, which ``decode_image`` reads."""
    data = bytes(data)
    kind = sniff(data)
    if kind == "FITS":
        tile = _fits_open(data)
        if tile is None or tile.mode != "F" or tile.decoder != RAW:
            return None
        offset, w, h = tile.offset, tile.w, tile.h
        dt = ">f8" if tile.args[3] == -64 else ">f4"
        need = w * h * np.dtype(dt).itemsize
        if offset + need > len(data):
            raise ValueError("image file is truncated (FITS data)")
        return np.frombuffer(data, dt, w * h, offset).reshape(h, w, 1)[::-1].astype(np.float32)
    if kind == "IM":
        return _raster(load_library(), kind, data, floats=True)
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
