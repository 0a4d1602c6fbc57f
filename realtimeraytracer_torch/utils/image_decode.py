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
does (the PNG signature, JPEG's SOI, ``BM``, ``GIF87a``/``GIF89a``, a PNM
magic, ``8BPS``, Pillow's six TIFF prefixes, ``RIFF....WEBP`` with a VP8,
VP8L or VP8X chunk first; TGA by a valid header when nothing else
matches), and returns uint8 (H, W, C) pixels with the Pillow
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
"RGB").  For PNG and TIFF's Deflate, this module
inflates with ``zlib``, and TIFF's LZMA it decodes with liblzma (the
library under Python's ``lzma``, driven as libtiff drives it): the
library calls ``_decompress`` back for each strip or tile; the library
does the rest.  Values that differ from Pillow's, as stb_image (the
reference's decoder) has them: 16-bit grey PNG, PGM and TIFF samples come
back as their high byte, 12-bit grey TIFF samples as their top 8 bits,
where Pillow's convert clips them.  A Lab image comes back as "LAB",
converted to RGBA; ``obj_loader.load_texture_file`` refuses it as grey,
as Pillow's convert("L") does.  ``decode_float_samples(data)`` gives a float TIFF
(mode F) or a PFM as its float32 samples, as a sky's linear radiance.

Malformed input and formats not ported (16-bit PSD, TIFF compressed by
old-style JPEG; and, as Pillow refuses them, TIFF compressed by SGILog or
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
import os
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
_CODES = {"JPEG": 1, "BMP": 2, "TGA": 3, "GIF": 4, "PNM": 5, "PSD": 6, "WEBP": 7}
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
        lib.imgd_tiff.restype = c.c_void_p
        lib.imgd_tiff.argtypes = [c.c_char_p, c.c_int64, _DECOMPRESS, *err]
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
        lib.imgd_floats.argtypes = [c.c_void_p, c.POINTER(c.c_int64), c.POINTER(c.c_int64)]
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


def _decode_png(lib, data: bytes) -> tuple[np.ndarray, str]:
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
        elif kind == b"tRNS":
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


def sniff(data: bytes) -> str:
    """The format of image bytes, by their content: "PNG", "JPEG", "BMP",
    "GIF", "PNM", "PSD", "TIFF", "WEBP", "TGA"; raises ValueError for a
    format not ported or not an image."""
    if data.startswith(PNG_SIGNATURE):
        return "PNG"
    if data.startswith(b"\xff\xd8\xff"):
        return "JPEG"
    if data.startswith(b"BM"):
        return "BMP"
    if data.startswith((b"GIF87a", b"GIF89a")):
        return "GIF"
    if len(data) >= 2 and data[:1] == b"P" and data[1:2] in b"0123456fy":   # PpmImagePlugin._accept
        return "PNM"
    if data.startswith(b"8BPS"):
        return "PSD"
    if data.startswith(TIFF_PREFIXES):
        return "TIFF"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP" and data[12:16] in (b"VP8 ", b"VP8L", b"VP8X"):
        return "WEBP"                                                    # WebPImagePlugin._accept
    if _is_tga(data):
        return "TGA"
    raise ValueError("not an image file this port reads (PNG, JPEG, BMP, GIF, PNM, PSD, TIFF, WebP, TGA)")


def decode_image(data: bytes) -> tuple[np.ndarray, str]:
    """(uint8 (H, W, C) pixels, Pillow mode) of image file bytes."""
    data = bytes(data)
    kind = sniff(data)
    lib = load_library()
    if kind == "PNG":
        return _decode_png(lib, data)
    if kind == "TIFF":
        return _collect(lib, lib.imgd_tiff, data, len(data), _decompress)
    return _collect(lib, lib.imgd_decode, data, len(data), _CODES[kind])


def decode_float_samples(data: bytes) -> np.ndarray | None:
    """The float32 (H, W, 1) samples of a float TIFF (grey, mode F) or a
    PFM, top row first: the linear radiance a sky holds, as the JAX
    package's imageio reads a TIFF (its bundled tifffile: as stored, no
    Orientation applied).  None for any other image, which
    ``decode_image`` reads."""
    data = bytes(data)
    kind = sniff(data)
    if kind not in ("TIFF", "PNM"):
        return None
    lib = load_library()
    call = (lib.imgd_tiff, data, len(data), _decompress) if kind == "TIFF" else \
        (lib.imgd_decode, data, len(data), _CODES[kind])
    with _result(lib, *call) as handle:
        h, w = ctypes.c_int64(), ctypes.c_int64()
        floats = lib.imgd_floats(handle, ctypes.byref(h), ctypes.byref(w))
        if not floats:
            return None
        return np.ctypeslib.as_array(floats, shape=(h.value * w.value,)).reshape(h.value, w.value, 1).copy()


def pixels_digest(arr: np.ndarray) -> str:
    """SHA-256 of an array's dtype, shape and C-order bytes (the fixtures'
    ``expected.json`` holds these of ``load_texture_file``'s output)."""
    arr = np.ascontiguousarray(arr)
    h = hashlib.sha256(f"{arr.dtype.str}{arr.shape}".encode())
    h.update(arr.tobytes())
    return h.hexdigest()
