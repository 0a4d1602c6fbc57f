"""A small PNG codec: 8-bit grey, RGB and RGBA images, with zlib and struct.

No JAX counterpart: the JAX package reads and writes PNGs with Pillow
(utils/image_io.py, scene/obj_loader.py::load_texture_file), which the
port does not depend on.  ``encode_png`` writes non-interlaced 8-bit
images (colour types 0, 2 and 6) with one filter type per row (None by
default; the others exist so that tests can exercise the decoder).
``decode_png`` reads non-interlaced 8-bit grey, RGB and RGBA images with
any of the five row filters and raises ``ValueError`` on anything else
(palettes, grey + alpha, 16-bit or sub-byte depths, Adam7 interlacing).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}          # colour type -> samples per pixel
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    """The Paeth predictor of left a, up b and upper-left c (int arrays)."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_row(kind: int, raw: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Filter one scanline (uint8) with filter `kind` given the previous
    raw scanline."""
    x = raw.astype(np.int16)
    up = prior.astype(np.int16)
    left = np.concatenate([np.zeros(bpp, np.int16), x[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int16), up[:-bpp]])
    pred = {0: 0, 1: left, 2: up, 3: (left + up) // 2,
            4: _paeth(left, up, upleft)}[kind]
    return ((x - pred) % 256).astype(np.uint8)


def encode_png(image: np.ndarray, filters=None, level: int = 6) -> bytes:
    """PNG bytes of an (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) uint8
    image.  filters: None (filter 0 on every row) or a sequence of row
    filter types, cycled over the rows."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"encode_png takes grey, RGB or RGBA images, got shape {img.shape}")
    h, w, c = img.shape
    rows = np.ascontiguousarray(img).reshape(h, w * c)
    out = bytearray()
    prior = np.zeros(w * c, np.uint8)
    for y in range(h):
        kind = 0 if filters is None else int(filters[y % len(filters)])
        out.append(kind)
        out += _filter_row(kind, rows[y], prior, c).tobytes()
        prior = rows[y]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(bytes(out), level)) + _chunk(b"IEND", b""))


def _unfilter_row(kind: int, line: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    if kind == 0:
        return line
    if kind == 1:                        # Sub: a running sum per channel
        return np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    if kind == 2:                        # Up
        return (line.astype(np.uint16) + prior).astype(np.uint8)
    if kind not in (3, 4):
        raise ValueError(f"PNG row filter {kind} does not exist (0-4)")
    # Average and Paeth depend on the reconstructed left pixel: pixel by pixel.
    out = np.zeros(line.size + bpp, np.int16)
    up = np.concatenate([np.zeros(bpp, np.int16), prior.astype(np.int16)])
    src = line.astype(np.int16)
    for i in range(bpp, out.size, bpp):
        left, b = out[i - bpp:i], up[i:i + bpp]
        pred = (left + b) // 2 if kind == 3 else _paeth(left, b, up[i - bpp:i])
        out[i:i + bpp] = (src[i - bpp:i] + pred) % 256
    return out[bpp:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, C) uint8 pixels of an 8-bit, non-interlaced grey (C=1), RGB
    (C=3) or RGBA (C=4) PNG."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file (bad signature)")
    pos, header, idat = len(SIGNATURE), None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"truncated PNG chunk {kind!r}")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if crc != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG has no IHDR or no IDAT chunk")
    w, h, depth, ctype, compression, filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS:
        raise ValueError(
            f"unsupported PNG: bit depth {depth}, colour type {ctype} (this codec "
            "reads 8-bit grey, RGB and RGBA only)")
    if compression != 0 or filt != 0 or interlace != 0:
        raise ValueError(
            f"unsupported PNG: compression {compression}, filter method {filt}, "
            f"interlace {interlace} (this codec reads non-interlaced images only)")
    c = _CHANNELS[ctype]
    stride = w * c
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG image data holds {raw.size} bytes, expected {h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        prior = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prior, c)
    return out.reshape(h, w, c)
