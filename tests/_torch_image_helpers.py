"""Image writers for the port's decoder tests, and the committed fixtures.

Pillow writes no Adam7 PNG, no PNG of an arbitrary colour type and depth,
no JPEG sampled 4:4:0 or 4:1:1, no PSD, no RLE or 16-bit BMP, no 16-bit
TGA, no PNM with comments or an odd maxval, and no GIF with a local
colour table, an offset frame or an unusual LZW stream, no tiled, planar,
predicted, BigTIFF, bit-reversed or subsampled YCbCr TIFF, no TIFF of
associated alpha or 2-bit grey, and no YCCK JPEG, so ``make_png``,
``encode_jpeg``, ``make_bmp`` (with ``encode_bmp_rle``), ``make_tga``,
``encode_gif`` (with ``lzw_encode``), ``encode_pnm``, ``encode_psd`` and
``make_tiff`` (with ``tiff_lzw``) write them here from NumPy; Pillow then
decodes them as the oracle.

``python tests/_torch_image_helpers.py`` rewrites ``tests/data/images/``:
the fixtures (written with Pillow and ``make_png`` from seeded NumPy
images) and ``expected.json``, the SHA-256 of the JAX package's
``load_texture_file`` output on each (``image_decode.pixels_digest``), for
both values of ``grayscale``.  It needs Pillow and the JAX package.
"""

from __future__ import annotations

import ctypes
import json
import os
import struct
import sys
import zlib
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from realtimeraytracer_torch.utils.png import SIGNATURE, _chunk  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "data" / "images"
FIXTURE_NAMES = ("prog420_odd.jpg", "base422_rst.jpg", "grey.jpg", "rle.tga", "palette_trns.png",
                 "adam7.png", "rgb24.bmp", "smooth1024.jpg", "frame.gif", "leaf.psd", "cmyk.psd",
                 "gloss.pgm", "comments.ppm", "discs_rle8.bmp", "rle4.bmp", "bf565.bmp",
                 "rgb16_rle.tga", "lzw_pred_rgb.tif", "deflate_tiles_grey.tif", "jpeg_ycbcr.tif",
                 "packbits_rgba.tif", "bigtiff_planar.tif", "ycbcr22_lzw.tif", "ycck.jpg", "cmyk.jpg",
                 "corrupt_ycck.jpg", "corrupt_cmyk.jpg", "corrupt_base422.jpg", "corrupt_prog420.jpg",
                 "leaf_alpha.webp", "ground_lossless.webp", "smooth1024_alpha.webp", "smooth1024.webp",
                 "ramp1024_lossless.webp")

# Corrupt JPEGs: a fixture with bytes replaced ((offset, byte), ...), whose
# dequantized coefficients overflow libjpeg-turbo's 16-bit SIMD IDCT lanes
# (a quantizer entry and entropy data, a quantizer entry alone, a
# progressive scan's data).  libjpeg decodes them without an error.
CORRUPT_JPEGS = {"corrupt_ycck.jpg": ("ycck.jpg", ((68, 104), (3505, 44))),
                 "corrupt_cmyk.jpg": ("cmyk.jpg", ((42, 250),)),
                 "corrupt_base422.jpg": ("base422_rst.jpg", ((27, 216),)),
                 "corrupt_prog420.jpg": ("prog420_odd.jpg", ((693, 38),))}

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _pack_rows(samples: np.ndarray, depth: int) -> list[bytes]:
    """(h, w, spp) integer samples -> one packed big-endian row each."""
    rows = []
    for row in samples:
        v = row.reshape(-1).astype(np.uint32)
        if depth == 16:
            rows.append(v.astype(">u2").tobytes())
        elif depth == 8:
            rows.append(v.astype(np.uint8).tobytes())
        else:
            bits = np.unpackbits(v.astype(np.uint8)[:, None], axis=1)[:, 8 - depth:]
            rows.append(np.packbits(bits.reshape(-1)).tobytes())
    return rows


def make_png(samples, depth: int, ctype: int, interlace: int = 0, plte: bytes | None = None,
             trns: bytes | None = None, filters=(0, 1, 2, 3, 4)) -> bytes:
    """PNG bytes of (h, w[, spp]) integer samples at any colour type and
    depth, Adam7-interlaced if asked (each pass extracted with NumPy), the
    row filters cycled over the rows."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[..., None]
    h, w, spp = s.shape
    bpp = max(1, spp * depth // 8)
    out = bytearray()
    n = 0
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = s[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        prior = None
        for row in _pack_rows(sub, depth):
            r = np.frombuffer(row, np.uint8).astype(np.int16)
            up = np.zeros_like(r) if prior is None else prior
            left = np.concatenate([np.zeros(bpp, np.int16), r[:-bpp]])
            upleft = np.concatenate([np.zeros(bpp, np.int16), up[:-bpp]])
            kind = filters[n % len(filters)]
            n += 1
            if kind == 4:
                p = left + up - upleft
                pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
                pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
            else:
                pred = (0 * r, left, up, (left + up) // 2)[kind]
            out.append(kind)
            out += ((r - pred) % 256).astype(np.uint8).tobytes()
            prior = r
    data = SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if plte is not None:
        data += _chunk(b"PLTE", bytes(plte))
    if trns is not None:
        data += _chunk(b"tRNS", bytes(trns))
    return data + _chunk(b"IDAT", zlib.compress(bytes(out))) + _chunk(b"IEND", b"")


_NATURAL = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40,
                     48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
                     29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61,
                     54, 47, 55, 62, 63])
_DCT = np.array([[np.sqrt((1 if u == 0 else 2) / 8) * np.cos((2 * x + 1) * u * np.pi / 16)
                  for x in range(8)] for u in range(8)])
_AC_SYMBOLS = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]


def _segment(code: int, body: bytes) -> bytes:
    return bytes([0xFF, code]) + struct.pack(">H", len(body) + 2) + body


def encode_jpeg(planes, factors, q: int = 4, restart: int = 0, adobe: int | None = None,
                jfif: bool = True, ids=None) -> bytes:
    """A baseline JPEG of full-size uint8 component planes sampled at
    `factors` ((h, v) each): box-averaged, a float DCT, one flat quantizer
    `q`, one DC and one AC table of fixed-length codes (4 and 8 bits); an
    Adobe marker with transform `adobe`, else a JFIF marker if `jfif`."""
    hgt, wid = planes[0].shape
    n = len(planes)
    ids = list(ids or range(1, n + 1))
    mh, mv = max(f[0] for f in factors), max(f[1] for f in factors)
    mcux, mcuy = -(-wid // (8 * mh)), -(-hgt // (8 * mv))
    comps = []
    for p, (h, v) in zip(planes, factors):
        full = np.pad(p.astype(np.float64), ((0, mcuy * mv * 8 - hgt), (0, mcux * mh * 8 - wid)),
                      mode="edge")
        sy, sx = mv // v, mh // h
        small = full.reshape(full.shape[0] // sy, sy, full.shape[1] // sx, sx).mean(axis=(1, 3))
        blocks = small.reshape(small.shape[0] // 8, 8, small.shape[1] // 8, 8).transpose(0, 2, 1, 3)
        coefs = np.rint(np.einsum("ux,abxy,vy->abuv", _DCT, blocks - 128, _DCT) / q).astype(int)
        comps.append(coefs.reshape(coefs.shape[0], coefs.shape[1], 64)[:, :, _NATURAL].tolist())
    out = bytearray()
    acc = [0, 0]                      # bits, count

    def put(value, nbits):
        acc[0] = (acc[0] << nbits) | (value & ((1 << nbits) - 1))
        acc[1] += nbits
        while acc[1] >= 8:
            b = (acc[0] >> (acc[1] - 8)) & 0xFF
            acc[1] -= 8
            out.append(b)
            if b == 0xFF:
                out.append(0)
        acc[0] &= (1 << acc[1]) - 1

    def flush():
        if acc[1]:
            put((1 << (8 - acc[1])) - 1, 8 - acc[1])

    def category(v):
        s = int(abs(v)).bit_length()
        return s, (v if v >= 0 else v + (1 << s) - 1)

    pred = [0] * n

    def block(ci, zz):
        s, bits = category(zz[0] - pred[ci])
        pred[ci] = zz[0]
        put(s, 4)
        put(bits, s)
        run = 0
        last = max([k for k in range(1, 64) if zz[k]] or [0])
        for k in range(1, last + 1):
            if zz[k] == 0:
                run += 1
                continue
            while run > 15:
                put(_AC_SYMBOLS.index(0xF0), 8)
                run -= 16
            s, bits = category(zz[k])
            put(_AC_SYMBOLS.index((run << 4) | s), 8)
            put(bits, s)
            run = 0
        if last < 63:
            put(0, 8)                 # EOB

    if n == 1:
        (h, v), = factors
        bw, bh = -(-(-(-wid * h // mh)) // 8), -(-(-(-hgt * v // mv)) // 8)
        units = [[(0, comps[0][by][bx])] for by in range(bh) for bx in range(bw)]
    else:
        units = [[(ci, comps[ci][my * v + y][mx * h + x]) for ci, (h, v) in enumerate(factors)
                  for y in range(v) for x in range(h)]
                 for my in range(mcuy) for mx in range(mcux)]
    for i, unit in enumerate(units):
        if restart and i and i % restart == 0:
            flush()
            out += bytes([0xFF, 0xD0 + (i // restart - 1) % 8])
            pred = [0] * n
        for ci, zz in unit:
            block(ci, zz)
    flush()
    head = b"\xff\xd8"
    if adobe is not None:
        head += _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe]))
    elif jfif:
        head += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    head += _segment(0xDB, b"\x00" + bytes([q] * 64))
    head += _segment(0xC0, struct.pack(">BHHB", 8, hgt, wid, n) + b"".join(
        bytes([i, (h << 4) | v, 0]) for i, (h, v) in zip(ids, factors)))
    head += _segment(0xC4, b"\x00" + bytes([0, 0, 0, 12] + [0] * 12) + bytes(range(12)))
    head += _segment(0xC4, b"\x10" + bytes([0] * 7 + [len(_AC_SYMBOLS)] + [0] * 8)
                     + bytes(_AC_SYMBOLS))
    if restart:
        head += _segment(0xDD, struct.pack(">H", restart))
    head += _segment(0xDA, bytes([n]) + b"".join(bytes([i, 0]) for i in ids) + b"\x00\x3f\x00")
    return head + bytes(out) + b"\xff\xd9"


def encode_jpeg_blocks(blocks, w: int, h: int, quant) -> bytes:
    """A baseline grey JPEG of raw coefficient blocks (each 64 values in
    zigzag order, raster block order, w x h pixels) and a quantizer of any
    16-bit values: DC sizes up to 15 in 5-bit codes, every AC run/size in
    8-bit codes.  For blocks no encoder writes (libjpeg-turbo's IDCT
    overflow)."""
    dc_symbols = list(range(16))
    ac_symbols = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 16)]
    out = bytearray()
    acc = [0, 0]

    def put(value, nbits):
        acc[0] = (acc[0] << nbits) | (value & ((1 << nbits) - 1))
        acc[1] += nbits
        while acc[1] >= 8:
            b = (acc[0] >> (acc[1] - 8)) & 0xFF
            acc[1] -= 8
            out.append(b)
            if b == 0xFF:
                out.append(0)
        acc[0] &= (1 << acc[1]) - 1

    def category(v):
        s = int(abs(v)).bit_length()
        return s, (v if v >= 0 else v + (1 << s) - 1)

    pred = 0
    for zz in blocks:
        s, bits = category(zz[0] - pred)
        pred = zz[0]
        put(s, 5)
        put(bits, s)
        run, last = 0, max([k for k in range(1, 64) if zz[k]] or [0])
        for k in range(1, last + 1):
            if zz[k] == 0:
                run += 1
                continue
            while run > 15:
                put(ac_symbols.index(0xF0), 8)
                run -= 16
            s, bits = category(zz[k])
            put(ac_symbols.index((run << 4) | s), 8)
            put(bits, s)
            run = 0
        if last < 63:
            put(0, 8)
    if acc[1]:
        put((1 << (8 - acc[1])) - 1, 8 - acc[1])
    wide = max(quant) > 255
    dqt = bytes([0x10 if wide else 0]) + (struct.pack(">64H", *quant) if wide else bytes(quant))
    return (b"\xff\xd8" + _segment(0xDB, dqt)
            + _segment(0xC0, struct.pack(">BHHB", 8, h, w, 1) + bytes([1, 0x11, 0]))
            + _segment(0xC4, b"\x00" + bytes([0, 0, 0, 0, 16] + [0] * 11) + bytes(dc_symbols))
            + _segment(0xC4, b"\x10" + bytes([0] * 7 + [len(ac_symbols)] + [0] * 8) + bytes(ac_symbols))
            + _segment(0xDA, b"\x01\x01\x00\x00\x3f\x00") + bytes(out) + b"\xff\xd9")


def make_tga(pix, itype: int, depth: int, flags: int = 0, cmap=None, cmap_start: int = 0,
             cmap_depth: int = 24, idfield: bytes = b"", rng=None, width: int | None = None,
             max_packet: int = 5) -> bytes:
    """TGA bytes of (h, w, bytes a pixel) stored values (a 1-bit image:
    (h, packed row bytes, 1) and its `width`); RLE packets (type & 8) of
    1 to `max_packet` pixels break at each row, as Pillow's do; `cmap`
    holds the map's stored bytes."""
    pix = np.asarray(pix)
    h, units = pix.shape[:2]
    w = units if width is None else width
    ncmap = 0 if cmap is None else len(cmap) // (cmap_depth // 8)
    head = struct.pack("<BBBHHBHHHHBB", len(idfield), int(cmap is not None), itype, cmap_start,
                       ncmap, cmap_depth if cmap is not None else 0, 0, 0, w, h, depth, flags)
    body = bytearray()
    for row in pix.reshape(h, units, -1).astype(np.uint8):
        if not itype & 8:
            body += row.tobytes()
            continue
        i = 0
        while i < units:
            n = min(int(rng.integers(1, max_packet + 1)), units - i)
            if (row[i:i + n] == row[i]).all():
                body.append(0x80 | (n - 1))
                body += row[i].tobytes()
            else:
                body.append(n - 1)
                body += row[i:i + n].tobytes()
            i += n
    return head + idfield + (bytes(cmap) if cmap is not None else b"") + bytes(body)


def make_bmp(pix, bits: int, hs: int = 40, top_down: bool = False, palette=None,
             compression: int = 0, masks=None, data: bytes | None = None, size=None) -> bytes:
    """BMP bytes with a `hs`-byte header: (h, w[, bytes]) samples packed at
    `bits` (16: uint16 values), or the given pixel `data` (RLE) of `size`
    (w, h); masks follow a 40-byte header."""
    if data is None:
        pix = np.asarray(pix)
        h, w = pix.shape[:2]
        stride = ((w * bits + 31) >> 3) & ~3
        rows = []
        for r in pix:
            if bits <= 8:
                b = np.packbits(np.unpackbits(r.reshape(-1).astype(np.uint8)[:, None], axis=1)
                                [:, 8 - bits:].reshape(-1)).tobytes()
            elif bits == 16:
                b = r.reshape(-1).astype("<u2").tobytes()
            else:
                b = r.astype(np.uint8).tobytes()
            rows.append(b + bytes(stride - len(b)))
        data = b"".join(rows if top_down else rows[::-1])
    else:
        w, h = size
    pad = b"" if hs == 12 else b"\0"
    pal = b"" if palette is None else b"".join(bytes(np.asarray(p, np.uint8)[::-1]) + pad
                                               for p in palette)
    ncol = 0 if palette is None else len(palette)
    if hs == 12:
        dib = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        dib = struct.pack("<IiiHHIIiiII", hs, w, -h if top_down else h, 1, bits, compression,
                          len(data), 2835, 2835, ncol, 0)
        m = b"" if masks is None else struct.pack(f"<{len(masks)}I", *masks)
        dib = dib + m + bytes(hs - len(dib) - len(m)) if hs > 40 else dib + m
    off = 14 + len(dib) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off) + dib + pal + data


def encode_bmp_rle(idx, rle4: bool, rng, delta: bool = False, odd_runs: bool = False,
                   max_run: int = 8) -> bytes:
    """BMP RLE8/RLE4 data of (h, w) palette indexes, bottom row first:
    encoded runs of up to `max_run` (< 254) pixels (some past the row's
    end, which decoders cut) and absolute runs of 3 or more (padded to 16
    bits; an RLE4 run of n pixels holds (n + 1) / 2 bytes, and only
    `odd_runs` gives n = 1 mod 4, which Pillow reads short), end-of-line
    after each row, end-of-bitmap; with `delta`, delta escapes here and
    there.  Without deltas, decoders that read the runs as written give
    back `idx`."""
    idx = np.asarray(idx)
    h, w = idx.shape
    out = bytearray()
    for r, row in enumerate(idx[::-1]):
        x = 0
        while x < w:
            if delta and rng.random() < 0.1:
                dx, dy = int(rng.integers(0, 4)), int(rng.random() < 0.2)
                out += bytes([0, 2, dx, dy, dx, dy])       # Pillow reads the second pair
            n = int(rng.integers(1, max_run + 1))
            if rle4 and not odd_runs and n % 4 == 1 and n > 1:
                n += 2
            seg = row[x:x + n]
            even, odd = seg[::2], seg[1::2]
            encodable = (even == even[0]).all() and (not rle4 or (odd == odd[:1]).all()) and \
                (rle4 or (odd == even[0]).all())
            if len(seg) >= 3 and (not encodable or rng.random() < 0.4):
                if rle4:
                    nib = np.concatenate([seg, [0]])[:len(seg) + (len(seg) & 1)]
                    body = bytes(int(a) << 4 | int(b) for a, b in zip(nib[::2], nib[1::2]))
                else:
                    body = bytes(seg.astype(np.uint8))
                out += bytes([0, len(seg)]) + body + bytes(len(body) & 1)
            else:
                if not encodable:
                    seg = seg[:2 if rle4 else 1]
                v = int(seg[0]) if not rle4 else int(seg[0]) << 4 | int(seg[1] if len(seg) > 1 else 0)
                run = len(seg) + (2 if x + len(seg) == w and rng.random() < 0.3 else 0)   # past the end
                out += bytes([run, v])
            x += len(seg)
        out += b"\0\0"
    return bytes(out + b"\0\1")


def lzw_encode(indices, min_size: int, deferred: bool = False, clear_every: int = 0,
               end_after: int | None = None, end: bool = True, lead_clear: bool = True,
               pause_after: int | None = None) -> bytes:
    """GIF LZW codes of `indices`, packed LSB first: codes widen as the
    decoder's table grows, a full table emits a clear code (or, with
    `deferred`, none: 12-bit codes go on with no new entry); `clear_every`
    codes a clear; the end code after `end_after` pixels, or none; with
    `pause_after`, an end code and a clear code after that many pixels and
    then the rest."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out, acc = bytearray(), [0, 0]
    dec = {}

    def reset():
        dec.update(next=clear + 2, size=min_size + 1, first=True)

    def emit(code):
        acc[0] |= code << acc[1]
        acc[1] += dec["size"]
        while acc[1] >= 8:
            out.append(acc[0] & 255)
            acc[0] >>= 8
            acc[1] -= 8
        if code == clear:
            reset()
        elif code != eoi:
            if dec["first"]:
                dec["first"] = False
            elif dec["next"] < 4096:
                if dec["next"] == (1 << dec["size"]) - 1 and dec["size"] < 12:
                    dec["size"] += 1
                dec["next"] += 1

    reset()
    px = [int(v) for v in np.asarray(indices).reshape(-1)][:end_after]
    table, nxt, ncodes, w = {}, clear + 2, 0, None
    if lead_clear:
        emit(clear)
    for i, k in enumerate(px):
        if i == pause_after and w is not None:
            emit(w)
            emit(eoi)
            emit(clear)
            table, nxt, w = {}, clear + 2, None
        if w is None:
            w = k
        elif (w, k) in table:
            w = table[(w, k)]
        else:
            emit(w)
            ncodes += 1
            if nxt < 4096:
                table[(w, k)] = nxt
                nxt += 1
            elif not deferred:
                emit(clear)
                table, nxt = {}, clear + 2
            if clear_every and ncodes % clear_every == 0 and nxt != clear + 2:
                emit(clear)
                table, nxt = {}, clear + 2
            w = k
    if w is not None:
        emit(w)
    if end:
        emit(eoi)
    if acc[1]:
        out.append(acc[0] & 255)
    return bytes(out)


def _gif_table(pal, bits):
    pal = bytes(np.asarray(pal, np.uint8).reshape(-1))
    return pal + bytes(3 * (1 << bits) - len(pal))


def _gif_bits(pal, bits):
    return bits or max(1, int(np.ceil(np.log2(max(2, len(pal))))))


def encode_gif(frames, screen, palette=None, pal_bits: int | None = None, tail: bytes = b";",
               version: bytes = b"GIF89a") -> bytes:
    """GIF bytes.  `frames`: dicts of ``indices`` (h, w) and optionally
    ``x``, ``y``, ``palette`` (a local table), ``pal_bits``, ``transparency``,
    ``interlace`` (rows written in the four passes), ``min_size``, ``lzw``
    (lzw_encode options) or ``data`` (the LZW bytes), ``block`` (sub-block
    size), ``extensions`` (raw bytes before the descriptor)."""
    w, h = screen
    flags = 0
    if palette is not None:
        gb = _gif_bits(palette, pal_bits)
        flags = 0xF0 | (gb - 1)
    out = bytearray(version + struct.pack("<HHBBB", w, h, flags, 0, 0))
    if palette is not None:
        out += _gif_table(palette, gb)
    for f in frames:
        idx = np.asarray(f["indices"])
        fh, fw = idx.shape
        out += b"".join(f.get("extensions", ()))
        t = f.get("transparency")
        if t is not None:
            out += b"!\xf9\x04" + bytes([1]) + struct.pack("<H", 0) + bytes([t]) + b"\0"
        lp = f.get("palette")
        lflags = 0x40 if f.get("interlace") else 0
        if lp is not None:
            lb = _gif_bits(lp, f.get("pal_bits"))
            lflags |= 0x80 | (lb - 1)
        out += b"," + struct.pack("<HHHHB", f.get("x", 0), f.get("y", 0), fw, fh, lflags)
        if lp is not None:
            out += _gif_table(lp, lb)
        rows = np.concatenate([idx[0::8], idx[4::8], idx[2::4], idx[1::2]]) if f.get("interlace") else idx
        ms = f.get("min_size", 8)
        data = f["data"] if "data" in f else lzw_encode(rows, ms, **f.get("lzw", {}))
        out.append(ms)
        bs = f.get("block", 255)
        for i in range(0, len(data), bs):
            out += bytes([len(data[i:i + bs])]) + data[i:i + bs]
        out += b"\0"
    return bytes(out + tail)


def encode_pnm(samples, magic: bytes, maxval: int = 255, comments: bool = False, rng=None,
               scale: float = -1.0) -> bytes:
    """PNM bytes: P1/P4 of (h, w) bits (1 = black), P2/P3/P5/P6 of (h, w[, 3])
    samples (binary: 16-bit big-endian above 255), Pf of (h, w) floats
    (little-endian for a negative scale, rows bottom-up; PF of (h, w, 3)).  With `comments`,
    ``#`` lines between the header tokens and between ASCII samples, and
    ASCII rows of irregular whitespace."""
    s = np.asarray(samples)
    h, w = s.shape[:2]
    c = b"# a comment\n" if comments else b""
    head = magic + b"\n" + c + b"%d " % w + c + b"%d\n" % h
    if magic in (b"Pf", b"PF"):
        f = s.astype("<f4" if scale < 0 else ">f4")[::-1]
        return head + b"%r\n" % scale + f.tobytes()
    if magic not in (b"P1", b"P4"):
        head += c + b"%d\n" % maxval
    if magic == b"P4":
        return head + b"".join(np.packbits(r.astype(np.uint8)).tobytes() for r in s)
    if magic in (b"P5", b"P6"):
        return head + s.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    out = bytearray(head)
    for r in s.reshape(h, -1):
        for v in r:
            out += b"%d" % v + (b" " if magic != b"P1" or rng is None or rng.random() < 0.5 else b"")
            if comments and rng is not None and rng.random() < 0.05:
                out += b" # note\n"
        out += b"\n" if rng is None or rng.random() < 0.7 else b"\t\r\n"
    return bytes(out)


def packbits(row: bytes, rng=None) -> bytes:
    """PackBits of one row: runs of 2+ equal bytes, literals, and (with
    `rng`) now and then a no-op byte 0x80."""
    out, i = bytearray(), 0
    while i < len(row):
        if rng is not None and rng.random() < 0.05:
            out.append(0x80)
        j = i
        while j + 1 < len(row) and row[j + 1] == row[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), row[i]])
            i = j + 1
            continue
        j = i + 1
        while j < len(row) and j - i < 128 and not (j + 1 < len(row) and row[j + 1] == row[j]):
            j += 1
        out += bytes([j - i - 1]) + row[i:j]
        i = j
    return bytes(out)


def encode_psd(planes, color_mode: int, depth: int = 8, compression: int = 0,
               channels: int | None = None, width: int | None = None, palette: bytes = b"",
               resources: bytes = b"", layers: bytes = b"", rng=None) -> bytes:
    """PSD bytes with a composite image of (h, w) uint8 planes (a bitmap:
    packed rows and their `width`), raw or PackBits with per-row byte
    counts, `channels` in the header (default: the planes'); colour mode
    data `palette`, image resources and a layer section as given."""
    planes = [np.asarray(p, np.uint8) for p in planes]
    h, rb = planes[0].shape
    out = bytearray(b"8BPS" + struct.pack(">H6xHIIHH", 1, channels or len(planes), h, width or rb,
                                          depth, color_mode))
    out += struct.pack(">I", len(palette)) + palette
    out += struct.pack(">I", len(resources)) + resources
    out += struct.pack(">I", len(layers)) + layers
    out += struct.pack(">H", compression)
    if compression == 0:
        out += b"".join(p.tobytes() for p in planes)
    else:
        rows = [packbits(r.tobytes(), rng) for p in planes for r in p]
        out += b"".join(struct.pack(">H", len(r)) for r in rows) + b"".join(rows)
    return bytes(out)


def tiff_lzw(data: bytes) -> bytes:
    """TIFF LZW of `data`: codes packed most significant bit first, 9 to
    12 bits wide, each width one code earlier than GIF's (libtiff's
    LZWEncode); a clear code first, another when the table fills, the end
    code last."""
    out = bytearray()
    acc = nacc = 0
    bits, free = 9, 258
    table = {}                       # (prefix code << 8 | byte) -> code

    def put(code):
        nonlocal acc, nacc
        acc = (acc << bits) | code
        nacc += bits
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 255)
        acc &= (1 << nacc) - 1

    put(256)
    w = -1
    for c in data:
        if w < 0:
            w = c
            continue
        key = w << 8 | c
        code = table.get(key)
        if code is not None:
            w = code
            continue
        put(w)
        table[key] = free
        free += 1                    # the entry the decoder adds for this code
        if free == 4094:
            put(256)
            table.clear()
            bits, free = 9, 258
        elif free > (1 << bits) - 1:
            bits += 1
        w = c
    if w >= 0:
        put(w)
        free += 1
        if free == 4094:
            put(256)
            bits = 9
        elif free > (1 << bits) - 1:
            bits += 1
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


_TIFF_FMT = {1: "B", 2: "B", 3: "H", 4: "I", 5: "I", 6: "b", 7: "B", 8: "h", 9: "i", 10: "i",
             11: "f", 12: "d", 16: "Q", 17: "q"}
_TIFF_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 16: 8, 17: 8}


def _tiff_pack(samples: np.ndarray, bits: int, order: str, fmt: int) -> bytes:
    """(rows, n) samples of one segment row by row: each row packed most
    significant bit first below 8 bits and padded to a byte, else in the
    file's byte order (`fmt` 3: float16 or float32)."""
    rows = []
    for row in samples:
        if bits < 8:
            b = np.unpackbits(row.astype(np.uint8)[:, None], axis=1)[:, 8 - bits:]
            rows.append(np.packbits(b.reshape(-1)).tobytes())
        else:
            dt = {8: "u1", 16: "u2", 32: "u4"}[bits] if fmt != 3 else {16: "f2", 32: "f4"}[bits]
            if fmt == 2:
                dt = dt.replace("u", "i")
            rows.append(row.astype(order + dt).tobytes())
    return b"".join(rows)


def _hor_diff(rows: np.ndarray, bits: int, spp: int) -> np.ndarray:
    """Horizontal differencing (predictor 2) of integer sample rows."""
    a = rows.astype(np.int64)
    d = a.copy()
    d[:, spp:] = a[:, spp:] - a[:, :-spp]
    return d & ((1 << bits) - 1)


def _fp_predict(row_bytes: bytes, spp: int) -> bytes:
    """libtiff's fpDiff on one row of float32 samples in native order:
    byte planes, most significant first, then bytewise differencing."""
    v = np.frombuffer(row_bytes, "<u4")
    planes = np.stack([(v >> s) & 255 for s in (24, 16, 8, 0)]).astype(np.uint8).reshape(-1)
    d = planes.astype(np.int16)
    d[spp:] = d[spp:] - planes[:-spp].astype(np.int16)
    return (d & 255).astype(np.uint8).tobytes()


def tiff_reverse_bits(data: bytes) -> bytes:
    """Each byte's bits reversed (FillOrder 2)."""
    a = np.frombuffer(data, np.uint8)
    return np.packbits(np.unpackbits(a[:, None], axis=1)[:, ::-1].reshape(-1)).tobytes()


def make_tiff(samples, bits, photometric: int, *, order: str = "<", header: str = "tiff",
              sample_format=None, extra=None, planar: int = 1, fill_order=None,
              compression: int = 1, predictor=None, rows_per_strip=None, tile=None,
              colormap=None, subsampling=None, jpeg_q: int = 4, jpeg_tables: bool = True,
              tags=None, omit=(), packbits_rng=None, ifd_first: bool = False,
              seg_data=None) -> bytes:
    """TIFF bytes of (h, w[, n]) samples: `bits` per sample (an int, or a
    tuple for the tag), in byte order `order` ("<" II, ">" MM); `header`
    "tiff", "bigtiff" or "swapped" (the magic in the other order, which
    Pillow accepts as an "invalid" prefix); strips of `rows_per_strip` or
    `tile` (w, h) tiles (edge tiles padded); `planar` 2 writes a segment
    per sample plane; compression 1 (none), 32773 (PackBits), 5 (LZW), 8
    or 32946 (Deflate) with `predictor` 2 or 3, or 7 (JPEG: each segment a
    JPEG of `encode_jpeg`, its tables in JPEGTables unless `jpeg_tables`
    is false; YCbCr with `subsampling` (h, v) samples luma at that rate
    and chroma once a block).  Without JPEG, YCbCr data is written in
    libtiff's blocks of h*v luma samples, Cb, Cr.  `fill_order` 2 reverses
    the bits of every stored byte.  `sample_format`, `extra` and
    `colormap` ((2^bits, 3) 16-bit entries) fill their tags; `jpeg_q` is
    the JPEG quantizer, `packbits_rng` adds PackBits no-ops; `ifd_first`
    puts the directory before the data.  `tags` adds or replaces (tag,
    type, values) entries; `omit` drops tags by number; `seg_data`
    replaces the stored segments."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[..., None]
    h, w, n = s.shape
    bits_t = tuple(bits) if isinstance(bits, (tuple, list)) else (bits,) * n
    b0 = bits_t[0]
    fmt = (sample_format[0] if isinstance(sample_format, (tuple, list)) else sample_format) or 1
    if tile:
        tw, th = tile
        grid = [(x, y) for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        tw, th = w, rows_per_strip or h
        grid = [(0, y) for y in range(0, h, th)]
    planes = [s[..., k:k + 1] for k in range(n)] if planar == 2 else [s]
    tables = b""

    def encode(seg):
        nonlocal tables
        sh, sw, sn = seg.shape
        if compression == 7:
            comps = [seg[..., k].astype(np.uint8) for k in range(sn)]
            fac = [(1, 1)] * sn
            if photometric == 6 and subsampling and planar == 1:
                fac[0] = tuple(subsampling)
            data = encode_jpeg(comps, fac, q=jpeg_q, jfif=False)
            if jpeg_tables:
                parts, pos, kept = [], 2, [b"\xff\xd8"]
                while data[pos + 1] != 0xDA:
                    ln = struct.unpack(">H", data[pos + 2:pos + 4])[0]
                    (parts if data[pos + 1] in (0xDB, 0xC4) else kept).append(data[pos:pos + 2 + ln])
                    pos += 2 + ln
                tables = b"\xff\xd8" + b"".join(parts) + b"\xff\xd9"
                data = b"".join(kept) + data[pos:]
            return data
        if photometric == 6 and subsampling and planar == 1:
            hs, vs = subsampling
            pad = np.pad(seg, ((0, -sh % vs), (0, -sw % hs), (0, 0)), mode="edge").astype(np.int64)
            bh, bw = pad.shape[0] // vs, pad.shape[1] // hs
            blk = pad.reshape(bh, vs, bw, hs, 3)
            ys = blk[..., 0].transpose(0, 2, 1, 3).reshape(bh, bw, vs * hs)
            cb, cr = blk[:, 0, :, 0, 1], blk[:, 0, :, 0, 2]
            raw = np.concatenate([ys, cb[..., None], cr[..., None]], -1).astype(np.uint8).tobytes()
        else:
            flat = seg.reshape(sh, sw * sn)
            if predictor == 2:
                flat = _hor_diff(flat, b0, sn)
            if predictor == 3:
                raw = b"".join(_fp_predict(r.astype("<f4").tobytes(), sn) for r in flat)
            else:
                raw = _tiff_pack(flat, b0, order, fmt)
        if compression == 32773:
            rb = len(raw) // sh
            return b"".join(packbits(raw[i:i + rb], packbits_rng) for i in range(0, len(raw), rb))
        if compression == 5:
            return tiff_lzw(raw)
        if compression in (8, 32946):
            return zlib.compress(raw)
        return raw

    segments, done = [], {}           # equal segments are encoded once
    for plane in planes:
        for x, y in grid:
            seg = plane[y:y + th, x:x + tw]
            if tile:
                seg = np.pad(seg, ((0, th - seg.shape[0]), (0, tw - seg.shape[1]), (0, 0)), mode="edge")
            key = (seg.shape, seg.dtype.str, seg.tobytes())
            if key not in done or packbits_rng is not None:
                done[key] = encode(seg)
            segments.append(done[key])
    if fill_order == 2:
        segments = [tiff_reverse_bits(d) for d in segments]
    if seg_data is not None:
        segments = list(seg_data)
    big = header == "bigtiff"
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, list(bits_t)), 259: (3, [compression]),
               262: (3, [photometric]), 277: (3, [n])}
    if planar != 1:
        entries[284] = (3, [planar])
    if fill_order:
        entries[266] = (3, [fill_order])
    if sample_format:
        entries[339] = (3, list(sample_format) if isinstance(sample_format, (tuple, list)) else [fmt] * n)
    if extra:
        entries[338] = (3, list(extra))
    if predictor:
        entries[317] = (3, [predictor])
    if colormap is not None:
        entries[320] = (3, [int(v) for v in np.asarray(colormap).T.reshape(-1)])
    if subsampling:
        entries[530] = (3, list(subsampling))
    if tables and compression == 7:
        entries[347] = (7, list(tables))
    lens = [len(d) for d in segments]
    off_type = 16 if big else 4
    if tile:
        entries[322] = (3, [tw])
        entries[323] = (3, [th])
        entries[324], entries[325] = (off_type, [0] * len(segments)), (off_type, lens)
    else:
        entries[278] = (4, [th])
        entries[273], entries[279] = (off_type, [0] * len(segments)), (off_type, lens)
    for tag, typ, vals in tags or ():
        entries[tag] = (typ, list(vals))
    for tag in omit:
        entries.pop(tag, None)
    hdr_len = 16 if big else 8
    data_blob = b"".join(segments)
    nent = len(entries)
    ifd_len = (8 + 20 * nent + 8) if big else (2 + 12 * nent + 4)
    ifd_off = hdr_len if ifd_first else hdr_len + len(data_blob) + (len(data_blob) & 1)
    data_off = hdr_len + ifd_len if ifd_first else hdr_len
    seg_offs, pos = [], data_off
    for d in segments:
        seg_offs.append(pos)
        pos += len(d)
    offkey = 324 if tile else 273
    if offkey in entries:
        entries[offkey] = (entries[offkey][0], seg_offs)
    slot = 8 if big else 4
    extra_off = (ifd_off + ifd_len) if not ifd_first else data_off + len(data_blob)
    ext = bytearray()
    body = bytearray()
    for tag in sorted(entries):
        typ, vals = entries[tag]
        if typ in (5, 10):
            payload = b"".join(struct.pack(order + _TIFF_FMT[typ] * 2, *v) for v in vals)
            count = len(vals)
        else:
            payload = struct.pack(order + _TIFF_FMT[typ] * len(vals), *vals)
            count = len(vals)
        if len(payload) <= slot:
            value = payload.ljust(slot, b"\0")
        else:
            value = struct.pack(order + ("Q" if big else "I"), extra_off + len(ext))
            ext += payload + (b"\0" if len(payload) & 1 else b"")
        body += struct.pack(order + ("HHQ" if big else "HHI"), tag, typ, count) + value
    ifd = struct.pack(order + ("Q" if big else "H"), nent) + body + bytes(slot)
    bo = b"II" if order == "<" else b"MM"
    if big:
        head = bo + struct.pack(order + "HHHQ", 43, 8, 0, ifd_off)
    else:
        magic = struct.pack(order + "H", 42)
        head = bo + (magic[::-1] if header == "swapped" else magic) + struct.pack(order + "I", ifd_off)
    if ifd_first:
        return bytes(head + ifd + data_blob + ext)
    return bytes(head + data_blob + (b"\0" if len(data_blob) & 1 else b"") + ifd + ext)


# ---------------------------------------------------------------- WebP ----

class _WebPConfig(ctypes.Structure):      # libwebp's encode.h, every field 4 bytes
    _fields_ = [(name, ctypes.c_float if name in ("quality", "target_PSNR") else ctypes.c_int) for name in (
        "lossless", "quality", "method", "image_hint", "target_size", "target_PSNR", "segments",
        "sns_strength", "filter_strength", "filter_sharpness", "filter_type", "autofilter",
        "alpha_compression", "alpha_filtering", "alpha_quality", "pass_", "show_compressed",
        "preprocessing", "partitions", "partition_limit", "emulate_jpeg_size", "thread_level",
        "low_memory", "near_lossless", "exact", "use_delta_palette", "use_sharp_yuv", "qmin", "qmax")]


_PTR, _U32 = ctypes.c_void_p, ctypes.c_uint32


class _WebPPicture(ctypes.Structure):
    _fields_ = [("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int), ("width", ctypes.c_int),
                ("height", ctypes.c_int), ("y", _PTR), ("u", _PTR), ("v", _PTR), ("y_stride", ctypes.c_int),
                ("uv_stride", ctypes.c_int), ("a", _PTR), ("a_stride", ctypes.c_int), ("pad1", _U32 * 2),
                ("argb", _PTR), ("argb_stride", ctypes.c_int), ("pad2", _U32 * 3), ("writer", _PTR),
                ("custom_ptr", _PTR), ("extra_info_type", ctypes.c_int), ("extra_info", _PTR),
                ("stats", _PTR), ("error_code", ctypes.c_int), ("progress_hook", _PTR), ("user_data", _PTR),
                ("pad3", _U32 * 3), ("pad4", _PTR), ("pad5", _PTR), ("pad6", _U32 * 8), ("memory_", _PTR),
                ("memory_argb_", _PTR), ("pad7", _PTR * 2)]


class _WebPMemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", _U32)]


def encode_webp(pixels, quality: float = 75.0, **config) -> bytes:
    """A WebP file of uint8 (H, W, 3 or 4) pixels from libwebp's advanced
    encoder (WebPConfig, WebPEncode), for what Pillow's save does not
    expose: token `partitions` (log2, 0-3), `filter_type` (0 simple, 1
    normal), `filter_strength`, `filter_sharpness`, `segments`,
    `alpha_compression`, `alpha_filtering`, ...  It binds the libwebp that
    Pillow bundles (pillow.libs) with ctypes: tests only."""
    import glob

    import PIL
    from PIL import _webp  # noqa: F401 - loads libwebp's own dependencies first

    lib = ctypes.CDLL(sorted(glob.glob(os.path.join(os.path.dirname(PIL.__file__), os.pardir,
                                                    "pillow.libs", "libwebp-*.so*")))[0])
    pix = np.ascontiguousarray(pixels, np.uint8)
    h, w, c = pix.shape
    abi = 0x0210                                    # WEBP_ENCODER_ABI_VERSION's major 2
    cfg = _WebPConfig()
    if not lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, ctypes.c_float(quality), abi):
        raise RuntimeError("WebPConfigInit failed")
    for key, value in config.items():
        setattr(cfg, key, value)
    if not lib.WebPValidateConfig(ctypes.byref(cfg)):
        raise ValueError(f"libwebp refuses the configuration {config}")
    pic = _WebPPicture()
    if not lib.WebPPictureInitInternal(ctypes.byref(pic), abi):
        raise RuntimeError("WebPPictureInit failed")
    pic.width, pic.height, pic.use_argb = w, h, cfg.lossless
    importer = lib.WebPPictureImportRGBA if c == 4 else lib.WebPPictureImportRGB
    if not importer(ctypes.byref(pic), pix.ctypes.data_as(ctypes.c_void_p), w * c):
        raise RuntimeError("WebPPictureImport failed")
    out = _WebPMemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(out))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p)
    pic.custom_ptr = ctypes.cast(ctypes.byref(out), ctypes.c_void_p)
    ok = lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic))
    data = ctypes.string_at(out.mem, out.size)
    lib.WebPPictureFree(ctypes.byref(pic))
    lib.WebPMemoryWriterClear(ctypes.byref(out))
    if not ok:
        raise RuntimeError(f"WebPEncode failed with error {pic.error_code}")
    return data


def pillow_webp(pixels, **save) -> bytes:
    """Pillow's WebP of uint8 (H, W, C) pixels (`save`: quality, method,
    lossless, exact, ...)."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(pixels, np.uint8)).save(buf, "WEBP", **save)
    return buf.getvalue()


def webp_chunk(tag: bytes, body: bytes) -> bytes:
    """A RIFF chunk: tag, little-endian size, body, a pad byte if odd."""
    return tag + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def riff_webp(*chunks: bytes) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def webp_chunks(data: bytes) -> dict:
    """The chunks of a RIFF WEBP file by tag (each tag's first), bodies
    without padding; the animation's frames are not opened."""
    out, p = {}, 12
    while p + 8 <= len(data):
        tag, n = data[p:p + 4], struct.unpack("<I", data[p + 4:p + 8])[0]
        out.setdefault(tag, data[p + 8:p + 8 + n])
        p += 8 + n + (n & 1)
    return out


def vp8x_chunk(w: int, h: int, alpha: bool = False, animation: bool = False, flags: int = 0) -> bytes:
    f = flags | (0x10 if alpha else 0) | (0x02 if animation else 0)
    return webp_chunk(b"VP8X", bytes([f, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little"))


def anim_chunk(background: int = 0, loops: int = 0) -> bytes:
    return webp_chunk(b"ANIM", struct.pack("<IH", background, loops))


def anmf_chunk(x: int, y: int, w: int, h: int, frame: bytes, duration: int = 100, bits: int = 0) -> bytes:
    """An ANMF chunk of a frame's chunks (ALPH and VP8, or VP8L) at (x, y),
    which must be even."""
    head = b"".join(v.to_bytes(3, "little") for v in (x // 2, y // 2, w - 1, h - 1, duration))
    return webp_chunk(b"ANMF", head + bytes([bits]) + frame)


def alpha_residuals(alpha, method: int) -> np.ndarray:
    """libwebp's ALPH filter `method` (0 none, 1 horizontal, 2 vertical, 3
    gradient) applied to a uint8 (H, W) plane: the residuals its decoder
    adds back (first row from the left starting at 0, first column from
    above)."""
    a = alpha.astype(np.int32)
    pred = np.zeros_like(a)
    if method:
        pred[0, 1:] = a[0, :-1]
        pred[1:, 0] = a[:-1, 0]
        if method == 1:
            pred[1:, 1:] = a[1:, :-1]
        elif method == 2:
            pred[1:, 1:] = a[:-1, 1:]
        else:
            pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) & 255).astype(np.uint8)


def alph_chunk(alpha, method: int, compression: int, pre: int = 0) -> bytes:
    """An ALPH chunk of a uint8 (H, W) plane written by hand: filter
    `method`, raw (`compression` 0) or as the green channel of a VP8L
    stream (1: Pillow's lossless encode without its 5-byte header)."""
    res = alpha_residuals(alpha, method)
    if compression:
        res = webp_chunks(pillow_webp(np.repeat(res[..., None], 3, -1), lossless=True))[b"VP8L"][5:]
    else:
        res = res.tobytes()
    return webp_chunk(b"ALPH", bytes([compression | method << 2 | pre << 4]) + res)


def smooth_image(rng, h: int, w: int, c: int, noise: int = 40) -> np.ndarray:
    """Sine gradients per channel plus uniform noise, uint8."""
    y, x = np.mgrid[0:h, 0:w]
    chans = [np.sin(x / (3.0 + 2 * k) + y / (5.0 + k)) * 0.5 + 0.5 for k in range(c)]
    a = np.stack(chans, -1) * (255 - noise) + rng.integers(0, noise + 1, (h, w, c))
    return np.clip(a, 0, 255).astype(np.uint8)


def disc_pattern(n: int = 64) -> np.ndarray:
    """textured_obj's leaf cut-out: a grid of discs, (n, n) bool."""
    yy, xx = np.mgrid[0:n, 0:n]
    return (xx % 16 - 8.0) ** 2 + (yy % 16 - 8.0) ** 2 < 36.0


def write_new_format_fixtures(out: Path) -> None:
    """The GIF, PSD, PNM, RLE/16-bit BMP and 16-bit TGA fixtures: the GIF,
    PSD, PGM and RLE8 BMP stand in for textured_obj's ground colour, leaf
    colour, ground specular and leaf opacity maps (chip_smoke phase 38)."""
    rng = np.random.default_rng(16)
    yy, xx = np.mgrid[0:64, 0:64]
    checker = (xx // 8 + yy // 8) % 2
    idx = (checker * 8 + rng.integers(0, 8, (64, 64)))[3:62, 2:62]
    pal = np.concatenate([np.stack([64 + 4 * np.arange(8), 56 + 3 * np.arange(8), 51 + np.arange(8)], -1),
                          np.stack([200 + 4 * np.arange(8), 158 + 3 * np.arange(8), 115 + np.arange(8)], -1)])
    (out / "frame.gif").write_bytes(encode_gif(
        [dict(indices=idx, x=2, y=3, palette=pal, interlace=True, transparency=5, min_size=4),
         dict(indices=rng.integers(0, 4, (8, 8)), x=10, y=10, min_size=2)],
        (64, 64), rng.integers(0, 256, (4, 3))))
    leaf = np.stack([26 + 20 * checker, 115 + 64 * checker, np.full((64, 64), 20)], -1)
    leaf = (leaf + rng.integers(0, 4, (64, 64, 1))).astype(np.uint8)
    (out / "leaf.psd").write_bytes(encode_psd([leaf[..., k] for k in range(3)], 3, compression=1, rng=rng))
    (out / "cmyk.psd").write_bytes(encode_psd(
        [smooth_image(rng, 15, 20, 1, noise=60)[..., 0] for _ in range(4)], 4))
    gloss = np.clip(xx * 100 // 63, 5, 95)
    (out / "gloss.pgm").write_bytes(encode_pnm(gloss, b"P5", 100, comments=True))
    (out / "comments.ppm").write_bytes(encode_pnm(
        rng.integers(0, 1001, (12, 16, 3)), b"P3", 1000, comments=True, rng=rng))
    (out / "discs_rle8.bmp").write_bytes(make_bmp(
        None, 8, 40, False, [[12, 20, 8], [225, 235, 215]], 1,
        data=encode_bmp_rle(disc_pattern().astype(int), False, rng), size=(64, 64)))
    idx4 = rng.integers(0, 16, (17, 31))
    idx4[:, ::2] = idx4[:, :1]
    (out / "rle4.bmp").write_bytes(make_bmp(
        None, 4, 40, False, rng.integers(0, 256, (16, 3)), 2,
        data=encode_bmp_rle(idx4, True, rng), size=(31, 17)))
    (out / "bf565.bmp").write_bytes(make_bmp(
        smooth_image(rng, 17, 33, 2).view("<u2")[..., 0], 16, 40, False, compression=3,
        masks=(0xF800, 0x7E0, 0x1F)))
    (out / "rgb16_rle.tga").write_bytes(make_tga(
        smooth_image(rng, 23, 37, 2, noise=8), 10, 16, 0x21, rng=rng))


def write_tiff_fixtures(out: Path) -> None:
    """The TIFF, YCCK and CMYK JPEG fixtures: the first four stand in for
    textured_obj's ground colour, ground specular, leaf colour and leaf
    opacity maps (chip_smoke phase 38)."""
    from PIL import Image

    rng = np.random.default_rng(17)
    yy, xx = np.mgrid[0:64, 0:64]
    checker = (xx // 8 + yy // 8) % 2
    ground = np.stack([96 + 64 * checker, 80 + 40 * checker, 60 + 20 * checker], -1)
    ground = (ground + rng.integers(0, 6, (64, 64, 3))).astype(np.uint8)
    (out / "lzw_pred_rgb.tif").write_bytes(make_tiff(ground, 8, 2, compression=5, predictor=2,
                                                     rows_per_strip=8))
    gloss = np.clip(xx * 3 + yy, 0, 255)[:50, :37].astype(np.uint8)
    (out / "deflate_tiles_grey.tif").write_bytes(make_tiff(gloss, 8, 1, compression=32946, tile=(16, 16),
                                                           order=">"))
    leaf = np.stack([26 + 20 * checker, 115 + 64 * checker, np.full((64, 64), 20)], -1).astype(np.uint8)
    ycc = np.asarray(Image.fromarray(leaf).convert("YCbCr"))
    (out / "jpeg_ycbcr.tif").write_bytes(make_tiff(ycc, 8, 6, compression=7, subsampling=(2, 2),
                                                   tile=(32, 32), jpeg_q=2))
    disc = disc_pattern(64)
    cut = np.where(disc[..., None], [225, 235, 215, 255], [12, 20, 8, 96]).astype(np.uint8)
    (out / "packbits_rgba.tif").write_bytes(make_tiff(cut, 8, 2, extra=[2], compression=32773, planar=2,
                                                      rows_per_strip=16, packbits_rng=rng))
    (out / "bigtiff_planar.tif").write_bytes(make_tiff(smooth_image(rng, 23, 29, 3), 8, 2, header="bigtiff",
                                                       planar=2, compression=8, rows_per_strip=10))
    (out / "ycbcr22_lzw.tif").write_bytes(make_tiff(smooth_image(rng, 19, 27, 3), 8, 6, compression=5,
                                                    subsampling=(2, 2), rows_per_strip=6))
    (out / "ycck.jpg").write_bytes(encode_jpeg([smooth_image(rng, 21, 35, 1)[..., 0] for _ in range(4)],
                                               [(2, 2), (1, 1), (1, 1), (2, 2)], q=3, adobe=2))
    Image.fromarray(smooth_image(rng, 24, 30, 4), "CMYK").save(out / "cmyk.jpg", quality=90)


def write_webp_fixtures(out: Path) -> None:
    """The corrupt JPEGs and the WebP fixtures: a 64x64 lossy leaf with its
    cut-out in ALPH and a 64x64 lossless ground stand in for textured_obj's
    leaf and ground colour maps (chip_smoke phase 38); the three 1024^2
    files are phase 38's decode timings (lossy with alpha, lossy, lossless)."""
    for name, (seed, edits) in CORRUPT_JPEGS.items():
        data = bytearray((out / seed).read_bytes())
        for offset, byte in edits:
            data[offset] = byte
        (out / name).write_bytes(bytes(data))
    rng = np.random.default_rng(18)
    yy, xx = np.mgrid[0:64, 0:64]
    checker = (xx // 8 + yy // 8) % 2
    disc = disc_pattern(64)
    leaf = np.where(disc[..., None], [40, 150, 30, 255], [20, 90, 20, 0]) + rng.integers(0, 24, (64, 64, 4))
    (out / "leaf_alpha.webp").write_bytes(pillow_webp(np.clip(leaf, 0, 255), quality=80))
    ground = np.stack([110 + 50 * checker, 84 + 36 * checker, 60 + 20 * checker], -1) + rng.integers(0, 6, (64, 64, 3))
    (out / "ground_lossless.webp").write_bytes(pillow_webp(ground, lossless=True))
    y, x = np.mgrid[0:1024, 0:1024]
    smooth = np.stack([128 + 100 * np.sin(x / 197 + y / 263), 128 + 100 * np.cos(x / 301 - y / 167),
                       128 + 90 * np.sin((x + y) / 421)], -1).astype(np.uint8)
    (out / "smooth1024_alpha.webp").write_bytes(pillow_webp(np.dstack([smooth, ((x + y) // 8) & 255]), quality=30))
    (out / "smooth1024.webp").write_bytes(pillow_webp(smooth, quality=30))
    ramp = np.stack([(x + y) & 255, (2 * x) & 255, (3 * y) & 255], -1)
    (out / "ramp1024_lossless.webp").write_bytes(pillow_webp(ramp, lossless=True))


def write_fixtures(out: Path = FIXTURES) -> dict:
    """Write the committed fixtures and expected.json; returns the digests."""
    from PIL import Image

    from realtimeraytracer_torch.utils.image_decode import pixels_digest
    from realtimeraytracer_tpu.scene.obj_loader import load_texture_file

    rng = np.random.default_rng(15)
    out.mkdir(parents=True, exist_ok=True)
    Image.fromarray(smooth_image(rng, 45, 61, 3)).save(
        out / "prog420_odd.jpg", quality=90, subsampling=2, progressive=True)
    Image.fromarray(smooth_image(rng, 40, 57, 3)).save(
        out / "base422_rst.jpg", quality=85, subsampling=1, restart_marker_blocks=5)
    Image.fromarray(smooth_image(rng, 31, 40, 1)[..., 0]).save(out / "grey.jpg", quality=90)
    pal = Image.fromarray(smooth_image(rng, 32, 48, 3, noise=120)).quantize(16)
    pal.save(out / "palette_trns.png", transparency=bytes([0, 64, 128, 192, 255, 0, 30]))
    (out / "adam7.png").write_bytes(make_png(smooth_image(rng, 29, 37, 4, noise=80), 8, 6, 1))
    yy, xx = np.mgrid[0:64, 0:64]
    disc = ((xx % 16 - 8.0) ** 2 + (yy % 16 - 8.0) ** 2 < 36.0)
    leaf = np.where(disc[..., None], [225, 235, 215, 255], [12, 20, 8, 96]).astype(np.uint8)
    Image.fromarray(leaf, "RGBA").save(out / "rle.tga", compression="tga_rle")
    Image.fromarray(smooth_image(rng, 17, 33, 3)).save(out / "rgb24.bmp")
    y, x = np.mgrid[0:1024, 0:1024]
    big = np.stack([128 + 100 * np.sin(x / 97 + y / 131), 128 + 100 * np.cos(x / 151 - y / 83),
                    128 + 90 * np.sin((x + y) / 211)], -1).astype(np.uint8)
    Image.fromarray(big).save(out / "smooth1024.jpg", quality=90)
    write_new_format_fixtures(out)
    write_tiff_fixtures(out)
    write_webp_fixtures(out)
    digests = {name: {str(g).lower(): pixels_digest(load_texture_file(str(out / name), g))
                      for g in (False, True)} for name in FIXTURE_NAMES}
    (out / "expected.json").write_text(json.dumps({
        "what": "sha256 of the JAX package's load_texture_file(path, grayscale): "
                "realtimeraytracer_torch.utils.image_decode.pixels_digest",
        "digests": digests}, indent=1) + "\n")
    return digests


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    for name, d in write_fixtures().items():
        print(name, (FIXTURES / name).stat().st_size, d["false"][:12], d["true"][:12])
