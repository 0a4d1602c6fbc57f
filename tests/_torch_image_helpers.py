"""Image writers for the port's decoder tests, and the committed fixtures.

Pillow writes no Adam7 PNG, no PNG of an arbitrary colour type and depth,
and no JPEG sampled 4:4:0 or 4:1:1, so ``make_png`` and ``encode_jpeg``
write them here from NumPy; Pillow then decodes them as the oracle.

``python tests/_torch_image_helpers.py`` rewrites ``tests/data/images/``:
the fixtures (written with Pillow and ``make_png`` from seeded NumPy
images) and ``expected.json``, the SHA-256 of the JAX package's
``load_texture_file`` output on each (``image_decode.pixels_digest``), for
both values of ``grayscale``.  It needs Pillow and the JAX package.
"""

from __future__ import annotations

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
                 "adam7.png", "rgb24.bmp", "smooth1024.jpg")

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
        comps.append(coefs.reshape(coefs.shape[0], coefs.shape[1], 64)[:, :, _NATURAL])
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
        units = [[(0, comps[0][by, bx])] for by in range(bh) for bx in range(bw)]
    else:
        units = [[(ci, comps[ci][my * v + y, mx * h + x]) for ci, (h, v) in enumerate(factors)
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


def smooth_image(rng, h: int, w: int, c: int, noise: int = 40) -> np.ndarray:
    """Sine gradients per channel plus uniform noise, uint8."""
    y, x = np.mgrid[0:h, 0:w]
    chans = [np.sin(x / (3.0 + 2 * k) + y / (5.0 + k)) * 0.5 + 0.5 for k in range(c)]
    a = np.stack(chans, -1) * (255 - noise) + rng.integers(0, noise + 1, (h, w, c))
    return np.clip(a, 0, 255).astype(np.uint8)


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
