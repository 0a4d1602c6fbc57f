"""The port's GPU texture containers against the JAX package's Pillow path.

Held here: realtimeraytracer_torch/utils/image_decode.py's readers of
Pillow's DDS, BLP and FTEX openers (their headers read in Python, their
blocks by native/bcn_decode.cpp: Pillow's C "bcn" decoder, DDS's channel
masks as its Python decoder computes them, and BLP's own Python DXT
decoder, which rounds otherwise) through the port's ``load_texture_file``
against the JAX package's, bit for bit and for both values of
``grayscale``, and the mode ``decode_image`` reports against Pillow's:
DDS files Pillow writes (DXT1, DXT3, DXT5, BC2, BC3, BC5, raw RGB(A), L,
LA) and DDS files tests/_torch_image_helpers.py writes (random BC4, BC5S,
BC6H UF16 and SF16 and BC7 blocks, channel masks of 16, 24 and 32 bits,
L, LA, a palette, DX10's R8G8B8A8, sizes that are not multiples of 4,
mips); BLP1 and BLP2 palette files Pillow writes, BLP1 JPEG (RGB, grey,
CMYK, YCCK) and BLP2 DXT1/3/5 files the helpers write; FTEX DXT1 and raw
files.  Files Pillow refuses raise ValueError in the port.  The skies:
8-bit, as every 8-bit sky (texel / 255; JAX's imageio keeps the bytes).

Tolerance: none; every case is bit-equal.  No JAX render runs here.
"""

import functools
import io
import os
import sys

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_image_helpers import (DDPF_ALPHAPIXELS, DDPF_LUMINANCE, DDPF_PALETTEINDEXED8, DDPF_RGB,  # noqa: E402
                                  encode_bc4, encode_bc7_mode6, encode_blp_dxt, encode_jpeg, make_blp1, make_blp2,
                                  make_dds, make_ftex, smooth_image)
from test_torch_images_raster import _both_raise, _same_as_jax  # noqa: E402
from realtimeraytracer_torch.scene import obj_loader as tol  # noqa: E402
from realtimeraytracer_tpu.scene import obj_loader as jol  # noqa: E402

SIZES = ((23, 37), (1, 1), (2, 3), (17, 2), (8, 12))   # (h, w)


def _pillow(image, fmt="DDS", **kw) -> bytes:
    b = io.BytesIO()
    image.save(b, fmt, **kw)
    return b.getvalue()


def _random_blocks(rng, w, h, size):
    return rng.integers(0, 256, (-(-w // 4) * -(-h // 4) * size,), np.uint8).tobytes()


def _bgra_palette(rng):
    return rng.integers(0, 256, 1024, np.uint8).tobytes()


@functools.lru_cache(maxsize=None)     # one build for all its cases
def _cases():
    rng = np.random.default_rng(2301)
    cases = {}

    def add(name, *files):
        cases[name] = list(files)

    # Pillow's DDS writers, at several sizes.
    for fmt, mode in (("DXT1", "RGBA"), ("DXT3", "RGBA"), ("DXT5", "RGBA"), ("BC2", "RGBA"), ("BC3", "RGBA"),
                      ("BC5", "RGB"), (None, "RGB"), (None, "RGBA"), (None, "L"), (None, "LA")):
        files = []
        for h, w in SIZES:
            im = Image.fromarray(smooth_image(rng, h, w, 4)).convert(mode)
            files.append(_pillow(im, pixel_format=fmt) if fmt else _pillow(im))
        add(f"pillow-dds-{fmt or 'raw'}-{mode}", *files)

    # Random blocks of every BCn code, through FourCCs and DX10 formats, at
    # sizes that are not multiples of 4.
    for name, kw, size in (("bc4u", dict(fourcc=b"BC4U"), 8), ("ati1", dict(fourcc=b"ATI1"), 8),
                           ("bc4-dx10", dict(dxgi=80), 8), ("bc5s", dict(fourcc=b"BC5S"), 16),
                           ("ati2", dict(fourcc=b"ATI2"), 16), ("bc5s-dx10", dict(dxgi=84), 16),
                           ("bc5-typeless", dict(dxgi=82), 16), ("bc1-dx10", dict(dxgi=71), 8),
                           ("bc2-dx10", dict(dxgi=74), 16), ("bc3-typeless", dict(dxgi=76), 16),
                           ("bc6h-uf16", dict(dxgi=95), 16), ("bc6h-sf16", dict(dxgi=96), 16),
                           ("bc7", dict(dxgi=98), 16), ("bc7-srgb", dict(dxgi=99), 16),
                           ("bc7-typeless", dict(dxgi=97), 16)):
        add(f"dds-{name}", *(make_dds(w, h, _random_blocks(rng, w, h, size), **kw)
                             for h, w in ((64, 32), (5, 7), (2, 9), (13, 1))))
    # BC6H's modes and BC7's mode byte of 0, block by block.
    b6 = rng.integers(0, 256, (14 * 16, 16), np.uint8)
    b6[:, 0] = (b6[:, 0] & 0xE0) | np.tile([0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15, 19, 23], 14)
    b7 = rng.integers(0, 256, (16 * 16, 16), np.uint8)
    b7[::16, 0] = 0
    for sign in (95, 96):
        add(f"dds-bc6h-modes-{sign}", make_dds(64, 56, b6.tobytes(), dxgi=sign))
    add("dds-bc7-modes", make_dds(64, 64, b7.tobytes(), dxgi=98))
    # Encoded blocks: BC4 of a gradient, BC7 mode 6 of a smooth image.
    add("dds-bc4-encoded", make_dds(37, 23, encode_bc4(smooth_image(rng, 23, 37, 1)[..., 0]), fourcc=b"BC4U"))
    add("dds-bc7-encoded", make_dds(37, 23, encode_bc7_mode6(smooth_image(rng, 23, 37, 4)), dxgi=98))

    # Channel masks: 5:6:5, 4:4:4:4, 24 and 32 bits with and without alpha,
    # masks with holes or none, 12 bits (one byte read a pixel), data short
    # of the image (zeros).
    px = rng.integers(0, 256, (9, 11, 4), np.uint8)
    words16 = px[..., :2].copy().view("<u2")[..., 0].tobytes()
    for name, bits, masks, flags, data in (
            ("565", 16, (0xF800, 0x7E0, 0x1F), DDPF_RGB, words16),
            ("4444", 16, (0xF00, 0xF0, 0xF, 0xF000), DDPF_RGB | DDPF_ALPHAPIXELS, words16),
            ("1555", 16, (0x7C00, 0x3E0, 0x1F, 0x8000), DDPF_RGB | DDPF_ALPHAPIXELS, words16),
            ("24", 24, (0xFF0000, 0xFF00, 0xFF), DDPF_RGB, px[..., :3].tobytes()),
            ("32-alpha", 32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000), DDPF_RGB | DDPF_ALPHAPIXELS, px.tobytes()),
            ("32-x", 32, (0xFF, 0xFF00, 0xFF0000), DDPF_RGB, px.tobytes()),
            ("holes", 32, (0x50A0, 0x3, 0, 0x80000001), DDPF_RGB | DDPF_ALPHAPIXELS, px.tobytes()),
            ("12", 12, (0xF0, 0xC, 0x3), DDPF_RGB, px[..., 0].tobytes()),
            ("short", 32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000), DDPF_RGB | DDPF_ALPHAPIXELS, px.tobytes()[:150])):
        add(f"dds-masks-{name}", make_dds(11, 9, data, pfflags=flags, bitcount=bits,
                                          masks=masks + (0,) * (4 - len(masks))))
    add("dds-luminance", make_dds(11, 9, px[..., 0].tobytes(), pfflags=DDPF_LUMINANCE, bitcount=8),
        make_dds(11, 9, px[..., :2].tobytes(), pfflags=DDPF_LUMINANCE | DDPF_ALPHAPIXELS, bitcount=16))
    add("dds-palette", make_dds(11, 9, px[..., 0].tobytes(), pfflags=DDPF_PALETTEINDEXED8, bitcount=8,
                                palette=_bgra_palette(rng)))
    add("dds-r8g8b8a8", *(make_dds(11, 9, px.tobytes(), dxgi=f) for f in (27, 28, 29)))
    mips = encode_bc7_mode6(smooth_image(rng, 16, 16, 4)) + encode_bc7_mode6(smooth_image(rng, 8, 8, 4))
    add("dds-mips", make_dds(16, 16, mips + bytes(32), dxgi=98, mips=5))

    # BLP: Pillow's palette files (BLP1, BLP2; an RGBA palette makes them
    # RGBA), BLP1 JPEG, BLP2 DXT.
    for version in ("BLP1", "BLP2"):
        files = []
        for h, w in SIZES:
            im = Image.fromarray(smooth_image(rng, h, w, 3)).quantize(40)
            files.append(_pillow(im, "BLP", blp_version=version))
        rgba = Image.fromarray(smooth_image(rng, 9, 13, 4)).convert("P")
        rgba.putpalette(rng.integers(0, 256, 1024, np.uint8).tobytes(), "RGBA")
        files.append(_pillow(rgba, "BLP", blp_version=version))
        add(f"pillow-blp-{version}", *files)
    add("blp1-palette-encoding4", make_blp1(13, 9, indices=rng.integers(0, 256, (9, 13)), palette=_bgra_palette(rng),
                                            alpha=8, encoding=4))
    rgb = smooth_image(rng, 12, 20, 3)
    planes = [rgb[..., k] for k in range(3)]
    add("blp1-jpeg", make_blp1(20, 12, jpeg=encode_jpeg(planes, [(2, 2), (1, 1), (1, 1)])),
        make_blp1(20, 12, jpeg=encode_jpeg(planes, [(1, 1)] * 3), alpha=1, split=100, gap=b"What IS this?"),
        make_blp1(20, 12, jpeg=encode_jpeg(planes[:1], [(1, 1)])),
        make_blp1(16, 12, jpeg=encode_jpeg(planes, [(1, 1)] * 3)))    # narrower than the JPEG: its bytes read on
    add("blp1-jpeg-cmyk", make_blp1(20, 12, jpeg=encode_jpeg(planes + planes[:1], [(1, 1)] * 4, adobe=0)),
        make_blp1(20, 12, jpeg=encode_jpeg(planes + planes[:1], [(1, 1)] * 4, adobe=2)),
        make_blp1(20, 12, jpeg=encode_jpeg(planes + planes[:1], [(1, 1)] * 4, jfif=False)))
    leaf = smooth_image(rng, 10, 14, 4)
    for kind, alpha_encoding in ((1, 0), (2, 1), (3, 7)):
        files = [make_blp2(w, h, encode_blp_dxt(smooth_image(rng, h, w, 4), kind), alpha=alpha,
                           alpha_encoding=alpha_encoding)
                 for h, w in ((10, 14), (7, 5), (4, 8)) for alpha in (0, 8)]
        files.append(make_blp2(14, 10, _random_blocks(rng, 14, 10, 8 if kind == 1 else 16), alpha=1,
                               alpha_encoding=alpha_encoding))
        add(f"blp2-dxt{2 * kind - 1}", *files)
    add("blp2-palette-hand", make_blp2(14, 10, rng.integers(0, 256, 140, np.uint8).tobytes(), encoding=1, alpha=0,
                                       palette=_bgra_palette(rng)))

    # FTEX: DXT1 blocks, raw RGB, a mipmap size of -1 (the rest of the file).
    add("ftex-dxt1", *(make_ftex(w, h, _random_blocks(rng, w, h, 8)) for h, w in ((12, 20), (5, 7))),
        make_ftex(14, 10, encode_blp_dxt(leaf, 1)))
    add("ftex-raw", make_ftex(7, 5, rng.integers(0, 256, 105, np.uint8).tobytes(), fmt=1),
        make_ftex(7, 5, rng.integers(0, 256, 120, np.uint8).tobytes(), fmt=1, size=-1))
    return cases


TEXTURE_CASES = sorted(_cases())


@pytest.mark.parametrize("case", TEXTURE_CASES)
def test_texture_formats_match_jax(tmp_path, case):
    """DDS, BLP and FTEX files Pillow reads: the port's load_texture_file
    equals the JAX package's (C1 applied) for both grayscale values, and
    decode_image reports Pillow's mode."""
    for i, data in enumerate(_cases()[case]):
        p = tmp_path / f"{case}_{i}"
        p.write_bytes(data)
        _same_as_jax(p)


@functools.lru_cache(maxsize=None)
def _refusals():
    rng = np.random.default_rng(2302)
    bc1 = make_dds(8, 8, _random_blocks(rng, 8, 8, 8), fourcc=b"DXT1")
    blp = make_blp2(8, 8, encode_blp_dxt(smooth_image(rng, 8, 8, 4), 3))
    jpeg = encode_jpeg([smooth_image(rng, 8, 8, 1)[..., 0]], [(1, 1)])
    return {
        "dds-header-size": make_dds(8, 8, bytes(32), fourcc=b"DXT1", header_size=100),
        "dds-header-cut": bc1[:90],
        "dds-6-bytes": b"DDS \x7c\x00",
        "dds-no-flags": make_dds(8, 8, bytes(64), pfflags=0),
        "dds-fourcc": make_dds(8, 8, bytes(64), fourcc=b"ABCD"),
        "dds-bc4s": make_dds(8, 8, bytes(64), fourcc=b"BC4S"),
        "dds-dxgi": make_dds(8, 8, bytes(64), dxgi=10),
        "dds-dxgi-srgb-bc1": make_dds(8, 8, bytes(64), dxgi=72),
        "dds-dx10-cut": make_dds(8, 8, b"", fourcc=b"DX10"),
        "dds-luminance-16": make_dds(8, 8, bytes(128), pfflags=DDPF_LUMINANCE, bitcount=16),
        "dds-bc1-cut": bc1[:-1],
        "dds-raw-cut": make_dds(8, 8, bytes(60), pfflags=DDPF_LUMINANCE, bitcount=8),
        "dds-palette-cut": make_dds(8, 8, bytes(1050), pfflags=DDPF_PALETTEINDEXED8),
        "ftex-formats-2": make_ftex(8, 8, bytes(32), format_count=2),
        "ftex-format-3": make_ftex(8, 8, bytes(32), fmt=3),
        "ftex-cut": make_ftex(8, 8, bytes(31)),
        "ftex-short-header": b"FTEX" + bytes(12),
        "ftex-size-below-minus-1": make_ftex(8, 8, bytes(32), size=-2),
        "blp2-encoding-3": make_blp2(8, 8, bytes(256), encoding=3),
        "blp2-alpha-encoding-2": make_blp2(8, 8, bytes(64), alpha_encoding=2),
        "blp2-compression-0": make_blp2(8, 8, bytes(64), compression=0),
        "blp2-palette-cut": blp[:700],
        "blp2-dxt-cut": blp[:-1],
        "blp2-indices-short": make_blp2(8, 8, bytes(40), encoding=1),
        "blp2-short-header": b"BLP2" + bytes(10),
        "blp1-encoding-3": make_blp1(8, 8, indices=np.zeros((8, 8)), encoding=3),
        "blp1-palette-cut": make_blp1(8, 8, indices=np.zeros((8, 8)))[:600],
        "blp1-indices-short": make_blp1(8, 8, indices=np.zeros((4, 8))),
        "blp1-jpeg-larger-than-its-jpeg": make_blp1(9, 8, jpeg=jpeg),
        "blp1-jpeg-not-a-jpeg": make_blp1(8, 8, jpeg=b"\0" * 20 + jpeg, split=10),
    }


REFUSALS = sorted(_refusals())


@pytest.mark.parametrize("case", REFUSALS)
def test_texture_refusals_match_jax(tmp_path, case):
    """Files Pillow refuses (a header of another size or cut, unknown flags,
    FourCC or DXGI format, data short of the image, an FTEX of two formats,
    BLP encodings it lacks, a cut palette, too few indices, a JPEG smaller
    than the BLP's size; or no opener takes them): JAX raises, and the port
    raises ValueError."""
    p = tmp_path / case
    p.write_bytes(_refusals()[case])
    _both_raise(p)


def test_texture_skies(tmp_path):
    """A BC6H DDS, a BLP and an FTEX sky through load_hdr against the JAX
    package's imageio (its Pillow plugin reads all three): 8-bit texels
    read as texel / 255 (JAX keeps the bytes: the logged fault of every
    8-bit sky); a BC6H sky is Pillow's bytes, not half-float radiance."""
    rng = np.random.default_rng(2303)
    for name, data in (("sky.dds", make_dds(16, 8, _random_blocks(rng, 16, 8, 16), dxgi=95)),
                       ("sky.blp", make_blp2(16, 8, encode_blp_dxt(smooth_image(rng, 8, 16, 4), 3))),
                       ("sky.ftc", make_ftex(16, 8, _random_blocks(rng, 16, 8, 8)))):
        p = tmp_path / name
        p.write_bytes(data)
        jax = jol.load_hdr(str(p), tone_encode=False)
        assert jax.shape == (8, 16, 3) and jax.max() > 1.5
        assert np.array_equal(tol.load_hdr(str(p)), jax / np.float32(255))


def test_blp1_jpeg_reads_cmyk_as_its_samples(tmp_path):
    """BlpImagePlugin reads a 4-component JPEG with libjpeg's colour space
    forced to CMYK: a plain CMYK file reads as Pillow's own JPEG path does,
    a YCCK one keeps its Y, Cb, Cr samples (unconverted, inverted as
    "CMYK;I"); the result is read back as BGR."""
    rng = np.random.default_rng(2304)
    planes = [smooth_image(rng, 8, 8, 1)[..., 0] for _ in range(4)]
    for adobe in (0, 2):
        jpeg = encode_jpeg(planes, [(1, 1)] * 4, adobe=adobe)
        p = tmp_path / f"cmyk{adobe}.blp"
        p.write_bytes(make_blp1(8, 8, jpeg=jpeg))
        own = np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB"))[::-1, :, ::-1] / np.float32(255)
        got = tol.load_texture_file(str(p))
        assert np.array_equal(got, own) == (adobe == 0)
        _same_as_jax(p)


def test_blp2_dxt_rows_of_whole_blocks_read_at_the_image_width(tmp_path):
    """BLP2's Python DXT decoder writes rows of whole 4 x 4 blocks, which
    Pillow reads at the image's width: a width that is not a multiple of
    4 shears the rows (and DXT3/5 without alpha read 4-byte pixels as
    RGB); the port reads the same bytes."""
    rng = np.random.default_rng(2305)
    src = smooth_image(rng, 8, 6, 4)
    p = tmp_path / "sheared.blp"
    p.write_bytes(make_blp2(6, 8, encode_blp_dxt(src, 3), alpha=0))
    assert tol.load_texture_file(str(p)).shape == (8, 6, 3)
    _same_as_jax(p)
