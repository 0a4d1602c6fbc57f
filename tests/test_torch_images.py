"""The port's image decoders against the JAX package's Pillow/imageio path.

Held here: realtimeraytracer_torch/utils/image_decode.py (the native
decoder of native/image_decode.cpp) through the port's
``load_texture_file`` against the JAX package's, bit for bit and for both
values of ``grayscale``, on a matrix of files written in tmp_path from
seeded NumPy images: JPEG written by Pillow (quality 50 and 95, 4:4:4,
4:2:2, 4:2:0, progressive, restart markers, grey, sizes that are no
multiple of the MCU) and by tests/_torch_image_helpers.py's encoder
(4:4:0, 4:1:1, 3:1, chroma wider than luma, Adobe RGB); PNG written by
Pillow (1, L, LA, P with transparency, RGB, RGBA) and by hand (every
colour type and depth, tRNS, Adam7: Pillow writes no interlaced PNG); TGA
(L, P, RGB, RGBA, raw and RLE, every origin) and BMP (1, L, P, RGB, RGBA;
the header sizes, bitfields, top-down rows).  Also: the native 8-bit PNG
path against utils/png.py's decoder; truncated, corrupt and refused files
raise ValueError; the two divergences from the JAX package (16-bit grey
PNG, 8-bit skies), each with both sides' values; the five helpers of
ops/ against JAX; the committed fixtures of tests/data/images against
expected.json; an OBJ/MTL scene with JPEG and TGA maps through both
packages' loaders.

Tolerance: none.  Every case is bit-equal (the decoders reproduce
libjpeg-turbo's ISLOW IDCT, fancy upsampling and colour tables, and
Pillow's modes); the helpers rtol 1e-6.  No JAX render runs here.
"""

import io
import json
import os
import struct
import sys

import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_image_helpers import (FIXTURES, encode_jpeg, make_png,  # noqa: E402
                                  smooth_image)
from realtimeraytracer_torch.ops import bvh as tbvh  # noqa: E402
from realtimeraytracer_torch.ops import camera_rays as tcam  # noqa: E402
from realtimeraytracer_torch.ops import vecmath as tvm  # noqa: E402
from realtimeraytracer_torch.scene import obj_loader as tol  # noqa: E402
from realtimeraytracer_torch.utils import image_decode  # noqa: E402
from realtimeraytracer_torch.utils.png import decode_png, encode_png  # noqa: E402
from realtimeraytracer_tpu.ops import bvh as jbvh  # noqa: E402
from realtimeraytracer_tpu.ops import camera_rays as jcam  # noqa: E402
from realtimeraytracer_tpu.ops import vecmath as jvm  # noqa: E402
from realtimeraytracer_tpu.scene import obj_loader as jol  # noqa: E402

SIZES = ((23, 37), (1, 1), (2, 3), (17, 2), (9, 33), (40, 24))   # (h, w)


def _same_as_jax(path, mode=None):
    """The port's load_texture_file equals the JAX package's, for both
    grayscale values; and the decoder reports Pillow's mode."""
    for grayscale in (False, True):
        want = jol.load_texture_file(str(path), grayscale)
        got = tol.load_texture_file(str(path), grayscale)
        assert got.dtype == want.dtype and got.shape == want.shape, (path, grayscale)
        assert np.array_equal(got, want), (path, grayscale, float(np.abs(got - want).max()))
    with open(path, "rb") as f:
        assert image_decode.decode_image(f.read())[1] == (mode or Image.open(path).mode)


def _save(tmp_path, name, image, **kw):
    p = tmp_path / name
    image.save(p, **kw)
    return p


JPEG_CASES = {f"q{q}-s{s}" + ("-progressive" if prog else ""): dict(quality=q, subsampling=s,
                                                                     progressive=prog)
              for q in (50, 95) for s in (0, 1, 2) for prog in (False, True)}
JPEG_CASES.update({
    "restart-blocks-422": dict(quality=80, subsampling=1, restart_marker_blocks=3),
    "restart-rows-420-progressive": dict(quality=80, subsampling=2, progressive=True,
                                         restart_marker_rows=1),
    "optimized-444": dict(quality=90, subsampling=0, optimize=True),
})


@pytest.mark.parametrize("case", sorted(JPEG_CASES))
def test_pillow_jpeg_matches_jax(tmp_path, case):
    rng = np.random.default_rng(sorted(JPEG_CASES).index(case))
    for h, w in SIZES:
        _same_as_jax(_save(tmp_path, f"{h}x{w}.jpg", Image.fromarray(smooth_image(rng, h, w, 3)),
                           **JPEG_CASES[case]))


@pytest.mark.parametrize("progressive", [False, True])
def test_grey_jpeg_matches_jax(tmp_path, progressive):
    rng = np.random.default_rng(1)
    for h, w in SIZES:
        for q in (50, 95):
            img = Image.fromarray(smooth_image(rng, h, w, 1)[..., 0])
            _same_as_jax(_save(tmp_path, f"{h}x{w}q{q}.jpg", img, quality=q,
                               progressive=progressive))


ENCODED = {
    "440": ((1, 2), (1, 1), (1, 1)),
    "411": ((4, 1), (1, 1), (1, 1)),
    "31": ((3, 1), (1, 1), (1, 1)),
    "422-by-v": ((2, 2), (1, 2), (1, 2)),
    "chroma-wider": ((1, 1), (2, 2), (1, 1)),
    "42-11-11": ((4, 2), (1, 1), (1, 1)),
}


@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("sampling", sorted(ENCODED))
def test_encoded_jpeg_samplings_match_jax(tmp_path, sampling, restart):
    """Samplings Pillow cannot write (h1v2 fancy upsampling, the generic
    integral upsampler), from the test encoder."""
    rng = np.random.default_rng(7)
    for h, w in SIZES:
        planes = [smooth_image(rng, h, w, 1)[..., 0] for _ in range(3)]
        p = tmp_path / f"{h}x{w}.jpg"
        p.write_bytes(encode_jpeg(planes, ENCODED[sampling], q=3, restart=restart))
        _same_as_jax(p)


def test_adobe_and_component_id_colour_spaces_match_jax(tmp_path):
    """libjpeg's colour-space rules: Adobe transform 0 is RGB, 1 YCbCr;
    without JFIF or Adobe, ids 'R','G','B' are RGB; a grey frame sampled
    2x2."""
    rng = np.random.default_rng(8)
    planes = [smooth_image(rng, 23, 37, 1)[..., 0] for _ in range(3)]
    for name, data in {
        "adobe-rgb": encode_jpeg(planes, ((1, 1),) * 3, adobe=0),
        "adobe-ycc": encode_jpeg(planes, ((2, 2), (1, 1), (1, 1)), adobe=1),
        "ids-rgb": encode_jpeg(planes, ((1, 1),) * 3, jfif=False, ids=b"RGB"),
        "ids-other": encode_jpeg(planes, ((1, 1),) * 3, jfif=False, ids=b"abc"),
        "grey-2x2": encode_jpeg(planes[:1], ((2, 2),)),
    }.items():
        p = tmp_path / f"{name}.jpg"
        p.write_bytes(data)
        _same_as_jax(p)


PIL_PNG_MODES = ("1", "L", "LA", "P", "RGB", "RGBA")


@pytest.mark.parametrize("mode", PIL_PNG_MODES)
def test_pillow_png_matches_jax(tmp_path, mode):
    rng = np.random.default_rng(PIL_PNG_MODES.index(mode))
    for h, w in SIZES:
        noise = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        kw = {}
        if mode == "1":
            img = Image.fromarray(noise[..., 0] > 127)
        elif mode == "P":
            img = Image.fromarray(noise[..., :3]).quantize(7)
            kw = {"transparency": bytes([0, 128, 255, 3])}
        else:
            img = Image.fromarray(noise[..., :len(mode)].squeeze(-1) if mode == "L"
                                  else noise[..., :len(mode)], mode)
        _same_as_jax(_save(tmp_path, f"{h}x{w}.png", img, **kw))


PNG_TYPES = [(ctype, depth) for ctype, depths in ((0, (1, 2, 4, 8)), (2, (8, 16)), (3, (1, 2, 4, 8)),
                                                  (4, (8, 16)), (6, (8, 16))) for depth in depths]


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("ctype,depth", PNG_TYPES)
def test_png_types_depths_and_adam7_match_jax(tmp_path, ctype, depth, interlace):
    """Every colour type and depth, every row filter, with and without
    Adam7; tRNS on grey (Pillow's key rule: 1-bit keys become 0/255, other
    depths compare the raw key with the scaled sample), on RGB (ignored:
    the mode stays RGB) and on palettes (indexes past a short palette are
    opaque black)."""
    rng = np.random.default_rng(ctype * 100 + depth * 2 + interlace)
    spp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    top = (1 << depth) - 1
    for h, w in ((13, 11), (1, 1), (2, 9), (8, 8), (5, 17)):
        s = rng.integers(0, top + 1, (h, w, spp))
        files = {"plain": make_png(s, depth, ctype, interlace)} if ctype != 3 else {}
        if ctype == 0:
            for key in (0, 1, top):
                files[f"key{key}"] = make_png(s, depth, 0, interlace, trns=struct.pack(">H", key))
        if ctype == 2:
            files["key"] = make_png(s, depth, 2, interlace, trns=struct.pack(">HHH", *s[0, 0]))
        if ctype == 3:
            npal = min(top + 1, 6)
            idx = rng.integers(0, npal, (h, w, 1))
            plte = rng.integers(0, 256, 3 * npal).astype(np.uint8).tobytes()
            files["palette"] = make_png(idx, depth, 3, interlace, plte)
            files["palette-trns"] = make_png(idx, depth, 3, interlace, plte, bytes([0, 77, 255]))
            idx[0, 0, 0] = top
            files["short-palette"] = make_png(idx, depth, 3, interlace, plte[:6], bytes([0, 77, 255]))
        for name, data in files.items():
            p = tmp_path / f"{name}-{h}x{w}.png"
            p.write_bytes(data)
            _same_as_jax(p)


@pytest.mark.parametrize("mode", ["L", "P", "RGB", "RGBA"])
def test_pillow_tga_matches_jax(tmp_path, mode):
    rng = np.random.default_rng(20 + "LPRGBA".index(mode[0]))
    for h, w in SIZES:
        noise = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        if mode == "P":
            img = Image.fromarray(noise[..., :3]).quantize(9)
        else:
            img = Image.fromarray(noise[..., 0] if mode == "L" else noise[..., :len(mode)], mode)
        _same_as_jax(_save(tmp_path, f"{h}x{w}.tga", img))
        _same_as_jax(_save(tmp_path, f"{h}x{w}-rle.tga", img, compression="tga_rle"))


def _tga(pix, itype, depth, flags=0, cmap=None, cmap_start=0, idfield=b"", rng=None):
    """TGA bytes; RLE packets (type & 8) break at each row, as Pillow's do."""
    h, w = pix.shape[:2]
    ncmap = 0 if cmap is None else len(cmap) // 3
    head = struct.pack("<BBBHHBHHHHBB", len(idfield), int(cmap is not None), itype, cmap_start,
                       ncmap, 24 if cmap is not None else 0, 0, 0, w, h, depth, flags)
    body = bytearray()
    for row in pix.reshape(h, w, -1).astype(np.uint8):
        if not itype & 8:
            body += row.tobytes()
            continue
        i = 0
        while i < w:
            n = min(int(rng.integers(1, 6)), w - i)
            if (row[i:i + n] == row[i]).all():
                body.append(0x80 | (n - 1))
                body += row[i].tobytes()
            else:
                body.append(n - 1)
                body += row[i:i + n].tobytes()
            i += n
    return head + idfield + (bytes(cmap) if cmap is not None else b"") + bytes(body)


@pytest.mark.parametrize("flags", [0x00, 0x20, 0x10, 0x30, 0x28])
def test_tga_origins_and_colour_maps_match_jax(tmp_path, flags):
    rng = np.random.default_rng(flags)
    for h, w in ((7, 5), (1, 1), (3, 20)):
        g = rng.integers(0, 256, (h, w, 1))
        c3 = rng.integers(0, 256, (h, w, 3))
        c4 = rng.integers(0, 256, (h, w, 4))
        c3[:, ::3] = c3[:, :1]                     # runs for the RLE packets
        idx = rng.integers(0, 12, (h, w, 1))
        cmap = rng.integers(0, 256, 27).astype(np.uint8)
        for rle in (0, 8):
            for name, data in {
                "grey": _tga(g, 3 | rle, 8, flags, idfield=b"id", rng=rng),
                "rgb": _tga(c3, 2 | rle, 24, flags, rng=rng),
                "rgba": _tga(c4, 2 | rle, 32, flags | 8, rng=rng),
                "mapped": _tga(idx, 1 | rle, 8, flags, cmap, cmap_start=2, rng=rng),
            }.items():
                p = tmp_path / f"{name}{rle}-{h}x{w}.tga"
                p.write_bytes(data)
                _same_as_jax(p)


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_pillow_bmp_matches_jax(tmp_path, mode):
    rng = np.random.default_rng(30 + len(mode))
    for h, w in SIZES:
        noise = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        if mode == "1":
            img = Image.fromarray(noise[..., 0] > 127)
        elif mode == "P":
            img = Image.fromarray(noise[..., :3]).quantize(11)
        else:
            img = Image.fromarray(noise[..., 0] if mode == "L" else noise[..., :len(mode)], mode)
        _same_as_jax(_save(tmp_path, f"{h}x{w}.bmp", img))


def _bmp(pix, bits, hs=40, top_down=False, palette=None, compression=0, masks=None):
    """BMP bytes with a `hs`-byte header; masks follow a 40-byte header."""
    h, w = pix.shape[:2]
    stride = ((w * bits + 31) >> 3) & ~3
    rows = []
    for r in pix:
        if bits <= 8:
            b = np.packbits(np.unpackbits(r.reshape(-1).astype(np.uint8)[:, None], axis=1)
                            [:, 8 - bits:].reshape(-1)).tobytes()
        else:
            b = r.astype(np.uint8).tobytes()
        rows.append(b + bytes(stride - len(b)))
    data = b"".join(rows if top_down else rows[::-1])
    pad = b"" if hs == 12 else b"\0"
    pal = b"" if palette is None else b"".join(bytes(p[::-1]) + pad for p in palette)
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


@pytest.mark.parametrize("hs,top_down", [(12, False), (40, False), (40, True), (108, False),
                                         (108, True), (124, False), (124, True)])
def test_bmp_headers_bitfields_and_rows_match_jax(tmp_path, hs, top_down):
    """A 12-byte header (no top-down rows) and the 40-124 byte ones."""
    rng = np.random.default_rng(hs + top_down)
    for h, w in ((7, 5), (1, 1), (3, 20), (4, 33)):
        files = {}
        for bits in (1, 4, 8):
            npal = (1 << bits) if hs == 12 else min(1 << bits, 5)   # a short palette: black
            files[f"p{bits}"] = _bmp(rng.integers(0, 1 << bits, (h, w, 1)), bits, hs, top_down,
                                     rng.integers(0, 256, (npal, 3)))
        files["rgb24"] = _bmp(rng.integers(0, 256, (h, w, 3)), 24, hs, top_down)
        files["rgb32"] = _bmp(rng.integers(0, 256, (h, w, 4)), 32, hs, top_down)
        if hs != 12:
            files["bf24"] = _bmp(rng.integers(0, 256, (h, w, 3)), 24, hs, top_down, compression=3,
                                 masks=(0xFF0000, 0xFF00, 0xFF))
            for masks in ((0xFF0000, 0xFF00, 0xFF, 0xFF000000), (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                          (0xFF000000, 0xFF0000, 0xFF00, 0xFF), (0xFF0000, 0xFF00, 0xFF, 0),
                          (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0, 0, 0, 0)):
                files[f"bf32-{masks[0]:x}-{masks[3]:x}"] = _bmp(
                    rng.integers(0, 256, (h, w, 4)), 32, hs, top_down, compression=3,
                    masks=masks if hs != 40 else masks[:3])
        for name, data in files.items():
            p = tmp_path / f"{name}-{h}x{w}.bmp"
            p.write_bytes(data)
            if name.startswith("bf32-ff-") and hs == 40:
                with pytest.raises(ValueError, match="bitfields"):   # Pillow refuses it too
                    tol.load_texture_file(str(p))
                continue
            _same_as_jax(p)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_native_png_matches_python_codec(channels):
    """8-bit grey, RGB, RGBA through every row filter: the native path
    equals utils/png.py's decoder (and both the encoded pixels)."""
    rng = np.random.default_rng(channels)
    for h, w in ((19, 23), (1, 1), (64, 3)):
        img = smooth_image(rng, h, w, channels)
        for filters in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4]):
            data = encode_png(img, filters)
            got, mode = image_decode.decode_image(data)
            assert mode == {1: "L", 3: "RGB", 4: "RGBA"}[channels]
            assert np.array_equal(got, decode_png(data)) and np.array_equal(got, img)


def _fixture(name):
    return (FIXTURES / name).read_bytes()


@pytest.mark.parametrize("name", ["prog420_odd.jpg", "base422_rst.jpg", "adam7.png", "rle.tga",
                                  "rgb24.bmp", "palette_trns.png"])
def test_truncated_and_corrupt_files_raise(name):
    """Cut at several points, or with a marker, a CRC or a header field
    broken: ValueError, never a crash or a quiet result."""
    data = _fixture(name)
    end = len(data) - 26 if data.endswith(b"TRUEVISION-XFILE.\0") else len(data)  # TGA footer
    for cut in (end - 1, end - 7, end * 3 // 4, end // 2, 40, 20, 10, 3):
        with pytest.raises(ValueError):
            image_decode.decode_image(data[:cut])
    broken = []
    if name.endswith(".jpg"):
        sof = data.index(b"\xff\xc2" if "prog" in name else b"\xff\xc0")
        sos = data.index(b"\xff\xda")
        broken += [data[:sos] + b"\xff\x02" + data[sos + 2:],              # unknown marker
                   data[:sof + 5] + b"\x00\x00" + data[sof + 7:],         # height 0 (DNL)
                   data[:sos + 20] + b"\xff\xd9" + data[sos + 20:]]       # EOI inside a scan
        if "rst" in name:
            rst = data.index(b"\xff\xd0")
            broken.append(data[:rst + 1] + b"\xd3" + data[rst + 2:])      # RST out of sequence
    elif name.endswith(".png"):
        broken += [data[:40] + bytes([data[40] ^ 0xFF]) + data[41:],      # bad CRC
                   data[:24] + b"\x07" + data[25:]]                        # bad bit depth
    elif name.endswith(".tga"):
        broken += [data[:2] + b"\x05" + data[3:], data[:16] + b"\x10" + data[17:]]
    else:
        broken += [data[:28] + b"\x07" + data[29:], data[:30] + b"\x01" + data[31:]]
    for bad in broken:
        with pytest.raises(ValueError):
            image_decode.decode_image(bad)


def test_refused_formats_and_features_raise(tmp_path):
    """Formats and features not ported raise ValueError naming them."""
    img = Image.fromarray(smooth_image(np.random.default_rng(0), 16, 16, 3))
    for fmt, words in (("GIF", "GIF"), ("TIFF", "TIFF"), ("WEBP", "WebP"), ("PPM", "PNM")):
        buf = io.BytesIO()
        img.save(buf, format=fmt)
        with pytest.raises(ValueError, match=words):
            image_decode.decode_image(buf.getvalue())
    with pytest.raises(ValueError, match="PSD"):
        image_decode.decode_image(b"8BPS" + bytes(40))
    cmyk = io.BytesIO()
    img.convert("CMYK").save(cmyk, format="JPEG")
    with pytest.raises(ValueError, match="CMYK"):
        image_decode.decode_image(cmyk.getvalue())
    base = _fixture("base422_rst.jpg")
    sof = base.index(b"\xff\xc0")
    for marker, precision, words in ((b"\xff\xc0", 12, "12-bit"), (b"\xff\xc9", 8, "arithmetic"),
                                     (b"\xff\xc3", 8, "lossless"), (b"\xff\xc5", 8, "hierarchical")):
        bad = base[:sof] + marker + base[sof + 2:sof + 4] + bytes([precision]) + base[sof + 5:]
        with pytest.raises(ValueError, match=words):
            image_decode.decode_image(bad)
    # A progressive file without its last scan would be block-smoothed by libjpeg.
    prog = _fixture("prog420_odd.jpg")
    last_sos = prog.rindex(b"\xff\xda")
    with pytest.raises(ValueError, match="incomplete progressive"):
        image_decode.decode_image(prog[:last_sos] + b"\xff\xd9")
    # BMP RLE8 and 16-bit, 16-bit TGA.
    bmp8 = _bmp(np.zeros((4, 4, 1), int), 8, palette=np.zeros((4, 3), int))
    with pytest.raises(ValueError, match="RLE"):
        image_decode.decode_image(bmp8[:30] + b"\x01" + bmp8[31:])
    bmp16 = _bmp(np.zeros((4, 4, 2), int), 16)
    with pytest.raises(ValueError, match="16-bit BMP"):
        image_decode.decode_image(bmp16)
    tga16 = _tga(np.zeros((4, 4, 2), int), 2, 16)
    with pytest.raises(ValueError, match="16-bit TGA"):
        image_decode.decode_image(tga16)
    with pytest.raises(ValueError, match="not an image"):
        image_decode.decode_image(b"plain text, not an image")


def test_grey16_png_diverges_from_jax_as_stb(tmp_path):
    """Pillow opens a 16-bit grey PNG as "I;16" and the JAX package's
    convert clips it to 255; stb_image (the reference) keeps the high
    byte, and so does the port (ROADMAP queue C)."""
    samples = np.array([[55745, 41743, 33497, 200, 0]], np.uint16)
    p = tmp_path / "i16.png"
    p.write_bytes(make_png(samples, 16, 0))
    assert Image.open(p).mode == "I;16"
    jax_rgba = jol.load_texture_file(str(p))[0, :, 0]
    jax_grey = jol.load_texture_file(str(p), grayscale=True)[0, :, 0]
    want_jax = np.array([255, 255, 255, 200, 0], np.float32) / 255
    assert np.array_equal(jax_rgba, want_jax) and np.array_equal(jax_grey, want_jax)
    port = tol.load_texture_file(str(p))
    want = np.array([217, 163, 130, 0, 0], np.float32) / 255          # v >> 8
    assert np.array_equal(port[0, :, 0], want) and np.array_equal(port[0, :, 3], np.ones(5))
    assert np.array_equal(tol.load_texture_file(str(p), grayscale=True)[0, :, 0], want)


def test_8bit_sky_diverges_from_jax_as_stb(tmp_path):
    """JAX's load_hdr casts an 8-bit sky's texels to float without
    dividing by 255, so tone_encode makes it white (clip(v, 0, 1) **
    (1/2.2) = 1 for any texel of 1 or more); the port returns texel/255
    (the encoded sky stbi_load gives the reference) and, without
    tone_encode, its linear radiance (texel/255) ** 2.2."""
    texels = np.array([[[0, 1, 64], [128, 200, 255]]], np.uint8)
    p = tmp_path / "sky.png"
    p.write_bytes(encode_png(texels))
    jax_enc = jol.load_hdr(str(p), tone_encode=True)
    assert np.array_equal(jax_enc, np.array([[[0, 1, 1], [1, 1, 1]]], np.float32))
    assert np.array_equal(jol.load_hdr(str(p), tone_encode=False), texels.astype(np.float32))
    enc = tol.load_hdr(str(p), tone_encode=True)
    assert enc.dtype == np.float32 and np.array_equal(enc, texels.astype(np.float32) / 255.0)
    lin = tol.load_hdr(str(p), tone_encode=False)
    assert np.allclose(lin, (texels / 255.0) ** 2.2, rtol=1e-6, atol=0)
    # A grey JPEG sky repeats its channel; flipped like the .hdr branch.
    g = tmp_path / "sky.jpg"
    Image.fromarray(smooth_image(np.random.default_rng(3), 6, 10, 1)[..., 0]).save(g)
    sky = tol.load_hdr(str(g))
    grey = np.asarray(Image.open(g), np.float32)[::-1] / 255.0
    assert sky.shape == (6, 10, 3) and np.array_equal(sky, np.repeat(grey[..., None], 3, -1))


def test_validate_bvh_matches_jax():
    from realtimeraytracer_torch.utils.native import native_build_bvh

    rng = np.random.default_rng(4)
    v0 = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.1, 0.1, (300, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.1, 0.1, (300, 3)).astype(np.float32)
    for bvh in (tbvh.build_bvh(v0, v1, v2), native_build_bvh(v0, v1, v2)):
        tbvh.validate_bvh(bvh)
        jbvh.validate_bvh(jbvh.BVHArrays(*bvh))
        leaf = int(np.nonzero(bvh.node_count)[0][0])
        for broken in (bvh._replace(node_count=np.where(np.arange(len(bvh.node_count)) == leaf, 0,
                                                        bvh.node_count)),
                       bvh._replace(node_skip=bvh.node_skip + len(bvh.node_skip) + 1),
                       bvh._replace(node_min=bvh.node_max + 1.0)):
            with pytest.raises(AssertionError):
                tbvh.validate_bvh(broken)
            with pytest.raises(AssertionError):
                jbvh.validate_bvh(jbvh.BVHArrays(*broken))


def test_vecmath_and_scatter_helpers_match_jax():
    rng = np.random.default_rng(5)
    m = rng.normal(size=(4, 4)).astype(np.float32)
    m[3] = [0, 0, 0, 1]
    pts = rng.normal(size=(7, 5, 3)).astype(np.float32)
    tm, tp = torch.from_numpy(m), torch.from_numpy(pts)
    for tf, jf, arg in ((tvm.transform_points, jvm.transform_points, pts),
                        (tvm.transform_dirs, jvm.transform_dirs, pts)):
        np.testing.assert_allclose(tf(tm, torch.from_numpy(arg)).numpy(), np.asarray(jf(m, arg)),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tvm.normal_matrix(tm).numpy(), np.asarray(jvm.normal_matrix(m)),
                               rtol=1e-5, atol=1e-6)
    assert tvm.transform_points(tm, tp).shape == tp.shape
    for pos, at in (((6.5, 4.0, 8.5), (0.0, 1.2, 0.0)), ((0, 0, 0), (0, 1, 0)), ((1, 2, 3), (-4, 0.5, 7))):
        assert tvm.look_at_angles(pos, at) == jvm.look_at_angles(pos, at)
        p32, a32 = torch.tensor(pos, dtype=torch.float32), torch.tensor(at, dtype=torch.float32)
        assert tvm.look_at_angles(p32, a32) == jvm.look_at_angles(p32.numpy(), a32.numpy())
    for w, h, bw, bh in ((37, 23, 16, 8), (64, 32, 16, 8), (5, 3, 4, 2)):
        got = tcam.blocks_to_image_scatter(w, h, bw, bh)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), np.asarray(jcam.blocks_to_image_scatter(w, h, bw, bh)))


def test_blocks_to_image_scatter_unpacks_ray_blocks():
    """The scatter turns generate_ray_blocks' tiles back into raster rays."""
    from realtimeraytracer_torch.scene.camera import Camera

    frame = Camera(position=(0, 1, 4), look_at=(0, 0, 0)).viewport_frame(37, 23)
    blocks = tcam.generate_ray_blocks(frame, 37, 23, jitter=False)          # (Ts, 8, 128)
    lanes = blocks.permute(0, 2, 1).reshape(-1, 8)
    o, d = tcam.generate_rays(frame, 37, 23, jitter=False)
    raster = lanes[tcam.blocks_to_image_scatter(37, 23)]
    np.testing.assert_allclose(raster[:, 3:6].numpy(), d.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(raster[:, 0:3].numpy(), o.numpy())


def test_committed_fixtures_match_expected_json():
    """tests/data/images: both packages' load_texture_file still hash to
    expected.json (chip_smoke phase 38 checks the port's on the card
    machine); the JPEGs are what their names say."""
    expected = json.loads((FIXTURES / "expected.json").read_text())["digests"]
    assert sorted(expected) == sorted(p.name for p in FIXTURES.iterdir() if p.name != "expected.json")
    for name, digests in expected.items():
        for grayscale in (False, True):
            want = digests[str(grayscale).lower()]
            path = str(FIXTURES / name)
            assert image_decode.pixels_digest(jol.load_texture_file(path, grayscale)) == want
            assert image_decode.pixels_digest(tol.load_texture_file(path, grayscale)) == want
    assert b"\xff\xc2" in _fixture("prog420_odd.jpg") and b"\xff\xd0" in _fixture("base422_rst.jpg")
    assert Image.open(FIXTURES / "adam7.png").info.get("interlace") == 1
    assert len(_fixture("smooth1024.jpg")) <= 200_000


def test_obj_scene_with_jpeg_and_tga_maps_matches_jax(tmp_path):
    """An OBJ/MTL whose diffuse, specular and opacity maps are the JPEG and
    TGA fixtures loads the same textures through both packages."""
    from realtimeraytracer_torch.scene.scene import Scene as TScene
    from realtimeraytracer_tpu.scene.scene import Scene as JScene

    for name in ("prog420_odd.jpg", "grey.jpg", "rle.tga", "adam7.png"):
        (tmp_path / name).write_bytes(_fixture(name))
    (tmp_path / "quad.obj").write_text(
        "mtllib quad.mtl\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "usemtl leaf\nf 1/1 2/2 3/3\nf 1/1 3/3 4/4\n")
    (tmp_path / "quad.mtl").write_text(
        "newmtl leaf\nKd 1 1 1\nmap_Kd prog420_odd.jpg\nmap_Ks grey.jpg\nmap_d rle.tga\n"
        "map_Pm adam7.png\n")
    ts, js = TScene(), JScene()
    tol.load_obj_scene(ts, str(tmp_path / "quad.obj"))
    jol.load_obj_scene(js, str(tmp_path / "quad.obj"))
    assert len(ts.textures) == len(js.textures) == 4
    for a, b in zip(ts.textures, js.textures):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    mt, mj = ts.meshes[0].material, js.meshes[0].material
    assert (mt.color_map, mt.specular_map, mt.opacity_map, mt.metallic_map) == \
        (mj.color_map, mj.specular_map, mj.opacity_map, mj.metallic_map)


def test_library_builds_under_its_hash(tmp_path, monkeypatch):
    """The library's name hashes the source, the flags and the compiler's
    version; without a compiler the decode raises and names it."""
    lib = image_decode.load_library()
    path = image_decode.library_path(image_decode._compiler())
    assert path.exists() and lib is not None
    monkeypatch.setattr(image_decode, "_lib", None)
    monkeypatch.setattr(image_decode, "_compiler", lambda: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        image_decode.decode_image(_fixture("grey.jpg"))
    monkeypatch.undo()
    assert image_decode.decode_image(_fixture("grey.jpg"))[1] == "L"
