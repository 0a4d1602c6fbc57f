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

from _torch_image_helpers import (CORRUPT_JPEGS, FIXTURE_NAMES, FIXTURES, PROGRESSION1,  # noqa: E402
                                  PROGRESSION3, alph_chunk, anim_chunk, anmf_chunk, disc_pattern,
                                  encode_arith_planes, encode_bmp_rle, encode_gif, encode_jpeg,
                                  encode_jpeg_blocks, encode_lossless_jpeg, encode_pnm, encode_psd,
                                  encode_webp, make_bmp, make_png, make_tga, make_tiff, pillow_webp,
                                  riff_webp, smooth_image, vp8x_chunk, webp_chunk, webp_chunks)
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


def _jax_c1(path, grayscale):
    """The JAX package's load_texture_file with every texel divided by 255:
    where JAX's texels (Pillow's, after its convert) are all 1 or less, it
    skips the division, and the port (C1, as stbi_load) does not."""
    arr = jol.load_texture_file(str(path), grayscale)
    img = Image.open(path)
    img = img.convert("L") if grayscale else img if img.mode in ("RGB", "RGBA") else img.convert("RGBA")
    return arr if np.asarray(img).max() > 1.5 else arr / np.float32(255.0)


def _same_as_jax(path, mode=None):
    """The port's load_texture_file equals the JAX package's (C1 applied),
    for both grayscale values; and the decoder reports Pillow's mode."""
    for grayscale in (False, True):
        want = _jax_c1(path, grayscale)
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
                "grey": make_tga(g, 3 | rle, 8, flags, idfield=b"id", rng=rng),
                "rgb": make_tga(c3, 2 | rle, 24, flags, rng=rng),
                "rgba": make_tga(c4, 2 | rle, 32, flags | 8, rng=rng),
                "mapped": make_tga(idx, 1 | rle, 8, flags, cmap, cmap_start=2, rng=rng),
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


@pytest.mark.parametrize("hs,top_down", [(12, False), (40, False), (40, True), (108, False),
                                         (108, True), (124, False), (124, True)])
def test_bmp_headers_bitfields_and_rows_match_jax(tmp_path, hs, top_down):
    """A 12-byte header (no top-down rows) and the 40-124 byte ones."""
    rng = np.random.default_rng(hs + top_down)
    for h, w in ((7, 5), (1, 1), (3, 20), (4, 33)):
        files = {}
        for bits in (1, 4, 8):
            npal = (1 << bits) if hs == 12 else min(1 << bits, 5)   # a short palette: black
            files[f"p{bits}"] = make_bmp(rng.integers(0, 1 << bits, (h, w, 1)), bits, hs, top_down,
                                     rng.integers(0, 256, (npal, 3)))
        files["rgb24"] = make_bmp(rng.integers(0, 256, (h, w, 3)), 24, hs, top_down)
        files["rgb32"] = make_bmp(rng.integers(0, 256, (h, w, 4)), 32, hs, top_down)
        if hs != 12:
            files["bf24"] = make_bmp(rng.integers(0, 256, (h, w, 3)), 24, hs, top_down, compression=3,
                                 masks=(0xFF0000, 0xFF00, 0xFF))
            for masks in ((0xFF0000, 0xFF00, 0xFF, 0xFF000000), (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                          (0xFF000000, 0xFF0000, 0xFF00, 0xFF), (0xFF0000, 0xFF00, 0xFF, 0),
                          (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0, 0, 0, 0)):
                files[f"bf32-{masks[0]:x}-{masks[3]:x}"] = make_bmp(
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


def _matches_jax(path, mode=None):
    """Where the JAX package's load_texture_file reads the file, as
    _same_as_jax; where it raises, the port raises ValueError too."""
    try:
        for grayscale in (False, True):
            jol.load_texture_file(str(path), grayscale)
    except Exception:   # noqa: BLE001 - Pillow raises OSError, ValueError, EOFError, KeyError...
        for grayscale in (False, True):
            with pytest.raises(ValueError):
                tol.load_texture_file(str(path), grayscale)
        return False
    _same_as_jax(path, mode)
    return True


def _write_all(tmp_path, files, ext):
    """Write each named file and check it against JAX; returns how many
    JAX read."""
    read = 0
    for name, data in files.items():
        p = tmp_path / f"{name}.{ext}"
        p.write_bytes(data)
        read += _matches_jax(p)
    return read


def _gif_files(case, rng, h, w):
    pal = rng.integers(0, 256, (16, 3))
    idx = rng.integers(0, 16, (h, w))
    idx[:, ::3] = idx[:, :1]

    def one(**kw):
        return encode_gif([dict(indices=idx, min_size=4, **kw)], (w, h), pal)

    if case == "pillow":
        quant = Image.fromarray(smooth_image(rng, h, w, 3, noise=120)).quantize(13)
        files = {}
        for name, img, kw in (("p", quant, {}), ("p-flat", quant, {"interlace": False}),
                              ("l", Image.fromarray(smooth_image(rng, h, w, 1)[..., 0]), {}),
                              ("trns", quant, {"transparency": 3})):
            buf = io.BytesIO()
            img.save(buf, format="GIF", **kw)
            files[name] = buf.getvalue()
        return files
    if case == "code-sizes":
        files = {}
        for ms in (0, 1, 2, 3, 5, 7, 8, 9, 12):
            top = 1 << min(max(ms, 1), 8)
            files[f"ms{ms}"] = encode_gif([dict(indices=rng.integers(0, top, (h, w)), min_size=ms)], (w, h),
                                          rng.integers(0, 256, (top, 3)))
        return files
    if case == "growth-and-clears":
        big = rng.integers(0, 256, (h + 60, w + 70))
        bpal = rng.integers(0, 256, (256, 3))
        return {name: encode_gif([dict(indices=big, min_size=8, lzw=lzw)], big.shape[::-1], bpal)
                for name, lzw in (("clear-when-full", {}), ("deferred-clear", {"deferred": True}),
                                  ("clear-every-37", {"clear_every": 37}),
                                  ("no-leading-clear", {"lead_clear": False}))}
    if case == "end-codes":
        files = {"no-end-code": one(lzw={"end": False}),
                 "early-end-code": one(lzw={"end_after": h * w // 2}),     # Pillow: truncated
                 "small-blocks": one(block=7)}
        big = rng.integers(0, 256, (200 + h, 300 + w))
        bpal = rng.integers(0, 256, (256, 3))
        # The end code lies in the first 64 KiB of a longer file: Pillow reads on.
        files["paused"] = encode_gif([dict(indices=big, min_size=8, lzw={"pause_after": 5000})],
                                     big.shape[::-1], bpal)
        files["paused-late"] = encode_gif([dict(indices=big, min_size=8,
                                                lzw={"pause_after": big.size - 50})], big.shape[::-1], bpal)
        return files
    if case == "local-tables":
        short = rng.integers(0, 256, (5, 3))
        grey = np.repeat(np.arange(16)[:, None], 3, 1)
        return {"local-over-global": encode_gif([dict(indices=idx, min_size=4, palette=short)], (w, h), pal),
                "local-only": encode_gif([dict(indices=idx, min_size=4, palette=pal)], (w, h)),
                "short-global": encode_gif([dict(indices=idx, min_size=4)], (w, h), short),
                "identity-global": encode_gif([dict(indices=idx, min_size=4)], (w, h), grey),
                "no-table": encode_gif([dict(indices=idx, min_size=4)], (w, h))}
    if case == "interlace":
        return {"interlaced": one(interlace=True), "interlaced-trns": one(interlace=True, transparency=2)}
    if case == "transparency":
        return {"p": one(transparency=int(idx[0, 0])), "p-unused": one(transparency=15),
                "p-past-palette": encode_gif([dict(indices=idx, min_size=4, transparency=200)], (w, h),
                                             pal[:5]),
                "l": encode_gif([dict(indices=idx, min_size=4, transparency=int(idx[0, 0]))], (w, h))}
    if case == "sub-frame":
        return {"inside": encode_gif([dict(indices=idx, x=3, y=2, min_size=4)], (w + 5, h + 4), pal),
                "inside-trns": encode_gif([dict(indices=idx, x=1, y=4, min_size=4, transparency=7)],
                                          (w + 2, h + 6), pal),
                "past-screen": encode_gif([dict(indices=idx, x=2, y=1, min_size=4)], (w, max(h - 1, 1)), pal)}
    if case == "multi-frame":
        second = dict(indices=rng.integers(0, 16, (2, 3)), x=1, y=0, min_size=4, transparency=0)
        frames = [Image.fromarray(smooth_image(rng, h, w, 3, noise=100)).quantize(9) for _ in range(3)]
        buf = io.BytesIO()
        frames[0].save(buf, format="GIF", save_all=True, append_images=frames[1:], duration=40, loop=0)
        return {"hand": encode_gif([dict(indices=idx, min_size=4), second], (w, h), pal),
                "pillow": buf.getvalue()}
    assert case == "extensions"
    ext = [b"!\xfe\x05hello\x03abc\x00", b"!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00",
           b"!\x01\x0c" + bytes(12) + b"\x00", b"\x00\x17"]       # comment, loop, plain text, stray bytes
    return {"extensions": encode_gif([dict(indices=idx, min_size=4, extensions=ext)], (w, h), pal)}


GIF_CASES = ("pillow", "code-sizes", "growth-and-clears", "end-codes", "local-tables", "interlace",
             "transparency", "sub-frame", "multi-frame", "extensions")


@pytest.mark.parametrize("case", GIF_CASES)
def test_gif_matches_jax(tmp_path, case):
    """GIF's first frame (Pillow's GifImagePlugin and LZW decoder): code
    sizes 0-12, growth to 12 bits, clear codes, a full table with no clear,
    end codes (Pillow reads on past one only where the file has more than
    its first 64 KiB), tables local, global, short, identity or none,
    interlace, transparency, frames inside or past the screen, later
    frames ignored, extensions and stray bytes skipped."""
    rng = np.random.default_rng(100 + GIF_CASES.index(case))
    read = 0
    for h, w in ((23, 37), (1, 1), (2, 3), (17, 2)):
        read += _write_all(tmp_path, _gif_files(case, rng, h, w), "gif")
    assert read > 0


def _pnm_files(case, rng, h, w):
    if case == "pbm":
        bits = rng.integers(0, 2, (h, w))
        return {"p1": encode_pnm(bits, b"P1"), "p1-packed": encode_pnm(bits, b"P1", rng=rng),
                "p4": encode_pnm(bits, b"P4")}
    if case in ("pgm", "ppm"):
        files = {}
        shape = (h, w) if case == "pgm" else (h, w, 3)
        for maxval in ((255, 1, 15, 100, 254) if case == "pgm" else (255, 7, 1000, 65535)):
            s = rng.integers(0, maxval + 1, shape)
            for magic in ((b"P2", b"P5") if case == "pgm" else (b"P3", b"P6")):
                files[f"{magic.decode()}-{maxval}"] = encode_pnm(s, magic, maxval)
        return files
    if case == "comments":
        s = rng.integers(0, 101, (h, w, 3))
        joined = (b"P2\n%d %d\n9\n" % (w, h) + b" ".join(b"%d" % v for v in rng.integers(0, 10, h * w - 1))
                  + b" 1#x\n2")                         # the last sample "12": past maxval
        return {"p3": encode_pnm(s, b"P3", 100, comments=True, rng=rng),
                "p6": encode_pnm(s, b"P6", 100, comments=True),
                "p1": encode_pnm(s[..., 0] & 1, b"P1", comments=True, rng=rng),
                "in-token": b"P5 1#c\n3 %d\n255\n" % h                 # the width token "13"
                + rng.integers(0, 256, 13 * h).astype(np.uint8).tobytes(),
                "joined": joined}
    if case == "above-maxval":
        return {"p5": encode_pnm(rng.integers(0, 256, (h, w)), b"P5", 77),
                "p6": encode_pnm(rng.integers(0, 65536, (h, w, 3)), b"P6", 300)}
    assert case == "pfm"
    f = rng.choice(np.float32([0, 0.4, 1, 1.99, 2, 37.5, 254.9, 255, 300, -2, np.inf, -np.inf, np.nan]),
                   (h, w))
    f[0, 0] = 200.0
    return {"le": encode_pnm(f, b"Pf", scale=-1.0), "be": encode_pnm(f, b"Pf", scale=2.5),
            "colour": encode_pnm(np.repeat(f[..., None], 3, -1), b"PF", scale=-1.0)}   # Pillow: none


PNM_CASES = ("pbm", "pgm", "ppm", "comments", "above-maxval", "pfm")


@pytest.mark.parametrize("case", PNM_CASES)
def test_pnm_matches_jax(tmp_path, case):
    """PNM as Pillow's PpmImagePlugin reads it: P1-P6, ASCII and binary,
    comments between header tokens, inside one and in ASCII data, PBM's
    inverted bits, maxval below 255 (rounded as Pillow rounds), P3/P6
    above 255, binary samples above maxval (capped), Pf in both byte
    orders (convert truncates; PF, colour, is no file Pillow reads)."""
    rng = np.random.default_rng(200 + PNM_CASES.index(case))
    read = 0
    for h, w in ((13, 11), (1, 1), (2, 9), (7, 1)):
        read += _write_all(tmp_path, _pnm_files(case, rng, h, w), "pnm")
    assert read > 0


def test_pnm_headers_and_bad_data_raise_as_jax(tmp_path):
    """Header tokens Python's int() reads and refuses, maxval bounds, ASCII
    samples past maxval or negative, short data: where JAX reads, the port
    reads the same; where JAX raises, the port raises ValueError."""
    files = [b"P5 4 3 255\n" + bytes(range(12)), b"P5\t4\r3 255 " + bytes(range(12)),
             b"P5 4#c\n3 255\n" + bytes(range(12)), b"P5 +4 3 2_55\n" + bytes(range(12)),
             b"P5 04 3 0255\n" + bytes(range(12)), b"P5 4 3 255#x\n" + bytes(range(13)),
             b"P5 4 3 0\n" + bytes(12), b"P5 4 3 65536\n" + bytes(24), b"P5 4 -3 255\n" + bytes(12),
             b"P5 4 3 255\n" + bytes(11), b"P54 3 255\n" + bytes(12), b"P2 2 2 9 1 2 3 10",
             b"P2 2 2 9 1 2 3 -1", b"P2 2 2 9 1 2 3", b"P2 2 2 9 1 2 3 4 5 x", b"P2 2 2 9 1 2 3 0004",
             b"P1 3 2 01011x", b"P1 3 2 0101", b"P1 3 2 01 # x\n0110 junk", b"P3 1 1 255 1 2 3",
             b"Pf 2 1 1e999\n" + bytes(8), b"Pf 2 1 nan\n" + bytes(8), b"Pf 2 1 0\n" + bytes(8),
             b"Pf 2 1 -0x1p3\n" + bytes(8), b"Pf 2 1 1_0.5\n" + np.float32([3, 4]).byteswap().tobytes(),
             b"P7 2 1\n", b"P2 1 1 12345678901 1"]
    read = sum(_write_all(tmp_path, {f"h{i}": d}, "pnm") for i, d in enumerate(files))
    assert 6 <= read < len(files)


def test_16bit_pgm_diverges_from_jax_as_stb(tmp_path):
    """Pillow opens P2/P5 above maxval 255 as "I" (samples scaled to 0-65535)
    and the JAX package's convert clips them to 255; the port keeps the
    high byte, stb_image's 16-to-8 bit rule, as for 16-bit grey PNG."""
    s = np.array([[65535, 40000, 255, 256, 0]])
    for magic, maxval in ((b"P5", 65535), (b"P2", 65535), (b"P5", 1000)):
        p = tmp_path / f"i16-{maxval}.pgm"
        p.write_bytes(encode_pnm(np.minimum(s, maxval), magic, maxval))
        assert Image.open(p).mode == "I"
        pillow = np.asarray(Image.open(p))[0]
        want_jax = np.minimum(pillow, 255).astype(np.float32)
        want_jax = want_jax / 255 if want_jax.max() > 1.5 else want_jax
        for g in (False, True):
            assert np.array_equal(jol.load_texture_file(str(p), g)[0, :, 0], want_jax)
            port = tol.load_texture_file(str(p), g)
            assert np.array_equal(port[0, :, 0], (pillow >> 8).astype(np.float32) / 255)
        assert np.array_equal(tol.load_texture_file(str(p))[0, :, 3], np.ones(5, np.float32))


def _psd_files(case, compression, rng, h, w):
    def planes(n):
        out = [rng.integers(0, 256, (h, w)) for _ in range(n)]
        for p in out:
            p[:, ::4] = p[:, :1]                 # runs for PackBits
        return out

    kw = dict(compression=compression, rng=rng)
    if case == "bitmap":
        return {"1": encode_psd([rng.integers(0, 256, (h, (w + 7) // 8))], 0, 1, width=w, **kw)}
    if case == "grey":
        return {"grey": encode_psd(planes(1), 1, **kw), "bitmap-8": encode_psd(planes(1), 0, **kw),
                "duotone": encode_psd(planes(1), 8, **kw), "multichannel": encode_psd(planes(2), 7, **kw),
                "grey-alpha": encode_psd(planes(2), 1, **kw)}
    if case == "indexed":
        table = rng.integers(0, 256, 768).astype(np.uint8).tobytes()
        return {"table": encode_psd(planes(1), 2, palette=table, **kw),
                "no-table": encode_psd(planes(1), 2, palette=table[:300], **kw)}
    if case == "rgb":
        return {"rgb": encode_psd(planes(3), 3, **kw), "rgba": encode_psd(planes(4), 3, **kw),
                "five-channels": encode_psd(planes(5), 3, **kw)}
    if case == "cmyk":
        return {"cmyk": encode_psd(planes(4), 4, **kw), "cmyk-alpha": encode_psd(planes(5), 4, **kw)}
    assert case == "sections"
    res = (b"8BIM" + struct.pack(">H", 1005) + b"\x03abc" + struct.pack(">I", 5) + b"hello\0"
           + b"8BIM" + struct.pack(">H", 1039) + b"\x00\x00" + struct.pack(">I", 4) + b"icc!")
    return {"resources": encode_psd(planes(3), 3, resources=res, **kw),
            "layers": encode_psd(planes(3), 3, layers=struct.pack(">I", 0) + bytes(9), **kw),
            "16-bit": encode_psd(planes(3), 3, 16, **kw),
            "short-of-channels": encode_psd(planes(3), 4, **kw),
            "mode-5": encode_psd(planes(1), 5, **kw)}


PSD_CASES = ("bitmap", "grey", "indexed", "rgb", "cmyk", "sections")


@pytest.mark.parametrize("compression", [0, 1])
@pytest.mark.parametrize("case", PSD_CASES)
def test_psd_matches_jax(tmp_path, case, compression):
    """PSD's composite image, raw and PackBits (no-op bytes; Pillow places
    each channel's data after as many channels' row counts as its mode
    reads), by Pillow's MODES table: bitmap "1", grey/duotone/multichannel
    "L", indexed "P" (without a 768-byte table: black), "RGB", "RGBA"
    (four channels exactly), "CMYK" (stored inverted, expanded by Pillow's
    convert); image resources and a layer section skipped; 16-bit, too few
    channels and unknown modes raise where JAX raises."""
    rng = np.random.default_rng(300 + 2 * PSD_CASES.index(case) + compression)
    read = 0
    for h, w in ((13, 11), (1, 1), (3, 20), (9, 2)):
        read += _write_all(tmp_path, _psd_files(case, compression, rng, h, w), "psd")
    assert read > 0


@pytest.mark.parametrize("hs", [40, 56, 124])
def test_16bit_bmp_matches_jax(tmp_path, hs):
    """16-bit BMP: BI_RGB as Pillow's "BGR;15", BI_BITFIELDS 5-6-5 and
    5-5-5 (an alpha mask ignored, as Pillow compares the colour masks),
    other masks raise where JAX raises; bottom-up and top-down."""
    rng = np.random.default_rng(400 + hs)
    read = 0
    for h, w in ((7, 5), (1, 1), (3, 20), (4, 33)):
        for top_down in (False, True):
            files = {"bi-rgb": make_bmp(rng.integers(0, 65536, (h, w)), 16, hs, top_down)}
            for name, masks in (("565", (0xF800, 0x7E0, 0x1F, 0)), ("555", (0x7C00, 0x3E0, 0x1F, 0x8000)),
                                ("444", (0xF00, 0xF0, 0xF, 0)), ("bgr565", (0x1F, 0x7E0, 0xF800, 0))):
                files[name] = make_bmp(rng.integers(0, 65536, (h, w)), 16, hs, top_down, compression=3,
                                       masks=masks[:3] if hs == 40 else masks)
            read += _write_all(tmp_path, {f"{k}-{h}x{w}-{top_down}": v for k, v in files.items()}, "bmp")
    assert read == 4 * 2 * 3


@pytest.mark.parametrize("rle4", [False, True])
def test_rle_bmp_matches_jax(tmp_path, rle4):
    """BMP RLE8 and RLE4 as Pillow's BmpRleDecoder reads them: encoded runs
    (cut at the row's end), absolute runs (padded to 16 bits; an odd RLE4
    run Pillow reads short), end-of-line, end-of-bitmap, deltas (Pillow
    takes right and up from the second byte pair; skipped pixels index 0),
    bottom-up and top-down, grey palettes ("L"); data that ends before the
    image raises where JAX raises."""
    rng = np.random.default_rng(500 + rle4)
    bits, read = (4 if rle4 else 8), 0
    for h, w in ((7, 5), (1, 1), (3, 20), (9, 33)):
        idx = rng.integers(0, 16, (h, w))
        idx[:, ::2] = idx[:, :1]
        pal = rng.integers(0, 256, (16, 3))
        grey = np.repeat(np.arange(16)[:, None], 3, 1)
        files = {}
        for name, kw, table, top_down in (("plain", {}, pal, False), ("top-down", {}, pal, True),
                                          ("delta", {"delta": True}, pal, False),
                                          ("odd-runs", {"odd_runs": True}, pal, False),
                                          ("grey", {}, grey, False)):
            data = encode_bmp_rle(idx, rle4, rng, **kw)
            files[name] = make_bmp(None, bits, 40, top_down, table, 2 if rle4 else 1, data=data, size=(w, h))
        data = encode_bmp_rle(idx, rle4, rng)
        files["early-end"] = make_bmp(None, bits, 40, False, pal, 2 if rle4 else 1,
                                      data=data[:len(data) // 2] + b"\0\1", size=(w, h))
        read += _write_all(tmp_path, {f"{k}-{h}x{w}": v for k, v in files.items()}, "bmp")
    assert read >= 4 * 4


def test_grey_bmp_palettes_at_every_depth_match_jax(tmp_path):
    """Pillow reads a palette of entries i = i, i, i as "L" and the
    two-entry 0/255 one as "1", whatever the depth: 8-bit (resp. 1-bit)
    samples from the file's rows, an "L" row wider than its stride read
    through the memory map into the next rows (past the file's end: 0)."""
    rng = np.random.default_rng(600)
    read = 0
    for h, w in ((5, 13), (1, 1), (3, 40)):
        files = {}
        for bits in (1, 4, 8):
            for npal in (1, 2, 16, 256):
                table = (np.array([[0, 0, 0], [255, 255, 255]]) if npal == 2
                         else np.repeat(np.arange(npal)[:, None], 3, 1))
                idx = rng.integers(0, min(npal, 1 << bits), (h, w))
                files[f"{bits}-{npal}"] = make_bmp(idx, bits, 40, False, table)
                files[f"{bits}-{npal}-12"] = make_bmp(idx, bits, 12, False, table)
        read += _write_all(tmp_path, {f"{k}-{h}x{w}": v for k, v in files.items()}, "bmp")
    assert read == 3 * 24


@pytest.mark.parametrize("rle", [0, 8])
def test_16bit_1bit_and_la_tga_match_jax(tmp_path, rle):
    """TGA as Pillow reads it: 16-bit true colour as "BGRA;15Z" (alpha 0
    where the top bit is set, whatever the attribute bits), grey 16-bit as
    "LA", 1-bit grey as "1" (an RLE one raises, as Pillow's decoder never
    ends one), colour maps of 16-bit entries (15-bit ones raise where JAX
    raises); every origin."""
    rng = np.random.default_rng(700 + rle)
    read = 0
    for h, w in ((7, 5), (1, 1), (3, 20), (5, 9)):
        for flags in (0x00, 0x20, 0x10, 0x31, 0x08):
            c2 = rng.integers(0, 256, (h, w, 2))
            c2[:, ::3] = c2[:, :1]
            files = {"rgb16": make_tga(c2, 2 | rle, 16, flags, rng=rng),
                     "la": make_tga(rng.integers(0, 256, (h, w, 2)), 3 | rle, 16, flags, rng=rng),
                     "bit1": make_tga(rng.integers(0, 256, (h, (w + 7) // 8, 1)), 3 | rle, 1, flags,
                                      rng=rng, width=w)}
            for depth in (16, 15):
                cmap = rng.integers(0, 256, 2 * 12).astype(np.uint8)
                files[f"map{depth}"] = make_tga(rng.integers(0, 14, (h, w, 1)), 1 | rle, 8, flags, cmap,
                                                cmap_start=2, cmap_depth=depth, rng=rng)
            read += _write_all(tmp_path, {f"{k}-{h}x{w}-{flags}": v for k, v in files.items()}, "tga")
    assert read == 4 * 5 * (3 if rle else 4)


def test_palette_pillow_applies_to_grey_diverges_as_stb(tmp_path):
    """Pillow turns an "L" image that carries a colour table into "P" when
    it loads it, so convert("RGBA") looks the grey values up in that table
    (and convert("L") keeps them): a GIF whose local table is the identity
    ramp beside a global table (the global one is used), a grey TGA with a
    colour map.  stb_image reads the values, and so does the port."""
    rng = np.random.default_rng(800)
    idx = rng.integers(0, 16, (6, 7))
    pal = rng.integers(0, 256, (16, 3))
    ident = np.repeat(np.arange(16)[:, None], 3, 1)
    cmap = rng.integers(0, 256, 3 * 16).astype(np.uint8)
    for name, data in (("gif", encode_gif([dict(indices=idx, min_size=4, palette=ident)], (7, 6), pal)),
                       ("tga", make_tga(idx[..., None], 3, 8, 0x20, cmap))):
        p = tmp_path / f"grey.{name}"
        p.write_bytes(data)
        assert Image.open(p).mode == "L"
        table = pal.astype(np.float32) if name == "gif" else cmap.reshape(16, 3)[:, ::-1].astype(np.float32)
        assert np.array_equal(jol.load_texture_file(str(p))[::-1, :, :3], table[idx] / 255)
        values = idx.astype(np.float32) / 255
        assert np.array_equal(jol.load_texture_file(str(p), True)[::-1, :, 0], values)
        for g in (False, True):
            got = tol.load_texture_file(str(p), g)[::-1]
            assert np.array_equal(got[..., 0], values) and got.shape[2] == (1 if g else 4)


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


def _gif_first_frame_end(data):
    """Offset of the block terminator that ends a GIF's first frame."""
    p = 13 + (3 << ((data[10] & 7) + 1) if data[10] & 128 else 0)
    while data[p] != 0x2C:                         # extensions before the image
        p += 2
        while data[p]:
            p += data[p] + 1
        p += 1
    flags = data[p + 9]
    p += 10 + (3 << ((flags & 7) + 1) if flags & 128 else 0) + 1
    while data[p]:
        p += data[p] + 1
    return p


# Bytes at a fixture's end that no decoder needs: a TGA footer, a BMP's
# last row padding (Pillow reads a file without it), an RLE BMP's
# end-of-bitmap (and end-of-line, unless an odd RLE4 run left the row
# short), a GIF's later frames.
_SPARE = {"rle.tga": 26, "rgb24.bmp": 1, "bf565.bmp": 2, "discs_rle8.bmp": 4, "rle4.bmp": 2}


@pytest.mark.parametrize("name", ["prog420_odd.jpg", "base422_rst.jpg", "adam7.png", "rle.tga",
                                  "rgb24.bmp", "palette_trns.png", "frame.gif", "leaf.psd", "cmyk.psd",
                                  "gloss.pgm", "discs_rle8.bmp", "rle4.bmp", "bf565.bmp",
                                  "rgb16_rle.tga"])
def test_truncated_and_corrupt_files_raise(tmp_path, name):
    """Cut at several points, or with a marker, a CRC or a header field
    broken: ValueError, never a crash or a quiet result (for the GIF, PSD,
    PNM and 16-bit/RLE BMP and TGA fixtures: where the JAX package raises
    too)."""
    data = _fixture(name)
    new = name in FIXTURE_NAMES[8:]        # the GIF, PSD, PNM and 16-bit/RLE BMP and TGA fixtures
    end = _gif_first_frame_end(data) if name.endswith(".gif") else len(data) - _SPARE.get(name, 0)

    recovered = []                 # corrupt JPEG data libjpeg decodes on: the JAX package's pixels

    def raises(bad):
        with pytest.raises(ValueError):
            image_decode.decode_image(bad)
        if new:
            p = tmp_path / f"bad-{name}"
            p.write_bytes(bad)
            with pytest.raises(Exception):   # noqa: B017 - whatever Pillow raises
                jol.load_texture_file(str(p))

    if name.endswith(".bmp"):           # the spare bytes are spare: both read the file without them
        p = tmp_path / f"cut-{name}"
        p.write_bytes(data[:end])
        _same_as_jax(p)
    for cut in (end - 1, end - 7, end * 3 // 4, end // 2, 40, 20, 10, 3):
        raises(data[:cut])
    broken = []
    if name.endswith(".jpg"):
        sof = data.index(b"\xff\xc2" if "prog" in name else b"\xff\xc0")
        sos = data.index(b"\xff\xda")
        broken += [data[:sos] + b"\xff\x02" + data[sos + 2:],              # unknown marker
                   data[:sof + 5] + b"\x00\x00" + data[sof + 7:]]         # height 0 (DNL)
        recovered.append(data[:sos + 20] + b"\xff\xd9" + data[sos + 20:])  # EOI inside a scan
        if "rst" in name:
            rst = data.index(b"\xff\xd0")
            recovered.append(data[:rst + 1] + b"\xd3" + data[rst + 2:])   # RST out of sequence
    elif name.endswith(".png"):
        broken += [data[:40] + bytes([data[40] ^ 0xFF]) + data[41:],      # bad CRC
                   data[:24] + b"\x07" + data[25:]]                        # bad bit depth
    elif name.endswith(".tga"):                                            # type 5, depth 15
        broken += [data[:2] + b"\x05" + data[3:], data[:16] + b"\x0f" + data[17:]]
    elif name.endswith(".gif"):
        start = data.index(b",")
        start += 10 + (3 << ((data[start + 9] & 7) + 1) if data[start + 9] & 128 else 0)
        broken += [data[:start] + b"\x0d" + data[start + 1:],                 # LZW code size 13
                   data[:start + 2] + b"\xff\xff" + data[start + 4:],         # a code past the table
                   b"GIF88a" + data[6:]]
    elif name.endswith(".psd"):
        broken += [data[:5] + b"\x02" + data[6:],                              # version 2
                   data[:23] + b"\x10" + data[24:],                            # 16-bit
                   data[:13] + b"\x01" + data[14:]]                            # too few channels
    elif name.endswith(".pgm"):
        broken += [data.replace(b"100\n", b"0\n", 1), b"P7" + data[2:]]
    else:                                                       # 7 bits; RLE8 or PNG compression
        broken += [data[:28] + b"\x07" + data[29:], data[:30] + (b"\x05" if "rle" in name else b"\x01")
                   + data[31:]]
        if name == "bf565.bmp":
            broken.append(data[:54] + struct.pack("<I", 0x1F) + data[58:])  # unknown masks
    for bad in broken:
        raises(bad)
    for i, bad in enumerate(recovered):
        p = tmp_path / f"recovered{i}-{name}"
        p.write_bytes(bad)
        _same_as_jax(p)


def test_refused_formats_and_features_raise(tmp_path):
    """Formats and features not ported raise ValueError naming them: the
    TIFF codecs left out (CCITT, old-style JPEG, ThunderScan, SGILog,
    LZMA, ZSTD, WebP) and Lab TIFF, a two-component JPEG, 12-bit and
    hierarchical JPEG (which Pillow refuses too), Lab PSD."""
    img = Image.fromarray(smooth_image(np.random.default_rng(0), 16, 16, 3))
    for mode, compression, words in (("1", "group4", "CCITT Group 4"), ("1", "group3", "CCITT Group 3"),
                                     ("1", "tiff_ccitt", "CCITT RLE"), ("RGB", "lzma", "LZMA"),
                                     ("RGB", "zstd", "ZSTD")):
        buf = io.BytesIO()
        img.convert(mode).save(buf, format="TIFF", compression=compression)
        with pytest.raises(ValueError, match=words):
            image_decode.decode_image(buf.getvalue())
    # Pillow's WebP-in-TIFF writer crashes: these codes are written by hand.
    for code, words in ((6, "old-style JPEG"), (32809, "ThunderScan"), (34676, "SGILog"), (50001, "WebP"),
                        (12345, "compression 12345")):
        with pytest.raises(ValueError, match=words):
            image_decode.decode_image(make_tiff(np.zeros((4, 4, 3), int), 8, 2, compression=1,
                                                tags=[(259, 3, [code])]))
    with pytest.raises(ValueError, match="Lab"):
        image_decode.decode_image(make_tiff(np.zeros((4, 4, 3), int), 8, 8))
    two = encode_jpeg([np.zeros((8, 8), np.uint8)] * 2, [(1, 1)] * 2)
    with pytest.raises(ValueError, match="2 components"):
        image_decode.decode_image(two)
    base = _fixture("base422_rst.jpg")
    sof = base.index(b"\xff\xc0")
    for marker, precision, words in ((b"\xff\xc0", 12, "12-bit"), (b"\xff\xc5", 8, "hierarchical")):
        bad = base[:sof] + marker + base[sof + 2:sof + 4] + bytes([precision]) + base[sof + 5:]
        with pytest.raises(ValueError, match=words):
            image_decode.decode_image(bad)
    lab = encode_psd([np.zeros((2, 3), np.uint8)] * 3, 9)
    with pytest.raises(ValueError, match="Lab"):
        image_decode.decode_image(lab)
    with pytest.raises(ValueError, match="not an image"):
        image_decode.decode_image(b"plain text, not an image")


def test_dark_8bit_texture_is_divided_as_stb(tmp_path):
    """C1: the JAX package divides by 255 only when some texel exceeds 1.5,
    so a file of 0/1 texels keeps them: a 0/1 opacity cut-out reads 0 and
    1.0 there, and the leaves stand opaque.  stbi_load (the reference)
    gives 8-bit texels, and the port divides every one by 255: 0 and 1/255.
    A grey file read as RGBA gains alpha 255, so JAX divides it then, and
    the two agree; grey maps (grayscale=True: specular, metallic, opacity)
    and RGB files differ."""
    mask = disc_pattern(16)
    for name, data, rgb in (("grey.png", encode_png(mask.astype(np.uint8)), False),
                            ("grey.pgm", encode_pnm(mask.astype(int), b"P5"), False),
                            ("rgb.png", encode_png(np.repeat(mask[..., None], 3, -1).astype(np.uint8)), True),
                            ("rgb.ppm", encode_pnm(np.repeat(mask[..., None], 3, -1), b"P3"), True)):
        p = tmp_path / name
        p.write_bytes(data)
        texels = mask[::-1].astype(np.float32)
        for grayscale in (False, True):
            jax = jol.load_texture_file(str(p), grayscale)
            port = tol.load_texture_file(str(p), grayscale)
            assert jax.shape == port.shape and port.dtype == np.float32
            assert np.array_equal(port[..., 0], texels / 255), (name, grayscale)
            jax_divides = not grayscale and not rgb
            assert np.array_equal(jax[..., 0], texels / 255 if jax_divides else texels), (name, grayscale)
            if port.shape[2] == 4:
                assert np.array_equal(port[..., 3], np.ones_like(texels))


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
    """JAX's load_hdr casts an 8-bit sky's texels (PNG, WebP) to float without
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
    # A WebP sky (imageio reads it through Pillow) diverges the same way.
    w = tmp_path / "sky.webp"
    w.write_bytes(pillow_webp(texels, lossless=True))
    assert np.array_equal(jol.load_hdr(str(w), tone_encode=False), texels.astype(np.float32))
    assert np.array_equal(tol.load_hdr(str(w), tone_encode=True), texels.astype(np.float32) / 255.0)
    # A grey JPEG sky repeats its channel; flipped like the .hdr branch.
    g = tmp_path / "sky.jpg"
    Image.fromarray(smooth_image(np.random.default_rng(3), 6, 10, 1)[..., 0]).save(g)
    sky = tol.load_hdr(str(g))
    grey = np.asarray(Image.open(g), np.float32)[::-1] / 255.0
    assert sky.shape == (6, 10, 3) and np.array_equal(sky, np.repeat(grey[..., None], 3, -1))


# ---------------------------------------------------------------- TIFF ----

def _tiff_same_as_jax(tmp_path, name, data):
    p = tmp_path / name
    p.write_bytes(data)
    _same_as_jax(p)


def _both_raise(tmp_path, name, data, words=None):
    """The JAX package (Pillow) raises on the file for both grayscale
    values, and so does the port, with ValueError."""
    p = tmp_path / name
    p.write_bytes(data)
    for grayscale in (False, True):
        with pytest.raises(Exception):   # noqa: B017 - whatever Pillow raises
            jol.load_texture_file(str(p), grayscale)
    with pytest.raises(ValueError, match=words):
        image_decode.decode_image(data)


def _same_or_both_raise(tmp_path, name, data, words=None):
    """Bit-equal where Pillow reads the file; ValueError where it raises."""
    p = tmp_path / name
    p.write_bytes(data)
    try:
        Image.open(p).load()
    except Exception:                      # noqa: BLE001 - Pillow refuses: so must the port
        _both_raise(tmp_path, f"bad-{name}", data, words)
        return
    _same_as_jax(p)


def _samples(rng, h, w, n, bits=8, fmt=1):
    if fmt == 3:
        return (rng.random((h, w, n)) * 2 - 0.3).astype(np.float32)
    if fmt == 2:
        return rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), (h, w, n))
    return rng.integers(0, 1 << bits, (h, w, n))


# Pillow's OPEN_INFO entries by family: (samples, bits, photometric, tags).
TIFF_MODES = {
    "1-black0": (1, 1, 1, {}), "1-white0": (1, 1, 0, {}), "L2": (1, 2, 1, {}), "L2-white0": (1, 2, 0, {}),
    "L4": (1, 4, 1, {}), "L4-white0": (1, 4, 0, {}), "L": (1, 8, 1, {}), "L-white0": (1, 8, 0, {}),
    "LA": (2, 8, 1, dict(extra=[2])), "RGB": (3, 8, 2, {}), "RGBX": (4, 8, 2, dict(extra=[0])),
    "RGBXX": (5, 8, 2, dict(extra=[0, 0])), "RGBA": (4, 8, 2, dict(extra=[2])),
    "RGBa": (4, 8, 2, dict(extra=[1])), "RGBaX": (5, 8, 2, dict(extra=[1, 0])),
    "RGBA-no-extra": (4, 8, 2, {}), "RGBA-corel": (4, 8, 2, dict(extra=[999])),
    "RGBAXX": (6, 8, 2, dict(extra=[2, 0, 0])), "RGB16": (3, 16, 2, {}), "RGBA16": (4, 16, 2, dict(extra=[2])),
    "RGBa16": (4, 16, 2, dict(extra=[1])), "RGBX16": (4, 16, 2, dict(extra=[0])), "CMYK": (4, 8, 5, {}),
    "CMYKX": (5, 8, 5, dict(extra=[0])), "P1": (1, 1, 3, {}), "P2": (1, 2, 3, {}), "P4": (1, 4, 3, {}),
    "P": (1, 8, 3, {}), "PA": (2, 8, 3, dict(extra=[2])), "PX": (2, 8, 3, dict(extra=[0])),
    "YCbCr-raw-RGBX": (3, 8, 6, dict(subsampling=(1, 1))), "I32": (1, 32, 1, dict(sample_format=2)),
    "F": (1, 32, 1, dict(sample_format=3)),
}
TIFF_LAYOUTS = {"strips": dict(rows_per_strip=4), "tiles": dict(tile=(16, 16)),
                "planar": dict(rows_per_strip=4, planar=2)}


@pytest.mark.parametrize("mode", sorted(TIFF_MODES))
def test_tiff_modes_match_jax(tmp_path, mode):
    """Every mode of Pillow's TIFF table that convert accepts, in both byte
    orders, raw (Pillow's own unpackers: a planar file reads each plane by
    its band's letter) and PackBits, LZW and Deflate (libtiff's path:
    host-order samples, a big-endian 32-bit file read byte-swapped), in
    strips, tiles and planes: bit-equal, or raising where
    Pillow raises (a planar RGBX, a band letter without an unpacker)."""
    n, bits, photo, tags = TIFF_MODES[mode]
    rng = np.random.default_rng(sorted(TIFF_MODES).index(mode))
    for order in "<>":
        for comp in (1, 32773, 5, 8):
            for layout, kw in TIFF_LAYOUTS.items():
                s = _samples(rng, 9, 13, n, bits, tags.get("sample_format", 1))
                if mode == "I32":
                    s //= 1000
                kw = {**tags, **kw}
                if photo == 3:
                    kw["colormap"] = rng.integers(0, 65536, (1 << bits, 3))
                _same_or_both_raise(tmp_path, f"{order}{comp}{layout}.tif",
                                    make_tiff(s, bits, photo, order=order, compression=comp, **kw))


@pytest.mark.parametrize("compression", ["raw", "packbits", "tiff_lzw", "tiff_adobe_deflate", "tiff_deflate",
                                         "jpeg"])
def test_pillow_tiff_matches_jax(tmp_path, compression):
    """TIFFs Pillow writes (libtiff for every compression but raw) in each
    mode it saves, at sizes that end strips and MCUs mid-way.  Pillow's
    libtiff-written JPEG TIFFs of modes 1, P, I;16, I and F corrupt its heap,
    so those are left out."""
    rng = np.random.default_rng(3)
    for h, w in ((13, 11), (1, 1), (40, 33)):
        base = smooth_image(rng, h, w, 4)
        images = {"1": Image.fromarray(base[..., 0] > 128), "L": Image.fromarray(base[..., 0]),
                  "LA": Image.fromarray(base[..., :2], "LA"), "P": Image.fromarray(base[..., :3]).quantize(37),
                  "RGB": Image.fromarray(base[..., :3]), "RGBA": Image.fromarray(base, "RGBA"),
                  "CMYK": Image.fromarray(base, "CMYK"), "YCbCr": Image.fromarray(base[..., :3], "YCbCr"),
                  "I": Image.fromarray(base[..., 0].astype(np.int32) * 3 - 200),
                  "F": Image.fromarray(base[..., 0].astype(np.float32) / 100 - 0.3)}
        for mode, img in images.items():
            if compression == "jpeg" and mode in ("1", "P", "I", "F"):
                continue
            p = _save(tmp_path, f"{mode}{h}x{w}.tif", img, compression=compression)
            if mode == "YCbCr" and compression == "raw":   # Pillow's raw reader takes 4 bytes a pixel
                _both_raise(tmp_path, "ycbcr-raw.tif", p.read_bytes(), "truncated")
                continue
            _same_as_jax(p)


def test_tiff_predictors_match_jax(tmp_path):
    """Predictor 2 at 8, 16 and 32 bits (after libtiff's byte swap) and 3
    on float samples, with LZW and both Deflate codes, in strips, tiles and
    planes, both byte orders; a predictor on a PackBits file is ignored, as
    libtiff ignores it."""
    rng = np.random.default_rng(4)
    for bits, photo, n, fmt in ((8, 1, 1, None), (8, 2, 3, None), (16, 2, 3, None), (32, 1, 1, 2),
                                (8, 2, 4, None), (8, 5, 4, None), (32, 1, 1, 3)):
        for comp in (5, 8, 32946):
            for layout in TIFF_LAYOUTS.values():
                for order in "<>":
                    s = _samples(rng, 19, 27, n, min(bits, 16), fmt or 1)
                    kw = dict(sample_format=fmt) if fmt else {}
                    if n == 4 and photo == 2:
                        kw["extra"] = [2]
                    for pred in (2, 3) if fmt == 3 else (2,):
                        _tiff_same_as_jax(tmp_path, f"p{bits}{photo}{comp}{order}{pred}.tif",
                                          make_tiff(s, bits, photo, order=order, compression=comp,
                                                    predictor=pred, **kw, **layout))
    _tiff_same_as_jax(tmp_path, "pb-pred.tif", make_tiff(smooth_image(rng, 9, 13, 3), 8, 2, compression=32773,
                                                         predictor=2))


@pytest.mark.parametrize("subsampling", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2), (4, 4)])
def test_tiff_ycbcr_matches_jax(tmp_path, subsampling):
    """YCbCr without JPEG, which Pillow reads through libtiff's RGBA
    interface: each block of luma with its Cb and Cr, libtiff's float-built
    YCbCr tables (ReferenceBlackWhite and YCbCrCoefficients too), strips
    that end mid-block (gtStripContig's rounded-down scanlines, zeroed
    past them), tiles cut at the image's edge (putcontig8bitYCbCr44tile
    skips 10 bytes a block there, not 18)."""
    rng = np.random.default_rng(5)
    for comp in (32773, 5, 8):
        for layout in ({"rows_per_strip": 3}, {"rows_per_strip": 8}, {"tile": (16, 16)}, {}):
            for h, w in ((19, 27), (19, 8), (5, 13)):
                _tiff_same_as_jax(tmp_path, f"y{comp}{h}{w}.tif", make_tiff(
                    smooth_image(rng, h, w, 3), 8, 6, compression=comp, subsampling=subsampling, **layout))
    _tiff_same_as_jax(tmp_path, "y-ref.tif", make_tiff(
        smooth_image(rng, 19, 27, 3), 8, 6, compression=5, subsampling=subsampling, rows_per_strip=4,
        tags=[(532, 5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)]),
              (529, 5, [(2126, 10000), (7152, 10000), (722, 10000)])]))


TIFF_JPEG = {"ycbcr": (3, 6, {}), "rgb": (3, 2, {}), "grey": (1, 1, {}), "cmyk": (4, 5, {}),
             "rgba": (4, 2, dict(extra=[2])), "la": (2, 1, dict(extra=[2]))}


@pytest.mark.parametrize("kind", sorted(TIFF_JPEG))
def test_tiff_jpeg_matches_jax(tmp_path, kind):
    """Compression 7: each strip or tile an abbreviated JPEG (its tables in
    JPEGTables, or its own), decoded by the port's JPEG decoder as libtiff
    asks libjpeg: YCbCr converted to RGB (JPEGCOLORMODE_RGB) at the
    stream's sampling, any other photometric's components as they are;
    a last strip coded taller than the image is cut."""
    n, photo, tags = TIFF_JPEG[kind]
    rng = np.random.default_rng(6)
    subs = [(1, 1), (2, 1), (1, 2), (2, 2)] if photo == 6 else [None]
    for sub in subs:
        for layout in ({"rows_per_strip": 8}, {"rows_per_strip": 16}, {"tile": (16, 16)}, {}):
            for tables in (True, False):
                order = ">" if tables else "<"
                kw = dict(tags, **layout)
                if sub:
                    kw["subsampling"] = sub
                _tiff_same_as_jax(tmp_path, f"j{sub}{tables}.tif", make_tiff(
                    smooth_image(rng, 19, 27, n), 8, photo, order=order, compression=7, jpeg_tables=tables,
                    **kw))
    # 32 rows coded, ImageLength 19: the second strip's JPEG is 16 rows for 3.
    tall = make_tiff(smooth_image(rng, 32, 27, n), 8, photo, compression=7, rows_per_strip=16,
                     tags=[(257, 4, [19])], **tags)
    _tiff_same_as_jax(tmp_path, "tall.tif", tall)


def test_tiff_containers_and_orientation_match_jax(tmp_path):
    """BigTIFF; the two "invalid" byte-order prefixes (Pillow's raw reader
    takes them, libtiff refuses them); the directory before the data;
    every Orientation (Pillow 12 transposes at load); FillOrder 2 on every
    entry that has one (raw: Pillow's ";R" unpackers, where they exist;
    compressed: libtiff reverses the bytes first)."""
    rng = np.random.default_rng(7)
    rgb = smooth_image(rng, 19, 27, 3)
    for order in "<>":
        for comp in (1, 5, 8, 32773, 7):
            big = make_tiff(rgb, 8, 2, order=order, header="bigtiff", compression=comp, rows_per_strip=7)
            swapped = make_tiff(rgb, 8, 2, order=order, header="swapped", compression=comp, rows_per_strip=7)
            if order == "<":
                _tiff_same_as_jax(tmp_path, f"big{comp}.tif", big)
            else:        # Pillow reads a big-endian BigTIFF's header as a classic one's
                _both_raise(tmp_path, f"bigmm{comp}.tif", big, "BigTIFF")
            if comp == 1:
                _tiff_same_as_jax(tmp_path, f"sw{order}.tif", swapped)
            else:
                _both_raise(tmp_path, f"sw{order}{comp}.tif", swapped, "byte order")
    for comp in (1, 5):
        _tiff_same_as_jax(tmp_path, f"first{comp}.tif", make_tiff(
            smooth_image(rng, 9, 13, 4), 8, 2, extra=[2], compression=comp, ifd_first=True, rows_per_strip=3))
        for o in range(0, 10):
            _tiff_same_as_jax(tmp_path, f"o{o}{comp}.tif", make_tiff(rgb, 8, 2, compression=comp,
                                                                   tags=[(274, 3, [o])]))
            _tiff_same_as_jax(tmp_path, f"op{o}{comp}.tif", make_tiff(
                rng.integers(0, 16, (9, 13)), 4, 3, compression=comp, colormap=rng.integers(0, 65536, (16, 3)),
                tile=(16, 16), tags=[(274, 3, [o])]))
    for bits, photo in ((1, 0), (1, 1), (2, 1), (4, 0), (8, 1), (8, 0), (8, 2), (1, 3), (2, 3), (4, 3), (8, 3)):
        for comp in (1, 32773, 5, 8):
            for order in "<>":
                s = rng.integers(0, 1 << bits, (9, 13, 3 if photo == 2 else 1))
                kw = dict(colormap=rng.integers(0, 65536, (1 << bits, 3))) if photo == 3 else {}
                _same_or_both_raise(tmp_path, f"f{bits}{photo}{comp}{order}.tif",    # no "P;2R" unpacker
                                    make_tiff(s, bits, photo, order=order, compression=comp, fill_order=2, **kw))


def test_tiff_directory_faults_raise_as_jax(tmp_path):
    """Where Pillow refuses a TIFF, so does the port: a layout not in its
    table, too many samples, no ColorMap, no offsets, a strip or tile past
    the file's end, a raw strip cut short, a directory whose values lie
    past the end (Pillow stops reading it there); and a codec's data cut
    short or corrupt raises for every compression (a cut that leaves the
    image whole reads as Pillow reads it)."""
    rng = np.random.default_rng(8)
    rgb = smooth_image(rng, 9, 13, 3)
    cases = {
        "no-mode": make_tiff(rng.integers(0, 8, (9, 13, 1)), 3, 1),
        "mm-unsigned32": make_tiff(rng.integers(0, 9, (9, 13, 1)), 32, 1, order=">"),
        "seven-samples": make_tiff(rng.integers(0, 9, (9, 13, 7)), 8, 2),
        "no-colormap": make_tiff(rng.integers(0, 9, (9, 13, 1)), 8, 3),
        "no-offsets": make_tiff(rgb, 8, 2, omit=(273,)),
        "no-dimensions": make_tiff(rgb, 8, 2, omit=(257,)),
        "bps-past-end": make_tiff(rgb, 8, 2, tags=[(258, 3, [8, 8, 8])])[:-4],
        "windows-media-photo": make_tiff(rgb, 8, 2, tags=[(0xBC01, 3, [1])]),
        "lab-grey": make_tiff(rgb, 8, 8),
    }
    for name, data in cases.items():
        p = tmp_path / f"{name}.tif"
        p.write_bytes(data)
        if name == "lab-grey":   # convert("RGBA") reads Lab, convert("L") refuses it
            with pytest.raises(ValueError):
                jol.load_texture_file(str(p), grayscale=True)
            with pytest.raises(ValueError, match="Lab"):
                image_decode.decode_image(data)
            continue
        _both_raise(tmp_path, f"{name}-2.tif", data)
    for comp in (1, 32773, 5, 8, 7):
        data = make_tiff(rgb, 8, 2, compression=comp, ifd_first=True, rows_per_strip=5)
        for cut in (len(data) - 1, len(data) - 9, len(data) * 3 // 4):
            _same_or_both_raise(tmp_path, f"cut{comp}-{cut}.tif", data[:cut])
    for comp, junk in ((5, bytes([0x80, 0x40, 0x30]) * 8), (8, b"\x78\x9c\xff\xff" * 4),
                       (32773, b"\x7f\x00"), (7, b"\xff\xd8\xff\xd9")):
        data = make_tiff(rgb, 8, 2, compression=comp, rows_per_strip=9, seg_data=[junk])
        _both_raise(tmp_path, f"junk{comp}.tif", data)
    # Tile and strip sizes past the file or past 32 bits (a BigTIFF's
    # LONG8): Pillow's raw reader takes the row stride as a C int, libtiff
    # reads the three tags as 32-bit values.
    g = rng.integers(0, 256, (5, 4), dtype=np.uint8)
    for comp in (1, 5):
        for name, kw in (("tw62", dict(tile=(4, 5), tags=[(322, 16, [2 ** 62]), (323, 16, [5])])),
                         ("th62", dict(tile=(4, 5), tags=[(322, 16, [4]), (323, 16, [2 ** 62])])),
                         ("rps62", dict(tags=[(278, 16, [2 ** 62])])),
                         ("tw20", dict(tile=(4, 5), tags=[(322, 16, [2 ** 20])])),
                         ("spp-count2", dict(tags=[(277, 3, [1, 1])])),
                         ("w-count2", dict(tags=[(256, 4, [4, 4])]))):
            _same_or_both_raise(tmp_path, f"{name}-{comp}.tif", make_tiff(g, 8, 1, header="bigtiff",
                                                                       compression=comp, **kw))


@pytest.mark.parametrize("mode", ["L", "P", "RGBA", "CMYK", "L-planar"])
def test_tiff_mapped_orientation_matches_jax(tmp_path, mode):
    """Pillow memory-maps a lone uncompressed strip or tile whose rawmode
    is its mode: it reads the whole image from that offset, whatever the
    tile's extent, at the size Orientation 5-8 has already swapped (so the
    bytes are read as an image h wide and w high before they are
    transposed); the port reads them so.  A tile wider than the image
    keeps its stride, a map past the file's end raises, a strip cut short
    of the tile's own stride decodes as usual; where the last mapped row
    runs past the file's end (rows that overlap), Pillow reads past the
    file and the port raises."""
    rng = np.random.default_rng(12)
    h, w = 7, 11
    photo, kw = {"L": (1, {}), "P": (3, dict(colormap=rng.integers(0, 65536, (256, 3)))),
                 "RGBA": (2, dict(extra=[2])), "CMYK": (5, {}), "L-planar": (1, dict(planar=2))}[mode]
    s = rng.integers(0, 256, (h, w, {"RGBA": 4, "CMYK": 4}.get(mode, 1)))
    blob = rng.integers(0, 256, 8 * h * w, dtype=np.uint8).tobytes()
    for o in (1, 5, 6, 7, 8):
        for layout in (dict(), dict(tile=(16, 16)), dict(rows_per_strip=3),
                       dict(tile=(4, 4), seg_data=[blob]), dict(tile=(16, 4), seg_data=[blob])):
            data = make_tiff(s, 8, photo, tags=[(274, 3, [o])], **kw, **layout)
            for cut in (len(data), len(data) - 3):
                _same_or_both_raise(tmp_path, f"m{o}{len(layout)}{cut}.tif", data[:cut])
    if mode == "L":   # rows 4 bytes apart, 7 long once turned, the data last in the file
        data = make_tiff(s[:, :2], 8, 1, tile=(4, 8), seg_data=[blob[:8]], ifd_first=True, tags=[(274, 3, [6])])
        assert data.endswith(blob[:8])
        with pytest.raises(ValueError, match="truncated"):
            image_decode.decode_image(data)


@pytest.mark.parametrize("adobe", [None, 0, 1, 2])
def test_cmyk_and_ycck_jpeg_match_jax(tmp_path, adobe):
    """Four-component JPEG: CMYK without an Adobe marker or with transform
    0, YCCK with any other transform (jdcolor.c ycck_cmyk_convert), each
    component upsampled on its own at any integral sampling, restart
    markers; Pillow reads every one as "CMYK;I" (Adobe's inverted
    samples) and convert applies cmyk2rgb."""
    rng = np.random.default_rng(9 + (adobe or 0))
    factors = ([(1, 1)] * 4, [(2, 2), (1, 1), (1, 1), (2, 2)], [(2, 1), (1, 1), (1, 1), (2, 1)],
               [(1, 2), (1, 1), (1, 1), (1, 2)], [(1, 1), (2, 2), (1, 1), (1, 1)], [(4, 1), (1, 1), (1, 1), (1, 1)])
    for h, w in SIZES:
        planes = [smooth_image(rng, h, w, 1)[..., 0] for _ in range(4)]
        for fac in factors:
            for restart in (0, 2):
                _tiff_same_as_jax(tmp_path, f"c{h}x{w}.jpg",
                                  encode_jpeg(planes, fac, q=3, adobe=adobe, jfif=False, restart=restart))
        if adobe is None:    # Pillow writes an Adobe marker of transform 0
            img = Image.fromarray(np.stack(planes, -1), "CMYK")
            for kw in (dict(quality=90), dict(quality=50, progressive=True), dict(restart_marker_blocks=2)):
                _same_as_jax(_save(tmp_path, f"p{h}x{w}.jpg", img, **kw))


def test_16bit_tiff_grey_diverges_from_jax_as_stb(tmp_path):
    """Pillow opens 16-bit grey TIFF as "I;16", "I;16B" or (signed) "I",
    and the JAX package's convert clips each sample to 255; the port takes
    the high byte, as for 16-bit PNG and PGM (stb_image's rule; a negative
    signed sample reads 0) (ROADMAP, "Faults of the reference")."""
    samples = np.array([[55745, 41743, 33497, 200, 0]], np.int64)
    signed = np.array([[30000, 1000, 255, -5, -30000]], np.int64)
    for name, s, fmt, order, comp in (("i16.tif", samples, None, "<", 1), ("i16b.tif", samples, None, ">", 5),
                                      ("i16s.tif", signed, 2, "<", 8), ("i16bs.tif", signed, 2, ">", 1)):
        p = tmp_path / name
        p.write_bytes(make_tiff(s, 16, 1, order=order, compression=comp, sample_format=fmt))
        want_jax = np.clip(s[0], 0, 255).astype(np.float32) / 255
        want = (np.maximum(s[0], 0) >> 8).astype(np.float32) / 255
        for grayscale in (False, True):
            assert np.array_equal(jol.load_texture_file(str(p), grayscale)[0, :, 0], want_jax), name
            assert np.array_equal(tol.load_texture_file(str(p), grayscale)[0, :, 0], want), name
        assert image_decode.decode_image(p.read_bytes())[1] == Image.open(p).mode


# ------------------------------------------------------- corrupt JPEG ----

@pytest.mark.parametrize("name", sorted(CORRUPT_JPEGS))
def test_corrupt_jpeg_matches_jax(name):
    """Fixtures with a quantizer entry or entropy bytes changed, which
    libjpeg decodes without an error: their dequantized coefficients
    overflow the 16-bit lanes of libjpeg-turbo's SIMD ISLOW IDCT (what
    Pillow runs on x86-64), and the port computes that IDCT, so it gives
    JAX's pixels; libjpeg's C IDCT (JSIMD_FORCENONE) gives others."""
    seed, edits = CORRUPT_JPEGS[name]
    data = bytearray(_fixture(seed))
    for offset, byte in edits:
        data[offset] = byte
    assert bytes(data) == _fixture(name)
    _same_as_jax(FIXTURES / name)


def test_jpeg_idct_overflow_blocks_match_jax(tmp_path):
    """Coefficient blocks no encoder writes: DC-only blocks whose (DC x q)
    << 2 wraps 16 bits, blocks with only row 0 set, AC at every position,
    quantizers above 32767 (a 16-bit DQT), sums past 16 bits in both
    passes: bit-equal to JAX's Pillow, whose libjpeg-turbo SIMD IDCT
    wraps and saturates in 16-bit lanes."""
    rnd = np.random.default_rng(180)
    for case in range(24):
        blocks = []
        for b in range(4):
            zz = [0] * 64
            kind = (case + b) % 4
            if kind == 0:
                zz[0] = int(rnd.integers(-32767, 32768))
            elif kind == 1:
                for k in (0, 1, 5, 6, 14, 15, 27, 28):        # row 0 of the block
                    zz[k] = int(rnd.integers(-32767, 32768))
            elif kind == 2:
                for k in rnd.choice(64, 6, replace=False):
                    zz[int(k)] = int(rnd.integers(-32767, 32768))
            else:
                zz = [int(v) for v in rnd.integers(-3000, 3001, 64)]
            blocks.append(zz)
        pred = 0
        for zz in blocks:                                   # DC differences fit 15 bits
            zz[0] = int(np.clip(zz[0], pred - 32767, pred + 32767))
            pred = zz[0]
        quant = [int(v) for v in (rnd.integers(1, 256, 64) if case % 3 == 0 else rnd.integers(1, 65536, 64))]
        p = tmp_path / f"idct{case}.jpg"
        p.write_bytes(encode_jpeg_blocks(blocks, 16, 16, quant))
        _same_as_jax(p)


def test_corrupt_jpeg_libjpeg_recovers_diverges_from_jax(tmp_path):
    """A corrupt scan that libjpeg decodes on with a warning (a run past
    coefficient 63 writes coefficient 63) and Pillow returns as an image:
    the port follows libjpeg's recovery and gives the JAX package's
    pixels (ROADMAP queue C, repaired; the fixture corrupt_recovered.jpg)."""
    data = bytearray(_fixture("grey.jpg"))
    data[383] = 0x00
    assert bytes(data) == _fixture("corrupt_recovered.jpg")
    p = tmp_path / "recovered.jpg"
    p.write_bytes(bytes(data))
    for grayscale in (False, True):
        jax = jol.load_texture_file(str(p), grayscale)
        assert jax.shape == (31, 40, 4 if not grayscale else 1) and np.isfinite(jax).all()
    _same_as_jax(p)


def _edit(data, *edits, delete=None):
    b = bytearray(data)
    for offset, byte in edits:
        b[offset] = byte
    if delete:
        del b[delete[0]:delete[1]]
    return bytes(b)


def test_tiff_count_past_the_file_diverges_from_jax(tmp_path):
    """A TIFF directory entry whose count runs its data past the end of the
    file (jpeg_ycbcr.tif's TileOffsets, 4 -> 260 values): libtiff trims or
    skips the tag and Pillow decodes the image; the port refuses the
    directory (ROADMAP queue C, open; found by the JPEG fuzz of
    tests/_torch_jpeg_fuzz.py)."""
    p = tmp_path / "count.tif"
    p.write_bytes(_edit(_fixture("jpeg_ycbcr.tif"), (1107, 1)))
    for grayscale in (False, True):
        jax = jol.load_texture_file(str(p), grayscale)
        assert jax.shape[:2] == (64, 64) and np.isfinite(jax).all()
        with pytest.raises(ValueError, match="malformed TIFF directory"):
            tol.load_texture_file(str(p), grayscale)


def _recovery_cases():
    """Corrupt JPEG data and what libjpeg-turbo does with it (its first
    warning): byte edits of the fixtures, each found with libjpeg's own
    messages.  base422_rst.jpg's RST1 is at 1260, arith420_rst.jpg's at
    1531; the decoder expects RST1 there."""
    grey, prog, base = _fixture("grey.jpg"), _fixture("prog420_odd.jpg"), _fixture("base422_rst.jpg")
    arith, aprog = _fixture("arith420_rst.jpg"), _fixture("arith_prog.jpg")
    return {
        "huffman-past-63": _edit(grey, (383, 0)),
        "huffman-bad-code": _edit(prog, (986, 18)),                     # JWRN_HUFF_BAD_CODE
        "huffman-marker-in-scan": _edit(grey, (890, 214)),              # JWRN_HIT_MARKER: zeros, then grey
        "huffman-marker-in-restart-interval": _edit(base, (1245, 254)),
        "huffman-rst-far": _edit(base, (1261, 0xD5)),                   # resync: discard the marker
        "huffman-rst-next": _edit(base, (1261, 0xD2)),                  # resync: an empty segment
        "huffman-rst-prior": _edit(base, (1261, 0xD0)),                 # resync: skip to the next marker
        "huffman-rst-missing": _edit(base, delete=(1260, 1262)),
        "huffman-eoi-in-progressive-scan": prog[:1200] + b"\xff\xd9",
        "arith-bad-code": _edit(arith, (2430, 92)),                     # JWRN_ARITH_BAD_CODE
        "arith-progressive-bad-code": _edit(aprog, (4626, 102)),
        "arith-invalid-marker-for-rst": _edit(aprog, (1718, 255)),
        "arith-rst-far": _edit(arith, (1532, 0xD6)),
        "arith-rst-next": _edit(arith, (1532, 0xD3)),
        "arith-eoi-in-scan": arith[:1000] + b"\xff\xd9",
    }


@pytest.mark.parametrize("case", sorted(_recovery_cases()))
def test_corrupt_jpeg_recovery_matches_jax(tmp_path, case):
    """libjpeg-turbo's recovery from corrupt scans (jdhuff.c, jdphuff.c,
    jdarith.c, jdmarker.c): a bad Huffman code read as 0, a run past the
    band written to coefficient 63, zeros after a marker inside a scan and
    no more MCUs of that segment, the restart resync's three actions, the
    arithmetic decoder's code errors: Pillow returns the image, and the
    port gives the JAX package's pixels."""
    p = tmp_path / f"{case}.jpg"
    p.write_bytes(_recovery_cases()[case])
    _same_as_jax(p)


def test_jpeg_cut_inside_a_scan_raises_as_jax(tmp_path):
    """A file that ends inside a scan: Pillow raises "image file is
    truncated" (libjpeg suspends, LOAD_TRUNCATED_IMAGES is off), an
    arithmetic decoder cannot suspend; the port raises."""
    for name in ("grey.jpg", "prog420_odd.jpg", "base422_rst.jpg", "arith420_rst.jpg", "arith_prog.jpg",
                 "lossless_grey.jpg"):
        data = _fixture(name)
        for cut in (len(data) - 2, len(data) * 3 // 4):
            _both_raise(tmp_path, f"cut{cut}-{name}", data[:cut])


JPEG_STREAMS = {   # libjpeg's markers around and after the scans (jdmarker.c read_markers)
    "no-dht-standard-tables": lambda d: _strip_segments(d, 0xC4),
    "junk-between-markers": lambda d: d[:d.index(b"\xff\xda")] + b"\x12\x34" + d[d.index(b"\xff\xda"):],
    "rst-before-the-scan": lambda d: d[:d.index(b"\xff\xda")] + b"\xff\xd3" + d[d.index(b"\xff\xda"):],
    "dnl-between-markers": lambda d: d[:d.index(b"\xff\xda")] + b"\xff\xdc\x00\x04\x00\x28"
                                     + d[d.index(b"\xff\xda"):],
    "rst-for-eoi": lambda d: d[:-1] + b"\xd0",
    "tem-for-eoi": lambda d: d[:-1] + b"\x01",
    "no-eoi-junk-after": lambda d: d[:-2] + b"\x12" * 20,
    "dht-cut-after-the-scan": lambda d: d[:-2] + d[d.index(b"\xff\xc4"):d.index(b"\xff\xc4") + 30],
    "sequential-scan-parameters": lambda d: _edit(d, *((d.index(b"\xff\xda") + 2 + 2 * d[d.index(b"\xff\xda") + 4]
                                                       + 3 + k, v) for k, v in ((0, 5), (1, 20), (2, 0x23)))),
    "second-scan-raises": lambda d: d[:-2] + d[d.index(b"\xff\xda"):],
    "tem-before-the-scan-raises": lambda d: d[:d.index(b"\xff\xda")] + b"\xff\x01" + d[d.index(b"\xff\xda"):],
    "no-eoi-raises": lambda d: d[:-2],
    "short-jfif-raises": lambda d: d[:4] + b"\x00\x06JFIF" + d[20:],
}


def _strip_segments(data, code):
    out, p = bytearray(data[:2]), 2
    while data[p + 1] != 0xDA:
        n = struct.unpack(">H", data[p + 2:p + 4])[0]
        if data[p + 1] != code:
            out += data[p:p + 2 + n]
        p += 2 + n
    return bytes(out) + data[p:]


@pytest.mark.parametrize("case", sorted(JPEG_STREAMS))
def test_jpeg_markers_match_jax(tmp_path, case):
    """Markers as libjpeg reads them, on a Pillow baseline JPEG: missing
    Huffman tables are the standard ones (a sequential file), data bytes
    between markers are skipped, RSTn, TEM and DNL are passed over after
    the scan, a single-scan file may end without EOI after its scan (Pillow
    has every row), a sequential scan's odd Ss, Se, Ah, Al are a warning;
    a second scan of a single-scan file, TEM before the scan (Pillow's
    parser), a missing EOI inside the scan data and a short JFIF segment
    raise on both sides."""
    rng = np.random.default_rng(191)
    buf = io.BytesIO()
    Image.fromarray(smooth_image(rng, 40, 48, 3)).save(buf, "JPEG", quality=80)
    _same_or_both_raise(tmp_path, f"{case}.jpg", JPEG_STREAMS[case](buf.getvalue()))
    if case.endswith("raises"):
        with pytest.raises(ValueError):
            image_decode.decode_image(JPEG_STREAMS[case](buf.getvalue()))


@pytest.mark.parametrize("kind", ["huffman", "arith"])
def test_jpeg_in_tiff_recovery_matches_jax(tmp_path, kind):
    """JPEG-in-TIFF tiles with corrupt entropy data (bytes of the tiles
    changed, seeded): libtiff hands libjpeg each tile with a fake EOI past
    its end and ignores jpeg_finish_decompress's errors; bit-equal to JAX
    where Pillow decodes, ValueError where it raises."""
    rng = np.random.default_rng(192)
    enc = None if kind == "huffman" else (lambda c, f, q: encode_arith_planes(c, f, q, jfif=False))
    tif = make_tiff(smooth_image(rng, 32, 32, 3), 8, 6, compression=7, subsampling=(2, 2), tile=(16, 16),
                    jpeg=enc)
    ifd = struct.unpack("<I", tif[4:8])[0]
    decoded = 0
    for i in range(10):
        bad = bytearray(tif)
        for _ in range(1 + i % 3):
            bad[int(rng.integers(8, ifd))] = int(rng.integers(0, 256))
        p = tmp_path / f"t{i}.tif"
        p.write_bytes(bytes(bad))
        try:
            Image.open(p).load()
        except Exception:                      # noqa: BLE001 - Pillow refuses: so must the port
            with pytest.raises(ValueError):
                image_decode.decode_image(bytes(bad))
            continue
        _same_as_jax(p)
        decoded += 1
    assert decoded >= 5


def test_incomplete_progressive_jpeg_matches_jax(tmp_path):
    """A progressive file cut after any of its scans: libjpeg-turbo
    block-smooths it (jdcoefct.c decompress_smooth_data with
    do_block_smoothing on: coefficients 1-9 that are still zero and not
    known to be estimated from the 5x5 blocks' DC values, DC too while no
    AC coefficient is known), colour 4:2:0 and 4:4:4, grey, one to three
    blocks wide; bit-equal to JAX.  A complete file is not smoothed."""
    rng = np.random.default_rng(193)
    files = [_fixture("prog420_odd.jpg")]
    for (h, w, c, sub) in ((24, 9, 3, 2), (17, 24, 3, 0), (33, 17, 1, 0), (9, 16, 3, 2)):
        img = smooth_image(rng, h, w, c)
        buf = io.BytesIO()
        Image.fromarray(img if c == 3 else img[..., 0]).save(buf, "JPEG", quality=70, subsampling=sub,
                                                             progressive=True)
        files.append(buf.getvalue())
    for f, data in enumerate(files):
        sos = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
        for k in range(1, len(sos) + 1):
            p = tmp_path / f"prog{f}-{k}.jpg"
            p.write_bytes(data[:sos[k]] + b"\xff\xd9" if k < len(sos) else data)
            _same_as_jax(p)


def _arith_cases():
    rng = np.random.default_rng(194)
    img = smooth_image(rng, 29, 37, 4)
    rgb, cmyk = [img[..., k] for k in range(3)], [img[..., k] for k in range(4)]
    return {
        "444": encode_arith_planes(rgb, [(1, 1)] * 3),
        "422-restart-every-mcu": encode_arith_planes(rgb, [(2, 1), (1, 1), (1, 1)], restart=1),
        "440-dac": encode_arith_planes(rgb, [(1, 2), (1, 1), (1, 1)], dac=((0, 0xF2), (16, 60))),
        "420-dac-L-above-0": encode_arith_planes(rgb, [(2, 2), (1, 1), (1, 1)], 2, dac=((0, 0x43), (16, 0))),
        "grey": encode_arith_planes(rgb[:1], [(1, 1)], 3),
        "grey-progressive": encode_arith_planes(rgb[:1], [(1, 1)], 2, progression=PROGRESSION1, restart=5),
        "progressive-420": encode_arith_planes(rgb, [(2, 2), (1, 1), (1, 1)], progression=PROGRESSION3),
        "cmyk": encode_arith_planes(cmyk, [(1, 1)] * 4, adobe=0),
        "ycck": encode_arith_planes(cmyk, [(2, 2), (1, 1), (1, 1), (2, 2)], adobe=2),
        "incomplete-progressive": encode_arith_planes(rgb, [(1, 1)] * 3, progression=PROGRESSION3[:5]),
    }


@pytest.mark.parametrize("case", sorted(_arith_cases()))
def test_arithmetic_jpeg_matches_jax(tmp_path, case):
    """Arithmetic-coded JPEG (SOF9, SOF10; jdarith.c: the QM decoder, DC
    and AC statistics conditioned by DAC's L, U and K, reset at each
    restart) from the tests' encoder (jcarith.c's coder): samplings,
    grey, progressive, CMYK and YCCK, an incomplete progressive file;
    bit-equal to JAX."""
    p = tmp_path / f"{case}.jpg"
    p.write_bytes(_arith_cases()[case])
    _same_as_jax(p)


def test_arithmetic_jpeg_in_tiff_and_past_64k(tmp_path):
    """Arithmetic-coded JPEG tiles in a TIFF (libtiff hands libjpeg each
    whole tile) are bit-equal to JAX.  A standalone arithmetic file whose
    scan runs past 64 KiB raises in both packages: Pillow feeds libjpeg
    64 KiB reads and the arithmetic decoder cannot suspend; the port
    refuses it the same way, and reads one whose marker segments already
    took Pillow past the first read."""
    rng = np.random.default_rng(195)
    enc = lambda c, f, q: encode_arith_planes(c, f, q, jfif=False)   # noqa: E731
    for photo, n, kw in ((6, 3, dict(subsampling=(2, 2))), (1, 1, {}), (2, 3, {})):
        _tiff_same_as_jax(tmp_path, f"arith{photo}.tif", make_tiff(
            smooth_image(rng, 27, 34, n), 8, photo, compression=7, tile=(16, 16), jpeg=enc, **kw))
    noisy = smooth_image(rng, 200, 400, 1, noise=120)[..., 0]
    big = encode_arith_planes([noisy], [(1, 1)], 2)
    assert len(big) > 65536
    _both_raise(tmp_path, "arith-past-64k.jpg", big, "64 KiB")
    # A comment segment before the scans: a first SOS that ends past 64 KiB
    # is read with a second 64 KiB (the scans then fit), one that ends
    # before it leaves its scan data to cross the first read's end.
    small = encode_arith_planes([noisy[:120, :200]], [(1, 1)], 2, progression=PROGRESSION1)
    for pad, fits in ((65530, True), (65000, False)):
        data = small[:2] + b"\xff\xfe" + struct.pack(">H", pad + 2) + bytes(pad) + small[2:]
        assert data.index(b"\xff\xda") + 10 > 65536 if fits else data.index(b"\xff\xda") + 10 < 65536
        if fits:
            (tmp_path / f"pad{pad}.jpg").write_bytes(data)
            _same_as_jax(tmp_path / f"pad{pad}.jpg")
        else:
            _both_raise(tmp_path, f"pad{pad}.jpg", data, "64 KiB")


def _lossless_cases():
    rng = np.random.default_rng(196)
    img = smooth_image(rng, 23, 29, 4)
    rgb, grey = [img[..., k] for k in range(3)], [img[..., 3]]
    cases = {f"grey-predictor{k}-pt{pt}": encode_lossless_jpeg(grey, k, pt, restart_rows=3 if k % 2 else 0)
             for k in range(1, 8) for pt in (0, 3)}
    cases.update({
        "rgb-no-marker": encode_lossless_jpeg(rgb, 5, restart_rows=4),
        "rgb-component-ids": encode_lossless_jpeg(rgb, 4, ids=[82, 71, 66]),
        "rgb-adobe-0": encode_lossless_jpeg(rgb, 7, 1, adobe=0),
        "cmyk": encode_lossless_jpeg([img[..., k] for k in range(4)], 6, adobe=0),
    })
    return cases


@pytest.mark.parametrize("case", sorted(_lossless_cases()))
def test_lossless_jpeg_matches_jax(tmp_path, case):
    """Lossless JPEG (SOF3; libjpeg-turbo 3's jdlhuff.c, jddiffct.c,
    jdlossls.c): predictors 1-7, point transforms, restarts, one, three
    (RGB without a JFIF or YCbCr Adobe marker) and four components;
    bit-equal to JAX."""
    p = tmp_path / f"{case}.jpg"
    p.write_bytes(_lossless_cases()[case])
    _same_as_jax(p)


def _refused_jpegs():
    base = _fixture("base422_rst.jpg")
    sof = base.index(b"\xff\xc0")

    def sof_as(code, precision=8):
        return base[:sof + 1] + bytes([code]) + base[sof + 2:sof + 4] + bytes([precision]) + base[sof + 5:]

    rng = np.random.default_rng(197)
    rgb = [smooth_image(rng, 12, 14, 3)[..., k] for k in range(3)]
    lossless = encode_lossless_jpeg(rgb, 1, restart_rows=2)
    dri = lossless.index(b"\xff\xdd")
    return {
        "12-bit": sof_as(0xC0, 12),
        "12-bit-lossless": sof_as(0xC3, 12),
        **{f"hierarchical-sof{code - 0xC0}": sof_as(code) for code in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF)},
        "dnl-height": base[:sof + 5] + b"\x00\x00" + base[sof + 7:],
        "two-components": encode_jpeg([rgb[0]] * 2, [(1, 1)] * 2),
        "arithmetic-lossless-sof11": encode_lossless_jpeg(rgb[:1], 1, sof=0xCB),
        "lossless-ycbcr-jfif": encode_lossless_jpeg(rgb, 1, jfif=True),
        "lossless-ycck": encode_lossless_jpeg(rgb + rgb[:1], 1, adobe=2),
        "lossless-restart-not-whole-rows": lossless[:dri + 5] + b"\x0f" + lossless[dri + 6:],
        "huffman-data-under-sof3": sof_as(0xC3),
        "progressive-without-huffman-tables": _strip_segments(_fixture("prog420_odd.jpg"), 0xC4),
    }


@pytest.mark.parametrize("case", sorted(_refused_jpegs()))
def test_jpeg_refusals_match_jax(tmp_path, case):
    """What both sides refuse: 12-bit and hierarchical JPEG, a height set
    by a DNL marker, two components (Pillow's parser), arithmetic-coded
    lossless, lossless with a colour conversion, a lossless restart
    interval that is not whole rows, Huffman data under a lossless frame,
    a progressive file without its Huffman tables (libjpeg-turbo supplies
    the standard ones to sequential files only): the JAX package raises,
    the port raises ValueError."""
    _both_raise(tmp_path, f"{case}.jpg", _refused_jpegs()[case])


# ---------------------------------------------------------------- WebP ----

WEBP_SAVE = {"q80": dict(quality=80), "q10-m0": dict(quality=10, method=0),
             "q100-m6": dict(quality=100, method=6), "q50-m3": dict(quality=50, method=3),
             "lossless": dict(lossless=True), "lossless-exact": dict(lossless=True, exact=True)}


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("case", sorted(WEBP_SAVE))
def test_pillow_webp_matches_jax(tmp_path, case, channels):
    """Pillow-written WebP, lossy (VP8 key frames, alpha in ALPH) and
    lossless (VP8L), RGB and RGBA, at odd sizes and 1x1 (the macroblock
    and upsampler edges)."""
    rng = np.random.default_rng(sorted(WEBP_SAVE).index(case) * 2 + channels)
    for h, w in SIZES:
        px = smooth_image(rng, h, w, channels)
        if channels == 4:
            px[..., 3] = np.where(px[..., 3] < 64, 0, px[..., 3])       # transparent texels too
        p = tmp_path / f"{h}x{w}.webp"
        p.write_bytes(pillow_webp(px, **WEBP_SAVE[case]))
        _same_as_jax(p)


WEBP_ENCODER = {**{f"partitions-{1 << k}": dict(partitions=k) for k in range(4)},
                "simple-filter": dict(filter_type=0, filter_strength=60),
                "normal-filter": dict(filter_type=1, filter_strength=60),
                "sharpness-3": dict(filter_type=1, filter_strength=40, filter_sharpness=3),
                "sharpness-7": dict(filter_type=0, filter_strength=80, filter_sharpness=7),
                "filter-strength-0": dict(filter_strength=0, autofilter=0),
                **{f"segments-{k}": dict(segments=k, sns_strength=100) for k in range(1, 5)},
                **{f"alpha-c{c}-f{f}": dict(alpha_compression=c, alpha_filtering=f)
                   for c in (0, 1) for f in (0, 1, 2)}}


@pytest.mark.parametrize("case", sorted(WEBP_ENCODER))
def test_libwebp_encoder_options_match_jax(tmp_path, case):
    """Lossy WebP from libwebp's advanced encoder, for what Pillow's save
    does not set: 1 to 8 token partitions, the simple and the normal loop
    filter, sharpness, filter strength 0, 1 to 4 segments, ALPH raw or
    VP8L-coded with each alpha filtering."""
    opts = WEBP_ENCODER[case]
    rng = np.random.default_rng(sorted(WEBP_ENCODER).index(case) + 100)
    channels = 4 if case.startswith("alpha") else 3
    for h, w in ((23, 37), (40, 24), (1, 1)):
        px = smooth_image(rng, h, w, channels, noise=120)
        if channels == 4:
            px[..., 3] = smooth_image(rng, h, w, 1, noise=8)[..., 0]
        data = encode_webp(px, quality=60, **opts)
        if channels == 4 and h > 1:     # libwebp stores a plane raw where VP8L would not be smaller
            assert webp_chunks(data)[b"ALPH"][0] & 3 == opts["alpha_compression"]
        p = tmp_path / f"{h}x{w}.webp"
        p.write_bytes(data)
        _same_as_jax(p)


@pytest.mark.parametrize("compression", [0, 1])
@pytest.mark.parametrize("method", [0, 1, 2, 3])
def test_hand_written_alph_matches_jax(tmp_path, method, compression):
    """ALPH chunks written by hand beside a lossy VP8 frame: filter none,
    horizontal, vertical, gradient (libwebp's first-row and first-column
    rules, a 1-row and a 1-column plane), raw or the green channel of a
    headerless VP8L stream, the pre-processing bit set or not; and the
    chunk without the VP8X alpha flag (dropped, the mode still RGBA)."""
    rng = np.random.default_rng(10 * method + compression)
    for h, w in ((19, 27), (1, 9), (9, 1)):
        vp8 = webp_chunks(pillow_webp(smooth_image(rng, h, w, 3), quality=70))[b"VP8 "]
        alpha = smooth_image(rng, h, w, 1, noise=200)[..., 0]
        alph = alph_chunk(alpha, method, compression, pre=method & 1)
        for flag in (True, False):
            p = tmp_path / f"{h}x{w}-{flag}.webp"
            p.write_bytes(riff_webp(vp8x_chunk(w, h, alpha=flag), alph, webp_chunk(b"VP8 ", vp8)))
            _same_as_jax(p)
        got = image_decode.decode_image(p.read_bytes().replace(b"VP8X\x0a\0\0\0\x00", b"VP8X\x0a\0\0\0\x10"))
        assert np.array_equal(got[0][..., 3], alpha)


@pytest.mark.parametrize("colours", [2, 4, 16, 256])
def test_lossless_webp_palettes_match_jax(tmp_path, colours):
    """Lossless files of 2, 4, 16 and 256 colours (VP8L's colour-indexing
    transform bundles 8, 4, 2 and 1 pixels a byte) at widths that are no
    multiple of the bundle; RGB and RGBA."""
    rng = np.random.default_rng(colours)
    for channels in (3, 4):
        pal = rng.integers(0, 256, (colours, channels))
        for h, w in SIZES:
            p = tmp_path / f"{channels}-{h}x{w}.webp"
            p.write_bytes(pillow_webp(pal[rng.integers(0, colours, (h, w))], lossless=True))
            _same_as_jax(p)


def test_lossless_alpha_bit_sets_the_mode(tmp_path):
    """The mode follows VP8L's alpha-is-used bit, not the pixels: an RGB
    stream with the bit set reads RGBA (alpha 255), an RGBA stream with it
    cleared reads RGB (its alpha dropped)."""
    rng = np.random.default_rng(7)
    for channels, bit in ((3, True), (4, False), (3, False), (4, True)):
        px = smooth_image(rng, 13, 21, channels)
        vp8l = bytearray(webp_chunks(pillow_webp(px, lossless=True))[b"VP8L"])
        vp8l[4] = vp8l[4] | 0x10 if bit else vp8l[4] & ~0x10
        p = tmp_path / f"{channels}-{bit}.webp"
        p.write_bytes(riff_webp(webp_chunk(b"VP8L", bytes(vp8l))))
        _same_as_jax(p, "RGBA" if bit else "RGB")


WEBP_ANIMATIONS = ("save_all-rgba", "save_all-lossless", "anmf-offset", "anmf-offset-alpha",
                   "anmf-alph", "anmf-vp8l", "metadata")


@pytest.mark.parametrize("case", WEBP_ANIMATIONS)
def test_webp_animation_first_frame_and_containers_match_jax(tmp_path, case):
    """An animation's first frame as Pillow's WebPAnimDecoder gives it: a
    two-frame save_all (RGBA lossy, RGB lossless), and hand-wrapped ANMF
    frames at an offset inside a larger canvas (zeros around), with and
    without the alpha flag, lossy with ALPH and lossless; a still VP8X
    file with ICCP, EXIF, XMP and unknown chunks skipped."""
    rng = np.random.default_rng(WEBP_ANIMATIONS.index(case))
    p = tmp_path / "anim.webp"
    if case.startswith("save_all"):
        lossless = case.endswith("lossless")
        frames = [Image.fromarray(smooth_image(rng, 17, 23, 3 if lossless else 4)) for _ in range(2)]
        frames[0].save(p, "WEBP", save_all=True, append_images=frames[1:], duration=40, lossless=lossless)
        assert Image.open(p).n_frames == 2
    elif case == "metadata":
        vp8 = webp_chunks(pillow_webp(smooth_image(rng, 11, 13, 3)))[b"VP8 "]
        p.write_bytes(riff_webp(vp8x_chunk(13, 11, flags=0x2C), webp_chunk(b"ICCP", b"icc" * 5),
                                webp_chunk(b"ABCD", b"x"), webp_chunk(b"VP8 ", vp8),
                                webp_chunk(b"EXIF", b"Exif\0\0MM\0*" + bytes(7)), webp_chunk(b"XMP ", b"<x/>")))
    else:
        px = smooth_image(rng, 9, 11, 4)
        if case == "anmf-vp8l":
            frame = webp_chunk(b"VP8L", webp_chunks(pillow_webp(px, lossless=True))[b"VP8L"])
        else:
            frame = webp_chunk(b"VP8 ", webp_chunks(pillow_webp(px[..., :3], quality=60))[b"VP8 "])
            if case == "anmf-alph":
                frame = alph_chunk(px[..., 3], 3, 1) + frame
        alpha = case != "anmf-offset"
        second = anmf_chunk(0, 0, 40, 30, webp_chunk(b"VP8 ", webp_chunks(
            pillow_webp(smooth_image(rng, 30, 40, 3)))[b"VP8 "]))
        p.write_bytes(riff_webp(vp8x_chunk(40, 30, alpha=alpha, animation=True), anim_chunk(),
                                anmf_chunk(6, 4, 11, 9, frame), second))
    _same_as_jax(p)


def _webp_faults():
    rng = np.random.default_rng(18)
    full = pillow_webp(smooth_image(rng, 19, 27, 3), quality=70)
    vp8 = webp_chunks(full)[b"VP8 "]
    n = len(full)
    faults = {f"cut-{cut}": full[:cut] for cut in (n - 1, n - 9, n // 2, 40, 19)}
    faults.update({
        "riff-size-past-the-end": full[:4] + struct.pack("<I", n) + full[8:],
        "riff-size-short": full[:4] + struct.pack("<I", n - 20) + full[8:],
        "chunk-size-past-riff": full[:16] + struct.pack("<I", n) + full[20:],
        "vp8x-without-image": riff_webp(vp8x_chunk(27, 19, alpha=True), webp_chunk(b"EXIF", b"e" * 8)),
        "vp8x-size-differs": riff_webp(vp8x_chunk(29, 19), webp_chunk(b"VP8 ", vp8)),
        "frame-outside-canvas": riff_webp(vp8x_chunk(30, 20, animation=True), anim_chunk(),
                                          anmf_chunk(4, 2, 27, 19, webp_chunk(b"VP8 ", vp8))),
        "not-a-key-frame": riff_webp(webp_chunk(b"VP8 ", bytes([vp8[0] | 1]) + vp8[1:])),
        "vp8-partition-cut": riff_webp(webp_chunk(b"VP8 ", vp8[:len(vp8) // 2])),
        "vp8l-bad-signature": riff_webp(webp_chunk(b"VP8L", b"\x2e" + webp_chunks(
            pillow_webp(smooth_image(rng, 5, 7, 3), lossless=True))[b"VP8L"][1:])),
    })
    return faults


WEBP_FAULTS = _webp_faults()


@pytest.mark.parametrize("fault", sorted(WEBP_FAULTS))
def test_webp_faults_raise_as_jax(tmp_path, fault):
    """Files Pillow refuses (WebPDemux or WebPDecode fails): cut short, a
    RIFF or chunk size past the data, a VP8X without an image or of
    another size than its image, a frame outside the canvas, a VP8 frame
    that is no key frame or is cut, a bad VP8L signature: the port raises
    ValueError."""
    _both_raise(tmp_path, f"{fault}.webp", WEBP_FAULTS[fault])


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
