"""The port's plain raster openers against the JAX package's Pillow path.

Held here: realtimeraytracer_torch/utils/image_decode.py's readers of
Pillow's PCX, DCX, QOI, SGI, Sun raster, MSP, XBM, XPM, IM, SPIDER, FITS,
FLI/FLC, GBR, IM Tools, IPTC, McIdas, Photo CD, PIXAR and XV thumbnail
openers (their headers read in Python, their pixels by
native/raster_decode.cpp) through the port's ``load_texture_file``
against the JAX package's, bit for bit and for both values of
``grayscale``, and the mode ``decode_image`` reports against Pillow's:
files Pillow writes (PCX, QOI, raw SGI, MSP version 1, XBM, IM, SPIDER)
and files tests/_torch_image_helpers.py writes from seeded NumPy images
(bit-plane and odd-stride PCX, DCX pages, QOI ops, RLE and 16-bit SGI,
Sun raster at every depth, raw and RLE, with colour maps, MSP version 2,
XPM colour tables, IM Luts and bit depths, FITS cards and GZIP_1 tiles,
FLI chunks, IPTC records, Photo CD orientations, GBR, IM Tools, McIdas,
PIXAR, XV thumbnails).  Files Pillow refuses raise ValueError in the
port.  The logged divergences: 16-bit grey samples read as their high
byte (FITS 16, McIdas "I;16B", IM "I;16*"), a float FITS sky read as its
true samples.  IPTC layers Pillow mislabels read as Pillow reads them
(queue C, repaired).  Also the TIFF repairs of
ROADMAP's queue C found by tests/_torch_tiff_fuzz.py (old-style JPEG of a
grey photometric in tiles, a JPEG tile narrower than TileWidth, offsets
under the other tag), and the formats still to port (JPEG 2000, AVIF)
raising.

Tolerance: none; every case is bit-equal, but for the pixels Pillow
leaves undefined (ROADMAP's "not compared" rule), masked where stated.
No JAX render runs here.
"""

import functools
import io
import os
import struct
import sys

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_image_helpers import (encode_fits, encode_fli, encode_gbr, encode_im, encode_imt,  # noqa: E402
                                  encode_iptc, encode_jpeg, encode_mcidas, encode_msp, encode_pcd, encode_pcx,
                                  encode_pixar, encode_qoi, encode_sgi, encode_spider, encode_sun, encode_xpm,
                                  encode_xvthumb,
                                  fli_brun, fli_chunk, fli_colour, fli_lc, fli_ss2, make_dcx, make_tga,
                                  smooth_image)
from realtimeraytracer_torch.scene import obj_loader as tol  # noqa: E402
from realtimeraytracer_torch.utils import image_decode  # noqa: E402
from realtimeraytracer_tpu.scene import obj_loader as jol  # noqa: E402

SIZES = ((23, 37), (1, 1), (2, 3), (17, 2), (9, 33))   # (h, w)


def _jax_c1(path, grayscale):
    """The JAX package's load_texture_file with every texel divided by 255
    where JAX skipped it (C1, as in tests/test_torch_images.py)."""
    arr = jol.load_texture_file(str(path), grayscale)
    img = Image.open(path)
    img = img.convert("L") if grayscale else img if img.mode in ("RGB", "RGBA") else img.convert("RGBA")
    return arr if np.asarray(img).max() > 1.5 else arr / np.float32(255.0)


def _same_as_jax(path):
    for grayscale in (False, True):
        want = _jax_c1(path, grayscale)
        got = tol.load_texture_file(str(path), grayscale)
        assert got.dtype == want.dtype and got.shape == want.shape, (path, grayscale)
        assert np.array_equal(got, want), (path, grayscale, float(np.abs(got - want).max()))
    with open(path, "rb") as f:
        assert image_decode.decode_image(f.read())[1] == Image.open(path).mode


def _both_raise(path):
    for grayscale in (False, True):
        with pytest.raises(Exception):   # noqa: B017 - whatever Pillow raises
            jol.load_texture_file(str(path), grayscale)
    with pytest.raises(ValueError):
        tol.load_texture_file(str(path), False)


def _same_or_both_raise(path):
    """Bit-equal where Pillow reads the file; ValueError where it raises
    (Pillow's PCX reader refuses its own 1x1 RGB file: a stride of 2 a
    plane, then too few bytes)."""
    try:
        Image.open(path).load()
    except Exception:                      # noqa: BLE001 - Pillow refuses: so must the port
        _both_raise(path)
        return False
    _same_as_jax(path)
    return True


def _pillow(fmt, image, **kw) -> bytes:
    b = io.BytesIO()
    image.save(b, fmt, **kw)
    return b.getvalue()


def _planar(rows, planes):
    """(H, W, planes) bytes as PCX lines: a plane after the other."""
    return np.concatenate([rows[..., k] for k in range(planes)], axis=1)


@functools.lru_cache(maxsize=None)     # one build for all its cases
def _cases():
    rng = np.random.default_rng(2201)
    cases = {}

    def add(name, *files):
        cases[name] = list(files)

    # Pillow's writers, at several sizes.
    for fmt, modes in (("PCX", ("1", "L", "P", "RGB")), ("QOI", ("RGB", "RGBA")), ("SGI", ("L", "RGB", "RGBA")),
                       ("MSP", ("1",)), ("XBM", ("1",)),
                       ("IM", ("1", "L", "P", "RGB", "RGBA", "LA", "I", "F", "CMYK", "YCbCr")), ("SPIDER", ("F",))):
        for mode in modes:
            files = []
            for h, w in SIZES:
                a = smooth_image(rng, h, w, 4)
                if mode == "I":
                    im = Image.fromarray(rng.integers(-300, 600, (h, w)).astype(np.int32), "I")
                elif mode == "F":
                    f = (rng.random((h, w)) * 300 - 20).astype(np.float32)
                    f.flat[:4] = (np.nan, -np.inf, 254.99, 0.5)[:f.size]
                    im = Image.fromarray(f, "F")
                elif mode == "P":
                    im = Image.fromarray(a[..., :3]).convert("P", palette=Image.Palette.ADAPTIVE, colors=40)
                else:
                    im = Image.fromarray(a).convert(mode)
                files.append(_pillow(fmt, im))
            add(f"pillow-{fmt.lower()}-{mode}", *files)

    # PCX by hand: bit planes, odd strides, palettes.
    idx = rng.integers(0, 16, (11, 13))
    bits4 = np.stack([np.packbits((idx >> k) & 1, axis=1) for k in range(4)], -1)
    add("pcx-p4l", encode_pcx(_planar(bits4, 4), 13, 11, 1, 4, palette16=rng.integers(0, 256, 48, np.uint8).tobytes()))
    add("pcx-p2l", encode_pcx(_planar(bits4[..., :2], 2), 13, 11, 1, 2,
                              palette16=rng.integers(0, 256, 48, np.uint8).tobytes()))
    wide = rng.integers(0, 16, (5, 21))
    planes21 = np.stack([np.packbits((wide >> k) & 1, axis=1) for k in range(4)], -1)
    add("pcx-p4l-odd-stride", encode_pcx(_planar(np.pad(planes21, ((0, 0), (0, 1), (0, 0))), 4), 21, 5, 1, 4,
                                         stride=4, palette16=bytes(range(48))))
    rgb5 = smooth_image(rng, 7, 5, 3)
    add("pcx-rgb-odd-stride", encode_pcx(_planar(np.pad(rgb5, ((0, 0), (0, 1), (0, 0))), 3), 5, 7, 8, 3, stride=6))
    grey = smooth_image(rng, 9, 14, 1)[..., 0]
    add("pcx-l-no-palette", encode_pcx(grey, 14, 9, 8, 1).ljust(900, b"\0"))
    ramp3 = bytes(np.repeat(np.arange(256), 3).astype(np.uint8))
    add("pcx-l-grey-palette", encode_pcx(grey, 14, 9, 8, 1, palette=ramp3))
    add("pcx-v2-1bit", encode_pcx(np.packbits(rng.integers(0, 2, (6, 19)), axis=1), 19, 6, 1, 1, version=2))
    add("pcx-raw-bytes-high", encode_pcx(np.full((3, 8), 0xC5, np.uint8), 8, 3, 8, 1,
                                        palette=rng.integers(0, 256, 768, np.uint8).tobytes()))
    # DCX: the first page.
    page1 = _pillow("PCX", Image.fromarray(smooth_image(rng, 12, 10, 3)))
    add("dcx-two-pages", make_dcx([page1, _pillow("PCX", Image.fromarray(smooth_image(rng, 4, 4, 3)))]))
    # QOI by hand: diff, luma, runs; a channels byte of 3 over RGBA ops; any other byte RGBA.
    q = smooth_image(rng, 19, 23, 4)
    q[5:9] = q[5, 0]
    q[..., 3] = np.where(rng.random((19, 23)) < 0.3, 77, 255)
    add("qoi-hand-rgba", encode_qoi(q))
    add("qoi-hand-rgb", encode_qoi(q[..., :3]))
    c3 = bytearray(encode_qoi(q))
    c3[12] = 3
    add("qoi-channels-3-alpha-ops", bytes(c3))
    c3[12] = 7
    add("qoi-channels-7", bytes(c3))
    # SGI by hand: RLE (repeat and copy runs), 16-bit raw and RLE, one-row dimension 1.
    for z in (1, 3, 4):
        pl = smooth_image(rng, 13, 17, z).transpose(2, 0, 1)
        pl[:, 4:6] = 9
        add(f"sgi-rle-{z}", encode_sgi(pl, rle=True), encode_sgi(pl, rle=True, copy=True))
        p16 = rng.integers(0, 65536, (z, 6, 9))
        add(f"sgi-16-{z}", encode_sgi(p16, 2), encode_sgi(p16, 2, rle=True), encode_sgi(p16, 2, rle=True, copy=True))
    add("sgi-dimension-1", encode_sgi(smooth_image(rng, 1, 30, 1).transpose(2, 0, 1)))
    # Sun raster: each depth, RGB order, colour maps, RLE with escapes and runs across rows.
    sun = smooth_image(rng, 9, 11, 3)
    b1 = np.packbits(rng.integers(0, 2, (9, 11)), axis=1)
    n4 = rng.integers(0, 16, (9, 11))
    p4 = np.packbits(np.unpackbits(n4.astype(np.uint8)[..., None], axis=2)[..., 4:].reshape(9, -1), axis=1)
    g8 = sun[..., 0].copy()
    g8[2, :] = 0x80
    g8[3:5] = 7
    cmap = rng.integers(0, 256, 3 * 40, np.uint8).tobytes()
    add("sun-1", encode_sun(b1, 11, 9, 1), encode_sun(b1, 11, 9, 1, rle=True))
    add("sun-4", encode_sun(p4, 11, 9, 4), encode_sun(p4, 11, 9, 4, rle=True))
    add("sun-4-colormap", encode_sun(p4, 11, 9, 4, colormap=cmap[:48]))
    add("sun-8", encode_sun(g8, 11, 9, 8), encode_sun(g8, 11, 9, 8, rle=True))
    add("sun-8-colormap", encode_sun(g8, 11, 9, 8, colormap=cmap), encode_sun(g8, 11, 9, 8, rle=True, colormap=cmap))
    bgr = sun[..., ::-1].reshape(9, -1)
    add("sun-24", encode_sun(bgr, 11, 9, 24), encode_sun(bgr, 11, 9, 24, rle=True),
        encode_sun(sun.reshape(9, -1), 11, 9, 24, file_type=3))
    xbgr = np.concatenate([np.zeros((9, 11, 1), np.uint8), sun[..., ::-1]], 2)
    add("sun-32", encode_sun(xbgr[..., [1, 2, 3, 0]].reshape(9, -1), 11, 9, 32),
        encode_sun(np.concatenate([sun, np.zeros((9, 11, 1), np.uint8)], 2).reshape(9, -1), 11, 9, 32, file_type=3))
    # MSP version 2 (white rows of no bytes), XBM with a hot spot.
    m = (smooth_image(rng, 10, 21, 1)[..., 0] > 120).astype(np.uint8)
    m[3] = 1
    add("msp-v2", encode_msp(m), encode_msp(m[:, :16]))
    add("xbm-hotspot", b"#define x_width 10\n#define x_height 2\n#define x_x_hot 1\n#define x_y_hot 0\n"
        b"static char x_bits[] = {\n 0x13, 0xfe, 0x02,\n 0xA0 };\n")
    # XPM: one and two characters a key, lines that are not rows, an unused
    # None colour (its key's bytes become alphas in convert("RGBA")), more
    # than 256 colours ("RGB").
    cols = rng.integers(0, 256, (40, 3))
    ix = rng.integers(0, 40, (12, 9))
    add("xpm-1", encode_xpm(ix, cols))
    add("xpm-2", encode_xpm(ix, cols, bpp=2), encode_xpm(ix, cols, bpp=2, per_line=5))
    add("xpm-none-unused", encode_xpm(ix, cols, none_key=b" "), encode_xpm(ix, cols, bpp=2, none_key=b"  "))
    add("xpm-rgb", encode_xpm(rng.integers(0, 300, (10, 31)), rng.integers(0, 256, (300, 3)), bpp=2))
    # IM by hand: Luts, planar RGB3, 2- and 4-bit palettes, bit depths, signed types.
    g = smooth_image(rng, 8, 13, 1)[..., 0]
    up = g[::-1].tobytes()
    lut = rng.integers(0, 256, 768, np.uint8).tobytes()
    ramp = bytes(255 - (i % 256) for i in range(768))
    add("im-lut-colour", encode_im("Greyscale image", 13, 8, up, lut))
    add("im-lut-grey", encode_im("Greyscale image", 13, 8, up, ramp))
    la = smooth_image(rng, 8, 13, 2)[::-1]
    add("im-la-lut-colour", encode_im("LA image", 13, 8, np.concatenate([la[..., 0], la[..., 1]], 1).tobytes(), lut))
    rgb = smooth_image(rng, 8, 13, 3)[::-1]
    add("im-rgb3", encode_im("RGB3 image", 13, 8, b"".join(rgb[..., k].tobytes() for k in (1, 0, 2))))
    add("im-x24", encode_im("X 24 image", 13, 8, rgb.tobytes()))
    add("im-b2", encode_im("B2 image", 13, 8, np.packbits(rng.integers(0, 2, (8, 26)), axis=1).tobytes()))
    add("im-b4-lut", encode_im("B4 image", 13, 8, rng.integers(0, 256, 8 * 13, np.uint8).tobytes(), lut))
    for t, dt in (("L 8S image", "i1"), ("L 16S image", "<i2"), ("L*16 image", "<u2"), ("L 32 image", "<u4"),
                  ("L 32S image", "<i4"), ("L 32F image", "<f4"), ("L*32S image", "<i4")):
        v = rng.integers(-400, 700, (8, 13)) if dt[-2] != "f" else rng.random((8, 13)) * 600 - 100
        add(f"im-{t.split()[1].lower()}", encode_im(t, 13, 8, v.astype(dt).tobytes()))
    for bits in (2, 5, 12, 31):
        add(f"im-bits-{bits}", encode_im(f"L*{bits} image", 13, 8,
                                         rng.integers(0, 256, 8 * 13 * 4, np.uint8).tobytes()))
    # SPIDER: little-endian, and a stack's first image.
    sp = (rng.random((6, 7)) * 300).astype(np.float32)
    add("spider-le", encode_spider(sp, big=False))
    stack = bytearray(encode_spider(sp))
    hdr = len(stack) - sp.size * 4
    stack[23 * 4:24 * 4] = struct.pack(">f", 2.0)        # istack > 0, imgnumber 0
    add("spider-stack", bytes(stack[:hdr]) + bytes(stack))
    # FITS: every BITPIX Pillow reads the right way round, 1-D, GZIP_1 tiles.
    add("fits-8", encode_fits(smooth_image(rng, 7, 9, 1)[..., 0], 8))
    add("fits-32", encode_fits(rng.integers(-300, 70000, (7, 9)), 32))
    add("fits-float", encode_fits(rng.random((7, 9)) * 300, -32), encode_fits(rng.random((7, 9)) * 300, -64))
    add("fits-naxis-1", encode_fits(smooth_image(rng, 1, 9, 1)[..., 0], 8)[:2880].replace(
        b"NAXIS   =                    2", b"NAXIS   =                    1") + encode_fits(
        smooth_image(rng, 1, 9, 1)[..., 0], 8)[2880:])
    add("fits-gzip", encode_fits(smooth_image(rng, 7, 9, 1)[..., 0], 8, gzip_tiles=True),
        encode_fits(rng.integers(-300, 70000, (7, 9)), 32, gzip_tiles=True))
    # GBR, IM Tools, McIdas, PIXAR, XV thumbnail.
    add("gbr", encode_gbr(smooth_image(rng, 5, 6, 1)[..., 0], 1), encode_gbr(smooth_image(rng, 5, 6, 1)[..., 0]),
        encode_gbr(smooth_image(rng, 5, 6, 4)))
    add("imt", encode_imt(smooth_image(rng, 6, 9, 1)[..., 0]))
    add("mcidas", encode_mcidas(smooth_image(rng, 6, 9, 1)[..., 0], 1, prefix=3),
        encode_mcidas(rng.integers(-300, 70000, (6, 9)), 4))
    add("pixar", encode_pixar(smooth_image(rng, 6, 9, 3)))
    add("xvthumb", encode_xvthumb(rng.integers(0, 256, (6, 9))))
    # FLI/FLC's first frame: colour maps (256- and 64-level), BRUN, COPY,
    # LC and SS2 over BLACK, a frame with no colour chunk (grey ramp).
    fp = smooth_image(rng, 7, 10, 1)[..., 0]
    pal = rng.integers(0, 256, (256, 3))
    add("fli-brun", encode_fli(10, 7, [fli_colour([(0, pal)]), fli_brun(fp, literal=2)]),
        encode_fli(10, 7, [fli_colour([(5, pal[:20] // 4), (3, pal[:9] // 4)], six_bit=True), fli_brun(fp)],
                   magic=0xAF11))
    add("fli-copy", encode_fli(10, 7, [fli_colour([(0, pal)]), fli_chunk(16, fp.tobytes())]),
        encode_fli(10, 7, [fli_chunk(16, fp.tobytes())]))
    add("fli-delta", encode_fli(10, 7, [fli_colour([(0, pal)]), fli_chunk(13, b""), fli_lc(fp[2:5], 2)]),
        encode_fli(10, 7, [fli_colour([(0, pal)]), fli_ss2(fp, skip_first=2)]),
        encode_fli(10, 7, [fli_colour([(0, pal)]), fli_chunk(18, bytes(20)), fli_ss2(fp)]))
    # IPTC: a raw grey image, one band of RGB or CMYK, a JPEG.
    g = smooth_image(rng, 6, 11, 1)[..., 0]
    add("iptc-raw", encode_iptc(g.tobytes(), 11, 6), encode_iptc(g.tobytes(), 11, 6, chunk=17))
    add("iptc-band", encode_iptc(g.tobytes(), 11, 6, 3, 1, band=1), encode_iptc(g.tobytes(), 11, 6, 4, 1, band=2),
        encode_iptc(g.tobytes(), 11, 6, 3, 1))
    add("iptc-jpeg", encode_iptc(encode_jpeg([g], [(1, 1)], q=3), 11, 6, compression=5))
    # Photo CD's base image, upright and turned.
    luma = np.repeat(smooth_image(rng, 64, 96, 1)[..., 0], 8, 0).repeat(8, 1)
    c1, c2 = (np.repeat(smooth_image(rng, 32, 48, 1)[..., 0], 8, 0).repeat(8, 1) for _ in range(2))
    add("pcd", *(encode_pcd(luma, c1, c2, o) for o in (0, 1, 3)))
    return cases


RASTER_CASES = sorted(_cases())


@pytest.mark.parametrize("case", RASTER_CASES)
def test_raster_formats_match_jax(tmp_path, case):
    """Each file of the case bit-equal to JAX for both grayscale values,
    the decoder's mode Pillow's, sniff's format Pillow's."""
    read = 0
    for i, data in enumerate(_cases()[case]):
        p = tmp_path / f"{case}-{i}"
        p.write_bytes(data)
        read += _same_or_both_raise(p)
        assert image_decode.sniff(data) == {"XVThumb": "XVTHUMB"}.get(Image.open(p).format, Image.open(p).format)
    assert read >= len(_cases()[case]) - (case == "pillow-pcx-RGB")


# ------------------------------------------------ TIFF repairs (queue C) ----

def _rename_tags(data: bytes, renames: dict) -> bytes:
    """A little-endian classic TIFF with its first directory's tags renamed
    ({old: new}), types, counts and values kept."""
    b = bytearray(data)
    ifd = struct.unpack("<I", b[4:8])[0]
    for i in range(struct.unpack("<H", b[ifd:ifd + 2])[0]):
        at = ifd + 2 + 12 * i
        tag = struct.unpack("<H", b[at:at + 2])[0]
        if tag in renames:
            b[at:at + 2] = struct.pack("<H", renames[tag])
    return bytes(b)


def _set_short(data: bytes, tag: int, value: int) -> bytes:
    """A little-endian classic TIFF with a SHORT or LONG tag's one value set."""
    b = bytearray(data)
    ifd = struct.unpack("<I", b[4:8])[0]
    for i in range(struct.unpack("<H", b[ifd:ifd + 2])[0]):
        at = ifd + 2 + 12 * i
        if struct.unpack("<H", b[at:at + 2])[0] == tag:
            typ = struct.unpack("<H", b[at + 2:at + 4])[0]
            b[at + 8:at + 12] = struct.pack("<HH", value, 0) if typ == 3 else struct.pack("<I", value)
    return bytes(b)


def _equal_where(path, defined_rows):
    """The port's load_texture_file equals JAX's where `defined_rows(g)`
    (a mask in the flipped output) holds, for both grayscale values."""
    for g in (False, True):
        got, want = tol.load_texture_file(str(path), g), _jax_c1(path, g)
        assert got.shape == want.shape
        keep = defined_rows(got.shape)
        assert np.array_equal(got[keep], want[keep]), (path, g)


@pytest.mark.parametrize("photometric", [0, 1])
def test_old_style_jpeg_tiles_of_a_grey_photometric_match_jax(tmp_path, photometric):
    """An old-style JPEG TIFF in tiles whose three samples carry a grey
    photometric (0 or 1), found by tests/_torch_tiff_fuzz.py (seed 8):
    libtiff hands them on as raw 1x1 YCbCr blocks (3 bytes a pixel, its
    frame of 1x1 sampling over data coded 2x2), Pillow unpacks each tile
    row by its YCbCr rawmode, RGBX (4 bytes a pixel), so each row reads on
    into the next.  The last row of a tile reads past the tile's buffer
    from pixel (3 * 48 - 2) / 4 on: undefined in Pillow, not compared."""
    rng = np.random.default_rng(2202)
    planes = [np.pad(smooth_image(rng, 32, 40, 1)[..., 0], ((0, 0), (0, 8)), mode="edge") for _ in range(3)]
    from _torch_image_helpers import make_ojpeg_tiff
    data = _set_short(make_ojpeg_tiff(planes, [(2, 2), (1, 1), (1, 1)], layout="tables", tile=(48, 16)), 262,
                      photometric)
    p = tmp_path / "ojpeg_grey_photometric.tif"
    p.write_bytes(data)

    def defined(shape):
        keep = np.ones(shape, bool)
        rows = np.arange(shape[0])[::-1] % 16 == 15          # the tile's last row, before the flip
        keep[rows, 36:] = False
        return keep
    _equal_where(p, defined)
    assert Image.open(p).mode == image_decode.decode_image(data)[1] == "RGB"


def test_jpeg_tiff_tile_narrower_than_tile_width_matches_jax(tmp_path):
    """A JPEG-in-TIFF whose TileWidth (531) is wider than its tiles' JPEG
    streams (32), found by the fuzz (seeds 7 and 8): libtiff warns and
    decodes each stream into the start of the tile's rows; the rest of each
    row is what Pillow's buffer held before (undefined: not compared)."""
    from _torch_image_helpers import FIXTURES
    data = _set_short((FIXTURES / "jpeg_ycbcr.tif").read_bytes(), 322, 531)
    p = tmp_path / "narrow_tiles.tif"
    p.write_bytes(data)

    def defined(shape):
        keep = np.zeros(shape, bool)
        keep[:, :32] = True
        return keep
    _equal_where(p, defined)


@pytest.mark.parametrize("layout", ["tiles-listed-as-strips", "strips-listed-as-tiles"])
def test_ccitt_tiff_offsets_under_the_other_tag_match_jax(tmp_path, layout):
    """A CCITT TIFF whose offsets (and byte counts) stand under the other
    tag, StripOffsets in a tiled file (the fuzz's seed 7) or TileOffsets in
    a striped one: libtiff keeps both in one field, so it reads the file,
    and so does the port."""
    from _torch_image_helpers import make_tiff
    rng = np.random.default_rng(2203)
    bits = (smooth_image(rng, 21, 37, 1)[..., 0] > 120).astype(int)
    if layout == "tiles-listed-as-strips":
        data = _rename_tags(make_tiff(bits, 1, 1, compression=4, tile=(16, 16)), {324: 273, 325: 279})
    else:
        data = _rename_tags(make_tiff(bits, 1, 1, compression=4, rows_per_strip=8), {273: 324, 279: 325})
    p = tmp_path / f"{layout}.tif"
    p.write_bytes(data)
    _same_as_jax(p)


# ------------------------------------------- divergences and refusals ----

def test_16bit_raster_samples_diverge_from_jax_as_stb(tmp_path):
    """16-bit grey samples Pillow opens as "I;16", "I;16B" or "I;16L" (FITS
    BITPIX 16, read in its own rawmode and so byte-swapped; McIdas; IM):
    JAX's convert clips them at 255, the port keeps each sample's high
    byte, stb_image's rule, as for 16-bit PNG, PGM and TIFF."""
    rng = np.random.default_rng(2204)
    v = rng.integers(0, 65536, (5, 7))
    v.flat[:4] = (0, 255, 256, 65535)
    files = {"fits": encode_fits(v.astype(np.int16), 16),
             "fits-gzip": encode_fits(v.astype(np.int16), 16, gzip_tiles=True), "mcidas": encode_mcidas(v, 2)}
    for t, dt in (("L 16 image", "<u2"), ("L 16B image", ">u2"), ("L 16L image", "<u2")):
        files[t] = encode_im(t, 7, 5, v[::-1].astype(dt).tobytes())
    for name, data in files.items():
        p = tmp_path / name
        p.write_bytes(data)
        pillow = np.asarray(Image.open(p)).astype(np.int64)
        assert Image.open(p).mode in ("I;16", "I;16B", "I;16L")
        want_jax = np.minimum(pillow, 255).astype(np.float32)
        want_jax = want_jax / 255 if want_jax.max() > 1.5 else want_jax
        for g in (False, True):
            assert np.array_equal(jol.load_texture_file(str(p), g)[::-1, :, 0], want_jax)
            assert np.array_equal(tol.load_texture_file(str(p), g)[::-1, :, 0], (pillow >> 8).astype(np.float32) / 255)
        assert image_decode.decode_image(data)[1] == Image.open(p).mode


def _refusals():
    rng = np.random.default_rng(2205)
    pcx = _pillow("PCX", Image.fromarray(smooth_image(rng, 9, 8, 3)))
    sgi = encode_sgi(smooth_image(rng, 6, 7, 3).transpose(2, 0, 1), rle=True)
    xpm = encode_xpm(rng.integers(0, 4, (3, 5)), rng.integers(0, 256, (4, 3)), none_key=b"a")  # "a" is also a colour
    cases = {
        "pcx-cut": pcx[:200], "pcx-8bit-version-2": encode_pcx(np.zeros((2, 8), np.uint8), 8, 2, 8, 1, version=2),
        "pcx-run-past-line": bytes(encode_pcx(np.zeros((2, 8), np.uint8), 8, 2, 8, 1, palette=bytes(768),
                                              rle=False)[:128]) + b"\xcf\x01" * 4 + bytes(769),
        "dcx-no-page-end": struct.pack("<II", 0x3ADE68B1, 12),
        "qoi-cut": encode_qoi(smooth_image(rng, 5, 6, 4))[:30],
        "sgi-mode": _pillow("SGI", Image.fromarray(smooth_image(rng, 3, 4, 3)))[:10] + b"\0\5" +
        _pillow("SGI", Image.fromarray(smooth_image(rng, 3, 4, 3)))[12:],
        "sgi-rle-overrun": sgi[:512 + 8 * 18] + b"\x7f\x01" + sgi[512 + 8 * 18 + 2:],
        "sgi-rle-tables-cut": sgi[:600],
        "sgi-compression-2": sgi[:2] + b"\x02" + sgi[3:],
        "sun-cut": encode_sun(smooth_image(rng, 4, 6, 1)[..., 0], 6, 4, 8)[:40],
        "sun-1-colormap": encode_sun(np.zeros((3, 1), np.uint8), 5, 3, 1, colormap=bytes(6)),
        "msp-v2-cut": encode_msp(np.zeros((4, 9), np.uint8))[:40],
        "xbm-cut": b"#define x_width 16\n#define x_height 2\nstatic char x_bits[] = {\n 0x13, 0xfe, 0x02,",
        "xpm-none-pixels": encode_xpm(np.arange(15).reshape(3, 5) % 3, rng.integers(0, 256, (3, 3)), none_key=b"Z")
        .replace(b'"abcab', b'"Zbcab'),
        "xpm-named-colour": xpm.replace(b"c #", b"c red #", 1).replace(b"c red #", b"c red", 1),
        "im-pa": encode_im("PA image", 4, 2, bytes(16)), "im-rlb": encode_im("RLB image", 4, 2, bytes(24)),
        "im-cut": encode_im("RGB image", 4, 2, bytes(20)),
        "fits-no-image": encode_fits(np.zeros((2, 2)), 8)[:2880].replace(b"NAXIS   =                    2",
                                                                          b"NAXIS   =                    0"),
        "fits-gzip-float": encode_fits(np.zeros((2, 3)), -32, gzip_tiles=True),
        "fits-cut": encode_fits(np.zeros((40, 40)), 8)[:2900],
        "spider-in-a-stack": encode_spider(np.zeros((4, 4)))[:4 * 26] + struct.pack(">f", 3.0) +
        encode_spider(np.zeros((4, 4)))[4 * 27:],
        "pixar-other-depth": encode_pixar(smooth_image(rng, 3, 4, 3), depth=1),
        "gbr-cut": encode_gbr(smooth_image(rng, 5, 6, 4))[:60],
        "mcidas-cut": encode_mcidas(np.zeros((6, 9)), 1)[:300],
        "xvthumb-size": b"P7 332\n#END_OF_COMMENTS\n12\n" + bytes(40),
        # A TGA whose ID is 10 bytes long and that has no colour map starts
        # 0x0A 0x00: Pillow's PCX opener (11th) takes it before TGA (38th),
        # finds no PCX mode and raises OSError, which ends Image.open.
        "tga-read-as-pcx": make_tga(smooth_image(rng, 4, 5, 3), 2, 24, idfield=b"0123456789"),
    }
    return cases


REFUSALS = sorted(_refusals())


@pytest.mark.parametrize("case", REFUSALS)
def test_raster_refusals_match_jax(tmp_path, case):
    """Files Pillow refuses (cut, overrun, modes it has no unpacker or no
    palette for, keys not in an XPM's table, a GZIP_1 float FITS, a SPIDER
    image opened inside its stack, a PIXAR of another depth, a TGA Pillow
    takes for a PCX): JAX raises, and the port raises ValueError."""
    p = tmp_path / case
    p.write_bytes(_refusals()[case])
    _both_raise(p)


# --------------------------------------------------------------- skies ----

def test_raster_skies(tmp_path):
    """Non-.hdr skies of the new formats, against the JAX package's imageio
    path: 8-bit files read as texels / 255 (JAX keeps the bytes: the fault
    of the reference logged for every 8-bit sky); 1-bit MSP and XBM come
    from imageio as bool, so JAX's sky of 0/1 equals the port's; imageio
    raises on a SPIDER file, and so does the port; an IM "F" sky holds its
    float samples in both; a float FITS sky is read as its true
    (big-endian) samples, where JAX's imageio takes Pillow's byte-swapped
    ones (logged)."""
    rng = np.random.default_rng(2206)
    rgb = smooth_image(rng, 6, 9, 3)
    for name, data in (("sky.pcx", _pillow("PCX", Image.fromarray(rgb))), ("sky.qoi", encode_qoi(rgb)),
                       ("sky.sgi", encode_sgi(rgb.transpose(2, 0, 1), rle=True))):
        p = tmp_path / name
        p.write_bytes(data)
        assert np.array_equal(tol.load_hdr(str(p)), jol.load_hdr(str(p), tone_encode=False) / np.float32(255))
    bits = (smooth_image(rng, 6, 16, 1)[..., 0] > 120).astype(np.uint8)
    xbm = _pillow("XBM", Image.fromarray(bits * 255).convert("1"))
    for name, data in (("sky.msp", encode_msp(bits)), ("sky.xbm", xbm)):
        p = tmp_path / name
        p.write_bytes(data)
        for tone in (True, False):
            assert np.array_equal(tol.load_hdr(str(p), tone), jol.load_hdr(str(p), tone))
    p = tmp_path / "sky.spi"
    p.write_bytes(encode_spider(rng.random((4, 5))))
    with pytest.raises(Exception):  # noqa: B017 - imageio's EOFError
        jol.load_hdr(str(p))
    with pytest.raises(ValueError, match="SPIDER"):
        tol.load_hdr(str(p))
    f = (rng.random((5, 6)) * 3).astype(np.float32)
    p = tmp_path / "sky.im"
    p.write_bytes(encode_im("L 32F image", 6, 5, f[::-1].astype("<f4").tobytes()))
    for tone in (True, False):
        assert np.array_equal(tol.load_hdr(str(p), tone), jol.load_hdr(str(p), tone))
    p = tmp_path / "sky.fits"
    p.write_bytes(encode_fits(f, -32))
    port = tol.load_hdr(str(p), tone_encode=False)
    assert np.array_equal(port, np.repeat(f[::-1, :, None], 3, 2))
    swapped = f.astype(">f4").view("<f4")[::-1]
    assert np.array_equal(jol.load_hdr(str(p), tone_encode=False), np.repeat(swapped[:, :, None], 3, 2))


@pytest.mark.parametrize("fmt", ["AVIF", "JPEG2000"])
def test_formats_still_to_port_raise_naming_them(tmp_path, fmt):
    """A12's group 4 (JPEG 2000, AVIF): Pillow reads them (the files here
    are Pillow's), the port raises ValueError naming the format."""
    im = Image.fromarray(smooth_image(np.random.default_rng(2207), 8, 8, 3))
    data = _pillow(fmt, im)
    assert Image.open(io.BytesIO(data)).format == fmt
    with pytest.raises(ValueError, match=f"{fmt} image: not a format this port reads yet"):
        image_decode.decode_image(data)


def test_iptc_data_of_another_size_matches_jax(tmp_path):
    """IPTC files whose image data has another size than their (3, 20)
    and (3, 30) records (found by a fuzz of these cases): Pillow keeps the
    data's image, of its own size, and so does the port."""
    g = smooth_image(np.random.default_rng(2208), 6, 20, 1)[..., 0]
    for name, data in (("jpeg", encode_iptc(encode_jpeg([g], [(1, 1)], q=3), 11, 6, compression=5)),
                       ("cmyk", encode_iptc(encode_jpeg([g], [(1, 1)], q=3), 11, 6, 4, 1, compression=5, band=2))):
        p = tmp_path / f"iptc_other_size_{name}.iim"
        p.write_bytes(data)
        assert tol.load_texture_file(str(p), False).shape == (6, 20, 4)
        _same_as_jax(p)


def test_iptc_layers_pillow_mislabels_match_jax(tmp_path):
    """IPTC files that Pillow labels by their records but holds another
    image (ROADMAP queue C, repaired): records of one grey layer over
    colour JPEG data, RGB and CMYK (Pillow keeps the colour image under the
    mode "L": convert("L") copies it, so JAX's grey load hands on its three
    channels, or a CMYK's four stored bytes, and convert("RGBA") converts
    it by its own mode) and over a grey JPEG of another size; a layer of an
    RGB image, each band, whose data has another size than the records
    (the unconverted image's RGB bytes, at the data's size, shaped by the
    records' size: narrower, or narrower and taller; convert("L") at the
    data's own size); a layer of a CMYK image of another size."""
    rng = np.random.default_rng(2209)
    rgb, g = smooth_image(rng, 6, 8, 3), smooth_image(rng, 6, 20, 1)[..., 0]
    colour = encode_jpeg([rgb[..., k] for k in range(3)], [(1, 1)] * 3, q=3)
    cmyk = encode_jpeg([rgb[..., k] for k in (0, 1, 2, 0)], [(1, 1)] * 4, q=3, adobe=0)
    grey = encode_jpeg([g], [(1, 1)], q=3)
    files = {"colour_in_grey": encode_iptc(colour, 8, 6, compression=5),
             "cmyk_in_grey": encode_iptc(cmyk, 8, 6, compression=5),
             "grey_other_size": encode_iptc(grey, 11, 6, compression=5),
             "cmyk_layer_other_size": encode_iptc(grey, 11, 6, 4, 1, compression=5, band=3)}
    for band in range(3):
        files[f"rgb_band{band}_narrower"] = encode_iptc(grey, 11, 6, 3, 1, compression=5, band=band)
    files["rgb_taller"] = encode_iptc(grey, 11, 8, 3, 1, compression=5, band=1)
    for name, data in files.items():
        p = tmp_path / f"iptc_{name}.iim"
        p.write_bytes(data)
        _same_as_jax(p)
    p = tmp_path / "iptc_colour_in_grey.iim"
    assert tol.load_texture_file(str(p), True).shape == (6, 8, 3)
    assert tol.load_texture_file(str(tmp_path / "iptc_cmyk_in_grey.iim"), True).shape == (6, 8, 4)
    p = tmp_path / "iptc_rgb_band2_narrower.iim"
    assert tol.load_texture_file(str(p), False).shape == (6, 11, 3)
    assert tol.load_texture_file(str(p), True).shape == (6, 20, 1)
