"""Differential fuzz of the port's TIFF decoder against the JAX package (not a test).

``python tests/_torch_tiff_fuzz.py [--files N] [--seed S] [--lab-table]``
mutates seed TIFFs (CCITT RLE, RLEW, Group 3 1-D and 2-D, Group 4 in
strips and tiles, both photometrics and FillOrder 2; ThunderScan; LZMA and
ZSTD at several levels, planes, tiles and predictors; Lab; old-style LZW
in strips, tiles, planes and YCbCr blocks, with predictor 2; old-style
JPEG in both layouts, grey and YCbCr 1x1, 2x1, 2x2, in one strip,
several or a column of tiles; and the committed LZW, Deflate, PackBits,
JPEG, BigTIFF and old-style fixtures), drawn with
``random.Random(S)`` (``--keep DIR`` writes the mismatching files to DIR): a directory entry's count, value or offset, or type
changed (40% of the files), 1-4 bytes of a strip or tile set to random
values (40%), or the file cut (20%); each mismatch is printed with its
seed and mutation.  Each file goes through the JAX
package's ``load_texture_file`` (Pillow) and the port's, with both values
of ``grayscale``; it prints the count of files equal on both sides,
raising on both, refused by one side only, and decoded to other pixels,
and the first cases of each mismatch.  16-bit grey files (the port's
logged stb rule) are counted apart.  ``--lab-table`` also holds the port's
Lab conversion to Pillow's on all 2^24 Lab values (a 4096 x 4096 Lab
TIFF).  Needs Pillow, zstandard and the JAX package.
"""

from __future__ import annotations

import argparse
import os
import random
import struct
import sys
import tempfile
import warnings
from pathlib import Path

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from _torch_image_helpers import FIXTURES, make_ojpeg_tiff, make_tiff, smooth_image  # noqa: E402

from realtimeraytracer_torch.scene import obj_loader as tol  # noqa: E402


def seeds() -> list[tuple[str, bytes]]:
    rng = np.random.default_rng(20)
    out = [(name, (FIXTURES / name).read_bytes()) for name in
           ("jpeg_ycbcr.tif", "lzw_pred_rgb.tif", "deflate_tiles_grey.tif", "packbits_rgba.tif",
            "bigtiff_planar.tif", "ycbcr22_lzw.tif")]
    bits = (smooth_image(rng, 21, 37, 1)[..., 0] > 120).astype(int)
    for comp, t4 in ((2, 0), (32771, 0), (3, 0), (3, 1), (3, 5), (4, 0)):
        for photo in (0, 1):
            for kw in ({}, {"rows_per_strip": 8}, {"tile": (16, 16)}, {"fill_order": 2}):
                out.append((f"ccitt{comp}-{t4}-{photo}-{sorted(kw)}.tif",
                            make_tiff(bits, 1, photo, compression=comp, t4_options=t4, **kw)))
    grey4 = rng.integers(0, 16, (19, 30))
    grey4[:, 10:20] = grey4[:, 10:11]
    for photo in (0, 1):
        out.append((f"thunder-{photo}.tif", make_tiff(grey4, 4, photo, compression=32809, codec_rng=rng,
                                                      rows_per_strip=7)))
    rgb = smooth_image(rng, 23, 29, 3)
    for comp in (34925, 50000):
        for kw in ({}, {"rows_per_strip": 8}, {"tile": (16, 16)}, {"planar": 2}, {"predictor": 2},
                   {"zstd_level": 19}, {"zstd_level": -3}):
            out.append((f"c{comp}-{sorted(kw)}.tif", make_tiff(rgb, 8, 2, compression=comp, **kw)))
        out.append((f"c{comp}-grey.tif", make_tiff(rgb[..., 0], 8, 1, compression=comp, order=">")))
    for comp in (1, 5):
        out.append((f"lab{comp}.tif", make_tiff(rgb, 8, 8, compression=comp, rows_per_strip=9)))
    for kw in ({}, {"rows_per_strip": 8}, {"tile": (16, 16)}, {"planar": 2}, {"predictor": 2}):
        out.append((f"lzw-compat-{sorted(kw)}.tif", make_tiff(rgb, 8, 2, compression=5, lzw_compat=True, **kw)))
    out.append(("lzw-compat-grey.tif", make_tiff(rgb[..., 0], 8, 1, compression=5, lzw_compat=True, order=">")))
    out.append(("lzw-compat-ycbcr.tif", make_tiff(rgb, 8, 6, compression=5, lzw_compat=True, subsampling=(2, 2),
                                                   rows_per_strip=6)))
    planes = [smooth_image(rng, 32, 40, 1)[..., 0] for _ in range(3)]
    for layout in ("interchange", "tables"):
        for fac in ((1, 1), (2, 1), (2, 2)):
            f = [fac, (1, 1), (1, 1)]
            out.append((f"ojpeg-{layout}-{fac}.tif", make_ojpeg_tiff(planes, f, layout=layout)))
            out.append((f"ojpeg-{layout}-{fac}-strips.tif", make_ojpeg_tiff(planes, f, layout=layout,
                                                                            rows_per_strip=16)))
        out.append((f"ojpeg-{layout}-tiles.tif", make_ojpeg_tiff(planes, [(2, 2), (1, 1), (1, 1)], layout=layout,
                                                                tile=(48, 16))))
        out.append((f"ojpeg-{layout}-grey.tif", make_ojpeg_tiff(planes[:1], [(1, 1)], layout=layout, photometric=1,
                                                               rows_per_strip=8)))
    out.append(("ojpeg-header-only.tif", make_ojpeg_tiff(planes, [(2, 2), (1, 1), (1, 1)], header_only=True)))
    return out


def entries(data: bytes) -> list[int]:
    """The offsets of the first directory's entries (classic or BigTIFF)."""
    o = "<" if data[:2] == b"II" else ">"
    big = struct.unpack(o + "H", data[2:4])[0] == 43
    ifd = struct.unpack(o + ("Q" if big else "I"), data[8:16] if big else data[4:8])[0]
    if big:
        n = struct.unpack(o + "Q", data[ifd:ifd + 8])[0]
        return [ifd + 8 + 20 * i for i in range(n)]
    n = struct.unpack(o + "H", data[ifd:ifd + 2])[0]
    return [ifd + 2 + 12 * i for i in range(n)]


def mutate(r: random.Random, data: bytes) -> tuple[bytes, str]:
    """The mutated file and what was done."""
    kind = r.random()
    if kind < 0.2:
        cut = r.randrange(8, len(data))
        return data[:cut], f"cut at {cut}"
    b = bytearray(data)
    o = "<" if data[:2] == b"II" else ">"
    big = data[2:4] in (b"+\0", b"\0+")
    if kind < 0.6:
        pos = r.choice(entries(data))
        tag = struct.unpack(o + "H", data[pos:pos + 2])[0]
        field = r.randrange(3)
        if field == 0:                           # the type
            new = r.choice([0, 1, 2, 3, 4, 5, 7, 9, 11, 13, 16, 17, 99])
            b[pos + 2:pos + 4] = struct.pack(o + "H", new)
        elif field == 1:                         # the count
            at, fmt = (pos + 4, "Q") if big else (pos + 4, "I")
            old = struct.unpack(o + fmt, bytes(b[at:at + struct.calcsize(fmt)]))[0]
            new = r.choice([0, 1, 2, 3, 4, old + 1, max(old - 1, 0), old * 2, old + 256, 1 << r.randrange(8, 31)])
            b[at:at + struct.calcsize(fmt)] = struct.pack(o + fmt, new)
        else:                                    # the value or offset
            at, fmt = (pos + 12, "Q") if big else (pos + 8, "I")
            new = r.choice([0, 1, r.randrange(len(data)), len(data) - r.randrange(1, 9), len(data) + r.randrange(64)])
            b[at:at + struct.calcsize(fmt)] = struct.pack(o + fmt, new)
        return bytes(b), f"tag {tag} {('type', 'count', 'value')[field]} -> {new}"
    edits = [(r.randrange(8, len(b)), r.randrange(256)) for _ in range(r.randint(1, 4))]
    for at, v in edits:                          # bytes anywhere after the header
        b[at] = v
    return bytes(b), f"bytes {edits}"


def run(path: str, data: bytes):
    """('equal' | 'both raise' | 'port refuses' | 'jax refuses' | 'differ' |
    'stb rule', detail) for one file."""
    from PIL import Image

    from realtimeraytracer_tpu.scene import obj_loader as jol

    Path(path).write_bytes(data)
    kinds = []
    for g in (False, True):
        try:
            want, we = jol.load_texture_file(path, g), None
            img = Image.open(path)
            if img.mode in ("I;16", "I;16B", "I;16L", "I"):
                return "stb rule", img.mode
            img = img.convert("L") if g else img if img.mode in ("RGB", "RGBA") else img.convert("RGBA")
            if np.asarray(img).max() <= 1.5:
                want = want / np.float32(255.0)
        except Exception as e:                   # noqa: BLE001 - whatever Pillow raises
            want, we = None, repr(e)[:80]
        try:
            got, ge = tol.load_texture_file(path, g), None
        except ValueError as e:
            got, ge = None, str(e)[:80]
        if want is None and got is None:
            kinds.append(("both raise", ""))
        elif want is None:
            kinds.append(("jax refuses", we))
        elif got is None:
            kinds.append(("port refuses", ge))
        elif got.shape == want.shape and np.array_equal(got, want):
            kinds.append(("equal", ""))
        else:
            kinds.append(("differ", f"grayscale={g}"))
    bad = [k for k in kinds if k[0] not in ("equal", "both raise")]
    return bad[0] if bad else kinds[0]


def lab_table(tmp: str) -> int:
    """Mismatching Lab values of the port's conversion against Pillow's."""
    from PIL import Image

    v = np.arange(256, dtype=np.uint8)
    grid = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(4096, 4096, 3)
    path = os.path.join(tmp, "lab_table.tif")
    Path(path).write_bytes(make_tiff(grid, 8, 8, rows_per_strip=256))
    want = np.asarray(Image.open(path).convert("RGBA"))[::-1].astype(np.float32) / 255
    got = tol.load_texture_file(path, False)
    return int((want != got).any(-1).sum())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--files", type=int, default=3000)
    ap.add_argument("--seed", type=int, default=20)
    ap.add_argument("--lab-table", action="store_true")
    ap.add_argument("--keep", type=Path, help="write the mismatching files here")
    args = ap.parse_args()
    warnings.simplefilter("ignore")
    r = random.Random(args.seed)
    pool = seeds()
    counts = {k: 0 for k in ("equal", "both raise", "port refuses", "jax refuses", "differ", "stb rule")}
    shown = {k: 0 for k in counts}
    with tempfile.TemporaryDirectory(prefix="tiff_fuzz_") as tmp:
        if args.lab_table:
            print("Lab values converted otherwise than Pillow:", lab_table(tmp))
        for i in range(args.files):
            name, data = pool[r.randrange(len(pool))]
            bad, how = mutate(r, data)
            kind, detail = run(os.path.join(tmp, "f.tif"), bad)
            counts[kind] += 1
            if kind not in ("equal", "both raise", "stb rule") and shown[kind] < 40:
                shown[kind] += 1
                print(f"{kind}: file {i} from {name}, {how}: {detail}")
            if kind not in ("equal", "both raise", "stb rule") and args.keep:
                args.keep.mkdir(parents=True, exist_ok=True)
                (args.keep / f"{kind.replace(' ', '_')}_{i}.tif").write_bytes(bad)
    print(counts)


if __name__ == "__main__":
    main()
