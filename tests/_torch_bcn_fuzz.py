"""Differential fuzz of the port's DDS, BLP and FTEX readers against the JAX package (not a test).

``python tests/_torch_bcn_fuzz.py [--blocks N] [--files N] [--seed S] [--keep DIR]``
has two parts, both drawn from the seed S:

- blocks: N random 16-byte (8-byte) blocks of each BCn code (BC1, BC2,
  BC3, BC4, BC5, BC5S, BC6H UF16 and SF16, BC7; BC6H's mode bits drawn
  among its 14 modes and the reserved ones for half of its blocks) in one
  DDS each, decoded by Pillow and by the port; it prints the blocks whose
  pixels differ;
- files: mutations of the texture cases of tests/test_torch_images_bcn.py
  and the committed DDS, BLP and FTEX fixtures (a header word set to a
  random, small or nearby value (40% of the files), 1-4 bytes of the data
  set to random values (40%), or the file cut (20%)), each through the JAX
  package's ``load_texture_file`` (Pillow, C1 applied) and the port's with
  both values of ``grayscale``; it prints the count of files equal on both
  sides, raising on both, refused by one side only, and decoded to other
  pixels, and the first cases of each mismatch (``--keep DIR`` writes the
  mismatching files there).  Files whose mutated size would have Pillow's
  Python decoders loop over more than 2^18 pixels are drawn again.

Needs Pillow and the JAX package.
"""

from __future__ import annotations

import argparse
import io
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

from _torch_image_helpers import FIXTURES, make_dds  # noqa: E402

from realtimeraytracer_torch.scene import obj_loader as tol  # noqa: E402
from realtimeraytracer_torch.utils import image_decode  # noqa: E402

# name -> (FourCC or DXGI format, block bytes)
FORMATS = {"BC1": (b"DXT1", 8), "BC2": (b"DXT3", 16), "BC3": (b"DXT5", 16), "BC4": (b"BC4U", 8),
           "BC5": (b"BC5U", 16), "BC5S": (b"BC5S", 16), "BC6H": (95, 16), "BC6HS": (96, 16), "BC7": (98, 16)}
BC6_MODES = [0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15, 19, 23, 27, 31]


def blocks(seed: int, n: int) -> dict:
    """Mismatching blocks of each format over `n` random blocks."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    out = {}
    for name, (code, size) in FORMATS.items():
        b = rng.integers(0, 256, (n, size), np.uint8)
        if name.startswith("BC6"):
            half = rng.random(n) < 0.5
            b[half, 0] = (b[half, 0] & 0xE0) | rng.choice(BC6_MODES, int(half.sum()))
        cols = 256
        rows = -(-n // cols)
        b = np.concatenate([b, np.zeros((rows * cols - n, size), np.uint8)])
        kw = {"dxgi": code} if isinstance(code, int) else {"fourcc": code}
        data = make_dds(4 * cols, 4 * rows, b.tobytes(), **kw)
        want = np.asarray(Image.open(io.BytesIO(data)))
        got = image_decode.decode_image(data)[0]
        want = want.reshape(got.shape)
        diff = (want != got).any(-1).reshape(rows, 4, cols, 4).any((1, 3)).reshape(-1)[:n]
        out[name] = int(diff.sum())
        for i in np.nonzero(diff)[0][:3]:
            print(f"{name} block {i} differs: {b[i].tobytes().hex()}")
    return out


def seeds() -> list[tuple[str, bytes]]:
    from test_torch_images_bcn import _cases

    out = [(f"{k}_{i}", d) for k, files in _cases().items() for i, d in enumerate(files)]
    for p in sorted(FIXTURES.iterdir()):
        if p.suffix in (".dds", ".blp", ".ftc"):
            out.append((p.name, p.read_bytes()))
    return out


def pixels(data: bytes) -> int:
    """The pixel count a texture's header states (0 where none)."""
    try:
        if data.startswith(b"DDS "):
            h, w = struct.unpack("<II", data[12:20])
        elif data.startswith((b"BLP1", b"BLP2")):
            w, h = struct.unpack("<II", data[12:20])
        elif data.startswith(b"FTEX"):
            w, h = struct.unpack("<2i", data[8:16])
        else:
            return 0
    except struct.error:
        return 0
    return abs(w * h)


def mutate(r: random.Random, data: bytes) -> tuple[bytes, str]:
    b = bytearray(data)
    roll = r.random()
    if roll < 0.4:
        at = r.randrange(0, min(len(b) - 3, 180)) & ~3
        old = struct.unpack_from("<I", b, at)[0]
        new = r.choice([r.getrandbits(32), r.randrange(0, 300), (old + r.randrange(-8, 9)) & 0xFFFFFFFF,
                        old ^ (1 << r.randrange(32))])
        struct.pack_into("<I", b, at, new)
        return bytes(b), f"word at {at}: {old} -> {new}"
    if roll < 0.8:
        places = [r.randrange(len(b)) for _ in range(r.randint(1, 4))]
        for at in places:
            b[at] = r.getrandbits(8)
        return bytes(b), f"bytes at {places}"
    cut = r.randrange(len(b))
    return bytes(b[:cut]), f"cut at {cut} of {len(b)}"


def run(path: str, data: bytes) -> tuple[str, str]:
    from PIL import Image

    from realtimeraytracer_tpu.scene import obj_loader as jol

    Path(path).write_bytes(data)
    kinds = []
    for g in (False, True):
        try:
            want, we = jol.load_texture_file(path, g), None
            img = Image.open(path)
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=100_000)
    ap.add_argument("--files", type=int, default=3000)
    ap.add_argument("--seed", type=int, default=23)
    ap.add_argument("--keep", type=Path, help="write the mismatching files here")
    args = ap.parse_args()
    warnings.simplefilter("ignore")
    if args.blocks:
        print("mismatching blocks of", args.blocks, "each:", blocks(args.seed, args.blocks))
    r = random.Random(args.seed)
    pool = seeds()
    counts = {k: 0 for k in ("equal", "both raise", "port refuses", "jax refuses", "differ")}
    shown = {k: 0 for k in counts}
    with tempfile.TemporaryDirectory(prefix="bcn_fuzz_") as tmp:
        for i in range(args.files):
            while True:
                name, data = pool[r.randrange(len(pool))]
                bad, how = mutate(r, data)
                if pixels(bad) <= 1 << 18:
                    break
            kind, detail = run(os.path.join(tmp, "f"), bad)
            counts[kind] += 1
            if kind not in ("equal", "both raise") and shown[kind] < 40:
                shown[kind] += 1
                print(f"{kind}: file {i} from {name}, {how}: {detail}")
            if kind not in ("equal", "both raise") and args.keep:
                args.keep.mkdir(parents=True, exist_ok=True)
                (args.keep / f"{kind.replace(' ', '_')}_{i}").write_bytes(bad)
    print(counts)


if __name__ == "__main__":
    main()
