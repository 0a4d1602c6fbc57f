"""Differential fuzz of the port's JPEG decoder against Pillow (not a test).

``python tests/_torch_jpeg_fuzz.py [--files N] [--seed S] [--asan DIR]``
mutates seed JPEG files (the committed JPEG fixtures, ``jpeg_ycbcr.tif``'s
JPEG tiles and tables,
Pillow JPEGs at several qualities, samplings and progressions, arithmetic-
coded and lossless files from the hand encoders in
``_torch_image_helpers``): 1-4 bytes set to random values, or a JPEG cut
(15% of the files), drawn with ``random.Random(S)``.  Each file goes through
Pillow (the JAX package's ``load_texture_file`` reads textures with it) and
the port's ``decode_image``; it prints the count of files equal on both
sides, raising on both, decoded by Pillow and refused by the port, decoded
by the port and refused by Pillow, and decoded to other pixels, and the
first cases of each mismatch.  With ``--asan DIR`` it also writes the files
to DIR and decodes them with a ``-fsanitize=address,undefined`` build of
the decoder sources (a small C++ driver, zlib for the TIFF's inflate),
printing any sanitizer report.  Needs Pillow and a C++ compiler.
"""

from __future__ import annotations

import argparse
import io
import random
import struct
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from _torch_image_helpers import (FIXTURES, PROGRESSION1, PROGRESSION3, encode_arith_jpeg,  # noqa: E402
                                  encode_jpeg, encode_lossless_jpeg, jpeg_blocks, smooth_image)

from realtimeraytracer_torch.utils import image_decode  # noqa: E402

DRIVER = r"""
#include <cstdint>
#include <cstdio>
#include <fstream>
#include <iterator>
#include <string>
#include <vector>
#include <zlib.h>
extern "C" {
typedef int64_t (*codec_fn)(int32_t, const uint8_t*, int64_t, uint8_t*, int64_t);
void* imgd_decode(const uint8_t*, int64_t, int32_t, char*, int64_t);
void* imgd_tiff(const uint8_t*, int64_t, codec_fn, char*, int64_t);
void imgd_free(void*);
}
static int64_t inflate_cb(int32_t codec, const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  uLongf out = uLongf(cap);  // zlib only (codec 0): no LZMA here
  return codec == 0 && uncompress(dst, &out, src, uLong(n)) == Z_OK ? int64_t(out) : -1;
}
int main(int argc, char** argv) {
  int ok = 0;
  for (int i = 1; i < argc; ++i) {
    std::ifstream f(argv[i], std::ios::binary);
    std::vector<uint8_t> d((std::istreambuf_iterator<char>(f)), std::istreambuf_iterator<char>());
    char err[512];
    std::string name(argv[i]);
    void* h = name.size() > 4 && name.substr(name.size() - 4) == ".tif"
                  ? imgd_tiff(d.data(), int64_t(d.size()), inflate_cb, err, sizeof err)
                  : imgd_decode(d.data(), int64_t(d.size()), 1, err, sizeof err);
    if (h) ++ok, imgd_free(h);
  }
  std::printf("decoded %d of %d\n", ok, argc - 1);
}
"""


def seeds() -> list[tuple[str, bytes]]:
    from PIL import Image

    out = [(p.name, p.read_bytes()) for p in sorted(FIXTURES.glob("*.jpg"))]
    out.append(("jpeg_ycbcr.tif", (FIXTURES / "jpeg_ycbcr.tif").read_bytes()))
    rng = np.random.default_rng(19)
    img = smooth_image(rng, 29, 35, 3)
    for q in (30, 75, 95):
        for sub in (0, 2):
            for extra in ({}, {"progressive": True}, {"restart_marker_blocks": 2}):
                buf = io.BytesIO()
                Image.fromarray(img).save(buf, "JPEG", quality=q, subsampling=sub, **extra)
                out.append((f"pil-q{q}-s{sub}-{sorted(extra)}.jpg", buf.getvalue()))
    buf = io.BytesIO()
    Image.fromarray(img[..., 0]).save(buf, "JPEG", quality=80, progressive=True)
    out.append(("pil-grey-prog.jpg", buf.getvalue()))
    planes = [img[..., k] for k in range(3)]
    out.append(("enc-440.jpg", encode_jpeg(planes, [(1, 2), (1, 1), (1, 1)], restart=3)))
    out.append(("enc-ycck.jpg", encode_jpeg(planes + [planes[0]], [(1, 1)] * 4, adobe=2)))
    for fac in ([(2, 2), (1, 1), (1, 1)], [(1, 1)] * 3):
        blocks = jpeg_blocks(planes, fac, 4)
        out.append((f"arith-seq-{fac[0]}.jpg", encode_arith_jpeg(blocks, 35, 29, fac, [4] * 64, restart=4,
                                                                 dac=((0, 0x31), (16, 3)))))
        out.append((f"arith-prog-{fac[0]}.jpg", encode_arith_jpeg(blocks, 35, 29, fac, [4] * 64,
                                                                  progression=PROGRESSION3, restart=3)))
    grey = jpeg_blocks([planes[1]], [(1, 1)], 3)
    out.append(("arith-grey-prog.jpg", encode_arith_jpeg(grey, 35, 29, [(1, 1)], [3] * 64,
                                                         progression=PROGRESSION1)))
    out.append(("lossless-grey.jpg", encode_lossless_jpeg([planes[0]], 4, 1, restart_rows=4)))
    out.append(("lossless-rgb.jpg", encode_lossless_jpeg(planes, 7)))
    return out


def jpeg_spans(data: bytes) -> list[tuple[int, int]]:
    """Where a little-endian TIFF keeps its JPEG streams (tiles or strips,
    JPEGTables); the whole file after SOI for a JPEG."""
    if not data.startswith(b"II*\0"):
        return [(2, len(data))]
    ifd = struct.unpack("<I", data[4:8])[0]
    tags = {}
    for i in range(struct.unpack("<H", data[ifd:ifd + 2])[0]):
        tag, typ, count, value = struct.unpack("<HHII", data[ifd + 2 + 12 * i:ifd + 14 + 12 * i])
        tags[tag] = (typ, count, value)
    spans = []
    for off_tag, cnt_tag in ((324, 325), (273, 279)):
        if off_tag in tags:
            n = tags[off_tag][1]
            read = (lambda t: [tags[t][2]] if n == 1 else
                    list(struct.unpack(f"<{n}I", data[tags[t][2]:tags[t][2] + 4 * n])))
            spans += [(o, o + c) for o, c in zip(read(off_tag), read(cnt_tag))]
    if 347 in tags:
        spans.append((tags[347][2], tags[347][2] + tags[347][1]))
    return spans


def mutate(r: random.Random, data: bytes) -> bytes:
    """A cut (15%), else 1-4 bytes of the JPEG data set to random values
    (a TIFF's directory is left alone: this fuzz is about JPEG data)."""
    if r.random() < 0.15 and not data.startswith(b"II*\0"):
        return data[:r.randrange(2, len(data))]
    b = bytearray(data)
    spans = jpeg_spans(data)
    for _ in range(r.randint(1, 4)):
        lo, hi = spans[r.randrange(len(spans))]
        b[r.randrange(lo, hi)] = r.randrange(256)
    return bytes(b)


def pillow(data: bytes):
    from PIL import Image

    im = Image.open(io.BytesIO(data))
    im.load()
    if im.mode not in ("L", "RGB", "RGBA", "LA"):
        im = im.convert("RGBA")
    a = np.asarray(im)
    return a if a.ndim == 3 else a[..., None]


def port(data: bytes):
    return image_decode.decode_image(data)[0]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--files", type=int, default=3000)
    ap.add_argument("--seed", type=int, default=19)
    ap.add_argument("--asan", type=Path)
    args = ap.parse_args()
    warnings.simplefilter("ignore")
    r = random.Random(args.seed)
    pool = seeds()
    counts = {"equal": 0, "both raise": 0, "port refuses": 0, "pillow refuses": 0, "differ": 0}
    shown = {k: 0 for k in counts}
    files = []
    for i in range(args.files):
        name, data = pool[r.randrange(len(pool))]
        bad = mutate(r, data)
        files.append((f"{i:05d}-{name}", bad))
        try:
            want, we = pillow(bad), None
        except Exception as e:      # noqa: BLE001 - whatever Pillow raises
            want, we = None, repr(e)[:70]
        try:
            got, ge = port(bad), None
        except ValueError as e:
            got, ge = None, str(e)[:70]
        if want is None and got is None:
            kind = "both raise"
        elif want is None:
            kind = "pillow refuses"
        elif got is None:
            kind = "port refuses"
        else:
            kind = "equal" if got.shape == want.shape and np.array_equal(got, want) else "differ"
        counts[kind] += 1
        if kind not in ("equal", "both raise") and shown[kind] < 5:
            shown[kind] += 1
            print(f"{kind}: {i} {name} pillow={we} port={ge}")
    print(counts)
    if args.asan:
        args.asan.mkdir(parents=True, exist_ok=True)
        paths = []
        for fname, bad in files:
            p = args.asan / (fname if fname.endswith(".tif") else fname.rsplit(".", 1)[0] + ".jpg")
            p.write_bytes(bad)
            paths.append(str(p))
        src = args.asan / "driver.cpp"
        src.write_text(DRIVER)
        exe = args.asan / "driver"
        subprocess.run(["g++", "-O1", "-g", "-std=c++17", "-fsanitize=address,undefined",
                        "-fno-sanitize-recover=undefined", "-o", str(exe), str(src),
                        *map(str, image_decode.SOURCES), "-lz"], check=True)
        run = subprocess.run([str(exe), *paths], capture_output=True, text=True)
        print("sanitizer build:", run.stdout.strip(), "rc", run.returncode)
        if run.stderr.strip():
            print(run.stderr[-3000:])


if __name__ == "__main__":
    main()
