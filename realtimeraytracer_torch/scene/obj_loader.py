"""OBJ + MTL loading, texture files and Radiance HDR skies.

Counterpart of realtimeraytracer_tpu/scene/obj_loader.py (the replacement
of the reference's vendored tinyobjloader, core/file.cppm:44-268):
``parse_mtl``, ``parse_obj`` (the native C++ tokenizer of
native/objparse.cpp through utils/native.py, or the pure-Python parser
with ``allow_native=False`` or without a C++ compiler), ``_dedup_shape``,
``load_obj``, ``load_obj_mtl``, ``load_texture_file``, ``decode_radiance_hdr``,
``encode_radiance_hdr``, ``load_hdr`` and ``load_obj_scene``, with the same
results.  Texture files and 8-bit skies are read by the port's native
decoder (utils/image_decode.py: JPEG, PNG, TGA, BMP, GIF, PNM, PSD, TIFF,
WebP, the icon formats and Pillow's plain raster openers) instead of
Pillow and imageio, with Pillow's modes and grey conversion reproduced
bit for bit; every 8-bit texel is divided by 255, as stbi_load reads it.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field

import numpy as np

from realtimeraytracer_torch.scene.geometry import TriangleMesh, compute_vertex_normals
from realtimeraytracer_torch.scene.materials import Material
from realtimeraytracer_torch.utils import image_decode
from realtimeraytracer_torch.utils.image_decode import decode_float_samples, decode_image, sniff

log = logging.getLogger(__name__)


@dataclass
class MTLMaterial:
    name: str = ""
    diffuse: tuple = (0.8, 0.8, 0.8)   # Kd
    specular: float = 0.5              # Ks (first channel)
    metallic: float = 0.0              # non-standard `metallic` key
    map_kd: str | None = None
    map_ks: str | None = None
    map_metallic: str | None = None
    map_d: str | None = None           # opacity / alpha map


def parse_mtl(path: str) -> dict[str, MTLMaterial]:
    """Parse a .mtl file into named materials."""
    mats: dict[str, MTLMaterial] = {}
    cur: MTLMaterial | None = None
    base = os.path.dirname(path)
    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key = parts[0]
            if key == "newmtl":
                cur = MTLMaterial(name=parts[1] if len(parts) > 1 else "")
                mats[cur.name] = cur
            elif cur is None:
                continue
            elif key == "Kd" and len(parts) >= 4:
                cur.diffuse = tuple(float(x) for x in parts[1:4])
            elif key == "Ks" and len(parts) >= 2:
                cur.specular = float(parts[1])
            elif key == "metallic" and len(parts) >= 2:
                cur.metallic = float(parts[1])
            elif key == "map_Kd":
                cur.map_kd = os.path.join(base, parts[-1])
            elif key == "map_Ks":
                cur.map_ks = os.path.join(base, parts[-1])
            elif key in ("map_Pm", "map_metallic"):
                cur.map_metallic = os.path.join(base, parts[-1])
            elif key == "map_d":
                cur.map_d = os.path.join(base, parts[-1])
    return mats


def _parse_index(tok: str, nv: int, nt: int, nn: int):
    """One face corner 'v', 'v/vt', 'v//vn', or 'v/vt/vn' (1-based or
    negative-relative, per the OBJ spec)."""
    segs = tok.split("/")

    def fix(s, n):
        if not s:
            return -1
        i = int(s)
        return i - 1 if i > 0 else n + i
    vi = fix(segs[0], nv)
    ti = fix(segs[1], nt) if len(segs) > 1 else -1
    ni = fix(segs[2], nn) if len(segs) > 2 else -1
    return vi, ti, ni


@dataclass
class _ShapeAccum:
    name: str
    material: str
    corners: list = field(default_factory=list)  # list of (vi, ti, ni)
    faces: list = field(default_factory=list)    # triangles of corner-indices


def parse_obj(path: str, allow_native: bool = True):
    """Parse an OBJ file.

    Returns (positions (V,3), texcoords (T,2), normals (N,3), shapes,
    mtllibs), where each shape holds triangulated faces of (vi, ti, ni)
    corners, split on o/g/usemtl boundaries (tinyobjloader shape
    semantics).

    Uses the native C++ tokenizer (native/objparse.cpp) unless
    `allow_native` is False or the machine has no C++ compiler; the
    pure-Python path below is the reference implementation and fallback
    (it also raises a file's error)."""
    from realtimeraytracer_torch.utils import native

    if allow_native and native.load_library() is not None:
        try:
            return _parse_obj_native(path)
        except OSError:
            pass
    positions: list = []
    texcoords: list = []
    normals: list = []
    mtllibs: list[str] = []
    shapes: list[_ShapeAccum] = []

    def shape(name="", material=""):
        if (not shapes or shapes[-1].faces
                or shapes[-1].material != material or (name and shapes[-1].name != name)):
            if shapes and not shapes[-1].faces and shapes[-1].material == "":
                shapes.pop()
            shapes.append(_ShapeAccum(name=name or (shapes[-1].name if shapes else ""),
                                      material=material))
        return shapes[-1]

    cur = shape()
    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key = parts[0]
            if key == "v":
                positions.append([float(x) for x in parts[1:4]])
            elif key == "vt":
                texcoords.append([float(parts[1]), float(parts[2]) if len(parts) > 2 else 0.0])
            elif key == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif key == "f":
                idx = [
                    _parse_index(t, len(positions), len(texcoords), len(normals))
                    for t in parts[1:]
                ]
                # Fan triangulation of polygons (tinyobjloader default).
                for k in range(1, len(idx) - 1):
                    cur.faces.append((idx[0], idx[k], idx[k + 1]))
            elif key in ("o", "g"):
                cur = shape(name=" ".join(parts[1:]), material=cur.material)
            elif key == "usemtl":
                cur = shape(name=cur.name, material=parts[1] if len(parts) > 1 else "")
            elif key == "mtllib":
                mtllibs.extend(parts[1:])

    shapes = [s for s in shapes if s.faces]
    return (
        np.asarray(positions, np.float32).reshape(-1, 3),
        np.asarray(texcoords, np.float32).reshape(-1, 2),
        np.asarray(normals, np.float32).reshape(-1, 3),
        shapes,
        mtllibs,
    )


def _parse_obj_native(path: str):
    """Native-tokenizer front end producing the same structures as the
    pure-Python parser."""
    from realtimeraytracer_torch.utils.native import NativeObj

    positions, texcoords, normals, corners, tri_shape, shape_meta, mtllibs = \
        NativeObj(path).arrays()
    order = np.argsort(tri_shape, kind="stable")
    bounds = np.searchsorted(tri_shape[order], np.arange(len(shape_meta) + 1))
    corner_rows = corners[order].tolist()
    shapes = []
    for i, (name, mat) in enumerate(shape_meta):
        if bounds[i] == bounds[i + 1]:
            continue
        s = _ShapeAccum(name=name, material=mat)
        s.faces = [tuple(map(tuple, tri)) for tri in corner_rows[bounds[i]:bounds[i + 1]]]
        shapes.append(s)
    return positions, texcoords, normals, shapes, mtllibs


def _dedup_shape(shape: _ShapeAccum, positions, texcoords, normals):
    """Deduplicate (v, vt, vn) corner triples into an indexed mesh
    (reference: file.cppm:60-96 unordered_map<Vertex, uint32_t>)."""
    remap: dict[tuple, int] = {}
    verts, uvs, nrms, faces = [], [], [], []
    has_normals = True
    for tri in shape.faces:
        face = []
        for corner in tri:
            j = remap.get(corner)
            if j is None:
                j = len(verts)
                remap[corner] = j
                vi, ti, ni = corner
                verts.append(positions[vi])
                uvs.append(texcoords[ti] if ti >= 0 else (0.0, 0.0))
                if ni >= 0:
                    nrms.append(normals[ni])
                else:
                    has_normals = False
                    nrms.append((0.0, 0.0, 1.0))
            face.append(j)
        faces.append(face)
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int32)
    n = np.asarray(nrms, np.float32) if has_normals else compute_vertex_normals(v, f)
    return v, f, n, np.asarray(uvs, np.float32)


def load_obj(path: str, material: Material | None = None) -> TriangleMesh:
    """Load a whole OBJ as one TriangleMesh (reference loadModel,
    file.cppm:44-102: all shapes merged, dedup'd)."""
    positions, texcoords, normals, shapes, _ = parse_obj(path)
    merged = _ShapeAccum(name=os.path.basename(path), material="")
    for s in shapes:
        merged.faces.extend(s.faces)
    v, f, n, uv = _dedup_shape(merged, positions, texcoords, normals)
    return TriangleMesh(vertices=v, faces=f, normals=n, uvs=uv,
                        material=material or Material(),
                        name=os.path.basename(path))


def load_obj_mtl(obj_path: str, mtl_path: str | None = None) -> list[TriangleMesh]:
    """Load per-shape meshes with MTL materials (reference loadOBJandMTL,
    file.cppm:112-268).  Texture references stay as file-path strings on the
    Material; load_obj_scene resolves them to atlas indices."""
    positions, texcoords, normals, shapes, mtllibs = parse_obj(obj_path)
    mats: dict[str, MTLMaterial] = {}
    candidates = []
    if mtl_path:
        candidates.append(mtl_path)
    base = os.path.dirname(obj_path)
    candidates += [os.path.join(base, m) for m in mtllibs]
    for c in candidates:
        if os.path.exists(c):
            mats.update(parse_mtl(c))

    meshes = []
    for s in shapes:
        v, f, n, uv = _dedup_shape(s, positions, texcoords, normals)
        m = mats.get(s.material)
        if m is not None:
            material = Material(
                color=m.diffuse, specular=m.specular, metallic=m.metallic,
                color_map=m.map_kd, specular_map=m.map_ks,
                metallic_map=m.map_metallic, opacity_map=m.map_d,
                name=m.name,
            )
        else:
            material = Material()
        meshes.append(TriangleMesh(vertices=v, faces=f, normals=n, uvs=uv,
                                   material=material,
                                   name=s.name or s.material or "shape"))
    return meshes


def _grey(pixels: np.ndarray) -> np.ndarray:
    """(H, W) uint8 luma of (H, W, C) pixels as Pillow's convert("L")
    gives it: grey (C = 1, 2) as it is, colour rounded as Pillow rounds:
    (R*19595 + G*38470 + B*7471 + 2^15) >> 16."""
    if pixels.shape[2] <= 2:
        return pixels[..., 0]
    p = pixels.astype(np.uint32)
    return ((p[..., 0] * 19595 + p[..., 1] * 38470 + p[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def _icns_array(path: str, px: np.ndarray, mode: str) -> np.ndarray:
    """An ICNS image as the JAX package's ``np.asarray(Image.open(path))``
    gives it: Pillow reports "RGBA" until it loads the member, so no
    convert runs, and its ``tobytes`` packs the loaded member with the
    rawmode "RGBA" but shapes the array by the member's own mode.  An
    RGBA member comes out as it is; an RGB one as its RGBX bytes (X 255)
    cut into three a pixel, shifted along the rows; any other mode has no
    RGBA packer, and Pillow raises."""
    if mode == "RGBA":
        return px
    if mode != "RGB":
        raise ValueError(f"{path}: an ICNS member in mode {mode} does not pack as RGBA (Pillow raises too)")
    h, w = px.shape[:2]
    rgbx = np.concatenate([px, np.full((h, w, 1), 255, np.uint8)], axis=2)
    return rgbx.reshape(-1)[:h * w * 3].reshape(h, w, 3)


def _rgba(px: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 grey (C = 1), grey and alpha (2), RGB (3) or RGBA
    (4) as Pillow's convert("RGBA") gives it: grey repeated, alpha 255
    where there is none."""
    if px.shape[2] == 4:
        return px
    alpha = px[..., 1:] if px.shape[2] == 2 else np.full(px.shape[:2] + (1,), 255, np.uint8)
    return np.concatenate([px if px.shape[2] == 3 else np.repeat(px[..., :1], 3, axis=2), alpha], axis=2)


def _iptc_array(data: bytes, grayscale: bool) -> np.ndarray:
    """An IPTC image as the JAX package's ``np.asarray`` of its converted
    image gives it.  Pillow labels the image by the records (mode, size)
    but holds the one its data decodes to (``image_decode.iptc_image``):
    - records of one grey layer ("L"): convert("L") copies the held image,
      so a colour one keeps its channels (CMYK its stored bytes), and
      convert("RGBA") converts it by its own mode;
    - a layer of an RGB image: unconverted, the held RGB bytes (at the
      data's size) shaped by the records' size (zeros past them, where
      Pillow reads past its buffer); convert("L") converts it at the
      data's own size;
    - a layer of a CMYK image: both converts at the data's size."""
    held = image_decode.iptc_image(data)
    px = held.px
    if held.mode == "L":
        if held.inner == "CMYK" and grayscale:
            px = image_decode.iptc_image(data, stored_cmyk=True).px
            if px.shape[2] != 4:
                raise ValueError("IPTC grey records over a CMYK image that is not a JPEG (not read)")
            return px
        if held.inner not in ("1", "L", "LA", "RGB", "RGBA", "CMYK", "P"):
            raise ValueError(f"IPTC grey records over a {held.inner} image (not read)")
        if grayscale:
            if held.inner == "P":        # the copy's indices, which the decode does not keep
                raise ValueError("IPTC grey records over a palette image read as grey (not read)")
            return px[..., 0] // 255 if held.inner == "1" else px if px.shape[2] > 1 else px[..., 0]
        return _rgba(px)
    if grayscale:
        return _grey(px)
    if held.mode != "RGB":
        return px
    need = held.w * held.h * 3
    flat = px.reshape(-1)[:need]
    return np.concatenate([flat, np.zeros(need - flat.size, np.uint8)]).reshape(held.h, held.w, 3)


def load_texture_file(path: str, grayscale: bool = False) -> np.ndarray:
    """Decode an image file to float32 [0,1] (H, W, C), vertically flipped
    to match the reference's stbi_set_flip_vertically_on_load usage
    (file.cppm:276-291; grayscale R8 vs RGBA8 modes).  Read: JPEG (Huffman,
    arithmetic-coded and lossless; incomplete progressive files and corrupt
    data as libjpeg decodes them for Pillow), PNG, TGA, BMP, DIB, ICO,
    CUR, ICNS, GIF (its first frame), PNM (P1-P6, Pf), PSD (its composite
    image), TIFF (its first image), WebP (an animation's first frame),
    PCX, DCX, QOI, SGI, Sun raster, MSP, XBM, XPM, IM, SPIDER, FITS,
    FLI/FLC (the first frame), GBR, IM Tools, IPTC (as Pillow mislabels
    some: ``_iptc_array``), McIdas, Photo CD (its base image), PIXAR and XV
    thumbnails, DDS (masked RGB(A), L, LA, P, BC1-BC7), FTEX and BLP, as
    utils/image_decode.py lists them; the rest (JPEG 2000, AVIF, and what
    Pillow cannot load either) raise ValueError.  As in the JAX package, RGB and RGBA
    files keep their channels and any other file loads as RGBA (palettes
    expanded, grey with alpha 1 or its own, Lab through littleCMS's sRGB
    conversion, YCbCr through Pillow's tables) unless grayscale is set (a
    YCbCr file's grey is its Y band); a Lab file read as grey raises
    ValueError, as Pillow's convert("L") does.  Integer and float samples
    clip as Pillow's convert does; 16-bit grey keeps its high byte, as
    stb_image does.  Every texel is divided
    by 255, as stbi_load's 8-bit images are read (the JAX package divides
    only when some texel exceeds 1.5, so a file of 0/1 texels reads 0/1
    there)."""
    with open(path, "rb") as f:
        data = f.read()
    kind = sniff(data)
    if kind == "IPTC":
        px = _iptc_array(data, grayscale)
    else:
        px, mode = decode_image(data)
        if mode == "YCbCr":  # convert("L") keeps the Y band (the decoder's fourth channel), convert("RGBA") converts
            px = px[..., 3] if grayscale else _rgba(px[..., :3])
        elif grayscale:
            if mode == "LAB":    # Pillow's convert("L") has no Lab conversion
                raise ValueError(f"{path}: a Lab image does not convert to grey")
            px = _grey(px)
        elif kind == "ICNS":
            px = _icns_array(path, px, mode)
        elif px.shape[2] <= 2:
            px = _rgba(px)
    arr = px.astype(np.float32) / 255.0
    arr = arr[::-1]  # vertical flip
    if arr.ndim == 2:
        arr = arr[..., None]
    return np.ascontiguousarray(arr)


def decode_radiance_hdr(data: bytes) -> np.ndarray:
    """Decode Radiance RGBE (.hdr) bytes to linear (H, W, 3) float32: the
    adaptive (new-style) per-component RLE scanlines, flat RGBE scanlines,
    and old-style repeat pixels; conversion by stb's c * 2^(e-136)."""
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance HDR file (missing #? magic)")
    # Header: lines until the first empty line, then the resolution line.
    pos = 0
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line == b"":
            break
    nl = data.index(b"\n", pos)
    res = data[pos:nl].split()
    pos = nl + 1
    if len(res) != 4 or res[0] not in (b"-Y", b"+Y") or res[2] != b"+X":
        raise ValueError(f"unsupported HDR resolution line: {res!r}")
    h, w = int(res[1]), int(res[3])
    top_down = res[0] == b"-Y"      # -Y: first scanline is the top row

    buf = np.frombuffer(data, np.uint8, offset=pos)
    out = np.zeros((h, w, 4), np.uint8)
    p = 0
    for y in range(h):
        if (w >= 8 and w < 32768 and p + 4 <= len(buf)
                and buf[p] == 2 and buf[p + 1] == 2
                and (int(buf[p + 2]) << 8 | int(buf[p + 3])) == w):
            # New-style: 4 components, each RLE-coded across the scanline.
            p += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = int(buf[p])
                    p += 1
                    if count > 128:                      # run
                        out[y, x:x + count - 128, c] = buf[p]
                        p += 1
                        x += count - 128
                    else:                                # literal
                        out[y, x:x + count, c] = buf[p:p + count]
                        p += count
                        x += count
                if x != w:
                    raise ValueError(f"HDR RLE overrun at scanline {y}")
        else:
            # Flat RGBE, with old-style (1,1,1,count) repeat pixels.
            x = 0
            while x < w:
                px = buf[p:p + 4]
                p += 4
                if px[0] == 1 and px[1] == 1 and px[2] == 1 and x > 0:
                    n = int(px[3])
                    out[y, x:x + n] = out[y, x - 1]
                    x += n
                else:
                    out[y, x] = px
                    x += 1
    rgbe = out.astype(np.float32)
    e = out[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(np.float32)
    rgb = rgbe[..., :3] * scale[..., None]
    if not top_down:
        rgb = rgb[::-1]
    return np.ascontiguousarray(rgb)


def encode_radiance_hdr(rgb: np.ndarray) -> bytes:
    """Encode linear (H, W, 3) float32 to flat (non-RLE) Radiance bytes."""
    rgb = np.asarray(rgb, np.float32)
    h, w = rgb.shape[:2]
    m = rgb.max(-1)
    nz = m > 1e-32
    fr, ex = np.frexp(np.where(nz, m, 1.0))
    scale = np.where(nz, fr * 256.0 / np.where(nz, m, 1.0), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, ex + 128, 0).astype(np.uint8)
    head = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    return head + rgbe.tobytes()


def load_hdr(path: str, tone_encode: bool = True) -> np.ndarray:
    """Load a sky to (H, W, 3) float32, flipped (row 0 = bottom).

    A Radiance .hdr file is decoded to linear radiance; with tone_encode it
    is clamped and encoded with pow(1/2.2) as the reference's 8-bit sky path
    does (application.cppm:250), and the miss shader re-linearizes it.

    A float TIFF (16-, 32- or 64-bit samples; grey, RGB or RGBA), a PFM,
    an IM "F" image or a float FITS holds linear radiance, as a .hdr file
    does: its channels 0-2 (a grey one repeated to three) take the .hdr
    branch's clamp and encoding, as the JAX package's imageio path gives a
    TIFF's and an IM's (a PFM's it rounds to bytes; a planar TIFF's it
    takes as (C, H, W); a ZSTD one it cannot read; a FITS's it reads
    byte-swapped, as Pillow does: ROADMAP, "Faults of the reference").  A
    SPIDER sky raises ValueError, as imageio cannot read one either.

    Any other file (every format utils/image_decode.py reads; grey
    repeated to three channels, alpha dropped)
    holds 8-bit encoded texels, as ``stbi_load`` gives them to the
    reference (a 16- or 32-bit TIFF the texture path's bytes): with
    tone_encode they come back as texel / 255, the encoded sky; without,
    as (texel / 255) ** 2.2, the linear radiance whose encoding the .hdr
    branch computes.  The JAX package reads such files with imageio and
    does not divide by 255, so its encoded sky is white wherever a texel
    is 1 or more (ROADMAP, "Faults of the reference")."""
    with open(path, "rb") as f:
        data = f.read()
    if path.lower().endswith(".hdr"):
        rgb = decode_radiance_hdr(data)
    else:
        if sniff(data) == "SPIDER":  # imageio's Pillow plugin seeks past the first frame and fails
            raise ValueError(f"{path}: a SPIDER sky, which the JAX package's imageio cannot read either")
        rgb = decode_float_samples(data)
        if rgb is not None:
            rgb = np.repeat(rgb, 3, axis=2) if rgb.shape[2] == 1 else rgb[..., :3]
    if rgb is not None:
        rgb = rgb[::-1]  # flip: row 0 = bottom, so v=1-acos(y)/pi maps up to sky
        if tone_encode:
            rgb = np.clip(rgb, 0.0, 1.0) ** (1.0 / 2.2)
        return np.ascontiguousarray(rgb.astype(np.float32))
    px, _ = decode_image(data)
    rgb = px[..., :3] if px.shape[2] >= 3 else np.repeat(px[..., :1], 3, axis=2)
    rgb = rgb[::-1].astype(np.float32) / 255.0
    if not tone_encode:
        rgb = rgb ** 2.2
    return np.ascontiguousarray(rgb.astype(np.float32))


def load_obj_scene(scene, obj_path: str, mtl_path: str | None = None,
                   transform=None) -> list[TriangleMesh]:
    """Load an OBJ+MTL into a Scene: registers texture files (deduplicated
    by path, parity with create_scene.cppm:75-136) and adds the meshes."""
    meshes = load_obj_mtl(obj_path, mtl_path)
    cache: dict[str, int] = {}

    def resolve(ref, grayscale=False):
        if ref is None or isinstance(ref, int):
            return ref
        if ref not in cache:
            if not os.path.exists(ref):
                log.warning("texture not found: %s", ref)
                cache[ref] = None
            else:
                cache[ref] = scene.add_texture(load_texture_file(ref, grayscale))
        return cache[ref]

    for m in meshes:
        mat = m.material
        mat.color_map = resolve(mat.color_map)
        mat.specular_map = resolve(mat.specular_map, grayscale=True)
        mat.metallic_map = resolve(mat.metallic_map, grayscale=True)
        mat.opacity_map = resolve(mat.opacity_map, grayscale=True)
        if transform is not None:
            m.transform = np.asarray(transform, np.float32) @ m.transform
        scene.add(m)
    return meshes
