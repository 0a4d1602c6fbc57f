"""Textures and asset loading of the PyTorch port against the JAX package.

Held here: the port's PNG codec (realtimeraytracer_torch/utils/png.py)
against Pillow in both directions; texture files, the Radiance HDR codec
and the OBJ/MTL loader against the JAX package on textured_obj's fixture
files (the JAX side with its pure-Python OBJ parser); the atlas samplers
against JAX on seeded uvs; resolve_surface's texture branch; the compiled
texture and alpha-mask leaves of textured_obj and of a baked
foliage_field against the JAX compile (NumPy BVH builder on both sides);
a 32x32 alpha-tested frame of each scene against JAX's; and, in a
subprocess, that the port imports no Pillow.

The JAX frames take its brute-force route, the alpha ladder over exact
all-pairs traces (its hybrid route in interpret mode takes about 90 s per
frame on the CPU; the hybrid ladders are held trace by trace in
tests/test_torch_alpha.py).  The port's hybrid frame with its in-kernel
masks off computes the same thing and is held to it on both scenes, and
on textured_obj so is its default, masked frame; these frames take one
ladder round (alpha_rounds=1), which halves the JAX frame's compile.  On
the dense foliage, rays that exhaust the unmasked ladder resolve further
with masks (PARITY.md, round-5 notes; ROADMAP queue C): 1.7% of values
differ there at the default 4 rounds.  So the masked frame is held to the
unmasked one at alpha_rounds=16, where no ray exhausts the ladder.

Tolerances: PNG pixels, decoded textures, HDR arrays, loader arrays and
compiled leaves are equal (the same integer and NumPy float32 arithmetic);
samples and surfaces rtol 1e-5, atol 1e-6 (XLA on the CPU contracts the
lerps' multiply-adds into FMAs, the port does not); frames by the rule of
tests/test_torch_slice.py (no NaN, under 0.5% of values off by > 2e-3).
"""

import io
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from PIL import Image

import realtimeraytracer_tpu as jax_rt

import realtimeraytracer_tpu.scene.obj_loader as jax_obj
import realtimeraytracer_tpu.utils.native as jax_native
from realtimeraytracer_tpu import scenes as jax_scenes
from realtimeraytracer_tpu.ops import texture as jax_texture
from realtimeraytracer_tpu.ops.intersect import HitRecord as JaxHit
from realtimeraytracer_tpu.render.megakernel import render_components as jax_components
from realtimeraytracer_tpu.render.pipeline import denoise_and_combine as jax_combine
from realtimeraytracer_tpu.render.surface import resolve_surface as jax_resolve_surface
from realtimeraytracer_tpu.scene.scene import Scene as JaxScene
import realtimeraytracer_torch as rt
from realtimeraytracer_torch import scenes
from realtimeraytracer_torch.ops import texture
from realtimeraytracer_torch.ops.intersect import HitRecord
from realtimeraytracer_torch.render.alpha import wrap_backend_with_alpha
from realtimeraytracer_torch.render.backends import make_hybrid_backend
from realtimeraytracer_torch.render.megakernel import render_components
from realtimeraytracer_torch.render.pipeline import denoise_and_combine
from realtimeraytracer_torch.render.surface import resolve_surface
from realtimeraytracer_torch.scene import obj_loader
from realtimeraytracer_torch.scene.gpu_scene import from_numpy_leaves
from realtimeraytracer_torch.utils import png
from realtimeraytracer_torch.utils.image_io import to_uint8, write_png

torch.set_num_threads(2)

MODES = {1: "L", 3: "RGB", 4: "RGBA"}
PNGS = ("ground_kd.png", "ground_ks.png", "leaf_kd.png", "leaf_d.png", "pillar_pm.png")
# foliage_field at 12k triangles: the smallest target above its 8,192
# terrain triangles that instances foliage (at 8k it places no plants).
FOLIAGE_TRIS = 12_000


def _pure_python_obj(monkeypatch):
    """Route the JAX loader to its pure-Python OBJ parser (the port has no
    native tokenizer yet) and the JAX compile to its NumPy BVH builder."""
    def no_native(path):
        raise RuntimeError("native OBJ tokenizer disabled")
    monkeypatch.setattr(jax_obj, "_parse_obj_native", no_native)
    monkeypatch.setattr(jax_native, "native_build_bvh", lambda *a, **k: None)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """textured_obj's files as each package writes them, and both scenes."""
    mp = pytest.MonkeyPatch()
    _pure_python_obj(mp)
    jdir, tdir = tmp_path_factory.mktemp("jax_obj"), tmp_path_factory.mktemp("torch_obj")
    jscene, tscene = jax_scenes.textured_obj(str(jdir)), scenes.textured_obj(str(tdir))
    jleaves = {k: np.asarray(v) for k, v in jscene.compile()._asdict().items()
               if v is not None}
    mp.undo()
    return str(jdir), str(tdir), jscene, tscene, jleaves


def _pil(data: bytes) -> np.ndarray:
    img = np.asarray(Image.open(io.BytesIO(data)))
    return img if img.ndim == 3 else img[..., None]


@pytest.mark.parametrize("channels", sorted(MODES))
@pytest.mark.parametrize("filters", [None, (0, 1, 2, 3, 4)])
def test_png_codec_matches_pil(channels, filters):
    """Random 8-bit images: the port's PNGs decode in Pillow to the same
    pixels (every row filter on the second pass), and Pillow's PNGs decode
    in the port to the same pixels."""
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (29, 37, channels), dtype=np.uint8)
    np.testing.assert_array_equal(_pil(png.encode_png(img, filters)), img)
    np.testing.assert_array_equal(png.decode_png(png.encode_png(img, filters)), img)
    buf = io.BytesIO()
    Image.fromarray(img[..., 0] if channels == 1 else img, MODES[channels]).save(
        buf, format="PNG", optimize=filters is not None)
    np.testing.assert_array_equal(png.decode_png(buf.getvalue()), img)


def test_png_refuses_what_it_cannot_read():
    img = np.zeros((4, 4, 3), np.uint8)
    cases = {}
    for mode, arr in (("P", img[..., 0]), ("LA", img[..., :2]), ("I;16", img[..., 0].astype(np.uint16))):
        buf = io.BytesIO()
        Image.fromarray(arr, mode).save(buf, format="PNG")
        cases[mode] = buf.getvalue()
    good = png.encode_png(img)
    ihdr = png.struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 1)        # Adam7
    cases["interlaced"] = good[:8] + png._chunk(b"IHDR", ihdr) + good[33:]
    cases["bad crc"] = good[:29] + bytes([good[29] ^ 1]) + good[30:]
    cases["not a png"] = b"GIF89a" + good[6:]
    for what, data in cases.items():
        with pytest.raises(ValueError):
            png.decode_png(data)
    with pytest.raises(ValueError):
        png.encode_png(img.astype(np.float32))


def test_fixture_pngs_match_pil(fixtures):
    """textured_obj's PNG fixtures: the port's files hold the pixels of the
    JAX package's (written by Pillow), and the port decodes Pillow's."""
    jdir, tdir, *_ = fixtures
    for name in PNGS:
        with open(os.path.join(jdir, name), "rb") as f:
            jax_bytes = f.read()
        with open(os.path.join(tdir, name), "rb") as f:
            port_bytes = f.read()
        np.testing.assert_array_equal(_pil(port_bytes), _pil(jax_bytes), err_msg=name)
        np.testing.assert_array_equal(png.decode_png(jax_bytes), _pil(jax_bytes), err_msg=name)


@pytest.mark.parametrize("grayscale", [False, True])
def test_load_texture_file_matches_jax(fixtures, tmp_path, grayscale):
    """Every fixture, plus random RGB and grey files (Pillow's grey
    conversion rounds (R*19595 + G*38470 + B*7471 + 2^15) >> 16)."""
    jdir, *_ = fixtures
    rng = np.random.default_rng(4)
    paths = [os.path.join(jdir, n) for n in PNGS]
    for name, arr in (("rgb.png", rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)),
                      ("rgba.png", rng.integers(0, 256, (9, 11, 4), dtype=np.uint8)),
                      ("grey.png", rng.integers(0, 256, (9, 11), dtype=np.uint8))):
        Image.fromarray(arr).save(tmp_path / name)
        paths.append(str(tmp_path / name))
    for path in paths:
        want = jax_obj.load_texture_file(path, grayscale)
        got = obj_loader.load_texture_file(path, grayscale)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


def test_hdr_codec_matches_jax(fixtures, tmp_path):
    """Flat RGBE from encode_radiance_hdr, and a new-style RLE scanline
    file with a run, decode and load as in JAX."""
    jdir, tdir, *_ = fixtures
    for name in ("sky.hdr",):
        with open(os.path.join(jdir, name), "rb") as f:
            jax_bytes = f.read()
        with open(os.path.join(tdir, name), "rb") as f:
            assert f.read() == jax_bytes
        np.testing.assert_array_equal(obj_loader.decode_radiance_hdr(jax_bytes),
                                      jax_obj.decode_radiance_hdr(jax_bytes))
        np.testing.assert_array_equal(obj_loader.load_hdr(os.path.join(jdir, name)),
                                      jax_obj.load_hdr(os.path.join(jdir, name)))
    w = 12
    rng = np.random.default_rng(2)
    lines = b""
    for _ in range(3):
        lines += bytes([2, 2, 0, w])
        for c in range(4):
            vals = rng.integers(100, 140, w).astype(np.uint8)
            lines += bytes([130, int(vals[0])]) + bytes([w - 2]) + vals[2:].tobytes()
    data = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+Y 3 +X 12\n" + lines
    np.testing.assert_array_equal(obj_loader.decode_radiance_hdr(data),
                                  jax_obj.decode_radiance_hdr(data))
    sky = scenes.make_sky_gradient(8, 16)
    assert obj_loader.encode_radiance_hdr(sky) == jax_obj.encode_radiance_hdr(sky)


def test_obj_mtl_loader_matches_jax(fixtures, monkeypatch):
    _pure_python_obj(monkeypatch)
    jdir, *_ = fixtures
    obj, mtl = os.path.join(jdir, "scene.obj"), os.path.join(jdir, "scene.mtl")
    assert {k: vars(v) for k, v in obj_loader.parse_mtl(mtl).items()} == \
        {k: vars(v) for k, v in jax_obj.parse_mtl(mtl).items()}
    got, want = obj_loader.load_obj_mtl(obj), jax_obj.load_obj_mtl(obj)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.name == w.name and vars(g.material) == vars(w.material)
        for field in ("vertices", "faces", "normals", "uvs", "transform"):
            np.testing.assert_array_equal(getattr(g, field), getattr(w, field), err_msg=field)
    g, w = obj_loader.load_obj(obj), jax_obj.load_obj(obj)
    for field in ("vertices", "faces", "normals", "uvs"):
        np.testing.assert_array_equal(getattr(g, field), getattr(w, field), err_msg=field)


def test_textured_obj_scene_matches_jax(fixtures):
    """load_obj_scene through textured_obj: materials, texture ids (deduped
    by path), textures and the HDR sky."""
    _, _, jscene, tscene, _ = fixtures
    assert len(tscene.meshes) == len(jscene.meshes) == 4
    for g, w in zip(tscene.meshes, jscene.meshes):
        m = vars(g.material)
        assert {k: m[k] for k in m} == vars(w.material)
    assert len(tscene.textures) == len(jscene.textures) == 5
    for g, w in zip(tscene.textures, jscene.textures):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tscene.hdri, jscene.hdri)


@pytest.fixture(scope="module")
def atlas():
    """Three textures of different true sizes padded into one atlas."""
    rng = np.random.default_rng(6)
    s = JaxScene()
    for h, w in ((13, 20), (32, 7), (5, 5)):
        s.add_texture(rng.random((h, w, 3)).astype(np.float32))
    from realtimeraytracer_tpu.scene.scene import _pack_textures as jax_pack
    from realtimeraytracer_torch.scene.scene import _pack_textures

    want = jax_pack(s.textures)
    got = _pack_textures(s.textures)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    return got


def test_pack_atlas_neighbors_matches_jax(atlas):
    a, sizes = atlas
    np.testing.assert_array_equal(texture.pack_atlas_neighbors_np(a, sizes),
                                  jax_texture.pack_atlas_neighbors_np(a, sizes))


@pytest.mark.parametrize("packed", [False, True])
def test_sample_atlas_matches_jax(atlas, packed):
    """Seeded uvs in [-1.5, 2.5) (repeat wrap on each true extent), ids in
    [-1, 3) (-1 samples texture 0, as in JAX)."""
    a, sizes = atlas
    rng = np.random.default_rng(8)
    n = 4000
    tid = rng.integers(-1, 3, n).astype(np.int32)
    u, v = (rng.uniform(-1.5, 2.5, n).astype(np.float32) for _ in range(2))
    if packed:
        table = texture.pack_atlas_neighbors_np(a, sizes)
        want = jax_texture.sample_atlas_packed(jnp.asarray(table), jnp.asarray(sizes),
                                               *(jnp.asarray(x) for x in (tid, u, v)))
        got = texture.sample_atlas_packed(torch.from_numpy(table), torch.from_numpy(sizes),
                                          *(torch.from_numpy(x) for x in (tid, u, v)))
    else:
        want = jax_texture.sample_atlas(jnp.asarray(a), jnp.asarray(sizes),
                                        *(jnp.asarray(x) for x in (tid, u, v)))
        got = texture.sample_atlas(torch.from_numpy(a), torch.from_numpy(sizes),
                                   *(torch.from_numpy(x) for x in (tid, u, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        texture.sample_atlas(torch.from_numpy(a), torch.from_numpy(sizes),
                             *(torch.from_numpy(x) for x in (tid, u, v))).numpy(),
        texture.sample_atlas_packed(torch.from_numpy(texture.pack_atlas_neighbors_np(a, sizes)),
                                    torch.from_numpy(sizes),
                                    *(torch.from_numpy(x) for x in (tid, u, v))).numpy(),
        rtol=0, atol=0)


def _compare_leaves(got: dict, want: dict, required: tuple):
    for key in required:
        assert key in got and key in want, key
    assert set(got) <= set(want)
    for key, g in got.items():
        w = want[key]
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


TEXTURE_LEAVES = ("tex_atlas", "tex_size", "tex_atlas_packed", "obj_tex",
                  "pallas_amask", "q_amask")


def test_textured_obj_leaves_match_jax(fixtures):
    _, _, _, tscene, jleaves = fixtures
    got = tscene.compile_leaves()
    assert got["faces"].shape[0] == 1450 and got["pallas_panels"].shape[0] == 12
    _compare_leaves(got, jleaves, TEXTURE_LEAVES)


def test_baked_foliage_leaves_match_jax(monkeypatch):
    monkeypatch.setattr(jax_native, "native_build_bvh", lambda *a, **k: None)
    jax_gpu = jax_scenes.foliage_field(target_tris=FOLIAGE_TRIS).compile(bake_instances=True)
    want = {k: np.asarray(v) for k, v in jax_gpu._asdict().items() if v is not None}
    scene = scenes.foliage_field(target_tris=FOLIAGE_TRIS)
    assert scene.instances
    assert "inst_inv" in scene.compile_leaves()     # the shared-geometry form
    got = scene.compile_leaves(bake_instances=True)
    assert "inst_inv" not in got
    assert (got["pallas_amask"] != -1).any()       # some cells are transparent
    _compare_leaves(got, want, TEXTURE_LEAVES)
    ts = from_numpy_leaves(want)
    assert ts.has_textures and ts.q_amask.shape == want["q_amask"].shape


def test_surface_textures_match_jax(fixtures):
    """resolve_surface on textured_obj: seeded rays and hits (every object,
    so every map), JAX leaves on both sides."""
    _, _, jscene, _, jleaves = fixtures
    tgpu = from_numpy_leaves(jleaves)
    rng = np.random.default_rng(12)
    n = 600
    prim = rng.integers(-1, tgpu.num_tris, n).astype(np.int32)
    f = jleaves["faces"][np.clip(prim, 0, None)]
    w = rng.dirichlet((1, 1, 1), n).astype(np.float32)
    p = (jleaves["vertices"][f] * w[..., None]).sum(1)
    o = (p + rng.normal(0, 1, (n, 3)) * 2 + np.array([0, 3, 0])).astype(np.float32)
    d = (p - o) / np.linalg.norm(p - o, axis=1, keepdims=True)
    t = np.linalg.norm(p - o, axis=1).astype(np.float32)
    z = np.zeros(n, np.float32)
    from realtimeraytracer_tpu.scene.gpu_scene import GPUScene

    jgpu = GPUScene(**{k: jnp.asarray(v) for k, v in jleaves.items()})
    want = jax_resolve_surface(jgpu, JaxHit(*(jnp.asarray(x) for x in (t, prim, z, z))),
                               jnp.asarray(o), jnp.asarray(d.astype(np.float32)))
    got = resolve_surface(tgpu, HitRecord(*(torch.from_numpy(x) for x in (t, prim, z, z))),
                          torch.from_numpy(o), torch.from_numpy(d.astype(np.float32)))
    textured = jleaves["obj_tex"][jleaves["face_obj"][np.clip(prim, 0, None)]][:, :3] >= 0
    assert textured.any(axis=1).sum() > 100
    for key in ("albedo", "roughness", "metallic", "light_color", "uv", "valid"):
        np.testing.assert_allclose(getattr(got, key).numpy(), np.asarray(getattr(want, key)),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


def test_write_png_roundtrip(tmp_path):
    img = np.random.default_rng(1).random((6, 5, 3)).astype(np.float32)
    write_png(str(tmp_path / "a.png"), torch.from_numpy(img))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")), to_uint8(img))


def test_port_needs_no_pillow():
    """With Pillow made unimportable, every module of the port imports,
    textured_obj writes and loads its PNGs and compiles; nothing imported
    PIL."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        class NoPil:
            def find_spec(self, name, path=None, target=None):
                if name == "PIL" or name.startswith("PIL."):
                    raise ImportError("Pillow is not available")
        sys.meta_path.insert(0, NoPil())
        import realtimeraytracer_torch as rt
        for m in pkgutil.walk_packages(rt.__path__, "realtimeraytracer_torch."):
            importlib.import_module(m.name)
        from realtimeraytracer_torch import scenes
        gpu = scenes.textured_obj().compile()
        assert gpu.has_textures and gpu.pallas_amask is not None
        assert not any(k == "PIL" or k.startswith("PIL.") for k in sys.modules)
        assert not any(k == "jax" or k.startswith("realtimeraytracer_tpu") for k in sys.modules)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _frame_cfg(module, backend, rounds=1):
    return module.RenderConfig(width=32, height=32, primary_rays=1, shadow_rays=1,
                               denoise_iterations=2, alpha_test=True, alpha_rounds=rounds,
                               backend=backend)


def _port_frame(tgpu, frame, cfg, masks=True):
    backend = None
    if not masks:
        backend = wrap_backend_with_alpha(make_hybrid_backend(tgpu, cfg, use_amask=False),
                                          tgpu, cfg)
    with torch.inference_mode():
        return denoise_and_combine(render_components(tgpu, frame, cfg, 0, backend), cfg).numpy()


def _rule(got, want):
    assert got.shape == want.shape and want.std() > 0
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert (np.abs(got - want) > 2e-3).mean() < 5e-3


@pytest.fixture(scope="module", params=["textured_obj", "foliage_field"])
def alpha_frames(request, fixtures):
    """JAX's brute-force alpha frame and the port's frames on the same
    compiled scene: default route, and hybrid with the masks off."""
    if request.param == "textured_obj":
        _, _, jscene, tscene, jleaves = fixtures
    else:
        mp = pytest.MonkeyPatch()
        mp.setattr(jax_native, "native_build_bvh", lambda *a, **k: None)
        jscene = jax_scenes.foliage_field(target_tris=FOLIAGE_TRIS)
        jleaves = {k: np.asarray(v) for k, v in jscene.compile(bake_instances=True)
                   ._asdict().items() if v is not None}
        mp.undo()
        tscene = scenes.foliage_field(target_tris=FOLIAGE_TRIS)
    from realtimeraytracer_tpu.scene.gpu_scene import GPUScene

    jgpu = GPUScene(**{k: jnp.asarray(v) for k, v in jleaves.items()})
    jcfg = _frame_cfg(jax_rt, "brute")
    comp = jax.jit(lambda g, f: jax_components(g, f, jcfg, 0))(
        jgpu, jscene.camera.viewport_frame(32, 32))
    want = np.asarray(jax.jit(lambda c: jax_combine(c, jcfg))(comp))
    tgpu = from_numpy_leaves(jleaves)
    frame = tscene.camera.viewport_frame(32, 32)
    cfg = _frame_cfg(rt, "auto")
    return request.param, tgpu, frame, want, _port_frame(tgpu, frame, cfg), \
        _port_frame(tgpu, frame, cfg, masks=False)


def test_alpha_frame_matches_jax(alpha_frames):
    """The port's hybrid alpha frame with masks off against JAX's; on
    textured_obj its default, masked frame too."""
    name, _, _, want, masked, unmasked = alpha_frames
    _rule(unmasked, want)
    if name == "textured_obj":
        _rule(masked, want)


def test_masks_change_only_exhausted_rays(alpha_frames):
    """With a ladder no ray exhausts, the masked default route renders the
    unmasked frame."""
    _, tgpu, frame, *_ = alpha_frames
    cfg = _frame_cfg(rt, "auto", rounds=16)
    _rule(_port_frame(tgpu, frame, cfg), _port_frame(tgpu, frame, cfg, masks=False))
