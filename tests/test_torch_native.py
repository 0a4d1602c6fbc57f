"""The native host library of the PyTorch port against the JAX package.

Held here: utils/native.py (the binned-SAH and Morton LBVH builders and the
OBJ tokenizer of native/, built with native/Makefile's compiler and flags
into the port's build directory) against JAX's utils/native.py; the
default scene compile, which now builds its BVHs natively, against JAX's
default compile with no patch on either side; the fallback (the NumPy
builders only without a C++ compiler, with a warning; a failed build
raises); packed camera ray blocks (ops/camera_rays.py::
generate_ray_blocks) against JAX's and, through the v9 twin, against
generate_rays in block order; the demo CLI's render and fit against JAX's
scripts/demo.py on its brute-force route.

Tolerances: BVH nodes and orders, compiled leaves, parsed OBJ arrays and
ray-block origins and masks are equal (one library, byte for byte, on
both sides, and the same NumPy float32 arithmetic); ray-block directions
within 2e-7 (XLA on the CPU contracts the viewport's multiply-adds into
FMAs, the port does not); v9 hits on the two ray layouts: hit masks equal,
then the same id or the same t (ROADMAP queue C), t rtol 1e-5 (the two
layouts normalize with rsqrt and with a division); the demo's frame under
0.5% of values off by more than 2e-3, its fit losses and albedo error
rtol 1e-4 (float32 shading on two libraries, three Adam steps).
"""

import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import realtimeraytracer_tpu as jax_rt
import realtimeraytracer_tpu.scene.obj_loader as jax_obj
import realtimeraytracer_tpu.utils.native as jax_native
from realtimeraytracer_tpu import scenes as jax_scenes
from realtimeraytracer_tpu.diff.optimize import fit as jax_fit
from realtimeraytracer_tpu.ops import camera_rays as jax_cam
from realtimeraytracer_tpu.ops import refit as jax_refit
from realtimeraytracer_tpu.render.backends import make_backend as jax_make_backend
from realtimeraytracer_tpu.render.megakernel import shade_sample as jax_shade_sample
from realtimeraytracer_torch import demo, scenes
from realtimeraytracer_torch.ops import bvh as port_bvh
from realtimeraytracer_torch.ops import camera_rays, refit
from realtimeraytracer_torch.render import v7_backend as v7
from realtimeraytracer_torch.render.backends import trace_primary_blocks
from realtimeraytracer_torch.scene import obj_loader
from realtimeraytracer_torch.scene.gpu_scene import alpha_subset_amask, from_numpy_leaves
from realtimeraytracer_torch.utils import log, native
from realtimeraytracer_torch.utils.image_io import read_png, to_uint8

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _soup(n):
    """procedural_mesh(n)'s triangle soup (its largest mesh)."""
    mesh = max(scenes.procedural_mesh(n).meshes, key=lambda m: len(m.faces))
    v, f = mesh.vertices.astype(np.float32), mesh.faces
    return v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]


def _equal_trees(got, want):
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
        assert g.dtype == w.dtype, name


@pytest.mark.parametrize("builder", ["sah", "lbvh"])
def test_native_bvh_matches_jax(builder):
    """Node for node and order for order; the native LBVH is also the
    port's NumPy build_bvh."""
    soup = _soup(5_000)
    got = native.native_build_bvh(*soup, 4, builder=builder)
    _equal_trees(got, jax_native.native_build_bvh(*soup, 4, builder=builder))
    if builder == "lbvh":
        _equal_trees(got, port_bvh.build_bvh(*soup, leaf_size=4))
    else:
        assert not np.array_equal(got.tri_id, port_bvh.build_bvh(*soup, leaf_size=4).tri_id)


def _port_textured(tokenizer, monkeypatch, d):
    if tokenizer == "python":
        monkeypatch.setattr(obj_loader, "_parse_obj_native",
                            lambda path: pytest.fail("the native tokenizer was called"))
        real = obj_loader.parse_obj
        monkeypatch.setattr(obj_loader, "parse_obj",
                            lambda path, allow_native=True: real(path, allow_native=False))
    return scenes.textured_obj(str(d))


@pytest.mark.parametrize("name", ["procedural_mesh", "cornell_box", "textured_obj-native",
                                  "textured_obj-python", "foliage_field"])
def test_default_compile_matches_jax(name, monkeypatch, tmp_path):
    """No patch on either side: both compiles build their BVHs natively
    (the instanced foliage: each unique mesh above 128 triangles)."""
    if name.startswith("textured_obj"):
        jscene = jax_scenes.textured_obj(str(tmp_path / "jax"))
        tscene = _port_textured(name.split("-")[1], monkeypatch, tmp_path / "torch")
    else:
        args = {"procedural_mesh": (2_000,), "cornell_box": (),
                "foliage_field": (20_000,)}[name]
        jscene, tscene = getattr(jax_scenes, name)(*args), getattr(scenes, name)(*args)
    want = {k: np.asarray(v) for k, v in jscene.compile()._asdict().items() if v is not None}
    got = tscene.compile_leaves()
    # The port's own leaf, the alpha subset's masks (ROADMAP queue C): what
    # the split builds from JAX's leaves.
    own = got.pop("pallas_amask_alp", None)
    assert (own is None) == ("pallas_panels_alp" not in want)
    if own is not None:
        np.testing.assert_array_equal(own, alpha_subset_amask(from_numpy_leaves(want)).numpy())
    assert set(got) <= set(want)
    for key, g in got.items():
        assert g.dtype == want[key].dtype, key
        np.testing.assert_array_equal(g, want[key], err_msg=key)
    if name == "foliage_field":
        assert "inst_inv" in got


def test_sah_tree_invariants_and_refit_ranges():
    """The SAH tree of the default compile is a DFS pre-order tree with
    skip links: each node box bounds the triangles of its subtree, a skip
    link jumps exactly the subtree, the leaves cover the sorted triangles
    in order; ops/refit.py::subtree_ranges reads it unchanged."""
    g = scenes.procedural_mesh(2_000).compile_leaves()
    first, count, skip = g["bvh_node_first"], g["bvh_node_count"], g["bvh_node_skip"]
    n = len(first)
    leaves = np.nonzero(count > 0)[0]
    np.testing.assert_array_equal(first[leaves], np.concatenate([[0], np.cumsum(count[leaves])[:-1]]))
    assert count.sum() == len(g["faces"])
    ns, ne = refit.subtree_ranges(first, count, skip)
    np.testing.assert_array_equal(ns, g["bvh_node_tri_start"])
    np.testing.assert_array_equal(ne, g["bvh_node_tri_end"])
    tris = np.stack([g["bvh_tri_v0"], g["bvh_tri_v1"], g["bvh_tri_v2"]], 1)
    for i in range(n):
        assert i < skip[i] <= n
        sub = leaves[(leaves >= i) & (leaves < skip[i])]
        assert ns[i] == first[sub].min() and ne[i] == (first[sub] + count[sub]).max()
        pts = tris[ns[i]:ne[i]].reshape(-1, 3)
        assert (pts >= g["bvh_node_min"][i]).all() and (pts <= g["bvh_node_max"][i]).all()
        if count[i] == 0:     # an internal node: its first child follows it
            assert skip[i + 1] < skip[i] or skip[i + 1] == skip[i] == n


def test_apply_transforms_on_sah_scene_matches_jax():
    jg = jax_scenes.procedural_mesh(2_000).compile()
    tg = scenes.procedural_mesh(2_000).compile()
    np.testing.assert_array_equal(tg.faces.numpy(), np.asarray(jg.faces))
    last = tg.obj_color.shape[0] - 1
    table = refit.translate(refit.identity_transforms(tg), last, (0.3, -0.2, 0.5))
    table[0, :3, :3] = torch.tensor([[0.0, -1.5, 0.0], [1.5, 0.0, 0.0], [0.0, 0.0, 1.5]])
    jt = jnp.asarray(table.numpy())
    want = jax.jit(jax_refit.apply_transforms)(jg, jt)
    got = refit.apply_transforms(tg, table)
    for name in ("vertices", "bvh_tri_v0", "bvh_node_min", "bvh_node_max", "pallas_panels",
                 "pallas_cl_min", "pallas_cl_max"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


# Polygons, negative indices, no vt / vn, o / g / usemtl / mtllib.
OBJ = """# the two tokenizers agree on this one
mtllib one.mtl
mtllib two.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 0.5 1
v 2 0 0
f 1 2 3 4
o first
usemtl red
f 1 2 5
f -6 -5 -4 -3 -2
g second
f 2 6 3
usemtl blue
f -1 -2 -3
o third
f 3 4 5
"""
# Where JAX's two tokenizers differ (ROADMAP queue C): the native one
# names a shape by the first word after o / g and keeps the first file of
# an mtllib line; the Python one joins the words and keeps every file.
OBJ_DIVERGENT = """mtllib one.mtl two.mtl
v 0 0 0
v 1 0 0
v 1 1 0
o a shape
f 1 2 3
g another part
f -1 -2 -3
"""


def _parsed(result):
    pos, uv, nrm, shapes, mtllibs = result
    return (pos, uv, nrm, [(s.name, s.material, [tuple(map(tuple, t)) for t in s.faces])
                           for s in shapes], mtllibs)


def _same(a, b):
    for k in range(3):
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    assert a[3:] == b[3:]


@pytest.mark.parametrize("text", ["common", "divergent"])
def test_parse_obj_native_matches_python_and_jax(tmp_path, text):
    path = str(tmp_path / "fixture.obj")
    with open(path, "w") as f:
        f.write(OBJ if text == "common" else OBJ_DIVERGENT)
    got = {native_: _parsed(obj_loader.parse_obj(path, allow_native=native_))
           for native_ in (True, False)}
    for native_ in (True, False):
        _same(got[native_], _parsed(jax_obj.parse_obj(path, allow_native=native_)))
    assert got[True][1].shape == (0, 2) and got[True][2].shape == (0, 3)
    if text == "common":
        _same(got[True], got[False])
        assert len(got[True][3]) == 5 and got[True][4] == ["one.mtl", "two.mtl"]
    else:
        assert [s[0] for s in got[True][3]] == ["a", "another"]
        assert [s[0] for s in got[False][3]] == ["a shape", "another part"]
        assert got[True][4] == ["one.mtl"] and got[False][4] == ["one.mtl", "two.mtl"]
    with pytest.raises(FileNotFoundError):
        obj_loader.parse_obj(str(tmp_path / "missing.obj"))


@pytest.fixture
def fresh_library(monkeypatch, tmp_path):
    """A process that has not loaded the library yet, building into a
    scratch directory; the log's messages."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    messages = []
    monkeypatch.setattr(log, "_sink", messages.append)
    return messages


def test_no_compiler_falls_back_with_a_warning(fresh_library, monkeypatch, tmp_path):
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert native.native_build_bvh(*_soup(600)) is None
    assert any("warn" in m and "no C++ compiler" in m for m in fresh_library)
    with pytest.raises(RuntimeError, match="not available"):
        native.NativeObj(os.devnull)
    got = scenes.procedural_mesh(600).compile_leaves()
    v, f = got["vertices"], got["faces"]
    want = port_bvh.build_bvh(v[f[:, 0]], v[f[:, 1]], v[f[:, 2]], leaf_size=4)
    np.testing.assert_array_equal(got["bvh_node_skip"], want.node_skip)
    np.testing.assert_array_equal(want.tri_id, np.arange(len(f)))   # faces already in its order
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("failure", ["compile", "load"])
def test_a_failed_build_raises(fresh_library, monkeypatch, tmp_path, failure):
    """A compiler that fails, or writes a file that does not load: no
    fallback, the error carries the compiler's stderr."""
    cxx = tmp_path / "fake-c++"
    action = ('echo "fake-c++: cannot compile bvh_sah.cpp" >&2; exit 1' if failure == "compile"
              else 'while [ "$1" != -o ]; do shift; done; echo not-a-library > "$2"')
    cxx.write_text(f'#!/bin/sh\nif [ "$1" = --version ]; then echo fake-c++ 1.0; exit 0; fi\n'
                   f'{action}\n')
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    match = "cannot compile bvh_sah.cpp" if failure == "compile" else "cannot load"
    with pytest.raises(RuntimeError, match=match):
        native.native_build_bvh(*_soup(600))
    with pytest.raises(RuntimeError, match=match):
        scenes.procedural_mesh(600).compile_leaves()
    assert not any(p.name.endswith(".tmp") for p in (tmp_path / "build").iterdir())


def test_library_name_hashes_sources_and_flags(monkeypatch, tmp_path):
    cxx = native._compiler()
    assert cxx is not None
    name = native.library_path(cxx).name
    assert name.startswith("librtrt_native-") and name.endswith(".so")
    copy = tmp_path / "native"
    shutil.copytree(os.path.join(ROOT, "native"), copy)
    monkeypatch.setattr(native, "NATIVE_DIR", copy)
    assert native.library_path(cxx).name == name
    with open(copy / "bvh_sah.cpp", "a") as f:
        f.write("\n")
    edited = native.library_path(cxx).name
    assert edited != name
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS[:-2] + ("-shared",))
    assert native.library_path(cxx).name not in (name, edited)


def _frames(w, h):
    return (jax_scenes.procedural_mesh(300).camera.viewport_frame(w, h),
            scenes.procedural_mesh(300).camera.viewport_frame(w, h))


@pytest.mark.parametrize("jitter", [True, False])
@pytest.mark.parametrize("sample", [0, 7, 2**31 + 5])
def test_generate_ray_blocks_matches_jax(jitter, sample):
    """40x20 does not divide into 16x8 blocks: the out-of-image lanes'
    intervals are empty in both."""
    jf, tf = _frames(40, 20)
    want = np.asarray(jax_cam.generate_ray_blocks(jf, 40, 20, sample_index=sample, jitter=jitter))
    got = camera_rays.generate_ray_blocks(tf, 40, 20, sample_index=sample, jitter=jitter)
    assert got.dtype == torch.float32 and got.shape == want.shape == (9, 8, 128)
    got = got.numpy()
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    np.testing.assert_allclose(got[:, 3:6], want[:, 3:6], rtol=0, atol=2e-7)
    np.testing.assert_array_equal(got[:, 6:], want[:, 6:])
    assert (got[:, 6] == 3e38).sum() == 9 * 128 - 800


def test_ray_blocks_through_v9_twin_match_generate_rays():
    """The thin slice (blocks, then v9) against generate_rays in block
    order through the same twin, pixel by pixel."""
    w, h = 40, 20
    gpu = scenes.procedural_mesh(2_000).compile()
    assert gpu.q_panels is not None
    tf = _frames(w, h)[1]
    blocks = camera_rays.generate_ray_blocks(tf, w, h, sample_index=3)
    of, oi = trace_primary_blocks(gpu, blocks)
    g4 = np.mgrid[0:3, 0:3, 0:8, 0:16]
    px, py = (g4[1] * 16 + g4[3]).reshape(-1), (g4[0] * 8 + g4[2]).reshape(-1)
    valid = (px < w) & (py < h)
    pix = (py * w + px)[valid]
    t_b = np.empty(w * h, np.float32)
    i_b = np.empty(w * h, np.int32)
    t_b[pix], i_b[pix] = of[:, 0].reshape(-1).numpy()[valid], oi[:, 0].reshape(-1).numpy()[valid]

    o, d = camera_rays.generate_rays(tf, w, h, sample_index=3)
    perm, _ = camera_rays.block_permutation(w, h)
    r = o.shape[0]
    tiles = v7._pack_rays(o[perm], d[perm], torch.full((r,), 1e-3), torch.full((r,), 1e4))[0]
    of2, oi2 = trace_primary_blocks(gpu, tiles)
    t_r = np.empty(w * h, np.float32)
    i_r = np.empty(w * h, np.int32)
    t_r[perm.numpy()] = of2[:, 0].reshape(-1).numpy()[:r]
    i_r[perm.numpy()] = oi2[:, 0].reshape(-1).numpy()[:r]

    hit = i_b >= 0
    np.testing.assert_array_equal(hit, i_r >= 0)
    assert hit.mean() > 0.2
    same = i_b == i_r
    np.testing.assert_allclose(t_b[hit & same], t_r[hit & same], rtol=1e-5)
    np.testing.assert_array_equal(t_b[hit & ~same], t_r[hit & ~same])


def _jax_demo():
    spec = importlib.util.spec_from_file_location("jax_demo", os.path.join(ROOT, "scripts",
                                                                           "demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_demo_render_matches_jax(tmp_path):
    """`demo render cornell` at 32x32 on the CPU: the PNG it writes and its
    image against JAX's render of scripts/demo.py's cornell entry."""
    out = tmp_path / "cornell.png"
    got = demo.cmd_render("cornell", str(out), device="cpu", size=(32, 32)).numpy()
    scene, cfg = _jax_demo().SCENES["cornell"]()
    want = np.asarray(jax_rt.render(scene, cfg.replace(width=32, height=32)))
    assert got.shape == want.shape == (32, 32, 3) and want.std() > 0
    assert np.isfinite(got).all() and (np.abs(got - want) > 2e-3).mean() < 5e-3
    np.testing.assert_array_equal(read_png(str(out)), to_uint8(got))


def test_demo_fit_matches_jax():
    """`demo fit` at 32x32, three steps, on the CPU, against the body of
    scripts/demo.py's cmd_fit at the same size and step count."""
    losses, err = demo.cmd_fit(device="cpu", size=32, steps=3)
    scene = jax_scenes.cornell_box()
    cfg = jax_rt.RenderConfig(width=32, height=32, primary_rays=1, jitter=False, shadow_rays=1,
                              denoise_iterations=0, use_bvh=False, shadow_ray_margin=0.02)
    gpu = scene.compile()
    o, d = jax_cam.generate_rays(scene.camera.viewport_frame(32, 32), 32, 32, jitter=False)
    seed = jnp.arange(o.shape[0], dtype=jnp.uint32)
    target = jax.jit(lambda g: jax_shade_sample(g, cfg, o, d, seed,
                                                jax_make_backend(g, cfg)).analytic)(gpu)
    params, want = jax_fit(gpu._replace(obj_color=gpu.obj_color * 0.4 + 0.3), cfg, o, d, seed,
                           target, param_names=("obj_color",), steps=3)
    np.testing.assert_allclose(losses, want, rtol=1e-4)
    assert losses[-1] < losses[0]
    assert err == pytest.approx(float(jnp.abs(params["obj_color"] - gpu.obj_color).mean()),
                                rel=1e-4)


def test_demo_cli_prints_usage(capsys):
    demo.main([])
    assert "python -m realtimeraytracer_torch.demo render" in capsys.readouterr().out
