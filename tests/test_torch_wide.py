"""The wide cluster backend (render/wide_backend.py), the lane traversal
(render/attic/bvh_backend.py), the traversal diagnostics
(render/diagnostics.py), the per-image denoiser (``use_pallas_denoise=False``)
and BASELINE config 3 of the PyTorch port against the JAX package.

Scenes are the JAX compile's NumPy leaves carried across
(``from_numpy_leaves``); rays come from the scene's camera or a NumPy seed.
JAX's wide traces and frames are its oracles (plain XLA, jitted on the
CPU); no test here calls ``cpu_ref``.  Tolerances: t rtol 1e-5; where the
triangle ids differ, the t agree (same id or same t); u and v atol 1e-5 on
the rays with the same id, of which at most 0.5% may reach 1e-4 (the
Baldwin-Weber u = r1.o + t r1.d - r1.A cancels terms of order 100 on the
smallest triangles, where float32 rounds at 1e-5, and XLA contracts the
products into FMAs); occlusion flags equal; the cap statistics
(``cap_clipped``, ``steps``, ``cap``) equal; frames by the frame rule (under
0.5% of values off by more than 2e-3), the config-3 golden's by its own
(at most 0.4% off by more than 2e-3, mean error under 2e-3); gradients rtol
1e-4 with atol 1e-6 x the largest entry, as tests/test_torch_diff.py; the
per-image denoiser's frame from the same components rtol and atol 1e-5.

The lane traversal takes random rays here: on a ray with a direction
component in [-1e-12, 0) the JAX version misses every box it enters after
t = 0 (its reciprocal is 0 there), which the port repairs; one test holds
the port to brute force on camera rays that have such a component and
shows JAX's misses (ROADMAP queue C).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import realtimeraytracer_tpu as jax_rt
from realtimeraytracer_tpu import scenes as jax_scenes
from realtimeraytracer_tpu.diff.optimize import radiance_loss as jax_radiance_loss
from realtimeraytracer_tpu.ops.camera_rays import generate_rays as jax_generate_rays
from realtimeraytracer_tpu.render import wide_backend as jwide
from realtimeraytracer_tpu.render.attic import bvh_backend as jlane
from realtimeraytracer_tpu.render.megakernel import RenderComponents as JaxRenderComponents
from realtimeraytracer_tpu.render.pipeline import denoise_and_combine as jax_denoise_and_combine
from realtimeraytracer_tpu.render.wavefront import render_wavefront as jax_render_wavefront
from realtimeraytracer_tpu.scene.camera import Camera as JaxCamera
from realtimeraytracer_tpu.scene.lights import AreaLight as JaxAreaLight
from realtimeraytracer_tpu.scene.materials import Material as JaxMaterial
from realtimeraytracer_tpu.scene.obj_loader import load_obj as jax_load_obj
from realtimeraytracer_tpu.scene.scene import Scene as JaxScene
import realtimeraytracer_torch as rt
from realtimeraytracer_torch import scenes
from realtimeraytracer_torch.diff.optimize import radiance_loss
from realtimeraytracer_torch.render import wide_backend as wide
from realtimeraytracer_torch.render.attic import bvh_backend as lane
from realtimeraytracer_torch.render.backends import make_backend, make_bruteforce_backend
from realtimeraytracer_torch.render.megakernel import render_components
from realtimeraytracer_torch.render.pipeline import denoise_and_combine, render_pipeline_gpu
from realtimeraytracer_torch.render.wavefront import render_wavefront
from realtimeraytracer_torch.scene.camera import Camera
from realtimeraytracer_torch.scene.gpu_scene import from_numpy_leaves
from realtimeraytracer_torch.scene.lights import AreaLight
from realtimeraytracer_torch.scene.materials import Material
from realtimeraytracer_torch.scene.obj_loader import load_obj
from realtimeraytracer_torch.scene.scene import Scene
from realtimeraytracer_torch.utils import log

torch.set_num_threads(2)

MESH = 2_000
RAYS = 1_000            # of the 32x32 primaries: a ragged last tile of 128


def _carry(jgpu):
    return from_numpy_leaves({k: np.asarray(v) for k, v in jgpu._asdict().items()
                              if v is not None})


_SCENES = {}


def _scene(n=MESH, sun=False):
    """(JAX GPUScene, the port's TorchScene of its leaves, the JAX Scene)."""
    if (n, sun) not in _SCENES:
        jscene = jax_scenes.procedural_mesh(n, sun=sun)
        jgpu = jscene.compile()
        _SCENES[n, sun] = jgpu, _carry(jgpu), jscene
    return _SCENES[n, sun]


def _primaries(jscene, w=32, h=32):
    o, d = jax_generate_rays(jscene.camera.viewport_frame(w, h), w, h, jitter=False)
    return np.array(o), np.array(d)


def _segments(n, seed):
    """Random rays through the procedural mesh's box, with random lengths."""
    g = np.random.default_rng(seed)
    o = g.uniform([-6, 0.0, -6], [6, 3.0, 6], (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, g.uniform(0.5, 8.0, n).astype(np.float32)


def _same_hits(got, want):
    """got: the port's HitRecord; want: JAX's (NumPy fields)."""
    gid, wid = got.prim_id.numpy(), np.asarray(want.prim_id)
    np.testing.assert_array_equal(gid >= 0, wid >= 0)
    hit = wid >= 0
    gt, wt = got.t.numpy()[hit], np.asarray(want.t)[hit]
    np.testing.assert_allclose(gt, wt, rtol=1e-5)
    same = gid[hit] == wid[hit]
    assert same.all() or (gt[~same] == wt[~same]).all()
    for f in ("u", "v") if same.any() else ():
        err = np.abs(getattr(got, f).numpy()[hit][same] - np.asarray(getattr(want, f))[hit][same])
        assert (err > 1e-5).mean() <= 5e-3 and err.max() <= 1e-4, (f, err.max())
    return int(hit.sum())


def _same_stats(got, want):
    assert {k: int(v) for k, v in got.items()} == {k: int(v) for k, v in want.items()}


@pytest.mark.parametrize("k", [64, 256])
def test_build_wide_matches_jax(k):
    jgpu, tgpu, _ = _scene()
    assert tgpu.num_tris % k
    got = wide.build_wide(tgpu, k)
    want = jax.jit(jwide.build_wide, static_argnums=1)(jgpu, k)
    assert got.num_tris == want.num_tris == tgpu.num_tris
    for name in ("cl_min", "cl_max", "bw_rows", "bw_offs"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("k,visits", [(64, 64), (64, 1), (256, 64), (256, 2)])
def test_wide_traces_match_jax(k, visits):
    """Closest on 1000 primaries and occlusion on 1000 random segments,
    healthy (the default cap, above the cluster count) and starved."""
    jgpu, tgpu, jscene = _scene()
    cfg_kw = dict(cluster_size=k, max_cluster_visits=visits)
    jcfg, tcfg = jax_rt.RenderConfig(**cfg_kw), rt.RenderConfig(**cfg_kw)
    o, d = (x[:RAYS] for x in _primaries(jscene))
    want, wstats = jax.jit(lambda g, o, d: jwide.wide_closest(
        g, jcfg, o, d, 1e-3, 1e4, return_stats=True))(jgpu, o, d)
    got, gstats = wide.wide_closest(tgpu, tcfg, torch.from_numpy(o), torch.from_numpy(d),
                                    1e-3, 1e4, return_stats=True)
    _same_stats(gstats, wstats)
    hits = _same_hits(got, want)
    so, sd, tmax = _segments(RAYS, seed=k + visits)
    wocc, wostats = jax.jit(lambda g, o, d, t: jwide.wide_occluded(
        g, jcfg, o, d, 1e-3, t, return_stats=True))(jgpu, so, sd, tmax)
    gocc, gostats = wide.wide_occluded(tgpu, tcfg, *map(torch.from_numpy, (so, sd)), 1e-3,
                                       torch.from_numpy(tmax), return_stats=True)
    _same_stats(gostats, wostats)
    np.testing.assert_array_equal(gocc.numpy(), np.asarray(wocc))
    clusters = -(-tgpu.num_tris // k)
    assert gstats["cap"] == min(visits, clusters)
    if visits >= clusters:
        assert int(gstats["cap_clipped"]) == int(gostats["cap_clipped"]) == 0
        assert 0 < int(gocc.sum()) < RAYS
        brute = make_bruteforce_backend(tgpu, tcfg).closest(
            torch.from_numpy(o), torch.from_numpy(d), 1e-3, 1e4)
        assert torch.equal(brute.prim_id >= 0, got.prim_id >= 0) and hits > RAYS // 2
    else:
        assert int(gstats["cap_clipped"]) > 0 and int(gostats["cap_clipped"]) > 0


@pytest.mark.parametrize("mode,steps", [("closest", None), ("closest", 3),
                                        ("occluded", None), ("occluded", 2)])
def test_lane_traversal_matches_jax(mode, steps):
    """The skip-link walk on the SAH-ordered tree, healthy (the default
    cap) and starved (tests/test_diagnostics.py's caps), on random rays."""
    jgpu, tgpu, _ = _scene()
    kw = {} if steps is None else dict(max_traversal_steps=steps)
    jcfg, tcfg = jax_rt.RenderConfig(**kw), rt.RenderConfig(**kw)
    o, d, tmax = _segments(RAYS, seed=7)
    if mode == "closest":
        tmax = np.full(RAYS, 1e4, np.float32)
    jfn = jlane.traverse_closest if mode == "closest" else jlane.traverse_occluded
    tfn = lane.traverse_closest if mode == "closest" else lane.traverse_occluded
    want, wstats = jax.jit(lambda g, o, d, t: jfn(g, jcfg, o, d, 1e-3, t, return_stats=True))(
        jgpu, o, d, tmax)
    got, gstats = tfn(tgpu, tcfg, *map(torch.from_numpy, (o, d)), 1e-3, torch.from_numpy(tmax),
                      return_stats=True)
    _same_stats(gstats, wstats)
    if mode == "closest":
        _same_hits(got, want)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (int(gstats["cap_clipped"]) > 0) == (steps is not None)
    if steps is None:
        brute = make_bruteforce_backend(tgpu, tcfg)
        to, td, tt = map(torch.from_numpy, (o, d, tmax))
        if mode == "closest":
            assert torch.equal(brute.closest(to, td, 1e-3, tt).prim_id >= 0, got.prim_id >= 0)
        else:
            assert torch.equal(brute.occluded(to, td, 1e-3, tt), got)


def test_lane_tiny_negative_direction_is_repaired():
    """Camera primaries of a 32x32 frame: its centre column has |d.x| ~
    1e-17.  The port's lane traversal finds brute force's hits there; the
    JAX version, whose reciprocal of such a component is 0, misses some."""
    jgpu, tgpu, jscene = _scene()
    o, d = _primaries(jscene)
    tiny = ((np.abs(d) <= 1e-12) & (d < 0)).any(1)
    assert tiny.any()
    cfg = rt.RenderConfig()
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    got = lane.traverse_closest(tgpu, cfg, to, td, 1e-3, 1e4)
    brute = make_bruteforce_backend(tgpu, cfg).closest(to, td, 1e-3, 1e4)
    assert torch.equal(got.prim_id >= 0, brute.prim_id >= 0)
    want = jax.jit(lambda g, o, d: jlane.traverse_closest(g, jax_rt.RenderConfig(), o, d,
                                                          1e-3, 1e4))(jgpu, o, d)
    differ = (np.asarray(want.prim_id) >= 0) != (got.prim_id.numpy() >= 0)
    assert differ.any() and tiny[differ].all()


@pytest.mark.parametrize("starved", [True, False])
def test_debug_traversal_warns_when_starved(monkeypatch, starved):
    """cfg.debug_traversal on the wide backend: one loud warning through
    utils/log.py when the cap clips, none when it does not (JAX's
    tests/test_diagnostics.py:68-96)."""
    lines = []
    monkeypatch.setattr(log, "_sink", lines.append)
    monkeypatch.setattr(log, "_level", 0)
    _, tgpu, jscene = _scene()
    cfg = rt.RenderConfig(width=16, height=16, primary_rays=1, shadow_rays=1,
                          denoise_iterations=0, jitter=False, debug_traversal=True,
                          backend="wide", use_bvh=True,
                          **(dict(max_cluster_visits=1, cluster_size=64) if starved else {}))
    be = make_backend(tgpu, cfg)
    assert be.occluded_hinted is None
    frame = scenes.procedural_mesh(MESH).camera.viewport_frame(16, 16)
    img = render_pipeline_gpu(tgpu, frame, cfg)
    assert img.isfinite().all()
    warned = [m for m in lines if "traversal cap saturated" in m]
    assert bool(warned) == starved
    if not starved:
        plain = render_pipeline_gpu(tgpu, frame, cfg.replace(debug_traversal=False))
        assert torch.equal(img, plain)


def _write_config3_obj(path, num_tris=10_000, seed=3):
    """tests/test_golden.py's procedural 10k-triangle OBJ (BASELINE config 3)."""
    rng = np.random.default_rng(seed)
    n_blobs = max(1, num_tris // 64)
    centers = rng.uniform([-6, 0.3, -6], [6, 2.5, 6], (n_blobs, 3))
    base = centers[rng.integers(0, n_blobs, num_tris)]
    scale = rng.uniform(0.05, 0.3, (num_tris, 1, 1))
    tris = base[:, None, :] + rng.normal(0, 1, (num_tris, 3, 3)) * scale
    verts = tris.reshape(-1, 3)
    lines = ["o rocks"]
    lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]
    lines += [f"f {3*i+1} {3*i+2} {3*i+3}" for i in range(num_tris)]
    path.write_text("\n".join(lines) + "\n")


def _config3_scene(path, load, scene_cls, camera_cls, light_cls, material_cls):
    mesh = load(str(path), material=material_cls(color=(0.55, 0.5, 0.45), specular=0.3,
                                                  metallic=0.05))
    scene = scene_cls(camera=camera_cls(position=(0.0, 3.5, 12.0), look_at=(0.0, 1.0, 0.0),
                                        fov_y_degrees=55.0))
    scene.add(mesh)
    light = light_cls(color=(1.0, 0.95, 0.9), intensity=6.0)
    light.rotate("x", 90.0).scale(4.0).move(0.0, 7.0, 0.0)
    scene.add(light)
    return scene


def test_config3_golden_frame_through_wide_matches_jax(tmp_path):
    """BASELINE config 3 (tests/test_golden.py:107-135): the 10k-triangle
    OBJ through each package's loader and compile, LUT tonemap, 96x54 on
    the wide backend; the port's frame against JAX's render."""
    path = tmp_path / "rocks.obj"
    _write_config3_obj(path)
    kw = dict(width=96, height=54, primary_rays=1, jitter=False, shadow_rays=1,
              denoise_iterations=0, use_bvh=True, backend="wide", tonemap="lut",
              shadow_ray_margin=0.1)
    jscene = _config3_scene(path, jax_load_obj, JaxScene, JaxCamera, JaxAreaLight, JaxMaterial)
    tscene = _config3_scene(path, load_obj, Scene, Camera, AreaLight, Material)
    assert tscene.meshes[0].faces.shape[0] == 10_000
    want = np.asarray(jax_rt.render(jscene, jax_rt.RenderConfig(**kw)))
    got = rt.render(tscene, rt.RenderConfig(**kw), device="cpu").numpy()
    assert got.shape == want.shape == (54, 96, 3) and want.std() > 0
    err = np.abs(got - want)
    assert (err > 2e-3).mean() <= 4e-3 and err.mean() < 2e-3


def test_config4_wavefront_through_wide_matches_jax():
    """BASELINE config 4's golden configuration (tests/test_golden.py:
    139-151) through render_wavefront on the wide backend."""
    jgpu, tgpu, jscene = _scene(1_500, sun=True)
    kw = dict(width=64, height=40, primary_rays=2, jitter=False, shadow_rays=1,
              max_bounces=2, denoise_iterations=0, use_bvh=True, backend="wide",
              shadow_ray_margin=0.1)
    jcfg = jax_rt.RenderConfig(**kw)
    want = np.asarray(jax.jit(lambda g, f: jax_render_wavefront(g, f, jcfg))(
        jgpu, jscene.camera.viewport_frame(64, 40)))
    frame = scenes.procedural_mesh(1_500, sun=True).camera.viewport_frame(64, 40)
    got = render_wavefront(tgpu, frame, rt.RenderConfig(**kw)).numpy()
    assert got.shape == want.shape and want.std() > 0
    assert np.isfinite(got).all() and (np.abs(got - want) > 2e-3).mean() < 5e-3


def test_radiance_loss_grads_through_wide_match_jax():
    """tests/test_diff.py:123's case on the wide backend: the obj_color
    gradient of radiance_loss against jax.grad.  (The vertex gradient's
    path, the surface recompute, is the same on every backend: the port
    holds it to its brute force on "wide" in tests/test_torch_diff.py, and
    JAX's jitted vertex gradient would triple this test's compile.)"""
    jscene = jax_scenes.procedural_mesh(500, sun=True)
    jgpu = jscene.compile(bvh_threshold=0)
    tgpu = _carry(jgpu)
    kw = dict(width=16, height=16, primary_rays=1, shadow_rays=1, denoise_iterations=0,
              jitter=False, use_bvh=True, backend="wide", shadow_ray_margin=0.02)
    jcfg, tcfg = jax_rt.RenderConfig(**kw), rt.RenderConfig(**kw)
    o, d = _primaries(jscene, 16, 16)
    seed = np.arange(o.shape[0])
    target = np.zeros((o.shape[0], 3), np.float32)
    want = np.asarray(jax.jit(jax.grad(lambda c: jax_radiance_loss(
        {"obj_color": c}, jgpu, jcfg, jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(seed, jnp.uint32), jnp.asarray(target))))(jgpu.obj_color))
    color = tgpu.obj_color.clone().requires_grad_()
    radiance_loss({"obj_color": color}, tgpu, tcfg, torch.from_numpy(o), torch.from_numpy(d),
                  torch.from_numpy(seed), torch.from_numpy(target)).backward()
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(color.grad.numpy(), want, rtol=1e-4, atol=1e-6 * scale)


def test_per_image_denoise_frame_matches_jax():
    """use_pallas_denoise=False: the per-image stencil on each stochastic
    image.  The port's components of a 24x24 frame (the wide route, 2
    iterations: JAX's jitted stencil compiles in about 2 s an iteration)
    go through both packages' denoise_and_combine with the
    flag (values within 1e-5); the pair denoiser's frame meets the frame
    rule against it."""
    _, tgpu, _ = _scene()
    kw = dict(width=24, height=24, primary_rays=2, shadow_rays=2, denoise_iterations=2,
              backend="wide", use_pallas_denoise=False)
    tcfg, jcfg = rt.RenderConfig(**kw), jax_rt.RenderConfig(**kw)
    frame = scenes.procedural_mesh(MESH).camera.viewport_frame(24, 24)
    with torch.inference_mode():
        comp = render_components(tgpu, frame, tcfg, 0)
        got = denoise_and_combine(comp, tcfg).numpy()
        pair = denoise_and_combine(comp, tcfg.replace(use_pallas_denoise=None)).numpy()
    assert np.array_equal(got, render_pipeline_gpu(tgpu, frame, tcfg).numpy())
    jcomp = JaxRenderComponents(*(jnp.asarray(x.numpy()) for x in comp))
    want = np.asarray(jax.jit(lambda c: jax_denoise_and_combine(c, jcfg))(jcomp))
    assert want.std() > 0 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not np.array_equal(got, pair)
    assert (np.abs(pair - got) > 2e-3).mean() < 5e-3
