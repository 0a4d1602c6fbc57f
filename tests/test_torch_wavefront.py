"""The wavefront multi-bounce path tracer of the PyTorch port
(render/wavefront.py, ops/shading.py's samplers) against the JAX package.

The JAX side runs on its brute-force route (its hybrid route runs the
Pallas kernels in interpret mode, tens of seconds a frame); the port
renders the same compiled scene, carried across as NumPy leaves.
Tolerances: the samplers rtol 1e-5 with atol 1e-6 for components near 0
(XLA and torch round sin, cos and sqrt apart by an ulp or so); sort keys
and their stable order equal; one light sample per ray atol 1e-5, except
rays whose occlusion flips where the v8 twin's t quantization (one 2^-16
step) meets a segment's end, which are counted and at most 2 of 256;
frames by the JAX package's golden rule (tests/test_golden.py:159-160): at
most 0.6% of values off by more than 2e-3 and a mean error under 2e-3.
The port's own routes (the kernels' plain twins) are held to its brute
route by the same rule, and its sorted frame to its unsorted one bit for
bit.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import realtimeraytracer_tpu as jax_rt
from realtimeraytracer_tpu import scenes as jax_scenes
from realtimeraytracer_tpu.ops import shading as jax_shading
from realtimeraytracer_tpu.render import wavefront as jax_wf
from realtimeraytracer_tpu.render.backends import make_backend as jax_make_backend
from realtimeraytracer_tpu.scene.gpu_scene import GPUScene
import realtimeraytracer_torch as rt
from realtimeraytracer_torch import scenes
from realtimeraytracer_torch.ops import shading
from realtimeraytracer_torch.ops.camera_rays import generate_rays
from realtimeraytracer_torch.ops.intersect import BIG_T
from realtimeraytracer_torch.render import wavefront as wf
from realtimeraytracer_torch.render.alpha import wrap_backend_with_alpha
from realtimeraytracer_torch.render.backends import make_backend
from realtimeraytracer_torch.render.megakernel import coherence_key
from realtimeraytracer_torch.render.surface import resolve_surface
from realtimeraytracer_torch.scene.gpu_scene import from_numpy_leaves

torch.set_num_threads(2)

SIZE = 16
MESH = (1500, 0, True)            # procedural_mesh(n_tris, seed, sun)


def _golden(got, want):
    """JAX's golden rule: <= 0.6% of values off by > 2e-3, mean < 2e-3."""
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    err = np.abs(got - want)
    assert (err > 2e-3).mean() <= 6e-3 and err.mean() < 2e-3, (
        (err > 2e-3).mean(), err.mean())


def _jax_leaves(jscene, **compile_kw):
    gpu = jscene.compile(**compile_kw)
    return {k: np.asarray(v) for k, v in gpu._asdict().items() if v is not None}


_SCENES = {}


def _scene(name):
    """(JAX GPUScene, the port's TorchScene of the same leaves, the port's
    host scene) for a scenes.py generator, built once per module."""
    if name not in _SCENES:
        args = MESH if name == "procedural_mesh" else ()
        leaves = _jax_leaves(getattr(jax_scenes, name)(*args))
        jgpu = GPUScene(**{k: jnp.asarray(v) for k, v in leaves.items()})
        _SCENES[name] = jgpu, from_numpy_leaves(leaves), getattr(scenes, name)(*args)
    return _SCENES[name]


def _cfg(module, **kw):
    base = dict(width=SIZE, height=SIZE, primary_rays=1, shadow_rays=1,
                shadow_ray_margin=0.02, max_bounces=2)
    return module.RenderConfig(**{**base, **kw})


_JAX_FRAMES = {}


def _jax_frame(name, **kw):
    """JAX's brute-force frame, once per module for each setting."""
    key = (name, tuple(sorted(kw.items())))
    if key not in _JAX_FRAMES:
        jgpu, _, _ = _scene(name)
        jscene = getattr(jax_scenes, name)(*(MESH if name == "procedural_mesh" else ()))
        cfg = _cfg(jax_rt, backend="brute", **kw)
        _JAX_FRAMES[key] = np.asarray(jax.jit(lambda g, f: jax_wf.render_wavefront(g, f, cfg))(
            jgpu, jscene.camera.viewport_frame(SIZE, SIZE)))
    return _JAX_FRAMES[key]


def _port_frame(name, **kw):
    _, tgpu, tscene = _scene(name)
    return wf.render_wavefront(tgpu, tscene.camera.viewport_frame(SIZE, SIZE),
                               _cfg(rt, **kw)).numpy()


# ---- samplers -------------------------------------------------------------

def _sampler_inputs(n=512):
    g = np.random.default_rng(3)
    nrm = g.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    v = g.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    # Edge cases: v parallel to n (zero tangent), n.z = +0 and -0, n = -z.
    v[:8] = nrm[:8]
    v[8:12] = -nrm[8:12]
    nrm[12:16] = [[1, 0, 0], [0, 1, 0], [0.6, 0.8, 0], [0, 0, -1]]
    nrm[16:20] = [[1, 0, -0.0], [0, 1, -0.0], [0.6, -0.8, -0.0], [-1, 0, -0.0]]
    rough = g.uniform(0.03, 1.0, n).astype(np.float32)
    r1, r2 = (g.uniform(0, 1, n).astype(np.float32) for _ in range(2))
    return nrm, v, rough, r1, r2


@pytest.mark.parametrize("sampler", ["sample_ggx", "cosine_hemisphere"])
def test_samplers_match_jax(sampler):
    nrm, v, rough, r1, r2 = _sampler_inputs()
    assert np.signbit(nrm[16:20, 2]).all()
    if sampler == "sample_ggx":
        args = (nrm, v, rough, r1, r2)
    else:
        args = (nrm, r1, r2)
    want = np.asarray(getattr(jax_shading, sampler)(*(jnp.asarray(a) for a in args)))
    got = getattr(shading, sampler)(*(torch.from_numpy(a) for a in args)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---- the bounce-ray sort key ------------------------------------------------

def test_coherence_key_and_order_match_jax():
    g = np.random.default_rng(4)
    n = 4096
    o = g.normal(size=(n, 3)).astype(np.float32) * 5.0
    d = g.normal(size=(n, 3)).astype(np.float32)
    d[:64] = 0.0                       # zero directions: octant 0
    live = g.uniform(size=n) > 0.3     # dead lanes get 0xFFFFFFFF
    want = np.asarray(jax_wf._coherence_key(jnp.asarray(o), jnp.asarray(d), jnp.asarray(live)))
    got = coherence_key(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(live))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert (got[~torch.from_numpy(live)] == 0xFFFFFFFF).all()
    np.testing.assert_array_equal(torch.argsort(got, stable=True).numpy(),
                                  np.asarray(jnp.argsort(jnp.asarray(want))))


# ---- next-event estimation --------------------------------------------------

def test_sample_one_light_matches_jax():
    """256 surface points (primary hits, a third of them dead lanes)."""
    jgpu, tgpu, tscene = _scene("procedural_mesh")
    cfg = _cfg(rt)
    o, d = generate_rays(tscene.camera.viewport_frame(SIZE, SIZE), SIZE, SIZE)
    brute = make_backend(tgpu, cfg.replace(backend="brute"))
    surf = resolve_surface(tgpu, brute.closest(o, d, cfg.t_min, cfg.t_max), o, d)
    g = np.random.default_rng(6)
    seed = torch.from_numpy(g.integers(0, 2**32, o.shape[0], dtype=np.int64))
    live = surf.valid & torch.from_numpy(g.uniform(size=o.shape[0]) > 0.3)
    args = (surf.position, surf.normal, -d, surf.albedo, surf.roughness, surf.metallic, seed)
    jargs = [jnp.asarray(a.numpy()) for a in args[:-1]] + [jnp.asarray(seed.numpy().astype(np.uint32))]
    jcfg = _cfg(jax_rt, backend="brute")
    jbe = jax_make_backend(jgpu, jcfg)
    want = np.asarray(jax.jit(lambda *a, live: jax_wf._sample_one_light(
        jgpu, jcfg, jbe, *a, live=live))(*jargs, live=jnp.asarray(live.numpy())))
    assert np.abs(want).sum(1).astype(bool).sum() > 50
    got = wf._sample_one_light(tgpu, cfg, brute, *args, live=live).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # The hybrid route (the kernels' twins, t quantized) may flip a ray
    # whose occluder lies within a quantization step of a segment's end.
    hyb = wf._sample_one_light(tgpu, cfg, make_backend(tgpu, cfg), *args, live=live).numpy()
    flips = (np.abs(hyb - want) > 1e-5).any(axis=1)
    assert flips.sum() <= 2, flips.sum()


# ---- dead lanes -------------------------------------------------------------

@pytest.mark.parametrize("backend", ["brute", "pallas", "quarter", "hier", "auto"])
def test_empty_intervals_miss_on_every_route(backend):
    """Dead lanes' [BIG_T, -BIG_T) is a miss and never occluded on every
    route's twins (coherent and incoherent closest, occlusion); live lanes
    are untouched by the dead ones."""
    _, tgpu, tscene = _scene("procedural_mesh")
    cfg = _cfg(rt, backend=backend)
    be = make_backend(tgpu, cfg)
    o, d = generate_rays(tscene.camera.viewport_frame(SIZE, SIZE), SIZE, SIZE)
    live = torch.arange(o.shape[0]) % 3 != 0
    lo, hi = torch.where(live, 1e-3, BIG_T), torch.where(live, 1e4, -BIG_T)
    full = be.closest(o, d, 1e-3, 1e4, common="origin")
    assert full.hit[~live].any()
    for common in ("origin", None):
        hit = be.closest(o, d, lo, hi, common=common)
        assert not hit.hit[~live].any()
        assert torch.equal(hit.prim_id[live], full.prim_id[live])
    occ = be.occluded(o, d, lo, hi)
    assert not occ[~live].any()
    assert torch.equal(occ[live], be.occluded(o, d, 1e-3, 1e4)[live])


def _alpha_scene():
    """textured_obj's JAX leaves (native OBJ tokenizer and SAH BVH), JAX
    host scene and the port's host scene, once per module."""
    if "textured_obj" not in _SCENES:
        jscene = jax_scenes.textured_obj()
        leaves = _jax_leaves(jscene)
        _SCENES["textured_obj"] = leaves, jscene, scenes.textured_obj()
    return _SCENES["textured_obj"]


def test_alpha_ladder_spends_no_round_on_dead_lanes():
    leaves, _, tscene = _alpha_scene()
    tgpu = from_numpy_leaves(leaves)
    cfg = _cfg(rt, alpha_test=True)
    record = []
    be = wrap_backend_with_alpha(make_backend(tgpu, cfg.replace(alpha_test=False)), tgpu, cfg,
                                 record=record)
    o, d = generate_rays(tscene.camera.viewport_frame(SIZE, SIZE), SIZE, SIZE)
    dead_lo = torch.full((o.shape[0],), BIG_T)
    assert not be.closest(o, d, dead_lo, -dead_lo).hit.any()
    assert not be.occluded(o, d, dead_lo, -dead_lo).any()
    assert record == [("closest", 0), ("occluded", 0)]
    be.closest(o, d, 1e-3, 1e4)
    assert record[2][1] > 0            # live rays do meet transparent texels


# ---- whole frames -----------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("cornell_box", dict(max_bounces=0)),
    ("cornell_box", dict(max_bounces=2)),
    ("procedural_mesh", dict(primary_rays=2, sort_bounces=True)),
    ("procedural_mesh", dict(primary_rays=2, sort_bounces=False)),
])
def test_wavefront_frame_matches_jax(name, kw):
    """The JAX frame is its sorted one (sort_bounces changes no value in
    either package), so the port's unsorted frame meets it too."""
    want = _jax_frame(name, **{k: v for k, v in kw.items() if k != "sort_bounces"})
    assert want.std() > 0
    _golden(_port_frame(name, backend="brute", **kw), want)


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_routes_match_brute(backend):
    """The hybrid route (v9 bounce 0, v8 bounces and occlusion) and the
    "pallas" route (v7 everywhere), on the kernels' plain twins."""
    _golden(_port_frame("procedural_mesh", backend=backend),
            _port_frame("procedural_mesh", backend="brute"))


def test_sorting_changes_no_value():
    a = _port_frame("procedural_mesh", max_bounces=3)
    b = _port_frame("procedural_mesh", max_bounces=3, sort_bounces=False)
    np.testing.assert_array_equal(a, b)


def test_alpha_tested_frame_matches_jax():
    """textured_obj, one bounce: every closest trace and occlusion under
    the alpha ladder."""
    leaves, jscene, tscene = _alpha_scene()
    jgpu = GPUScene(**{k: jnp.asarray(v) for k, v in leaves.items()})
    kw = dict(alpha_test=True, alpha_rounds=1, max_bounces=1)
    jcfg = _cfg(jax_rt, backend="brute", **kw)
    want = np.asarray(jax.jit(lambda g, f: jax_wf.render_wavefront(g, f, jcfg))(
        jgpu, jscene.camera.viewport_frame(SIZE, SIZE)))
    got = wf.render_wavefront(from_numpy_leaves(leaves), tscene.camera.viewport_frame(SIZE, SIZE),
                              _cfg(rt, **kw)).numpy()
    assert want.std() > 0
    _golden(got, want)


def test_no_silent_device_move():
    """The frame renders where scene and frame are: a frame on another
    device raises, and without a card a scene cannot be moved to one."""
    _, tgpu, tscene = _scene("cornell_box")
    with pytest.raises(ValueError, match="device"):
        wf.render_wavefront(tgpu, tscene.camera.viewport_frame(SIZE, SIZE, device="meta"),
                            _cfg(rt))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tgpu.to("cuda")
