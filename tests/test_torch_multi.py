"""Multi-segment occlusion (hier_occluded_multi) and the FMA peak probe of
the PyTorch port.

On the CPU the port's hier_occluded_multi runs its plain twin (one
trace_hier_plain per sample).  It is held against the JAX package's
hier_occluded_multi (the Pallas kernel in interpret mode, called once) on
the setup of tests/test_hier.py::TestMultiSegmentOcclusion, and against the
port's own per-sample hier_occluded for S = 1, 2, 3 and 8, with direction
sets whose components straddle zero: masks equal exactly.  The fused
shadow branch of render_components gives bit-equal shadowed and analytic
images with and without it on a triangle scene.  The fused query tests
triangles only, as JAX's does, so on a scene with an analytic sphere the
fused frame is lit where a sphere shadows (the decision in ROADMAP C).
The probe's twin is held exactly to a NumPy float64-rounded recurrence.
The CUDA kernels themselves are held to these twins in
tests/test_torch_kernels.py (marked cuda).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimeraytracer_tpu.config import RenderConfig as JaxConfig
from realtimeraytracer_tpu.render.backends import TraceBackend as JaxTraceBackend
from realtimeraytracer_tpu.render.hier_backend import (
    hier_occluded_multi as jax_hier_occluded_multi)
from realtimeraytracer_tpu.scene.geometry import TriangleMesh as JaxMesh
from realtimeraytracer_tpu.scene.scene import Scene as JaxScene
from realtimeraytracer_torch import RenderConfig, scenes
from realtimeraytracer_torch.probes import fma_peak, fma_peak_kernel, fma_peak_plain
from realtimeraytracer_torch.render import hier_backend as hb
from realtimeraytracer_torch.render.alpha import wrap_backend_with_alpha
from realtimeraytracer_torch.render.backends import TraceBackend, make_backend
from realtimeraytracer_torch.render.megakernel import render_components
from realtimeraytracer_torch.scene.camera import Camera
from realtimeraytracer_torch.scene.geometry import MeshInstance, Sphere, TriangleMesh
from realtimeraytracer_torch.scene.gpu_scene import from_numpy_leaves
from realtimeraytracer_torch.scene.materials import Material
from realtimeraytracer_torch.scene.panels import RESIDENT_CB
from realtimeraytracer_torch.scene.scene import Scene

torch.set_num_threads(2)

BIG_T = 3.0e38
N_RAYS = 300          # not a multiple of the 128-ray tile


def _light_segments(r, o, s_count):
    """S segments from o toward jittered points around (0, 8, 0); 20% of
    the rays inactive ([BIG, -BIG))."""
    target = np.array([0.0, 8.0, 0.0], np.float32)
    dirs, this = [], []
    for _ in range(s_count):
        lp = target + r.normal(0, 0.5, o.shape).astype(np.float32)
        delta = lp - o
        dist = np.linalg.norm(delta, axis=1)
        dirs.append((delta / dist[:, None]).astype(np.float32))
        this.append((dist - 0.5).astype(np.float32))
    act = r.random(o.shape[0]) > 0.2
    tlo = np.where(act, 1e-3, BIG_T).astype(np.float32)
    this = [np.where(act, h, -BIG_T).astype(np.float32) for h in this]
    return dirs, tlo, this


def _straddle_segments(r, o, s_count):
    """S directions per ray whose x and z components change sign across the
    samples (the hull passes those axes), one with an x component below
    the parallel-axis epsilon; windows up to 12."""
    dirs = []
    for s in range(s_count):
        d = np.stack([r.uniform(-0.4, 0.4, o.shape[0]), np.ones(o.shape[0]),
                      r.uniform(-0.4, 0.4, o.shape[0])], axis=1)
        if s == 0:
            d[:, 0] = 1e-13
        dirs.append((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))
    tlo = np.full(o.shape[0], 1e-3, np.float32)
    this = [r.uniform(2.0, 12.0, o.shape[0]).astype(np.float32) for _ in range(s_count)]
    return dirs, tlo, this


@pytest.fixture(scope="module")
def jax_case():
    """tests/test_hier.py::TestMultiSegmentOcclusion's scene and segments,
    with the JAX package's fused masks (interpret mode) computed once."""
    r = np.random.default_rng(0)
    tris = (r.uniform(-4, 4, (700, 1, 3)) + r.normal(0, 0.3, (700, 3, 3))).astype(np.float32)
    s = JaxScene()
    s.add(JaxMesh(vertices=tris.reshape(-1, 3),
                  faces=np.arange(3 * 700, dtype=np.int32).reshape(700, 3)))
    jgpu = s.compile(bvh_threshold=0)
    tgpu = from_numpy_leaves({k: np.asarray(v) for k, v in jgpu._asdict().items()
                              if v is not None})
    r = np.random.default_rng(9)
    o = r.uniform(-6, 6, (N_RAYS, 3)).astype(np.float32)
    dirs, tlo, this = _light_segments(r, o, 3)
    want = jax_hier_occluded_multi(jgpu, JaxConfig(), jnp.asarray(o),
                                   [jnp.asarray(d) for d in dirs], jnp.asarray(tlo),
                                   [jnp.asarray(h) for h in this])
    return tgpu, (o, dirs, tlo, this), [np.asarray(w) for w in want]


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def test_multi_matches_jax(jax_case):
    tgpu, (o, dirs, tlo, this), want = jax_case
    got = hb.hier_occluded_multi(tgpu, RenderConfig(), torch.from_numpy(o), _t(*dirs),
                                 torch.from_numpy(tlo), _t(*this))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.bool and g.shape == (N_RAYS,)
        assert 10 < w.sum() < N_RAYS - 10
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("kind", ["light", "straddle"])
@pytest.mark.parametrize("s_count", [1, 2, 3, 8])
def test_multi_matches_per_sample(jax_case, s_count, kind):
    tgpu = jax_case[0]
    r = np.random.default_rng(100 + s_count)
    o = r.uniform(-6, 6, (N_RAYS, 3)).astype(np.float32)
    dirs, tlo, this = (_light_segments if kind == "light" else _straddle_segments)(r, o, s_count)
    got = hb.hier_occluded_multi(tgpu, RenderConfig(), torch.from_numpy(o), _t(*dirs),
                                 torch.from_numpy(tlo), _t(*this))
    occ = 0
    for s in range(s_count):
        want = hb.hier_occluded(tgpu, *_t(o, dirs[s], tlo, this[s]))
        assert torch.equal(got[s], want), f"sample {s}"
        occ += int(want.sum())
    assert 10 < occ < s_count * N_RAYS - 10


def test_pack_rays_multi_pads():
    r = np.random.default_rng(1)
    o = torch.from_numpy(r.normal(size=(N_RAYS, 3)).astype(np.float32))
    ds = [torch.from_numpy(r.normal(size=(N_RAYS, 3)).astype(np.float32)) for _ in range(2)]
    hs = [torch.full((N_RAYS,), 5.0 + s) for s in range(2)]
    rays, n = hb.pack_rays_multi(o, ds, torch.full((N_RAYS,), 1e-3), hs)
    assert n == N_RAYS and rays.shape == (3, 12, 128)
    lanes = rays.permute(0, 2, 1).reshape(-1, 12)
    torch.testing.assert_close(lanes[:N_RAYS, 0:3], o, rtol=0, atol=0)
    torch.testing.assert_close(lanes[:N_RAYS, 8:11], ds[1], rtol=0, atol=0)
    assert (lanes[:N_RAYS, 11] == 6.0).all()
    assert (lanes[N_RAYS:, 3] == BIG_T).all() and (lanes[N_RAYS:, [7, 11]] == -BIG_T).all()
    assert (lanes[N_RAYS:, [0, 1, 2, 4, 5, 6, 8, 9, 10]] == 0).all()


def _instanced_scene():
    """The two-instance scene of tests/test_torch_instancing.py::
    test_per_instance_materials."""
    r = np.random.default_rng(0)
    tris = (r.uniform(-1, 1, (300, 1, 3)) + r.normal(0, 0.15, (300, 3, 3))).astype(np.float32)
    mesh = TriangleMesh(vertices=tris.reshape(-1, 3),
                        faces=np.arange(900, dtype=np.int32).reshape(300, 3),
                        material=Material(color=(0.6, 0.3, 0.2)))
    s = Scene(camera=Camera(position=(0, 2, 8), look_at=(0, 0.5, 0)))
    for x, color in ((-2.0, (1.0, 0.0, 0.0)), (2.0, (0.0, 1.0, 0.0))):
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = (x, 1, 0)
        s.add(MeshInstance(mesh=mesh, transform=t, material=Material(color=color)))
    return s.compile()


@pytest.mark.parametrize("case", ["instanced", "too_many_blocks", "no_segment",
                                  "nine_segments"])
def test_multi_refuses(jax_case, case):
    gpu = jax_case[0]
    s_count = {"no_segment": 0, "nine_segments": 9}.get(case, 3)
    if case == "instanced":
        gpu = _instanced_scene()
        assert gpu.instanced
    elif case == "too_many_blocks":
        gpu = dataclasses.replace(gpu, pallas_panels=gpu.pallas_panels.new_zeros(
            (RESIDENT_CB + 1,) + tuple(gpu.pallas_panels.shape[1:])))
    o = torch.zeros((N_RAYS, 3))
    d = torch.tensor([0.0, 1.0, 0.0]).expand(N_RAYS, 3)
    with pytest.raises(ValueError):
        hb.hier_occluded_multi(gpu, RenderConfig(), o, [d] * s_count, 1e-3, [5.0] * s_count)


@pytest.fixture(scope="module")
def mesh_scene():
    scene = scenes.procedural_mesh(600, sun=True)
    return scene, scene.compile(bvh_threshold=0)


def test_backend_wiring(mesh_scene):
    """As in the JAX package: TraceBackend carries occluded_multi before
    occluded_hinted, no make_backend route supplies it, and the alpha
    ladder drops it."""
    assert TraceBackend._fields == JaxTraceBackend._fields
    assert TraceBackend._fields.index("occluded_multi") < TraceBackend._fields.index("occluded_hinted")
    _, gpu = mesh_scene
    for kind in ("auto", "hybrid", "hier"):
        be = make_backend(gpu, RenderConfig(backend=kind))
        assert be.occluded_multi is None, kind
    r = np.random.default_rng(0)
    tris = (r.uniform(-4, 4, (200, 1, 3)) + r.normal(0, 0.6, (200, 3, 3))).astype(np.float32)
    s = Scene()
    tex = s.add_texture(np.kron((r.random((4, 4)) > 0.5).astype(np.float32),
                                np.ones((8, 8), np.float32)))
    s.add(TriangleMesh(vertices=tris.reshape(-1, 3),
                       faces=np.arange(600, dtype=np.int32).reshape(200, 3),
                       uvs=r.uniform(0, 1, (600, 2)).astype(np.float32),
                       material=Material(opacity_map=tex)))
    agpu = s.compile(bvh_threshold=0)
    cfg = RenderConfig(backend="hier", alpha_test=True)
    fused = hb.make_hier_backend(agpu, cfg)._replace(occluded_multi=lambda *a: None)
    wrapped = wrap_backend_with_alpha(fused, agpu, cfg)
    assert wrapped is not fused and wrapped.occluded_multi is None


def _components(gpu, scene, cfg, fused: bool):
    frame = scene.camera.viewport_frame(cfg.width, cfg.height)
    be = make_backend(gpu, cfg)
    calls = []
    if fused:
        def multi(o, ds, lo, hs):
            calls.append(len(ds))
            return hb.hier_occluded_multi(gpu, cfg, o, ds, lo, hs)

        be = be._replace(occluded_multi=multi)
    comp = render_components(gpu, frame, cfg, 0, be)
    return comp, calls


def test_render_components_fused_is_bit_equal(mesh_scene):
    scene, gpu = mesh_scene
    cfg = RenderConfig(width=32, height=24, primary_rays=1, jitter=False, shadow_rays=3,
                       denoise_iterations=0, backend="hier", shadow_ray_margin=0.05)
    a, calls = _components(gpu, scene, cfg, fused=True)
    b, _ = _components(gpu, scene, cfg, fused=False)
    assert calls == [3] * gpu.num_light_tris
    assert torch.equal(a.shadowed, b.shadowed)
    assert torch.equal(a.analytic, b.analytic)
    assert not torch.equal(a.shadowed, a.unshadowed)


def test_fused_query_ignores_spheres():
    """The reference's fused query tests triangles only; the backend's
    per-sample occlusion ORs in the analytic spheres.  A sphere between the
    ground and the area light shadows the unfused frame only."""
    scene = scenes.procedural_mesh(600, sun=False)
    scene.add(Sphere(center=(0.0, 5.0, 2.0), radius=1.5))
    gpu = scene.compile(bvh_threshold=0)
    assert gpu.num_spheres == 1
    cfg = RenderConfig(width=32, height=24, primary_rays=1, jitter=False, shadow_rays=3,
                       denoise_iterations=0, backend="hier", shadow_ray_margin=0.05)
    a, calls = _components(gpu, scene, cfg, fused=True)
    b, _ = _components(gpu, scene, cfg, fused=False)
    assert calls == [3] * gpu.num_light_tris
    assert torch.equal(a.analytic, b.analytic)
    assert bool((a.shadowed >= b.shadowed).all())
    assert bool((a.shadowed > b.shadowed).any())


def test_fma_peak_plain_matches_numpy():
    """The probe's twin against r4_probe.py's kern (:61-72) written in
    NumPy, each FMA step as float64 a*b + c rounded to float32.  JAX's
    vpu_peak is a TPU-only script (no interpret flag), so it cannot serve
    as the oracle here."""
    x = np.random.default_rng(5).uniform(0.5, 1.5, (512, 128)).astype(np.float32)
    b = x * np.float32(0.9999999)
    accs = [x * np.float32(1.0 + 1e-7 * j) for j in range(8)]
    for _ in range(64):
        accs = [(a.astype(np.float64) * b.astype(np.float64)
                 + np.float64(np.float32(1e-9))).astype(np.float32) for a in accs]
    want = accs[0]
    for a in accs[1:]:
        want = want + a
    np.testing.assert_array_equal(fma_peak_plain(torch.from_numpy(x)).numpy(), want)


def test_fma_peak_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        fma_peak_kernel(torch.ones((512, 128)))
    with pytest.raises(ValueError, match="CUDA"):
        fma_peak("cpu")
