"""The hybrid route of the PyTorch port (render/backends.py:
make_hybrid_backend) against the JAX package's, and the port's entry
points' device default.

One JAX hybrid frame (v9 primaries, v8 hinted occlusion, all in interpret
mode) is computed once per module and held against the port's frame on the
same compiled scene by the whole-frame rule of tests/test_torch_slice.py:
no NaN, and under 0.5% of values off by more than 2e-3.
"""

import numpy as np
import pytest
import torch
import jax

import realtimeraytracer_tpu as jax_rt
from realtimeraytracer_tpu import scenes as jax_scenes
from realtimeraytracer_tpu.render.megakernel import render_components as jax_components
from realtimeraytracer_tpu.render.pipeline import denoise_and_combine as jax_combine
import realtimeraytracer_torch as rt
from realtimeraytracer_torch import scenes
from realtimeraytracer_torch.ops.camera_rays import generate_rays
from realtimeraytracer_torch.render import hier_backend as hb
from realtimeraytracer_torch.render import quarter_backend as qb
from realtimeraytracer_torch.render import v7_backend as v7
from realtimeraytracer_torch.render.backends import make_backend, resolve_backend_kind
from realtimeraytracer_torch.render.megakernel import render_components, shade_sample
from realtimeraytracer_torch.render.pipeline import denoise_and_combine
from realtimeraytracer_torch.scene.gpu_scene import from_numpy_leaves

torch.set_num_threads(2)

SIZE = 32
SCENE = (1500, 0, True)       # procedural_mesh(n_tris, seed, sun)


def _cfg(module, backend="hybrid"):
    return module.RenderConfig(width=SIZE, height=SIZE, primary_rays=2, shadow_rays=2,
                               denoise_iterations=2, backend=backend)


@pytest.fixture(scope="module")
def frames():
    jscene = jax_scenes.procedural_mesh(*SCENE)
    jcfg = _cfg(jax_rt)
    gpu = jscene.compile()
    comp = jax.jit(lambda g, f: jax_components(g, f, jcfg, 0))(
        gpu, jscene.camera.viewport_frame(SIZE, SIZE))
    want = np.asarray(jax.jit(lambda c: jax_combine(c, jcfg))(comp))
    tscene = from_numpy_leaves({k: np.asarray(v) for k, v in gpu._asdict().items()
                                if v is not None})
    tcfg = _cfg(rt, backend="auto")
    frame = scenes.procedural_mesh(*SCENE).camera.viewport_frame(SIZE, SIZE)
    with torch.inference_mode():
        got = denoise_and_combine(render_components(tscene, frame, tcfg, 0), tcfg).numpy()
    return tscene, want, got


def _rule(got, want):
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert (np.abs(got - want) > 2e-3).mean() < 5e-3


def test_auto_resolves_to_hybrid(frames):
    tscene, _, _ = frames
    assert resolve_backend_kind(tscene, rt.RenderConfig()) == "hybrid"
    assert resolve_backend_kind(tscene, rt.RenderConfig(use_bvh=False)) == "brute"
    be = make_backend(tscene, rt.RenderConfig())
    assert be.perray_cull and be.occluded_hinted is not None


def test_hybrid_frame_matches_jax(frames):
    _, want, got = frames
    assert want.std() > 0
    _rule(got, want)


@pytest.mark.parametrize("backend", ["pallas", "quarter", "hier"])
def test_routes_agree(frames, backend):
    """Every BVH route renders the hybrid frame (the port's twins only)."""
    tscene, _, got = frames
    cfg = _cfg(rt, backend)
    frame = scenes.procedural_mesh(*SCENE).camera.viewport_frame(SIZE, SIZE)
    with torch.inference_mode():
        other = denoise_and_combine(render_components(tscene, frame, cfg, 0), cfg).numpy()
    _rule(other, got)


def test_hint_chain_changes_nothing(frames):
    """shade_sample with the hint chain equals it without, bit for bit."""
    tscene, _, _ = frames
    cfg = _cfg(rt)
    frame = scenes.procedural_mesh(*SCENE).camera.viewport_frame(SIZE, SIZE)
    o, d = generate_rays(frame, SIZE, SIZE, jitter=False)
    seeds = torch.arange(o.shape[0], dtype=torch.int64)
    be = make_backend(tscene, cfg)
    state = {}
    with torch.inference_mode():
        hinted = shade_sample(tscene, cfg, o, d, seeds, be, hint_state=state)
        plain = shade_sample(tscene, cfg, o, d, seeds, be._replace(occluded_hinted=None))
    assert set(state) == {("lt", 0), ("lt", 1), "sun"}
    for a, b in zip(hinted, plain):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_cpu_frame_launches_no_kernel(frames):
    tscene, _, _ = frames
    counters = (v7.trace_blocks, qb.trace_blocks_quarter, hb.trace_blocks_hier)
    before = [c.launches for c in counters]
    rt.render(scenes.procedural_mesh(300, 0, True), _cfg(rt, "auto"), device="cpu")
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("backend,v9", [("auto", True), ("pallas", False), ("hier", False)])
def test_render_repacks_only_for_v9(monkeypatch, backend, v9):
    """render builds the SAH-repacked v9 panels only for a route that runs
    v9 (their host build costs time to first frame)."""
    from realtimeraytracer_torch.scene.scene import Scene

    seen, compile_leaves = [], Scene.compile_leaves

    def spy(self, *args):
        seen.append(args[2])
        return compile_leaves(self, *args)

    monkeypatch.setattr(Scene, "compile_leaves", spy)
    cfg = rt.RenderConfig(width=8, height=8, primary_rays=1, shadow_rays=1, backend=backend)
    assert rt.render(scenes.procedural_mesh(300, 0, True), cfg, device="cpu").shape == (8, 8, 3)
    assert seen == [v9]


def test_render_defaults_to_the_gpu(monkeypatch):
    """With no CUDA device, render and render_pipeline without a device
    argument raise; they never render on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = scenes.sphere_plane()
    cfg = rt.RenderConfig(width=8, height=8, primary_rays=1, shadow_rays=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rt.render(scene, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.render_pipeline(scene, cfg)
    assert rt.render(scene, cfg, device="cpu").shape == (8, 8, 3)
