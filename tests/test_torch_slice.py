"""The whole frame of the PyTorch port against the JAX package.

One JAX ``render_components`` + ``denoise_and_combine`` per route (computed
once per module: the interpret-mode Pallas frame is the slow part), fed the
same compiled scene through ``from_numpy_leaves``, compared component by
component and on the final image.  The "pallas" route runs the JAX v7
kernel in interpret mode against the port's v7 twin; the brute route
covers spheres on a scene without a BVH.  Jitter is on and
sort_shadows_min_rays=0, so the shadow-ray sort runs.

Rule (that of tests/test_pallas.py for whole frames): no NaN, and under
0.5% of values off by more than 2e-3.  Pixels whose primary hit flips
between two nearly equal triangles, or whose shadow sample grazes an edge,
legitimately differ; everything else agrees to float32 rounding.
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
from realtimeraytracer_torch.render.megakernel import render_components
from realtimeraytracer_torch.render.pipeline import denoise_and_combine
from realtimeraytracer_torch.scene.gpu_scene import from_numpy_leaves

torch.set_num_threads(2)

COMPONENTS = ("analytic", "shadowed", "unshadowed", "normal", "position")
ROUTES = {
    "pallas": ("procedural_mesh", (1500, 0, True), 32, "pallas"),
    "brute": ("sphere_plane", (), 16, "auto"),
}


def _cfg(module, size, backend):
    return module.RenderConfig(width=size, height=size, primary_rays=2,
                               shadow_rays=2, denoise_iterations=2,
                               backend=backend, sort_shadows_min_rays=0)


@pytest.fixture(scope="module", params=sorted(ROUTES))
def frames(request):
    name, args, size, backend = ROUTES[request.param]
    jscene = getattr(jax_scenes, name)(*args)
    jcfg = _cfg(jax_rt, size, backend)
    gpu = jscene.compile()
    jframe = jscene.camera.viewport_frame(size, size)
    comp = jax.jit(lambda g, f: jax_components(g, f, jcfg, 0))(gpu, jframe)
    want = {k: np.asarray(getattr(comp, k)) for k in COMPONENTS}
    want["final"] = np.asarray(jax.jit(lambda c: jax_combine(c, jcfg))(comp))

    tcfg = _cfg(rt, size, backend)
    tscene = from_numpy_leaves({k: np.asarray(v) for k, v in gpu._asdict().items()
                                if v is not None})
    tframe = getattr(scenes, name)(*args).camera.viewport_frame(size, size)
    with torch.inference_mode():
        tcomp = render_components(tscene, tframe, tcfg, 0)
        got = {k: getattr(tcomp, k).numpy() for k in COMPONENTS}
        got["final"] = denoise_and_combine(tcomp, tcfg).numpy()
        port_render = rt.render(getattr(scenes, name)(*args), tcfg, device="cpu").numpy()
    return request.param, want, got, port_render


def _rule(got, want):
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert (np.abs(got - want) > 2e-3).mean() < 5e-3


@pytest.mark.parametrize("key", COMPONENTS + ("final",))
def test_frame_matches_jax(frames, key):
    _, want, got, _ = frames
    assert want[key].std() > 0
    _rule(got[key], want[key])


def test_render_entry_point_matches_jax(frames):
    """rt.render compiles the port's own scene (its NumPy BVH) and renders
    the same frame."""
    _, want, _, port_render = frames
    _rule(port_render, want["final"])
