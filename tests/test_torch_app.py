"""The headless application loop of the PyTorch port and its utilities
(app/application.py, the camera's fly controls, utils/log.py,
utils/profiling.py, render/diagnostics.py) against the JAX package.

Tolerances: the fly controls bit-equal to the JAX package's Camera (both
are host float64 NumPy); an Application's first frame bit-equal to
render_pipeline_gpu's at frame index 0, and a debug_traversal frame to
the frame without it (same ops, same order).
"""

import re

import numpy as np
import pytest
import torch

from realtimeraytracer_tpu.scene.camera import Camera as JaxCamera
import realtimeraytracer_torch as rt
from realtimeraytracer_torch import scenes
from realtimeraytracer_torch.app.application import Application
from realtimeraytracer_torch.ops.camera_rays import generate_rays
from realtimeraytracer_torch.render import diagnostics
from realtimeraytracer_torch.render.pipeline import render_pipeline_gpu
from realtimeraytracer_torch.scene.camera import Camera
from realtimeraytracer_torch.utils import log, profiling

torch.set_num_threads(2)

SIZE = 16


def _cfg(**kw):
    return rt.RenderConfig(**{**dict(width=SIZE, height=SIZE, primary_rays=1, shadow_rays=1,
                                     denoise_iterations=1, shadow_ray_margin=0.02), **kw})


def _state(cam):
    return (tuple(np.asarray(cam.position, np.float64)), cam.yaw, cam.pitch,
            tuple(cam.forward), tuple(cam.right))


def test_fly_controls_bit_equal_to_jax():
    kw = dict(position=(0.3, 1.0, 3.6), look_at=(0.0, 1.2, 0.0), fov_y_degrees=45.0)
    cams = (Camera(**kw), JaxCamera(**kw))
    g = np.random.default_rng(8)
    assert _state(cams[0]) == _state(cams[1])
    for step in range(40):
        dx, dy = g.normal(0, 30, 2)
        fwd, strafe, dt = g.uniform(-1, 1), g.uniform(-1, 1), g.uniform(0.005, 0.05)
        for cam in cams:
            cam.process_mouse(dx, dy, 0.5 if step % 2 else 0.1)
            cam.move(forward=fwd, strafe=strafe, dt=dt)
            cam.rotate_y(0.5)
        assert _state(cams[0]) == _state(cams[1]), step
    for cam in cams:                   # the pitch clamp
        cam.process_mouse(0.0, 1e5)
    assert cams[0].pitch == cams[1].pitch == 89.0
    assert cams[0].move_speed == cams[1].move_speed == 10.5
    assert cams[0].mouse_sensitivity == cams[1].mouse_sensitivity == 0.5


def test_application_runs_on_the_cpu():
    scene = scenes.cornell_box()
    cam0 = Camera(position=scene.camera.position, look_at=(0.0, 1.0, 0.0), fov_y_degrees=45.0)
    app = Application("t", SIZE, SIZE, config=_cfg(), scene=scene, device="cpu")
    assert app.config.fast_lut is False and Application("d", device="cpu").config.fast_lut
    frame0 = next(app.frames(1))
    gpu = scene.compile()
    want = render_pipeline_gpu(gpu, cam0.viewport_frame(SIZE, SIZE), app.config, 0).numpy()
    np.testing.assert_array_equal(frame0, want)

    images = []

    def controller(a, i):
        a.process_input(forward=1.0, strafe=0.5, mouse_dx=4.0, mouse_dy=-2.0)
        if i == 0:
            a.toggle_spin()

    fps = app.run(2, controller=controller, on_frame=lambda i, img: images.append(img))
    assert fps > 0 and app.frame_index == 4          # frames(1), warm-up, 2 frames
    assert len(images) == 2 and all(im.device.type == "cpu" for im in images)
    assert not torch.equal(images[0], images[1])
    assert app.scene.camera.position != cam0.position
    assert app.scene.camera.yaw != cam0.yaw


def test_application_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Application()
    with pytest.raises(RuntimeError, match="CUDA"):
        Application("t", SIZE, SIZE, device="cuda:0")


def test_log_levels_and_sink():
    lines = []
    sink = log._sink
    log.set_sink(lines.append)
    try:
        log.set_level("warn")
        log.info("hidden {}", 1)
        log.warn("shown {} {x}", 2, x=3)
        log.error("plain {braces}")
        log.set_level("TRACE")
        log.trace("t")
        log.debug("d")
        log.critical("c {:.1f}", 0.25)
    finally:
        log.set_level("info")
        log.set_sink(sink)
    parsed = [re.fullmatch(r"\[ *\d+ms\] \[(\w+) *\] (.*)", ln).groups() for ln in lines]
    assert parsed == [("warn", "shown 2 3"), ("error", "plain {braces}"), ("trace", "t"),
                      ("debug", "d"), ("critical", "c 0.2")]
    with pytest.raises(KeyError):
        log.set_level("loud")


def test_time_fn_and_ray_counter(tmp_path):
    calls = []

    def fn(x):
        calls.append(1)
        return {"a": x * 2, "b": [x + 1]}

    sec = profiling.time_fn(fn, torch.ones(8), iters=3, warmup=2)
    assert sec >= 0 and len(calls) == 5
    counter = profiling.RayCounter()
    assert counter.rays_per_sec == 0.0
    counter.start()
    dt = counter.stop(1000)
    assert counter.rays == 1000 and counter.seconds == dt
    counter.seconds = 0.5
    assert counter.rays_per_sec == 2000.0
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(4).sum()
    assert prof is not None and (tmp_path / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_debug_traversal_leaves_the_frame_bit_equal(backend):
    scene = scenes.procedural_mesh(600, sun=True)
    gpu = scene.compile()
    frame = scene.camera.viewport_frame(SIZE, SIZE)
    cfg = _cfg(backend=backend, primary_rays=2)
    a = render_pipeline_gpu(gpu, frame, cfg)
    b = render_pipeline_gpu(gpu, frame, cfg.replace(debug_traversal=True))
    assert torch.equal(a, b) and a.std() > 0


def test_diagnose_traversal_zeros_and_raises():
    scene = scenes.procedural_mesh(600, sun=True)
    gpu = scene.compile()
    o, d = generate_rays(scene.camera.viewport_frame(SIZE, SIZE), SIZE, SIZE)
    cfg = _cfg()
    want = diagnostics.make_backend(gpu, cfg.replace(backend="brute")).closest(o, d, 1e-3, 1e4)
    for kind in ("brute", "pallas", "quarter", "hier", "hybrid", "auto", None):
        hit, stats = diagnostics.diagnose_traversal(gpu, cfg, o, d, 1e-3, 1e4, kind=kind)
        assert int(stats["cap_clipped"]) == int(stats["steps"]) == stats["cap"] == 0
        assert torch.equal(hit.prim_id, want.prim_id)
        occ, stats = diagnostics.diagnose_traversal(gpu, cfg, o, d, 1e-3, 1e4, "occluded", kind)
        assert occ.dtype == torch.bool and int(stats["cap_clipped"]) == 0
    # The capped kinds report their cap: healthy here, so exact and unclipped.
    for kind, cap in (("wide", -(-gpu.num_tris // cfg.cluster_size)),
                      ("lane", cfg.max_traversal_steps)):
        hit, stats = diagnostics.diagnose_traversal(gpu, cfg, o, d, 1e-3, 1e4, kind=kind)
        assert int(stats["cap_clipped"]) == 0 and stats["cap"] == cap
        assert 0 < int(stats["steps"]) <= cap
        assert torch.equal(hit.prim_id >= 0, want.prim_id >= 0)
        occ, stats = diagnostics.diagnose_traversal(gpu, cfg, o, d, 1e-3, 1e4, "occluded", kind)
        assert occ.dtype == torch.bool and int(stats["cap_clipped"]) == 0
    _, stats = diagnostics.diagnose_traversal(gpu, cfg.replace(max_cluster_visits=1), o, d,
                                              1e-3, 1e4, kind="wide")
    assert int(stats["cap_clipped"]) > 0 and stats["steps"] == stats["cap"] == 1
    with pytest.raises(ValueError, match="packet"):
        diagnostics.diagnose_traversal(gpu, cfg, o, d, 1e-3, 1e4, kind="packet")
    with pytest.raises(ValueError, match="unknown"):
        diagnostics.diagnose_traversal(gpu, cfg, o, d, 1e-3, 1e4, kind="bogus")
