"""Ray sharding of the PyTorch port (realtimeraytracer_torch/parallel/)
against the single-device port and against the JAX package's sharded frame.

Mirrors tests/test_sharding.py.  JAX shards over a virtual 8-device CPU
mesh in one process; the port is one process per rank, so one module
fixture starts four gloo ranks of tests/_torch_sharding_worker.py once
(four, so that the middle ranks receive both halos), and each test reads
what they wrote.  The ranks run at JAX's CFG (32x32, brute force); the
halo denoise at 64x64 with 4 iterations (16 rows a rank).  Tolerances are
JAX's: frames 1e-5, the halo denoise 1e-6, the wavefront bit for bit, the
step's params atol 1e-5 and loss rtol 1e-5 (the mean of the ranks' sums
rounds apart from one sum); the port's sharded frame against JAX's by the
frame rule of the parity tests (tests/test_torch_slice.py).
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import jax

import realtimeraytracer_tpu as jax_rt
from realtimeraytracer_tpu import scenes as jax_scenes
from realtimeraytracer_tpu.parallel.mesh import make_ray_mesh as jax_make_ray_mesh
from realtimeraytracer_tpu.parallel.sharded import (
    render_pipeline_sharded as jax_render_pipeline_sharded)
import realtimeraytracer_torch as rt
from realtimeraytracer_torch import scenes
from realtimeraytracer_torch.diff import optimize as opt
from realtimeraytracer_torch.ops.camera_rays import generate_rays
from realtimeraytracer_torch.parallel.mesh import (initialize_multihost, make_ray_mesh,
                                                   pad_to_multiple)
from realtimeraytracer_torch.render.backends import make_backend
from realtimeraytracer_torch.render.megakernel import shade_sample

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
KW = dict(width=32, height=32, primary_rays=1, shadow_rays=1, denoise_iterations=1,
          jitter=False, use_bvh=False, shadow_ray_margin=0.02)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def jax_scene():
    return jax_scenes.cornell_box().compile()


@pytest.fixture(scope="module")
def ranks(jax_scene, tmp_path_factory):
    """The four ranks' results: [(arrays, info)] by rank."""
    out = tmp_path_factory.mktemp("ranks")
    np.savez(out / "scene.npz", **{k: np.asarray(v) for k, v in jax_scene._asdict().items()
                                   if v is not None})
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")}
    env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    port = str(_free_port())
    script = os.path.join(REPO, "tests", "_torch_sharding_worker.py")
    procs = [subprocess.Popen([sys.executable, script, str(r), str(WORLD), port, str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=REPO) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("sharding ranks timed out:\n" + "\n".join(logs))
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"RANK {r} OK" in log, f"rank {r} failed:\n{log}"
    res = []
    for r in range(WORLD):
        with np.load(out / f"rank{r}.npz") as z:
            arrays = dict(z)
        with open(out / f"rank{r}.json") as f:
            res.append((arrays, json.load(f)))
    return res


def test_sharded_frame_matches_single_device(ranks):
    single = ranks[0][0]["frame_single"]
    assert single.shape == (32, 32, 3) and single.std() > 0
    for arrays, _ in ranks:
        np.testing.assert_allclose(arrays["frame"], single, atol=1e-5)


def test_sharded_frame_matches_jax_sharded(ranks, jax_scene):
    """The port's 4-rank frame against JAX's render_pipeline_sharded on
    make_ray_mesh(4) (jitted), on the same compiled scene."""
    cfg = jax_rt.RenderConfig(**KW)
    frame = jax_scenes.cornell_box().camera.viewport_frame(32, 32)
    mesh = jax_make_ray_mesh(4)
    want = np.asarray(jax.jit(lambda g, f: jax_render_pipeline_sharded(g, f, cfg, mesh))(
        jax_scene, frame))
    got = ranks[0][0]["frame"]
    assert np.isfinite(got).all() and np.isfinite(want).all() and want.std() > 0
    assert (np.abs(got - want) > 2e-3).mean() < 5e-3


def test_sharded_wavefront_matches_single_device(ranks):
    """The wavefront sample over 4 ranks equals trace_paths bit for bit:
    paths are independent and each rank's coherence sorts permute only its
    own paths."""
    single = ranks[0][0]["wavefront_single"]
    assert single.shape == (32 * 32, 3) and np.abs(single).max() > 0
    for arrays, _ in ranks:
        np.testing.assert_array_equal(arrays["wavefront"], single)


def test_sharded_shade_matches_single_device(ranks):
    """sharded_shade's slabs (every SampleRadiance field), gathered, equal
    shade_sample on all the rays: each ray's shading is its own."""
    single = ranks[0][0]["shade_single"]
    assert single.shape == (32 * 32, 15) and np.abs(single).max() > 0
    for arrays, _ in ranks:
        np.testing.assert_array_equal(arrays["shade"], single)


def test_halo_exchanged_denoise_matches_unsharded(ranks):
    """64 rows over 4 ranks, 4 iterations: each rank's 16 rows and its
    8-row halos reproduce the unsharded denoise."""
    single = ranks[0][0]["halo_single"]
    assert single.shape == (64, 64, 3)
    for arrays, _ in ranks:
        np.testing.assert_allclose(arrays["halo"], single, atol=1e-6)


def test_sharded_denoise_log_has_no_full_gather(ranks):
    """Each rank's collectives in the halo frame: 2*iterations-row halo
    exchanges (one for the G-buffer, one per iteration), then the single
    gather of its 16 rows; the frame of 1 iteration likewise with 2-row
    halos."""
    for r, (_, info) in enumerate(ranks):
        for log, it in ((info["halo_log"], 4), (info["frame_log"], 1)):
            assert [e["kind"] for e in log] == ["halo"] * (it + 1) + ["all_gather"], log
            assert all(e["rows"] == 2 * it for e in log[:-1]), log
            neighbours = (r > 0) + (r < WORLD - 1)
            assert all(e["bytes"] == neighbours * 2 * 2 * it * (64 if it == 4 else 32) * 3 * 4
                       for e in log[:-1]), log
            assert log[-1]["rows"] == (64 if it == 4 else 32) // WORLD


def test_each_rank_traces_a_quarter_of_the_rays(ranks):
    """The work division of benchmarks/scaling.py, counted in rays: the
    single device's traced rays over WORLD x the busiest rank's, >= 0.85."""
    single = ranks[0][1]["rays_single"]
    per_rank = [info["rays"] for _, info in ranks]
    assert single["closest"] == 32 * 32 and single["occluded"] > 0
    for kind in ("closest", "occluded"):
        assert sum(r[kind] for r in per_rank) == single[kind]
        assert single[kind] / (WORLD * max(r[kind] for r in per_rank)) >= 0.85


def test_allreduced_step_matches_single_device(ranks, jax_scene):
    """One Adam step with the loss and gradients averaged over 4 ranks
    against the same step on one rank (make_ray_mesh(1)), every rank's
    params equal (replicated)."""
    for arrays, info in ranks:
        np.testing.assert_allclose(arrays["step"], arrays["step_single"], atol=1e-5)
        np.testing.assert_allclose(info["step_loss"], info["step_single_loss"], rtol=1e-5)
        np.testing.assert_array_equal(arrays["step"], ranks[0][0]["step"])
    start = np.asarray(jax_scene.obj_color) * np.float32(0.7)
    assert np.abs(ranks[0][0]["step_single"] - start).max() > 1e-3


def test_fit_losses_equal_on_every_rank(ranks):
    losses = [info["fit_losses"] for _, info in ranks]
    assert len(losses[0]) == 3 and losses[0][-1] < losses[0][0]
    assert all(x == losses[0] for x in losses)


def test_initialize_multihost_without_a_launcher(ranks, monkeypatch):
    """No kwargs and none of the launcher's variables: a no-op (in each rank
    before its init, and here, where no process group may start)."""
    assert all(info["noop_without_launcher"] and info["world"] == WORLD for _, info in ranks)
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    initialize_multihost()
    assert not dist.is_initialized()


def _step_setup():
    scene = scenes.cornell_box()
    gpu = scene.compile()
    cfg = rt.RenderConfig(**KW)
    o, d = generate_rays(scene.camera.viewport_frame(32, 32), 32, 32, jitter=False)
    seed = torch.arange(o.shape[0])
    with torch.no_grad():
        target = shade_sample(gpu, cfg, o, d, seed, make_backend(gpu, cfg)).analytic
    return dataclasses.replace(gpu, obj_color=gpu.obj_color * 0.7), cfg, o, d, seed, target


@pytest.mark.parametrize("group", [False, True])
def test_one_rank_step_is_the_unsharded_step(group, tmp_path):
    """A one-rank mesh's step, without a process group and on a gloo group
    of one rank (whose all-reduce runs), equals the plain step, loss,
    gradient and params bit for bit."""
    wrong, cfg, o, d, seed, target = _step_setup()
    p0 = {"obj_color": wrong.obj_color.clone().requires_grad_()}
    ref = opt.adam(p0, 1e-2)
    ref.zero_grad()
    want_loss = opt.radiance_loss(p0, wrong, cfg, o, d, seed, target)
    want_loss.backward()
    want_grad = p0["obj_color"].grad.clone()
    ref.step()
    if group:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                                world_size=1, rank=0)
    try:
        mesh = make_ray_mesh(device="cpu")
        assert (mesh.group is not None) == group and mesh.size == 1
        p1 = {"obj_color": wrong.obj_color.clone().requires_grad_()}
        state = opt.TrainState(p1, opt.adam(p1, 1e-2))
        state, loss = opt.make_train_step(cfg, mesh, state.optimizer)(
            state, wrong, o, d, seed, target)
        assert [e["kind"] for e in mesh.log] == (["all_reduce"] if group else [])
    finally:
        if group:
            dist.destroy_process_group()
    assert torch.equal(loss, want_loss.detach())
    assert torch.equal(p1["obj_color"].grad, want_grad)
    assert torch.equal(p1["obj_color"], p0["obj_color"])


def test_make_ray_mesh_without_a_process_group(monkeypatch):
    """More devices than ranks raise as JAX's does; otherwise a one-rank
    mesh with no group, on cuda:LOCAL_RANK unless the CPU is asked for."""
    with pytest.raises(ValueError, match="requested 2 devices, only 1 present"):
        make_ray_mesh(2, device="cpu")
    mesh = make_ray_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.group, mesh.device) == (0, 1, None, torch.device("cpu"))
    assert mesh.slab(10) == (0, 10) and mesh.exchange_halo([torch.zeros(4, 2)], 2) == [(None, None)]
    assert pad_to_multiple(10, 4) == 12 and pad_to_multiple(12, 4) == 12
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert make_ray_mesh().device == torch.device("cuda", 2)
