"""The port's CUDA kernels against their plain PyTorch twins.

This file imports no JAX, so that it also runs on a GPU machine without
jax (whose tests/conftest.py cannot load):

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tests marked ``cuda`` need an NVIDIA GPU and nvcc and skip without a GPU.
Tolerances: v7 hit masks and occluded flags equal, t to rtol 1e-6 and ids
equal or t equal (kernel and twin round alike: no multiply-add contraction
on either side); the A-Trous pair rtol 1e-5, atol 1e-6 (expf and the
kernel's bounds test against the twin's masked taps); frames under 0.5% of
values off by more than 2e-3.  Without a GPU, the wrappers' input checks
are tested: a kernel never takes CPU tensors (no fallback inside it).
"""

import numpy as np
import pytest
import torch

from realtimeraytracer_torch import RenderConfig, scenes
from realtimeraytracer_torch.ops.denoise_kernel import (
    atrous_denoise_pair, atrous_pair_iteration_kernel, atrous_pair_iteration_plain)
from realtimeraytracer_torch.ops.denoise import ratio_combine
from realtimeraytracer_torch.render import v7_backend as v7
from realtimeraytracer_torch.render.megakernel import render_components
from realtimeraytracer_torch.render.pipeline import render_pipeline_gpu
from realtimeraytracer_torch.scene.geometry import TriangleMesh
from realtimeraytracer_torch.scene.scene import Scene

torch.set_num_threads(2)

BIG_T = 3.0e38
N_RAYS = 300
PHIS = (1.0, 0.001, 0.001)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _soup_scene(n=1000, seed=0):
    r = np.random.default_rng(seed)
    tris = (r.uniform(-4, 4, (n, 1, 3)) + r.normal(0, 0.3, (n, 3, 3))).astype(np.float32)
    s = Scene()
    s.add(TriangleMesh(vertices=tris.reshape(-1, 3),
                       faces=np.arange(3 * n, dtype=np.int32).reshape(n, 3)))
    return s.compile(bvh_threshold=0)


def _ray_tiles(common, seed, device):
    r = np.random.default_rng(seed)
    o = r.uniform(-6, 6, (N_RAYS, 3)).astype(np.float32)
    d = r.normal(size=(N_RAYS, 3)).astype(np.float32)
    if common == "origin":
        o[:] = 0.0
    elif common == "dir":
        d[:] = d[0]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(N_RAYS, 1e-3, np.float32)
    tmax = r.uniform(2.0, 12.0, N_RAYS).astype(np.float32)
    empty = np.arange(N_RAYS) % 7 == 3
    tmin[empty], tmax[empty] = BIG_T, -BIG_T
    return v7._pack_rays(*(torch.from_numpy(x).to(device) for x in (o, d, tmin, tmax)))[0]


def _denoise_data(h, w, seed):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    pos = np.stack([xx * 0.01, yy * 0.01, np.zeros_like(xx)], -1) + r.normal(0, 0.01, (h, w, 3))
    nrm = np.stack([0.1 * np.sin(xx * 0.3), np.ones_like(xx), 0.1 * np.cos(yy * 0.2)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    unsh = r.uniform(0.2, 1.0, (h, w, 3))
    shad = unsh * (r.uniform(size=(h, w, 1)) > 0.4)
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)) for a in (shad, unsh, nrm, pos)]


def test_kernels_refuse_cpu_tensors():
    gpu = _soup_scene(200)
    rays = _ray_tiles(None, 1, "cpu")
    keys, id_mask = v7.cull_keys(rays, gpu.pallas_cl_min, gpu.pallas_cl_max)
    with pytest.raises(ValueError, match="CUDA"):
        v7.trace_keys_kernel(rays, keys, gpu.pallas_panels, id_mask, "closest")
    with pytest.raises(ValueError, match="CUDA"):
        atrous_pair_iteration_kernel(*_denoise_data(8, 8, 0), 1, *PHIS)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,common", [("closest", None), ("closest", "origin"),
                                         ("occluded", None), ("occluded", "dir")])
def test_v7_kernel_matches_twin(cuda, mode, common):
    gpu = _soup_scene().to(cuda)
    rays = _ray_tiles(common, 5, cuda)
    keys, id_mask = v7.cull_keys(rays, gpu.pallas_cl_min, gpu.pallas_cl_max)
    before = v7.trace_blocks.launches
    kf, ki = v7.trace_keys_kernel(rays, keys, gpu.pallas_panels, id_mask, mode, common)
    assert v7.trace_blocks.launches == before + 1
    pf, pi = v7.trace_keys_plain(rays, keys, gpu.pallas_panels, id_mask, mode, common)
    kf, ki, pf, pi = (x[:, 0].cpu().numpy().ravel() for x in (kf, ki, pf, pi))
    if mode == "occluded":
        assert 10 < pf.sum() < pf.size - 10
        np.testing.assert_array_equal(kf, pf)
        return
    hit = pi >= 0
    assert hit.sum() > 20
    np.testing.assert_array_equal(ki >= 0, hit)
    np.testing.assert_allclose(kf[hit], pf[hit], rtol=1e-6)
    assert ((ki == pi) | (kf == pf)).all()


@pytest.mark.cuda
def test_v7_kernel_rejects_grad_inputs(cuda):
    gpu = _soup_scene(200).to(cuda)
    rays = _ray_tiles(None, 2, cuda)
    keys, id_mask = v7.cull_keys(rays, gpu.pallas_cl_min, gpu.pallas_cl_max)
    with pytest.raises(ValueError, match="grad"):
        v7.trace_keys_kernel(rays.requires_grad_(), keys, gpu.pallas_panels, id_mask, "closest")


@pytest.mark.cuda
@pytest.mark.parametrize("step", [1, 2, 3, 4])
def test_atrous_kernel_matches_twin(cuda, step):
    ins = [x.to(cuda) for x in _denoise_data(45, 70, 5)]
    before = atrous_denoise_pair.launches
    ks, ku = atrous_pair_iteration_kernel(*ins, step, *PHIS)
    assert atrous_denoise_pair.launches == before + 1
    ps, pu = atrous_pair_iteration_plain(*ins, step, *PHIS)
    torch.testing.assert_close(ks, ps, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ku, pu, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("iterations", [5, 6])
def test_atrous_kernel_beyond_four_iterations(cuda, iterations):
    """No halo limit: dilations past 4 run the kernel, not a plain path."""
    ins = [x.to(cuda) for x in _denoise_data(45, 70, 6)]
    before = atrous_denoise_pair.launches
    ks, ku = atrous_denoise_pair(*ins, iterations, *PHIS)
    assert atrous_denoise_pair.launches == before + iterations
    ps, pu = ins[0], ins[1]
    for i in range(iterations):
        ps, pu = atrous_pair_iteration_plain(ps, pu, ins[2], ins[3], i + 1, *PHIS)
    torch.testing.assert_close(ks, ps, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ku, pu, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_frame_kernels_match_twins(cuda):
    scene = scenes.procedural_mesh(3000, sun=True)
    gpu = scene.compile().to(cuda)
    cfg = RenderConfig(width=64, height=36, primary_rays=1, shadow_rays=2,
                       denoise_iterations=4, backend="pallas", sort_shadows_min_rays=0)
    frame = scene.camera.viewport_frame(64, 36, device=cuda)
    traces, dn = v7.trace_blocks.launches, atrous_denoise_pair.launches
    img_k = render_pipeline_gpu(gpu, frame, cfg).cpu().numpy()
    assert v7.trace_blocks.launches - traces == 1 + 2 * 2 + 1
    assert atrous_denoise_pair.launches - dn == 4
    plain = v7.make_v7_backend(gpu, cfg, trace=v7.trace_blocks_plain)
    with torch.inference_mode():
        comp = render_components(gpu, frame, cfg, 0, backend=plain)
        s, u = comp.shadowed, comp.unshadowed
        for i in range(4):
            s, u = atrous_pair_iteration_plain(s, u, comp.normal, comp.position, i + 1, *PHIS)
        img_p = ratio_combine(comp.analytic, s, u).cpu().numpy()
    assert np.isfinite(img_k).all() and img_k.std() > 0
    assert (np.abs(img_k - img_p) > 2e-3).mean() < 5e-3
