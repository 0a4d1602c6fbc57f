"""The port's CUDA kernels against their plain PyTorch twins.

This file imports no JAX, so that it also runs on a GPU machine without
jax (whose tests/conftest.py cannot load):

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tests marked ``cuda`` need an NVIDIA GPU and nvcc and skip without a GPU.
The instanced v8 kernel is held to its twin on foliage_field(20_000)
compiled instanced and at 3,000 (instance, super) pairs, with instance ids
equal or t equal.
The masked variants (alpha masks in closest mode) are held to their twins
by the same rule on a soup of alpha-mapped triangles.
Tolerances: v7, v8 and v9 hit masks and occluded flags equal, t to rtol
1e-6 and ids equal or t equal (kernel and twin round alike: no multiply-add
contraction on either side); v8 hints as in tests/test_torch_hier.py; the A-Trous pair rtol 1e-5, atol 1e-6 (expf and the
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
from realtimeraytracer_torch.render import hier_backend as hb
from realtimeraytracer_torch.render import quarter_backend as qb
from realtimeraytracer_torch.render import v7_backend as v7
from realtimeraytracer_torch.render.backends import make_hybrid_backend
from realtimeraytracer_torch.render.megakernel import render_components
from realtimeraytracer_torch.render.pipeline import render_pipeline_gpu
from realtimeraytracer_torch.scene.geometry import TriangleMesh
from realtimeraytracer_torch.scene.materials import Material
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


def _alpha_soup_scene(n=1000, seed=0):
    """A soup of triangles with random uvs and one blocky opacity map, so
    that the alpha masks hold both 0 and 1 cells."""
    r = np.random.default_rng(seed)
    tris = (r.uniform(-4, 4, (n, 1, 3)) + r.normal(0, 0.6, (n, 3, 3))).astype(np.float32)
    s = Scene()
    coarse = (r.random((4, 4)) > 0.5).astype(np.float32)
    tex = s.add_texture(np.kron(coarse, np.ones((8, 8), np.float32)))
    s.add(TriangleMesh(vertices=tris.reshape(-1, 3),
                       faces=np.arange(3 * n, dtype=np.int32).reshape(n, 3),
                       uvs=r.uniform(0, 1, (3 * n, 2)).astype(np.float32),
                       material=Material(opacity_map=tex)))
    return s.compile(bvh_threshold=0)


def _ray_tiles(common, seed, device, n=N_RAYS, span=6.0):
    r = np.random.default_rng(seed)
    o = r.uniform(-span, span, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    if common == "origin":
        o[:] = 0.0
    elif common == "dir":
        d[:] = d[0]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = r.uniform(2.0, 2.0 * span, n).astype(np.float32)
    empty = np.arange(n) % 7 == 3
    tmin[empty], tmax[empty] = BIG_T, -BIG_T
    return v7._pack_rays(*(torch.from_numpy(x).to(device) for x in (o, d, tmin, tmax)))[0]


def _same_closest(k, p):
    kf, ki, pf, pi = (x[:, 0].cpu().numpy().ravel() for x in (*k, *p))
    hit = pi >= 0
    assert hit.sum() > 20
    np.testing.assert_array_equal(ki >= 0, hit)
    np.testing.assert_allclose(kf[hit], pf[hit], rtol=1e-6)
    assert ((ki == pi) | (kf == pf)).all()


def _same_occluded(k, p):
    kf, pf = k[0][:, 0].cpu().numpy(), p[0][:, 0].cpu().numpy()
    assert 10 < pf.sum() < pf.size - 10
    np.testing.assert_array_equal(kf, pf)


def _fewer_pairs(k, p, rays):
    """outi row 5, the pairs each ray tested: the kernel's ordered,
    early-exit loop tests no pair the twin does not, and nothing for an
    empty window."""
    kp, pp = k[1][:, 5].cpu(), p[1][:, 5].cpu()
    assert kp.sum() > 0 and (kp <= pp).all()
    assert (kp[(rays[:, 6] > rays[:, 7]).cpu()] == 0).all()


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
    _fewer_pairs((kf, ki), (pf, pi), rays)
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
@pytest.mark.parametrize("common", [None, "origin"])
def test_v9_kernel_matches_twin(cuda, common):
    gpu = _soup_scene().to(cuda)
    rays = _ray_tiles(common, 5, cuda)
    keys, id_mask = v7.cull_quarter_keys(rays, gpu.q_cl_min, gpu.q_cl_max)
    before = qb.trace_blocks_quarter.launches
    k = qb.trace_quarter_kernel(rays, keys, gpu.q_panels, gpu.q_group_off, id_mask, common)
    assert qb.trace_blocks_quarter.launches == before + 1
    p = qb.trace_quarter_plain(rays, keys, gpu.q_panels, gpu.q_group_off, id_mask, common)
    _same_closest(k, p)
    _fewer_pairs(k, p, rays)


@pytest.mark.cuda
@pytest.mark.parametrize("n_tris,mode,common", [
    (1000, "closest", None), (1000, "closest", "origin"),
    (1000, "occluded", None), (1000, "occluded", "dir"),
    (17000, "closest", None), (17000, "occluded", None)])
def test_v8_kernel_matches_twin(cuda, n_tris, mode, common):
    """17000 triangles: 133 blocks in two supers, so L1 pops more than one."""
    gpu = _soup_scene(n_tris).to(cuda)
    rays = _ray_tiles(common, 6, cuda, n=1000)
    coeff, sup, blk, nsup = hb._hier_inputs(gpu)
    assert nsup == -(-coeff.shape[0] // hb.SUP)
    before = hb.trace_blocks_hier.launches
    k = hb.trace_hier_kernel(rays, sup, blk, coeff, nsup, mode, common)
    assert hb.trace_blocks_hier.launches == before + 1
    p = hb.trace_hier_plain(rays, sup, blk, coeff, nsup, mode, common)
    (_same_closest if mode == "closest" else _same_occluded)(k, p)
    counted = hb.trace_hier_kernel(rays, sup, blk, coeff, nsup, mode, common, count=True)
    assert torch.equal(counted[0][:, 0], k[0][:, 0]) and torch.equal(counted[1][:, 0], k[1][:, 0])
    _fewer_pairs(counted, p, rays)
    assert counted[1][:, 6].sum() > 0


@pytest.mark.cuda
def test_v8_kernel_hints(cuda):
    """Cold, self-fed and garbage hints give the twin's mask; each hint of
    a tile with an occluded ray is a block in [0, cb) occluding one of its
    rays, and -1 elsewhere."""
    gpu = _soup_scene().to(cuda)
    rays = _ray_tiles(None, 7, cuda, n=1000)
    coeff, sup, blk, nsup = hb._hier_inputs(gpu)
    want = hb.trace_hier_plain(rays, sup, blk, coeff, nsup, "occluded")
    cold = hb.trace_hier_kernel(rays, sup, blk, coeff, nsup, "occluded")
    hints = cold[1][:, 3:5, 0].contiguous()
    fed = hb.trace_hier_kernel(rays, sup, blk, coeff, nsup, "occluded", hints=hints)
    garbage = torch.stack([torch.full((rays.shape[0],), 10_000), torch.full((rays.shape[0],), -1)],
                          dim=1).to(torch.int32).to(cuda)
    bad = hb.trace_hier_kernel(rays, sup, blk, coeff, nsup, "occluded", hints=garbage)
    for got in (cold, fed, bad):
        _same_occluded(got, want)
    occ = want[0][:, 0] > 0.5
    cb = coeff.shape[0]
    for tile in range(rays.shape[0]):
        for h in hints[tile].tolist():
            if not occ[tile].any():
                assert h == -1
                continue
            assert 0 <= h < cb
            _, ok = v7._intersect_pairs(rays[tile][None], coeff[h][None], None)
            assert bool((ok[0].any(dim=1) & occ[tile]).any())


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


@pytest.mark.cuda
def test_hybrid_frame_kernels_match_twins(cuda):
    """The default route: v9 primaries, v8 hinted occlusion, A-Trous."""
    scene = scenes.procedural_mesh(3000, sun=True)
    gpu = scene.compile().to(cuda)
    cfg = RenderConfig(width=64, height=36, primary_rays=2, shadow_rays=2,
                       denoise_iterations=4)
    frame = scene.camera.viewport_frame(64, 36, device=cuda)
    counters = (v7.trace_blocks, qb.trace_blocks_quarter, hb.trace_blocks_hier,
                atrous_denoise_pair)
    before = [c.launches for c in counters]
    img_k = render_pipeline_gpu(gpu, frame, cfg).cpu().numpy()
    counts = [c.launches - b for c, b in zip(counters, before)]
    assert counts == [0, 2, 2 * (2 * 2 + 1), 4]
    plain = make_hybrid_backend(gpu, cfg, plain=True)
    with torch.inference_mode():
        comp = render_components(gpu, frame, cfg, 0, backend=plain)
        s, u = comp.shadowed, comp.unshadowed
        for i in range(4):
            s, u = atrous_pair_iteration_plain(s, u, comp.normal, comp.position, i + 1, *PHIS)
        img_p = ratio_combine(comp.analytic, s, u).cpu().numpy()
    assert np.isfinite(img_k).all() and img_k.std() > 0
    assert (np.abs(img_k - img_p) > 2e-3).mean() < 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["v7", "v9", "v8"])
@pytest.mark.parametrize("common", [None, "origin", "dir"])
def test_masked_kernels_match_twins(cuda, kernel, common):
    """Each kernel's masked variant against its masked twin; the masks
    reject some hits the unmasked kernel keeps."""
    gpu = _alpha_soup_scene().to(cuda)
    rays = _ray_tiles(common, 8, cuda, n=1000)
    if kernel == "v7":
        keys, id_mask = v7.cull_keys(rays, gpu.pallas_cl_min, gpu.pallas_cl_max)
        args = (rays, keys, gpu.pallas_panels, id_mask, "closest", common)
        amask, counter = gpu.pallas_amask, v7.trace_blocks
        launch, twin = v7.trace_keys_kernel, v7.trace_keys_plain
    elif kernel == "v9":
        keys, id_mask = v7.cull_quarter_keys(rays, gpu.q_cl_min, gpu.q_cl_max)
        args = (rays, keys, gpu.q_panels, gpu.q_group_off, id_mask, common)
        amask, counter = gpu.q_amask, qb.trace_blocks_quarter
        launch, twin = qb.trace_quarter_kernel, qb.trace_quarter_plain
    else:
        coeff, sup, blk, nsup = hb._hier_inputs(gpu)
        args = (rays, sup, blk, coeff, nsup, "closest", common, None)
        amask, counter = gpu.pallas_amask, hb.trace_blocks_hier
        launch, twin = hb.trace_hier_kernel, hb.trace_hier_plain
    before = (counter.launches, counter.masked_launches)
    k = launch(*args, amask=amask)
    assert (counter.launches, counter.masked_launches) == (before[0], before[1] + 1)
    p = twin(*args, amask=amask)
    _same_closest(k, p)
    unmasked = launch(*args)
    assert bool((unmasked[1][:, 0] != k[1][:, 0]).any())
    if kernel == "v8":
        counted = launch(*args, count=True, amask=amask)
        assert torch.equal(counted[0][:, 0], k[0][:, 0]) and torch.equal(counted[1][:, 0], k[1][:, 0])


@pytest.mark.cuda
def test_masked_kernels_refuse_occlusion(cuda):
    gpu = _alpha_soup_scene(200).to(cuda)
    rays = _ray_tiles(None, 3, cuda)
    keys, id_mask = v7.cull_keys(rays, gpu.pallas_cl_min, gpu.pallas_cl_max)
    with pytest.raises(ValueError, match="closest"):
        v7.trace_keys_kernel(rays, keys, gpu.pallas_panels, id_mask, "occluded",
                             amask=gpu.pallas_amask)
    coeff, sup, blk, nsup = hb._hier_inputs(gpu)
    with pytest.raises(ValueError, match="closest"):
        hb.trace_hier_kernel(rays, sup, blk, coeff, nsup, "occluded", amask=gpu.pallas_amask)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_alpha_frame_kernels_match_twins(cuda, backend):
    """textured_obj's alpha-tested frame: masked kernels on both routes,
    against the same ladder over the plain twins."""
    from realtimeraytracer_torch.render.alpha import wrap_backend_with_alpha

    scene = scenes.textured_obj()
    gpu = scene.compile().to(cuda)
    cfg = RenderConfig(width=64, height=36, primary_rays=1, shadow_rays=2,
                       denoise_iterations=4, alpha_test=True, backend=backend,
                       sort_shadows_min_rays=0)
    frame = scene.camera.viewport_frame(64, 36, device=cuda)
    counters = (v7.trace_blocks, qb.trace_blocks_quarter, hb.trace_blocks_hier)
    before = [c.masked_launches for c in counters]
    img_k = render_pipeline_gpu(gpu, frame, cfg).cpu().numpy()
    masked = [c.masked_launches - b for c, b in zip(counters, before)]
    if backend == "auto":
        assert masked[0] == 0 and masked[1] >= 2 and masked[2] >= 2 * 4
        plain = make_hybrid_backend(gpu, cfg, plain=True)
    else:
        assert masked[0] >= 2 + 2 * 4 and masked[1] == masked[2] == 0
        plain = v7.make_v7_backend(gpu, cfg, trace=v7.trace_blocks_plain)
    plain = wrap_backend_with_alpha(plain, gpu, cfg)
    with torch.inference_mode():
        comp = render_components(gpu, frame, cfg, 0, backend=plain)
        s, u = comp.shadowed, comp.unshadowed
        for i in range(4):
            s, u = atrous_pair_iteration_plain(s, u, comp.normal, comp.position, i + 1, *PHIS)
        img_p = ratio_combine(comp.analytic, s, u).cpu().numpy()
    assert np.isfinite(img_k).all() and img_k.std() > 0
    assert (np.abs(img_k - img_p) > 2e-3).mean() < 5e-3


def _foliage_instanced(device):
    scene = scenes.foliage_field(target_tris=20_000)
    gpu = scene.compile()
    assert gpu.instanced
    return scene, gpu.to(device)


def _inst_primaries(scene, device, w=64, h=36):
    from realtimeraytracer_torch.ops.camera_rays import generate_rays

    o, d = generate_rays(scene.camera.viewport_frame(w, h), w, h, jitter=True)
    r = o.shape[0]
    return v7._pack_rays(*(x.to(device) for x in (o, d, torch.full((r,), 1e-3),
                                                   torch.full((r,), 1e4))))[0]


def _same_instances(k, p):
    """Instance ids (outi row 2) equal, or else the two t equal."""
    kf, pf = k[0][:, 0].cpu().numpy(), p[0][:, 0].cpu().numpy()
    ki, pi = k[1][:, 2].cpu().numpy(), p[1][:, 2].cpu().numpy()
    assert ((ki == pi) | (kf == pf)).all()
    assert (ki[k[1][:, 0].cpu().numpy() < 0] == -1).all()


def test_inst_kernel_refuses_cpu_tensors():
    gpu = _blob_like_instanced(20)
    rays = _ray_tiles(None, 1, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        hb.trace_hier_inst_kernel(rays, *hb._inst_args(gpu), "closest")


def _blob_like_instanced(k, n=50, seed=0):
    """k instances on a grid of one n-triangle soup: k (instance, super)
    pairs."""
    from realtimeraytracer_torch.scene.geometry import MeshInstance

    r = np.random.default_rng(seed)
    tris = (r.uniform(-0.4, 0.4, (n, 1, 3)) + r.normal(0, 0.1, (n, 3, 3))).astype(np.float32)
    mesh = TriangleMesh(vertices=tris.reshape(-1, 3),
                        faces=np.arange(3 * n, dtype=np.int32).reshape(n, 3))
    s = Scene()
    side = int(np.ceil(np.sqrt(k)))
    for i in range(k):
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = ((i % side) - side / 2, 0.0, (i // side) - side / 2)
        if i % 3 == 1:
            t[:3, :3] = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], np.float32) * 0.8
        s.add(MeshInstance(mesh=mesh, transform=t))
    return s.compile()


@pytest.mark.cuda
@pytest.mark.parametrize("query", ["closest", "occluded", "masked_closest"])
def test_inst_kernel_matches_twin(cuda, query):
    """foliage_field(20_000) compiled instanced (273 pairs on 3 pages): the
    instanced kernel against its twin on jittered primaries and on
    segments from their hits toward light triangle 0."""
    scene, gpu = _foliage_instanced(cuda)
    args = hb._inst_args(gpu)
    rays = _inst_primaries(scene, cuda)
    amask = gpu.pallas_amask if query == "masked_closest" else None
    mode = "occluded" if query == "occluded" else "closest"
    if mode == "occluded":
        prim = hb.trace_hier_inst_plain(rays, *args, "closest")
        o = rays[:, 0:3].permute(0, 2, 1).reshape(-1, 3)
        d = rays[:, 3:6].permute(0, 2, 1).reshape(-1, 3)
        t = prim[0][:, 0].reshape(-1)
        hit = prim[1][:, 0].reshape(-1) >= 0
        p = o + d * torch.where(hit, t, 0.0)[:, None] - d * 1e-3
        delta = (gpu.lt_v0[0] + gpu.lt_v1[0] + gpu.lt_v2[0]) / 3.0 - p
        dist = delta.norm(dim=1)
        rays = v7._pack_rays(p, delta / dist[:, None], torch.where(hit, 1e-3, BIG_T),
                             torch.where(hit, dist - 0.05, -BIG_T))[0]
    counter = "masked_launches_inst" if amask is not None else "launches_inst"
    before = getattr(hb.trace_blocks_hier, counter)
    k = hb.trace_hier_inst_kernel(rays, *args, mode, amask=amask)
    assert getattr(hb.trace_blocks_hier, counter) == before + 1
    p = hb.trace_hier_inst_plain(rays, *args, mode, amask)
    if mode == "closest":
        _same_closest(k, p)
        _same_instances(k, p)
    else:
        _same_occluded(k, p)
    counted = hb.trace_hier_inst_kernel(rays, *args, mode, count=True, amask=amask)
    assert torch.equal(counted[0][:, 0], k[0][:, 0]) and torch.equal(counted[1][:, 0:3], k[1][:, 0:3])
    _fewer_pairs(counted, p, rays)
    assert counted[1][:, 6].sum() > 0 and counted[1][:, 7].sum() > 0


@pytest.mark.cuda
def test_inst_kernel_near_pair_capacity(cuda):
    """3,000 (instance, super) pairs of the kernel's 3,072: the L1 sort at
    4,096 keys, pair ids in 12 bits."""
    gpu = _blob_like_instanced(3000).to(cuda)
    assert int(gpu.pair_tab[:, 3].sum()) == 3000
    args = hb._inst_args(gpu)
    rays = _ray_tiles(None, 9, cuda, n=1000, span=28.0)
    for mode in ("closest", "occluded"):
        k = hb.trace_hier_inst_kernel(rays, *args, mode)
        p = hb.trace_hier_inst_plain(rays, *args, mode)
        if mode == "closest":
            _same_closest(k, p)
            _same_instances(k, p)
        else:
            _same_occluded(k, p)


@pytest.mark.cuda
def test_instanced_alpha_frame_kernels_match_twins(cuda):
    """The instanced foliage's alpha-tested frame launches only the
    instanced v8 kernels and A-Trous, and matches the twins' frame."""
    from realtimeraytracer_torch.render.alpha import wrap_backend_with_alpha

    scene, gpu = _foliage_instanced(cuda)
    cfg = RenderConfig(width=64, height=36, primary_rays=1, shadow_rays=2,
                       denoise_iterations=4, alpha_test=True)
    frame = scene.camera.viewport_frame(64, 36, device=cuda)
    h = hb.trace_blocks_hier
    names = ("launches", "masked_launches", "launches_inst", "masked_launches_inst")
    before = [getattr(h, n) for n in names]
    v7_before = (v7.trace_blocks.launches, v7.trace_blocks.masked_launches)
    img_k = render_pipeline_gpu(gpu, frame, cfg).cpu().numpy()
    got = [getattr(h, n) - b for n, b in zip(names, before)]
    # Under the alpha test every trace is a masked closest one (occlusion
    # is a ladder of closest traces).
    assert got[0] == got[1] == got[2] == 0 and got[3] > 0
    assert (v7.trace_blocks.launches, v7.trace_blocks.masked_launches) == v7_before
    plain = wrap_backend_with_alpha(hb.make_hier_backend(gpu, cfg, trace=hb.trace_blocks_hier_plain),
                                    gpu, cfg)
    with torch.inference_mode():
        comp = render_components(gpu, frame, cfg, 0, backend=plain)
        s, u = comp.shadowed, comp.unshadowed
        for i in range(4):
            s, u = atrous_pair_iteration_plain(s, u, comp.normal, comp.position, i + 1, *PHIS)
        img_p = ratio_combine(comp.analytic, s, u).cpu().numpy()
    assert np.isfinite(img_k).all() and img_k.std() > 0
    assert (np.abs(img_k - img_p) > 2e-3).mean() < 5e-3
