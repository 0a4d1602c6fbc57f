"""The port's CUDA kernels against their plain PyTorch twins.

This file imports no JAX, so that it also runs on a GPU machine without
jax (whose tests/conftest.py cannot load):

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tests marked ``cuda`` need an NVIDIA GPU and nvcc and skip without a GPU.
The instanced v8 kernel is held to its twin on foliage_field(20_000)
compiled instanced and at 3,000 (instance, super) pairs, with instance ids
equal or t equal.
The masked variants (alpha masks in closest mode) are held to their twins
by the same rule on a soup of alpha-mapped triangles.  The multi-segment
v8 kernel (hier_occluded_multi) is held to its twin and to one single v8
occluded launch per sample, flags equal, for S = 1, 3 and 8, on tiles
whose every ray is inactive (no visit, no pop), on rays whose samples the
single traces retire in different blocks and on S = 8 directions that all
straddle zero; on the CPU its entry refuses bad inputs before any build,
and its dynamic shared memory per S is checked; the FMA peak
probe to its twin under rtol 1e-6 (the twin rounds each FMA step through
float64, which differs from the fused rounding only in rare ties).
The v9 kernel culls in its prologue: it is held to the plain cull followed
by the twin (as below) and, every output row exactly, to the plain cull
followed by trace_quarter_ordered (the kernel's visit loop in torch), on
1,024 blocks (the in-kernel cull's capacity) and on streams that drain at
different visits.  v8's redesign (staging, live-ray culls, rank sorts, the
transposed visit) is held to the twin on tiles whose hints retire every
ray, on L1 key lists longer than a warp (34 supers; the 2,584-pair
instanced foliage) and on a tie of quantized t across two blocks, which
goes to the block visited first (the v8 twin takes the lower block id).
The wavefront multi-bounce frame (render/wavefront.py) is held to its
twins at 160x90 on the hybrid and the "pallas" route, with its launches.
On the CPU: the fused v9 entry refuses bad inputs before any build, the
ordered loop agrees with the twin, and each ctypes signature matches its
C entry.
The A-Trous pair's backward (B5b, csrc/atrous_pair_vjp.cu) is held to
autograd of the twin at steps 1 to 40, with and without the normal and
position gradients, and through atrous_denoise_pair under autograd.
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
    atrous_denoise_pair, atrous_pair_iteration_kernel, atrous_pair_iteration_plain,
    atrous_pair_iteration_vjp_kernel, atrous_pair_iteration_vjp_plain, atrous_pair_slab)
from realtimeraytracer_torch.ops.denoise import ratio_combine
from realtimeraytracer_torch.render import hier_backend as hb
from realtimeraytracer_torch.render import quarter_backend as qb
from realtimeraytracer_torch.render import v7_backend as v7
from realtimeraytracer_torch.render.backends import make_hybrid_backend
from realtimeraytracer_torch.render.megakernel import render_components
from realtimeraytracer_torch.render.pipeline import render_pipeline_gpu
from realtimeraytracer_torch.render.wavefront import render_wavefront
from realtimeraytracer_torch.scene.geometry import TriangleMesh
from realtimeraytracer_torch.scene.materials import Material
from realtimeraytracer_torch.scene.panels import RESIDENT_CB
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


def _same_v9(k, rays, cl_min, cl_max, coeff, group_off, common, amask=None):
    """The fused v9 kernel's outputs k against the plain cull followed by
    the twin (hits, t, ids) and by the ordered visit loop (every row,
    exactly: the in-kernel keys give the same visits and pairs)."""
    keys, id_mask = v7.cull_quarter_keys(rays, cl_min, cl_max)
    p = qb.trace_quarter_plain(rays, keys, coeff, group_off, id_mask, common, amask)
    o = qb.trace_quarter_ordered(rays, keys, coeff, group_off, id_mask, common, amask)
    _same_closest(k, p)
    assert torch.equal(k[0], o[0]) and torch.equal(k[1], o[1])
    _fewer_pairs(k, p, rays)
    return p


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
    with pytest.raises(ValueError, match="CUDA"):
        v7.trace_v7_kernel(rays, gpu.pallas_cl_min, gpu.pallas_cl_max, gpu.pallas_panels,
                           "closest")
    with pytest.raises(ValueError, match="CUDA"):
        atrous_pair_iteration_kernel(*_denoise_data(8, 8, 0), 1, *PHIS)


def _same_v7(k, rays, cl_min, cl_max, coeff, mode, common, amask=None):
    """The fused v7 kernel's outputs k against the plain cull followed by
    the twin (hits, t, ids, flags) and by the ordered visit loop (every
    row, exactly: the in-kernel keys give the same visits and pairs)."""
    keys, id_mask = v7.cull_keys(rays, cl_min, cl_max)
    p = v7.trace_keys_plain(rays, keys, coeff, id_mask, mode, common, amask)
    o = v7.trace_keys_ordered(rays, keys, coeff, id_mask, mode, common, amask)
    (_same_closest if mode == "closest" else _same_occluded)(k, p)
    assert torch.equal(k[0], o[0]) and torch.equal(k[1], o[1])
    _fewer_pairs(k, p, rays)
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("mode,common", [("closest", None), ("closest", "origin"),
                                         ("occluded", None), ("occluded", "dir")])
def test_v7_kernel_matches_twin(cuda, mode, common):
    """The kernel culls in its prologue: its outputs equal the plain cull
    followed by the twin (t, ids, flags) and by the ordered visit loop
    (every row)."""
    gpu = _soup_scene().to(cuda)
    rays = _ray_tiles(common, 5, cuda)
    before = v7.trace_blocks.launches
    k = v7.trace_v7_kernel(rays, gpu.pallas_cl_min, gpu.pallas_cl_max, gpu.pallas_panels, mode,
                           common)
    assert v7.trace_blocks.launches == before + 1
    _same_v7(k, rays, gpu.pallas_cl_min, gpu.pallas_cl_max, gpu.pallas_panels, mode, common)


@pytest.mark.cuda
def test_v7_kernel_rejects_grad_inputs(cuda):
    gpu = _soup_scene(200).to(cuda)
    rays = _ray_tiles(None, 2, cuda)
    with pytest.raises(ValueError, match="grad"):
        v7.trace_v7_kernel(rays.requires_grad_(), gpu.pallas_cl_min, gpu.pallas_cl_max,
                           gpu.pallas_panels, "closest")


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
    """The kernel culls in its prologue: its outputs equal the plain cull
    followed by the twin (t, ids) and by the ordered visit loop (every
    row)."""
    gpu = _soup_scene().to(cuda)
    rays = _ray_tiles(common, 5, cuda)
    before = qb.trace_blocks_quarter.launches
    k = qb.trace_quarter_kernel(rays, gpu.q_cl_min, gpu.q_cl_max, gpu.q_panels,
                                gpu.q_group_off, common)
    assert qb.trace_blocks_quarter.launches == before + 1
    _same_v9(k, rays, gpu.q_cl_min, gpu.q_cl_max, gpu.q_panels, gpu.q_group_off, common)


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
@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_wavefront_kernels_match_twins(cuda, backend):
    """The multi-bounce frame: hybrid (v9 at bounce 0, v8 incoherent
    closest and unhinted occlusion) or pallas (v7 everywhere), 160x90."""
    scene = scenes.procedural_mesh(3000, sun=True)
    gpu = scene.compile().to(cuda)
    cfg = RenderConfig(width=160, height=90, primary_rays=2, shadow_rays=1, max_bounces=2,
                       backend=backend)
    frame = scene.camera.viewport_frame(160, 90, device=cuda)
    counters = (v7.trace_blocks, qb.trace_blocks_quarter, hb.trace_blocks_hier)
    before = [c.launches for c in counters]
    img_k = render_wavefront(gpu, frame, cfg).cpu().numpy()
    counts = [c.launches - b for c, b in zip(counters, before)]
    # Per sample: 3 closest traces (bounces 0-2), 2 x 2 occlusions (bounces 0-1).
    assert counts == ([0, 2, 2 * 6] if backend == "auto" else [2 * 7, 0, 0])
    plain = (make_hybrid_backend(gpu, cfg, plain=True) if backend == "auto"
             else v7.make_v7_backend(gpu, cfg, trace=v7.trace_blocks_plain))
    img_p = render_wavefront(gpu, frame, cfg, backend=plain).cpu().numpy()
    assert [c.launches - b for c, b in zip(counters, before)] == counts
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
        args = ()
        amask, counter = gpu.pallas_amask, v7.trace_blocks

        def launch(amask=None):
            return v7.trace_v7_kernel(rays, gpu.pallas_cl_min, gpu.pallas_cl_max,
                                      gpu.pallas_panels, "closest", common, amask)

        def twin(amask=None):
            return v7.trace_keys_plain(rays, keys, gpu.pallas_panels, id_mask, "closest",
                                       common, amask)
    elif kernel == "v9":
        keys, id_mask = v7.cull_quarter_keys(rays, gpu.q_cl_min, gpu.q_cl_max)
        args = ()
        amask, counter = gpu.q_amask, qb.trace_blocks_quarter

        def launch(amask=None):
            return qb.trace_quarter_kernel(rays, gpu.q_cl_min, gpu.q_cl_max, gpu.q_panels,
                                           gpu.q_group_off, common, amask)

        def twin(amask=None):
            return qb.trace_quarter_plain(rays, keys, gpu.q_panels, gpu.q_group_off, id_mask,
                                          common, amask)
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
    if kernel == "v9":
        _same_v9(k, rays, gpu.q_cl_min, gpu.q_cl_max, gpu.q_panels, gpu.q_group_off, common,
                 amask)
    if kernel == "v7":
        _same_v7(k, rays, gpu.pallas_cl_min, gpu.pallas_cl_max, gpu.pallas_panels, "closest",
                 common, amask)
    unmasked = launch(*args)
    assert bool((unmasked[1][:, 0] != k[1][:, 0]).any())
    if kernel == "v8":
        counted = launch(*args, count=True, amask=amask)
        assert torch.equal(counted[0][:, 0], k[0][:, 0]) and torch.equal(counted[1][:, 0], k[1][:, 0])


@pytest.mark.cuda
def test_masked_kernels_refuse_occlusion(cuda):
    gpu = _alpha_soup_scene(200).to(cuda)
    rays = _ray_tiles(None, 3, cuda)
    with pytest.raises(ValueError, match="closest"):
        v7.trace_v7_kernel(rays, gpu.pallas_cl_min, gpu.pallas_cl_max, gpu.pallas_panels,
                           "occluded", amask=gpu.pallas_amask)
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


# ---- multi-segment occlusion (hier_occluded_multi) and the FMA probe -------

def _multi_segments(device, s_count, n=1000, seed=21, case="mixed"):
    """(o, dirs, tlo, this) of n rays: S directions toward jittered points
    of a light patch above, every third ray's directions straddling zero
    in x and z across the samples, one direction with an x component below
    the parallel-axis epsilon; 20% of the rays inactive.  case "straddling":
    every ray's directions straddle zero in x and z; "inactive tiles":
    also every ray of tiles 1 and 3 inactive."""
    r = np.random.default_rng(seed)
    o = r.uniform(-6, 6, (n, 3)).astype(np.float32)
    dirs, this = [], []
    for s in range(s_count):
        lp = np.array([0.0, 8.0, 0.0]) + r.normal(0, 0.5, (n, 3))
        every = 1 if case == "straddling" else 3
        lp[::every, 0] = o[::every, 0] + r.uniform(-3, 3, len(o[::every]))
        lp[::every, 2] = o[::every, 2] + r.uniform(-3, 3, len(o[::every]))
        delta = (lp - o).astype(np.float32)
        if s == 0:
            delta[1::3, 0] = 1e-13
        dist = np.linalg.norm(delta, axis=1)
        dirs.append((delta / dist[:, None]).astype(np.float32))
        this.append((dist - 0.5).astype(np.float32))
    act = r.random(n) > 0.2
    if case == "inactive tiles":
        act[128:256] = act[384:512] = False
    tlo = np.where(act, 1e-3, BIG_T).astype(np.float32)
    this = [np.where(act, h, -BIG_T).astype(np.float32) for h in this]
    to = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    return to(o), [to(d) for d in dirs], to(tlo), [to(h) for h in this]


def test_multi_kernel_refuses_cpu_tensors():
    gpu = _soup_scene(200)
    coeff, sup, blk, nsup = hb._hier_inputs(gpu)
    o, ds, lo, hs = _multi_segments("cpu", 2, n=300)
    rays, _ = hb.pack_rays_multi(o, ds, lo, hs)
    with pytest.raises(ValueError, match="CUDA"):
        hb.trace_hier_multi_kernel(rays, sup, blk, coeff, nsup)


@pytest.mark.cuda
@pytest.mark.parametrize("n_tris,s_count,case", [
    (1000, 1, "mixed"), (1000, 3, "mixed"), (1000, 8, "mixed"), (17000, 1, "mixed"),
    (17000, 3, "mixed"), (17000, 8, "mixed"), (17000, 3, "inactive tiles"),
    (17000, 3, "retired apart"), (17000, 8, "straddling")])
def test_multi_kernel_matches_twin_and_singles(cuda, n_tris, s_count, case):
    """Flags equal the twin's and S single v8 occluded launches'; the
    counting variant gives the same flags and tests no more pairs than the
    twin.  "inactive tiles": tiles whose every ray is inactive visit and pop
    nothing; "retired apart": rays whose samples the single traces retire
    in different blocks; "straddling": every ray's hull straddles zero in x
    and z."""
    gpu = _soup_scene(n_tris).to(cuda)
    coeff, sup, blk, nsup = hb._hier_inputs(gpu)
    o, ds, lo, hs = _multi_segments(cuda, s_count, case=case)
    rays, n = hb.pack_rays_multi(o, ds, lo, hs)
    before = hb.trace_blocks_hier.launches_multi
    k = hb.trace_hier_multi_kernel(rays, sup, blk, coeff, nsup)
    assert hb.trace_blocks_hier.launches_multi == before + 1
    p = hb.trace_hier_multi_plain(rays, sup, blk, coeff, nsup)
    assert torch.equal(k[0][:, :s_count], p[0][:, :s_count])
    occ, first = 0, []
    for s in range(s_count):
        single = v7._pack_rays(o, ds[s], lo, hs[s])[0]
        f, i = hb.trace_hier_kernel(single, sup, blk, coeff, nsup, "occluded")
        assert torch.equal(k[0][:, s], f[:, 0]), f"sample {s}"
        occ += int(f[:, 0].sum())
        first.append(i[:, 0])
    assert 10 < occ < s_count * n - 10
    if case == "inactive tiles":
        for t in (1, 3):
            assert not k[0][t].any() and not k[1][t, 0:2].any()
    if case == "retired apart":
        apart = (first[0] >= 0) & (first[1] >= 0) & (first[0] != first[1])
        assert int(apart.sum()) > 10
    c = hb.trace_hier_multi_kernel(rays, sup, blk, coeff, nsup, count=True)
    assert torch.equal(c[0], k[0]) and torch.equal(c[1][:, 0:2], k[1][:, 0:2])
    assert c[1][:, 5].sum() > 0 and (c[1][:, 5] <= p[1][:, 5]).all()
    assert c[1][:, 4].sum() > 0 and c[1][:, 6].sum() > 0 and c[1][:, 7].sum() > 0


def _multi_entry_args(case):
    """Arguments of the multi-segment entry with one defect each (CPU
    tensors)."""
    gpu = _soup_scene(200)
    coeff, sup, blk, nsup = hb._hier_inputs(gpu)
    o, ds, lo, hs = _multi_segments("cpu", 2, n=300)
    rays, _ = hb.pack_rays_multi(o, ds, lo, hs)
    args = dict(rays=rays, sup_panel=sup, blk_panels=blk, coeff=coeff, nsup=nsup)
    if case == "nine samples":
        args["rays"] = torch.zeros((rays.shape[0], 40, 128))
    elif case == "f64 rays":
        args["rays"] = rays.double()
    elif case == "blk shape":
        args["blk_panels"] = torch.zeros((nsup + 1, 8, 128))
    elif case == "too few supers":
        args["coeff"] = torch.zeros((nsup * hb.SUP + 1, 12, 128))
    return args


@pytest.mark.parametrize("case,match", [("cpu tensors", "CUDA"), ("nine samples", "1 <= S"),
                                        ("f64 rays", "float32"), ("blk shape", "shape"),
                                        ("too few supers", "covering every block")])
def test_multi_entry_refuses_bad_inputs_before_any_build(monkeypatch, case, match):
    """The multi-segment entry checks its sample count, layouts, supers and
    devices before it builds or launches anything."""
    from realtimeraytracer_torch import kernels

    def no_build(*a, **k):
        raise AssertionError("the kernel was built or launched")

    monkeypatch.setattr(kernels, "kernel", no_build)
    monkeypatch.setattr(kernels, "build", no_build)
    before = hb.trace_blocks_hier.launches_multi
    with pytest.raises(ValueError, match=match):
        hb.trace_hier_multi_kernel(**_multi_entry_args(case))
    assert hb.trace_blocks_hier.launches_multi == before


@pytest.mark.parametrize("s_count,nsup,want", [(1, 1, 3588), (3, 7, 10784), (8, 8, 28704),
                                               (8, 3072, 45056)])
def test_multi_dynamic_smem_per_sample_count(s_count, nsup, want):
    """The multi-segment launch's dynamic shared memory: 28 bytes a ray and
    sample (d | t_hi, the inverse direction) and the L1 keys padded to a
    power of two; S = 8 at the most supers the v8 kernel takes stays far
    below the 227 KB a CTA may opt into, beside its static part (about 32
    KB)."""
    assert hb.multi_dynamic_smem(s_count, nsup) == want
    assert hb.multi_dynamic_smem(8, hb.SPAGES * 128) + 40 * 1024 <= v7._SMEM_LIMIT


@pytest.mark.cuda
def test_fma_peak_kernel_matches_twin(cuda):
    from realtimeraytracer_torch.probes import fma_peak, fma_peak_kernel, fma_peak_plain

    x = torch.from_numpy(np.random.default_rng(3).uniform(0.5, 1.5, (512, 128))
                         .astype(np.float32)).to(cuda)
    torch.testing.assert_close(fma_peak_kernel(x), fma_peak_plain(x), rtol=1e-6, atol=0.0)
    ms, tflops, out = fma_peak(cuda, iters=4)
    assert ms > 0 and tflops > 0
    torch.testing.assert_close(out, fma_peak_plain(torch.ones_like(out)), rtol=1e-6, atol=0.0)


# ---- the redesigned v8 and the fused v9 (in-kernel quarter cull) ----------

def _lattice_tris(nblocks, seed=0, far_quarters_every=0):
    """nblocks x 128 small triangles, block b's in cell b of a lattice of
    unit cells (row-major over 16 x 16 columns), in block order, so that
    blocks and supers are compact.  far_quarters_every = k > 0 moves lanes
    32-127 of every k-th block far away, so that quarter 0's stream
    outlasts the other three."""
    r = np.random.default_rng(seed)
    b = np.arange(nblocks)
    cell = np.stack([b % 16, (b // 16) % 16, b // 256], 1).astype(np.float32) - 8.0
    tris = (cell[:, None, None, :] + r.uniform(0, 1, (nblocks, 128, 1, 3))
            + r.normal(0, 0.15, (nblocks, 128, 3, 3))).astype(np.float32)
    if far_quarters_every:
        tris[::far_quarters_every, 32:] += np.float32(1000.0)
    return tris.reshape(-1, 3, 3)


def _pinhole_tiles(device, common, seed, side=64):
    """A side x side pinhole image of the lattice from z = -40, in tiles of
    16 x 8 pixels (coherent bundles); common=None jitters each origin."""
    r = np.random.default_rng(seed)
    ty, tx, py, px = np.meshgrid(np.arange(side // 8), np.arange(side // 16), np.arange(8),
                                 np.arange(16), indexing="ij")
    x = ((tx * 16 + px + 0.5) / side - 0.5) * 0.5
    y = ((ty * 8 + py + 0.5) / side - 0.5) * 0.5
    d = np.stack([x.ravel(), y.ravel(), np.ones(x.size)], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.tile([0.0, 0.0, -40.0], (x.size, 1))
    if common is None:
        o += r.normal(0, 0.05, o.shape)
    n = x.size
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    return v7._pack_rays(to(o), to(d), to(np.full(n, 1e-3)), to(np.full(n, 1e3)))[0]


def _panels(tris, device):
    """(coeff, cl_min, cl_max) of triangles (T, 3, 3) in the given order:
    no BVH sort, no repack (group_off None)."""
    from realtimeraytracer_torch.scene.panels import pack_clusters_np

    return tuple(torch.from_numpy(x).to(device)
                 for x in pack_clusters_np(tris[:, 0], tris[:, 1], tris[:, 2]))


def _v9_entry_args(case, device):
    """Arguments of the fused v9 entry with one defect each."""
    gpu = _soup_scene(200)
    rays = _ray_tiles(None, 3, "cpu")
    args = dict(rays=rays, cl_min=gpu.q_cl_min, cl_max=gpu.q_cl_max, coeff=gpu.q_panels,
                group_off=gpu.q_group_off)
    if case == "f64 rays":
        args["rays"] = rays.double()
    elif case == "cl_min shape":
        args["cl_min"] = gpu.q_cl_min[:-4]
    elif case == "group_off dtype":
        args["group_off"] = gpu.q_group_off.long()
    elif case == "over capacity":
        n = RESIDENT_CB + 1
        args.update(coeff=torch.zeros((n, 12, 128)), cl_min=torch.zeros((4 * n, 3)),
                    cl_max=torch.zeros((4 * n, 3)), group_off=None)
    return args


@pytest.mark.parametrize("case,match", [("cpu tensors", "CUDA"), ("f64 rays", "float32"),
                                        ("cl_min shape", "shape"), ("group_off dtype", "int32"),
                                        ("over capacity", "1024 blocks")])
def test_v9_entry_refuses_bad_inputs_before_any_build(monkeypatch, case, match):
    """The fused v9 entry checks layouts, capacity and devices before it
    builds or launches anything."""
    from realtimeraytracer_torch import kernels

    def no_build(*a, **k):
        raise AssertionError("the kernel was built or launched")

    monkeypatch.setattr(kernels, "kernel", no_build)
    monkeypatch.setattr(kernels, "build", no_build)
    before = qb.trace_blocks_quarter.launches
    with pytest.raises(ValueError, match=match):
        qb.trace_quarter_kernel(**_v9_entry_args(case, "cpu"))
    assert qb.trace_blocks_quarter.launches == before


@pytest.mark.parametrize("common", [None, "origin"])
def test_v9_ordered_loop_agrees_with_twin(common):
    """trace_quarter_ordered (the kernel's visit loop, which checks the
    fused kernel's visit and pair rows on the card) finds the twin's hits,
    t and ids, in no more visits and pairs."""
    gpu = _soup_scene(3000)
    rays = _ray_tiles(common, 5, "cpu", n=700)
    keys, id_mask = v7.cull_quarter_keys(rays, gpu.q_cl_min, gpu.q_cl_max)
    p = qb.trace_quarter_plain(rays, keys, gpu.q_panels, gpu.q_group_off, id_mask, common)
    o = qb.trace_quarter_ordered(rays, keys, gpu.q_panels, gpu.q_group_off, id_mask, common)
    assert torch.equal(o[0][:, 0], p[0][:, 0])
    assert torch.equal(o[1][:, 0], p[1][:, 0])
    assert (o[1][:, 1] <= p[1][:, 1]).all() and (o[1][:, 5] <= p[1][:, 5]).all()
    assert o[1][:, 1].sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("nblocks,far,common", [(1024, 0, "origin"), (1024, 3, None),
                                                (300, 2, "origin")])
def test_v9_fused_cull_capacity_and_drained_streams(cuda, nblocks, far, common):
    """1,024 blocks (the in-kernel cull's capacity, 4,096 subcluster keys)
    and streams that drain at different visits (far quarters)."""
    coeff, cl_min, cl_max = _panels(_lattice_tris(nblocks, 4, far), cuda)
    assert coeff.shape[0] == nblocks
    rays = _pinhole_tiles(cuda, common, 11)
    k = qb.trace_quarter_kernel(rays, cl_min, cl_max, coeff, None, common)
    _same_v9(k, rays, cl_min, cl_max, coeff, None, common)
    keys, _ = v7.cull_quarter_keys(rays, cl_min, cl_max)
    n = (keys.reshape(rays.shape[0], 4, -1) != v7.INVALID).sum(dim=2)
    assert bool((n.amax(dim=1) > n.amin(dim=1)).any())          # some stream drains first


def _tie_tris():
    """Six blocks: one triangle X (plane y = 0) at lane 7 of blocks 0 and 5;
    block 5's lane 8 holds a small triangle at y = 3 off the rays' path, so
    its box (and its quarter 0's) is entered first from above; every other
    lane a small far triangle."""
    far = np.array([[50, 0, 50], [50.1, 0, 50], [50, 0, 50.1]], np.float32)
    tris = np.tile(far, (6 * 128, 1, 1))
    x = np.array([[-1, 0, -1], [1, 0, -1], [0, 0, 1]], np.float32)
    tris[7] = x
    tris[5 * 128 + 7] = x
    tris[5 * 128 + 8] = np.array([[10, 3, 0], [10.1, 3, 0], [10, 3, 0.1]], np.float32)
    return tris


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["v8", "v9", "v7"])
def test_equal_t_across_blocks_goes_to_the_first_visited(cuda, kernel):
    """Two copies of one triangle in blocks 0 and 5 give equal quantized t;
    block 5 is entered first, so the kernels keep its copy (strict <).  The
    v9 and v7 twins order ties by visit rank and agree; the v8 twin orders
    them by block id and keeps block 0's copy (ROADMAP C)."""
    coeff, cl_min, cl_max = _panels(_tie_tris(), cuda)
    r = np.random.default_rng(12)
    n = 256
    o = np.stack([r.uniform(-0.2, 0.2, n), np.full(n, 5.0), r.uniform(-0.5, 0.1, n)], 1)
    d = np.stack([r.normal(0, 0.005, n), -np.ones(n), r.normal(0, 0.005, n)], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    to = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(cuda)  # noqa: E731
    rays = v7._pack_rays(to(o), to(d), to(np.full(n, 1e-3)), to(np.full(n, 100.0)))[0]
    if kernel == "v9":
        k = qb.trace_quarter_kernel(rays, cl_min, cl_max, coeff, None, None)
        _same_v9(k, rays, cl_min, cl_max, coeff, None, None)
    elif kernel == "v7":
        k = v7.trace_v7_kernel(rays, cl_min, cl_max, coeff, "closest")
        _same_v7(k, rays, cl_min, cl_max, coeff, "closest", None)
    else:
        sup, blk = hb.pack_hierarchy(cl_min, cl_max)
        k = hb.trace_hier_kernel(rays, sup, blk, coeff, blk.shape[0], "closest")
        p = hb.trace_hier_plain(rays, sup, blk, coeff, blk.shape[0], "closest")
        assert torch.equal(k[0][:, 0], p[0][:, 0])
        assert bool((p[1][:, 0] == 7).all())
    assert bool((k[1][:, 0] == 5 * 128 + 7).all())


@pytest.mark.cuda
def test_v8_hints_that_retire_every_ray(cuda):
    """Every ray of every tile is occluded by one quad in block 0: fed its
    own hints, the kernel retires all rays in the hint visits, skips the
    culls (no super popped) and still gives the twin's flags and hints."""
    r = np.random.default_rng(13)
    quad = np.array([[[-9, 2, -9], [9, 2, -9], [9, 2, 9]], [[-9, 2, -9], [9, 2, 9], [-9, 2, 9]]],
                    np.float32)
    soup = _lattice_tris(40, 13)
    soup[..., 1] -= 20.0                                      # below the rays
    tris = np.concatenate([quad, soup[:128 * 40 - 2]])
    coeff, cl_min, cl_max = _panels(tris, cuda)
    sup, blk = hb.pack_hierarchy(cl_min, cl_max)
    n = 1000
    o = np.stack([r.uniform(-6, 6, n), np.zeros(n), r.uniform(-6, 6, n)], 1)
    d = np.stack([r.normal(0, 0.1, n), np.ones(n), r.normal(0, 0.1, n)], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    to = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(cuda)  # noqa: E731
    rays = v7._pack_rays(to(o), to(d), to(np.full(n, 1e-3)), to(np.full(n, 10.0)))[0]
    nsup = blk.shape[0]
    want = hb.trace_hier_plain(rays, sup, blk, coeff, nsup, "occluded")
    cold = hb.trace_hier_kernel(rays, sup, blk, coeff, nsup, "occluded")
    hints = cold[1][:, 3:5, 0].contiguous()
    assert bool((hints == 0).all())
    fed = hb.trace_hier_kernel(rays, sup, blk, coeff, nsup, "occluded", hints=hints, count=True)
    live = (rays[:, 6] <= rays[:, 7]).any(dim=1)
    assert bool((want[0][:, 0][rays[:, 6] <= rays[:, 7]] == 1.0).all())
    for got in (cold, fed):
        assert torch.equal(got[0][:, 0], want[0][:, 0])
        assert torch.equal(got[1][:, 3:5], want[1][:, 3:5])
    assert bool((fed[0][:, 1] == 0).all())                    # no super popped
    assert bool((fed[1][:, 1] == 2).all())                    # the two hint visits
    assert bool((cold[0][:, 1][live] > 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["closest", "occluded"])
def test_v8_l1_sort_beyond_one_warp(cuda, mode):
    """4,229 blocks in 34 supers, non-instanced: each tile of random rays
    overlaps more than 32 super boxes, so the L1 keys span more than one
    warp; flags, t and ids equal the twin's, and the counting variant's
    results equal the plain launch's."""
    coeff, cl_min, cl_max = _panels(_lattice_tris(33 * 128 + 5, 14), cuda)
    sup, blk = hb.pack_hierarchy(cl_min, cl_max)
    nsup = blk.shape[0]
    assert nsup == 34
    rays = _ray_tiles(None, 15, cuda, n=1000, span=8.0)
    k = hb.trace_hier_kernel(rays, sup, blk, coeff, nsup, mode)
    p = hb.trace_hier_plain(rays, sup, blk, coeff, nsup, mode)
    (_same_closest if mode == "closest" else _same_occluded)(k, p)
    c = hb.trace_hier_kernel(rays, sup, blk, coeff, nsup, mode, count=True)
    assert torch.equal(c[0][:, 0:2], k[0][:, 0:2]) and torch.equal(c[1][:, 0:5], k[1][:, 0:5])
    _fewer_pairs(c, p, rays)


@pytest.mark.cuda
@pytest.mark.parametrize("query", ["closest", "occluded", "masked_closest"])
def test_inst_kernel_l1_keys_across_warps(cuda, query):
    """foliage_field() instanced (2,584 pairs): random rays above the field
    with long windows give hundreds of L1 keys per tile (the rank sort with
    several keys per thread, and the bitonic network above 512)."""
    gpu = scenes.foliage_field().compile().to(cuda)
    args = hb._inst_args(gpu)
    r = np.random.default_rng(16)
    n = 1024
    o = np.stack([r.uniform(-15, 15, n), r.uniform(0.5, 4.0, n), r.uniform(-15, 15, n)], 1)
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    to = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(cuda)  # noqa: E731
    rays = v7._pack_rays(to(o), to(d), to(np.full(n, 1e-3)), to(np.full(n, 30.0)))[0]
    amask = gpu.pallas_amask if query == "masked_closest" else None
    mode = "occluded" if query == "occluded" else "closest"
    k = hb.trace_hier_inst_kernel(rays, *args, mode, amask=amask)
    p = hb.trace_hier_inst_plain(rays, *args, mode, amask)
    if mode == "closest":
        _same_closest(k, p)
        _same_instances(k, p)
    else:
        _same_occluded(k, p)


# ---- the fused v7 (in-kernel cull) and the staged A-Trous pair ------------

def _v7_entry_args(case):
    """Arguments of the fused v7 entry with one defect each."""
    gpu = _alpha_soup_scene(200)
    rays = _ray_tiles(None, 3, "cpu")
    args = dict(rays=rays, cl_min=gpu.pallas_cl_min, cl_max=gpu.pallas_cl_max,
                coeff=gpu.pallas_panels, mode="closest", common=None, amask=None)
    if case == "f64 rays":
        args["rays"] = rays.double()
    elif case == "cl_max shape":
        args["cl_max"] = gpu.pallas_cl_max[:-4]
    elif case == "amask dtype":
        args["amask"] = gpu.pallas_amask.long()
    elif case == "masked occlusion":
        args.update(mode="occluded", amask=gpu.pallas_amask)
    elif case == "over capacity":
        # 32,769 blocks: the sorted keys' room (the next power of two, 128
        # KB) and the staging buffers pass the 227 KB a CTA can hold.
        n = 32769
        args.update(coeff=torch.zeros((1, 12, 128)).expand(n, 12, 128),
                    cl_min=torch.zeros((1, 3)).expand(4 * n, 3),
                    cl_max=torch.zeros((1, 3)).expand(4 * n, 3))
    return args


@pytest.mark.parametrize("case,match", [("cpu tensors", "CUDA"), ("f64 rays", "float32"),
                                        ("cl_max shape", "shape"), ("amask dtype", "int32"),
                                        ("masked occlusion", "closest"),
                                        ("over capacity", "shared memory")])
def test_v7_entry_refuses_bad_inputs_before_any_build(monkeypatch, case, match):
    """The fused v7 entry checks layouts, the block count's shared memory
    and devices before it builds or launches anything."""
    from realtimeraytracer_torch import kernels

    def no_build(*a, **k):
        raise AssertionError("the kernel was built or launched")

    monkeypatch.setattr(kernels, "kernel", no_build)
    monkeypatch.setattr(kernels, "build", no_build)
    before = (v7.trace_blocks.launches, v7.trace_blocks.masked_launches)
    with pytest.raises(ValueError, match=match):
        v7.trace_v7_kernel(**_v7_entry_args(case))
    assert (v7.trace_blocks.launches, v7.trace_blocks.masked_launches) == before


def test_v7_entry_takes_32768_blocks():
    """32,768 blocks (4.2M triangles) pass the capacity check, masked too;
    one more does not: the refusal above is the capacity's."""
    assert v7._v7_dynamic_smem(32768, True) <= v7._SMEM_LIMIT - v7._V7_STATIC_SMEM
    assert v7._v7_dynamic_smem(32769, False) > v7._SMEM_LIMIT - v7._V7_STATIC_SMEM


@pytest.mark.parametrize("mode,common,masked", [
    ("closest", None, False), ("closest", "origin", False), ("occluded", None, False),
    ("occluded", "dir", False), ("closest", None, True), ("closest", "origin", True)])
def test_v7_ordered_loop_agrees_with_twin(mode, common, masked):
    """trace_keys_ordered (the kernel's visit loop, which checks the fused
    kernel's visit and pair rows on the card) finds the twin's hits, t, ids
    and flags, in no more visits and pairs."""
    gpu = _alpha_soup_scene(3000) if masked else _soup_scene(3000)
    amask = gpu.pallas_amask if masked else None
    rays = _ray_tiles(common, 5, "cpu", n=700)
    keys, id_mask = v7.cull_keys(rays, gpu.pallas_cl_min, gpu.pallas_cl_max)
    p = v7.trace_keys_plain(rays, keys, gpu.pallas_panels, id_mask, mode, common, amask)
    o = v7.trace_keys_ordered(rays, keys, gpu.pallas_panels, id_mask, mode, common, amask)
    assert torch.equal(o[0][:, 0], p[0][:, 0])
    assert torch.equal(o[1][:, 0], p[1][:, 0])
    assert (o[1][:, 1] <= p[1][:, 1]).all() and (o[1][:, 5] <= p[1][:, 5]).all()
    assert o[1][:, 1].sum() > 0
    assert (o[1][:, 5][rays[:, 6] > rays[:, 7]] == 0).all()


def test_kernel_library_hash_covers_headers(tmp_path, monkeypatch):
    """A library's name hashes its source and every csrc/ header, so an
    edited header (tile_trace.cuh, shared by v7 and v9) is rebuilt, not
    loaded stale."""
    from realtimeraytracer_torch import kernels

    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    first = kernels.library_path("k")
    assert kernels.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert kernels.library_path("k") != first
    assert kernels.library_path("k").name.startswith("k-")


def test_atrous_kernel_refuses_step_zero():
    with pytest.raises(ValueError, match="step"):
        atrous_pair_iteration_kernel(*_denoise_data(8, 8, 0), 0, *PHIS)


def _v7_case(case, device):
    """(coeff, cl_min, cl_max, rays) of the fused v7 edge cases."""
    if case == "8 pages":
        # 7,200 blocks (keys on 8 pages of 1,024, 13 id bits); random rays
        # with long windows make every block a candidate of every tile, so
        # the keys take the bitonic network.
        coeff, cl_min, cl_max = _panels(_lattice_tris(7200, 17), device)
        return coeff, cl_min, cl_max, _ray_tiles(None, 18, device, n=1000, span=8.0)
    coeff, cl_min, cl_max = _panels(_lattice_tris(300, 19), device)
    rays = _pinhole_tiles(device, "origin", 20)
    if case == "no block":
        # The first half of the tiles look away from the lattice: their cull
        # passes no block.
        rays[: rays.shape[0] // 2, 3:6] *= -1.0
    elif case == "zero entry":
        # Rays from the lattice's far x face (all origins on it), looking
        # in: the box entries of the blocks on that face are (+0 * -1) = -0
        # before the +0.0.
        r = np.random.default_rng(21)
        n = 2048
        o = np.stack([np.full(n, float(cl_max[:, 0].max())), r.uniform(-8, 8, n),
                      r.uniform(-7.8, -6.2, n)], 1)
        d = np.tile([-1.0, 0.0, 0.0], (n, 1))
        to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
        rays = v7._pack_rays(to(o), to(d), to(np.full(n, 1e-3)), to(np.full(n, 1e3)))[0]
    return coeff, cl_min, cl_max, rays


@pytest.mark.cuda
@pytest.mark.parametrize("case,mode", [("8 pages", "closest"), ("8 pages", "occluded"),
                                       ("no block", "closest"), ("no block", "occluded"),
                                       ("zero entry", "closest")])
def test_v7_fused_cull_edge_cases(cuda, case, mode):
    """Keys on 8 pages through the bitonic sort, tiles whose cull passes no
    block, and -0 box entries: every row equals the plain cull followed by
    the ordered loop."""
    coeff, cl_min, cl_max, rays = _v7_case(case, cuda)
    common = {"8 pages": None, "no block": "origin", "zero entry": "dir"}[case]
    k = v7.trace_v7_kernel(rays, cl_min, cl_max, coeff, mode, common)
    keys, _ = v7.cull_keys(rays, cl_min, cl_max)
    n = (keys.reshape(rays.shape[0], -1) != v7.INVALID).sum(dim=1)
    if case == "8 pages":
        assert int(n.amin()) > 512
    if case == "no block":
        assert bool((n[: rays.shape[0] // 2] == 0).all()) and bool((n > 0).any())
        assert bool((k[1][: rays.shape[0] // 2, 1] == 0).all())
    if case == "zero entry":
        assert bool((keys.reshape(rays.shape[0], -1)[:, 0] >= 0).all())
    _same_v7(k, rays, cl_min, cl_max, coeff, mode, common)


@pytest.mark.cuda
@pytest.mark.parametrize("step", [8, 31, 32, 40])
def test_atrous_kernel_wide_steps(cuda, step):
    """Steps from 8 up: one staged segment below 32, five column bands from
    32 on, a single row residue per CTA above the image height."""
    ins = [x.to(cuda) for x in _denoise_data(70, 150, 7)]
    ks, ku = atrous_pair_iteration_kernel(*ins, step, *PHIS)
    ps, pu = atrous_pair_iteration_plain(*ins, step, *PHIS)
    torch.testing.assert_close(ks, ps, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ku, pu, rtol=1e-5, atol=1e-6)


def _vjp_inputs(h, w, seed, device):
    ins = [x.to(device) for x in _denoise_data(h, w, seed)]
    r = np.random.default_rng(seed)
    gs, gu = (torch.from_numpy(r.normal(size=(h, w, 3)).astype(np.float32)).to(device)
              for _ in range(2))
    return ins, gs, gu


def test_atrous_vjp_kernel_refuses_cpu_tensors_and_bad_steps():
    ins, gs, gu = _vjp_inputs(8, 8, 0, "cpu")
    wsum = torch.ones((2, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        atrous_pair_iteration_vjp_kernel(*ins, ins[0], ins[1], wsum, 1, *PHIS, gs, gu)
    with pytest.raises(ValueError, match="step"):
        atrous_pair_iteration_vjp_kernel(*ins, ins[0], ins[1], wsum, 0, *PHIS, gs, gu)


@pytest.mark.cuda
@pytest.mark.parametrize("step,geometry", [(1, True), (2, False), (3, True), (4, True),
                                           (7, False), (40, True)])
def test_atrous_vjp_kernel_matches_twin(cuda, step, geometry):
    """B5b against its plain version (autograd of the twin): the sums run
    in another order, so |kernel - twin| <= 1e-5 |twin| + 1e-6 max|twin|
    (on the card both lie within about 5e-7 max|g| of a float64 twin)."""
    ins, gs, gu = _vjp_inputs(45, 70, step, cuda)
    out_s, out_u, wsum = atrous_pair_iteration_kernel(*ins, step, *PHIS, weights=True)
    before = atrous_denoise_pair.vjp_launches
    k = atrous_pair_iteration_vjp_kernel(*ins, out_s, out_u, wsum, step, *PHIS, gs, gu, geometry)
    assert atrous_denoise_pair.vjp_launches == before + 1
    t = atrous_pair_iteration_vjp_plain(*ins, step, *PHIS, gs, gu, geometry)
    for a, b in zip(k, t):
        if b is None:
            assert a is None
            continue
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * b.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("step,geometry", [(1, True), (1, False), (4, True), (4, False),
                                           (9, True), (12, False)])
def test_atrous_vjp_kernel_on_1080p_rows(cuda, step, geometry):
    """B5b at the frame's width and many CTAs (contiguous column segments up
    to step 8, column residues above), with and without the geometry
    gradients, against the twin: |err| <= 1e-5 |twin| + 1e-6 max|twin|."""
    ins, gs, gu = _vjp_inputs(64, 1920, 20 + step, cuda)
    out_s, out_u, wsum = atrous_pair_iteration_kernel(*ins, step, *PHIS, weights=True)
    k = atrous_pair_iteration_vjp_kernel(*ins, out_s, out_u, wsum, step, *PHIS, gs, gu, geometry)
    t = atrous_pair_iteration_vjp_plain(*ins, step, *PHIS, gs, gu, geometry)
    for a, b in zip(k, t):
        if b is None:
            assert a is None
            continue
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * b.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("step", [1, 3, 8, 40])
def test_atrous_kernel_weight_output_matches_twin(cuda, step):
    """B5 with its W output: the images equal those without it bit for
    bit, and the weight sums equal the twin's cum (the same float sums in
    the same order)."""
    ins = [x.to(cuda) for x in _denoise_data(45, 70, 30 + step)]
    ks, ku, wsum = atrous_pair_iteration_kernel(*ins, step, *PHIS, weights=True)
    ks0, ku0 = atrous_pair_iteration_kernel(*ins, step, *PHIS)
    assert torch.equal(ks, ks0) and torch.equal(ku, ku0)
    _, _, want = atrous_pair_iteration_plain(*ins, step, *PHIS, weights=True)
    assert wsum.shape == (2, 45, 70)
    torch.testing.assert_close(wsum, want, rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_atrous_pair_slabs_equal_the_unsharded_kernel(cuda):
    """Four row slabs of a 64-row image, each padded with its neighbours'
    8 rows where they exist, through atrous_pair_slab for 4 iterations: the
    rows equal the unsharded kernel's bit for bit."""
    ins = [x.to(cuda) for x in _denoise_data(64, 150, 12)]
    ks, ku = atrous_denoise_pair(*ins, 4, *PHIS)
    s, u = ins[0], ins[1]
    for i in range(4):
        parts = []
        for r in range(4):
            a, b = max(16 * r - 8, 0), min(16 * r + 24, 64)
            parts.append(atrous_pair_slab(*(x[a:b].contiguous() for x in (s, u, ins[2], ins[3])),
                                          16 * r - a, 16, i + 1, *PHIS))
        s, u = torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    assert torch.equal(s, ks) and torch.equal(u, ku)


@pytest.mark.cuda
def test_atrous_pair_backward_launches_the_vjp_kernel(cuda):
    """atrous_denoise_pair under autograd on the card: four forward and four
    VJP launches, the gradients of all four inputs against autograd through
    four twin iterations (1e-5 relative to the largest: four chained
    backward passes)."""
    ins, gs, gu = _vjp_inputs(45, 70, 11, cuda)
    xs = [x.clone().requires_grad_() for x in ins]
    fwd, vjp = atrous_denoise_pair.launches, atrous_denoise_pair.vjp_launches
    out = atrous_denoise_pair(*xs, 4, *PHIS)
    torch.autograd.backward(out, (gs, gu))
    assert atrous_denoise_pair.launches - fwd == 4 and atrous_denoise_pair.vjp_launches - vjp == 4
    ys = [x.clone().requires_grad_() for x in ins]
    s, u = ys[0], ys[1]
    for i in range(4):
        s, u = atrous_pair_iteration_plain(s, u, ys[2], ys[3], i + 1, *PHIS)
    torch.autograd.backward((s, u), (gs, gu))
    for x, y in zip(xs, ys):
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-5, atol=1e-5 * y.grad.abs().max().item())


@pytest.mark.parametrize("name", sorted(__import__("realtimeraytracer_torch.kernels",
                                                    fromlist=["SIGNATURES"]).SIGNATURES))
def test_kernel_signature_matches_its_c_entry(name):
    """Each ctypes signature lists the C entry's parameters in order: a
    pointer as c_void_p, an int as c_int, a float as c_float (a mismatch
    passes a cut pointer to the kernel)."""
    import ctypes
    import re

    from realtimeraytracer_torch import kernels

    source, symbol, argtypes = kernels.SIGNATURES[name]
    text = (kernels.CSRC / f"{source}.cu").read_text()
    m = re.search(rf"\bint {symbol}\(([^)]*)\)\s*\{{", text)
    assert m, f"no C entry {symbol} in {source}.cu"
    kinds = []
    for param in m.group(1).split(","):
        param = param.strip()
        kinds.append(ctypes.c_void_p if "*" in param else
                     ctypes.c_float if param.startswith("float") else ctypes.c_int)
    assert kinds == list(argtypes)
