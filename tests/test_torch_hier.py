"""v8 traversal of the PyTorch port (render/hier_backend.py).

On the CPU the port's plain twin is held against the JAX package's Pallas
kernel (trace_blocks_hier through hier_closest / hier_occluded /
hier_occluded_hinted, interpret mode) on one compiled scene and the same
rays.  Tolerances: hit masks and occluded flags equal; ids equal, or else
the two t equal (a quantized-t tie resolves by visit order); t to rtol
1e-6, except that against JAX a t may sit one quantization step (2^-16
relative) away on at most 5% of hits (XLA on the CPU contracts a*b+c into
FMAs, the port does not).  pack_hierarchy must agree exactly.

Hints depend on the order of visits, so their values need not match JAX's.
Their contract: (a) the occlusion mask is the same with no hints, chained
hints and garbage hints; (b) every hint of a tile with an occluded ray is a
block in [0, cb) that occludes at least one of the tile's rays; (c) a tile
with no occluded ray gets -1.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from realtimeraytracer_tpu.config import RenderConfig as JaxConfig
from realtimeraytracer_tpu.render.hier_backend import (
    hier_closest as jax_hier_closest, hier_occluded as jax_hier_occluded,
    hier_occluded_hinted as jax_hier_occluded_hinted,
    pack_hierarchy as jax_pack_hierarchy)
from realtimeraytracer_tpu.scene.geometry import TriangleMesh as JaxMesh
from realtimeraytracer_tpu.scene.scene import Scene as JaxScene
from realtimeraytracer_torch import RenderConfig
from realtimeraytracer_torch.render import hier_backend as hb
from realtimeraytracer_torch.render import v7_backend as v7
from realtimeraytracer_torch.scene.gpu_scene import from_numpy_leaves

torch.set_num_threads(2)

BIG_T = 3.0e38
N_RAYS = 300          # not a multiple of the 128-ray tile


def _scenes(n=900, seed=0):
    r = np.random.default_rng(seed)
    base = r.uniform(-4, 4, (n, 1, 3))
    tris = (base + r.normal(0, 0.3, (n, 3, 3))).astype(np.float32)
    s = JaxScene()
    s.add(JaxMesh(vertices=tris.reshape(-1, 3),
                  faces=np.arange(3 * n, dtype=np.int32).reshape(n, 3)))
    gpu = s.compile(bvh_threshold=0)
    leaves = {k: np.asarray(v) for k, v in gpu._asdict().items() if v is not None}
    return gpu, from_numpy_leaves(leaves)


@pytest.fixture(scope="module")
def scenes_pair():
    return _scenes()


def _rays(common, seed, tmax_hi=12.0):
    r = np.random.default_rng(seed)
    o = r.uniform(-6, 6, (N_RAYS, 3)).astype(np.float32)
    d = r.normal(size=(N_RAYS, 3)).astype(np.float32)
    if common == "origin":
        o[:] = 0.0           # inside the triangle cloud: most rays hit
    elif common == "dir":
        d[:] = d[0]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(N_RAYS, 1e-3, np.float32)
    tmax = r.uniform(2.0, tmax_hi, N_RAYS).astype(np.float32)
    empty = np.arange(N_RAYS) % 7 == 3       # inactive lanes: [BIG, -BIG)
    tmin[empty], tmax[empty] = BIG_T, -BIG_T
    return o, d, tmin, tmax, empty


def _torch(*xs):
    return [torch.from_numpy(x) for x in xs]


def test_pack_hierarchy_matches_jax(scenes_pair):
    _, tscene = scenes_pair
    lo, hi = tscene.pallas_cl_min, tscene.pallas_cl_max
    want = jax_pack_hierarchy(lo.numpy(), hi.numpy())
    got = hb.pack_hierarchy(lo, hi)
    for w, g in zip(want, got):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), w)


def test_pack_hierarchy_multi_super():
    """Above 128 blocks the supers split, pad lanes stay inverted."""
    r = np.random.default_rng(3)
    lo = r.uniform(-1, 0, (4 * 300, 3)).astype(np.float32)
    hi = lo + r.uniform(0, 1, lo.shape).astype(np.float32)
    want = jax_pack_hierarchy(lo, hi)
    got = hb.pack_hierarchy(torch.from_numpy(lo), torch.from_numpy(hi))
    assert got[1].shape == (3, 8, 128)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("common", [None, "origin"])
def test_closest_plain_matches_jax(scenes_pair, common):
    jgpu, tscene = scenes_pair
    o, d, tmin, tmax, empty = _rays(common, seed=1)
    want = jax_hier_closest(jgpu, JaxConfig(), *(jnp.asarray(x) for x in (o, d, tmin, tmax)),
                            common=common)
    got = hb.hier_closest(tscene, *_torch(o, d, tmin, tmax), common=common)
    t_ref, id_ref = np.asarray(want.t), np.asarray(want.prim_id)
    t_got, id_got = got.t.numpy(), got.prim_id.numpy()
    assert (id_got[empty] == -1).all()
    np.testing.assert_array_equal(id_got >= 0, id_ref >= 0)
    hit = id_ref >= 0
    assert hit.sum() > 20
    dt = np.abs(t_got[hit] - t_ref[hit])
    close = dt <= 1e-6 * np.abs(t_ref[hit])
    assert (dt <= 2.0 ** -15 * np.abs(t_ref[hit])).all() and (~close).mean() <= 0.05
    assert ((id_got == id_ref) | (t_got == t_ref))[hit].all()


@pytest.mark.parametrize("common", [None, "dir"])
def test_occluded_plain_matches_jax(scenes_pair, common):
    jgpu, tscene = scenes_pair
    o, d, tmin, tmax, empty = _rays(common, seed=2)
    want = np.asarray(jax_hier_occluded(
        jgpu, JaxConfig(), *(jnp.asarray(x) for x in (o, d, tmin, tmax)), common=common))
    got = hb.hier_occluded(tscene, *_torch(o, d, tmin, tmax), common=common).numpy()
    assert 10 < want.sum() < N_RAYS - 10
    assert not got[empty].any()
    np.testing.assert_array_equal(got, want)


def test_plain_matches_v7_twin(scenes_pair):
    """Closest t of the v8 twin equals the v7 twin's bit for bit."""
    _, tscene = scenes_pair
    args = _torch(*_rays(None, seed=6)[:4])
    a = v7.v7_closest(tscene, *args)
    b = hb.hier_closest(tscene, *args)
    np.testing.assert_array_equal(b.t.numpy(), a.t.numpy())
    assert ((b.prim_id == a.prim_id) | (b.t == a.t)).all()


def _tile_occluders(tscene, rays, tile, block):
    """Occluded flags of a tile's rays against one block's triangles."""
    _, ok = v7._intersect_pairs(rays[tile][None], tscene.pallas_panels[block][None], None)
    return ok[0].any(dim=1)


def test_hints_contract(scenes_pair):
    """(a) cold, chained and garbage hints give the unhinted mask (and
    JAX's); (b) a tile's hints are blocks occluding one of its rays; (c)
    -1 where the tile has no occluded ray."""
    jgpu, tscene = scenes_pair
    o, d, tmin, tmax, _ = _rays(None, seed=12, tmax_hi=5.0)
    args = _torch(o, d, tmin, tmax)
    want = np.asarray(jax_hier_occluded_hinted(
        jgpu, JaxConfig(), *(jnp.asarray(x) for x in (o, d, tmin, tmax)))[0])
    plain = hb.hier_occluded(tscene, *args).numpy()
    np.testing.assert_array_equal(plain, want)
    occ0, h0 = hb.hier_occluded_hinted(tscene, *args)
    occ1, h1 = hb.hier_occluded_hinted(tscene, *args, hints=h0)
    ts = h0.shape[0]
    bad = torch.stack([torch.full((ts,), 10_000, dtype=torch.int32),
                       torch.full((ts,), -1, dtype=torch.int32)], dim=1)
    occ2, _ = hb.hier_occluded_hinted(tscene, *args, hints=bad)
    for occ in (occ0, occ1, occ2):
        np.testing.assert_array_equal(occ.numpy(), want)
    assert h0.shape == (ts, 2) and h0.dtype == torch.int32

    rays = v7._pack_rays(*args)[0]
    cb = tscene.pallas_panels.shape[0]
    occ_t = np.pad(plain, (0, ts * 128 - N_RAYS)).reshape(ts, 128)
    for tile in range(ts):
        if occ_t[tile].any():
            for h in h0[tile].tolist():
                assert 0 <= h < cb
                assert bool((_tile_occluders(tscene, rays, tile, h)
                             & torch.from_numpy(occ_t[tile])).any())
        else:
            assert (h0[tile] == -1).all()


def test_backend_contract(scenes_pair):
    _, tscene = scenes_pair
    be = hb.make_hier_backend(tscene, RenderConfig())
    assert be.perray_cull and be.occluded_hinted is not None
    args = _torch(*_rays(None, seed=9)[:4])
    occ, hints = be.occluded_hinted(*args)
    np.testing.assert_array_equal(occ.numpy(), be.occluded(*args).numpy())


def test_cpu_wrapper_counts_no_launch(scenes_pair):
    _, tscene = scenes_pair
    before = hb.trace_blocks_hier.launches
    hb.hier_occluded(tscene, *_torch(*_rays(None, seed=4)[:4]))
    assert hb.trace_blocks_hier.launches == before


def test_kernel_refuses_cpu_tensors(scenes_pair):
    _, tscene = scenes_pair
    rays = v7._pack_rays(*_torch(*_rays(None, seed=3)[:4]))[0]
    coeff, sup, blk, nsup = hb._hier_inputs(tscene)
    with pytest.raises(ValueError, match="CUDA"):
        hb.trace_hier_kernel(rays, sup, blk, coeff, nsup, "occluded")
