"""v7 traversal of the PyTorch port (render/v7_backend.py).

On the CPU the port's plain twin is held against the JAX package's Pallas
kernel (pallas_closest / pallas_occluded, interpret mode) on one compiled
scene and the same rays.  Tolerances: hit masks and occluded flags equal;
ids equal, or else the two t equal (a quantized-t tie between blocks
resolves by visit order, which differs between the TPU kernel's paired pops
and the port's one-block visits); t to rtol 1e-6, except that against JAX
a t may sit one quantization step (2^-16 relative) away: XLA on the CPU
contracts a*b+c into FMAs and the port does not, so the unquantized t can
differ by an ulp and fall on the two sides of a step.  The CUDA kernel is
held against the twin in tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from realtimeraytracer_tpu.config import RenderConfig as JaxConfig
from realtimeraytracer_tpu.render.pallas_backend import (
    pallas_closest, pallas_occluded)
from realtimeraytracer_tpu.scene.geometry import TriangleMesh as JaxMesh
from realtimeraytracer_tpu.scene.scene import Scene as JaxScene
from realtimeraytracer_torch.render import v7_backend as v7
from realtimeraytracer_torch.scene.gpu_scene import from_numpy_leaves

torch.set_num_threads(2)

BIG_T = 3.0e38
N_RAYS = 300          # not a multiple of the 128-ray tile


def _scenes(n=1000, seed=0):
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


def _rays(common, seed):
    r = np.random.default_rng(seed)
    o = r.uniform(-6, 6, (N_RAYS, 3)).astype(np.float32)
    d = r.normal(size=(N_RAYS, 3)).astype(np.float32)
    if common == "origin":
        o[:] = 0.0           # inside the triangle cloud: most rays hit
    elif common == "dir":
        d[:] = d[0]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(N_RAYS, 1e-3, np.float32)
    tmax = r.uniform(2.0, 12.0, N_RAYS).astype(np.float32)
    empty = np.arange(N_RAYS) % 7 == 3       # inactive lanes: [BIG, -BIG)
    tmin[empty], tmax[empty] = BIG_T, -BIG_T
    return o, d, tmin, tmax, empty


def _check_closest(t_ref, id_ref, t_got, id_got, steps_allowed=False):
    np.testing.assert_array_equal(id_got >= 0, id_ref >= 0)
    hit = id_ref >= 0
    assert hit.sum() > 20
    dt = np.abs(t_got[hit] - t_ref[hit])
    close = dt <= 1e-6 * np.abs(t_ref[hit])
    if steps_allowed:
        one_step = dt <= 2.0 ** -15 * np.abs(t_ref[hit])
        assert one_step.all() and (~close).mean() <= 0.05
    else:
        assert close.all()
    assert ((id_got == id_ref) | (t_got == t_ref))[hit].all()
    assert (id_got[~hit] == -1).all()


@pytest.mark.parametrize("common", [None, "origin"])
def test_closest_plain_matches_pallas(scenes_pair, common):
    jgpu, tscene = scenes_pair
    o, d, tmin, tmax, empty = _rays(common, seed=1)
    want = pallas_closest(jgpu, JaxConfig(), jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(tmin), jnp.asarray(tmax), common=common)
    got = v7.v7_closest(tscene, torch.from_numpy(o), torch.from_numpy(d),
                        torch.from_numpy(tmin), torch.from_numpy(tmax),
                        common=common)
    id_got = got.prim_id.numpy()
    assert (id_got[empty] == -1).all()
    _check_closest(np.asarray(want.t), np.asarray(want.prim_id),
                   got.t.numpy(), id_got, steps_allowed=True)


@pytest.mark.parametrize("common", [None, "dir"])
def test_occluded_plain_matches_pallas(scenes_pair, common):
    jgpu, tscene = scenes_pair
    o, d, tmin, tmax, empty = _rays(common, seed=2)
    want = np.asarray(pallas_occluded(
        jgpu, JaxConfig(), jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin),
        jnp.asarray(tmax), common=common))
    got = v7.v7_occluded(tscene, torch.from_numpy(o), torch.from_numpy(d),
                         torch.from_numpy(tmin), torch.from_numpy(tmax),
                         common=common).numpy()
    assert 10 < want.sum() < N_RAYS - 10
    assert not got[empty].any()
    np.testing.assert_array_equal(got, want)


def test_cull_keys_bound_every_hit(scenes_pair):
    """Every hit's block is a candidate of its tile, with an entry key no
    larger than the hit distance (the lower bound the stop rule needs)."""
    _, tscene = scenes_pair
    o, d, tmin, tmax, _ = _rays(None, seed=3)
    rays, _, ts = v7._pack_rays(*(torch.from_numpy(x) for x in (o, d, tmin, tmax)))
    keys, id_mask = v7.cull_keys(rays, tscene.pallas_cl_min, tscene.pallas_cl_max)
    outf, outi = v7.trace_blocks(tscene, rays, "closest")
    k = keys.reshape(ts, -1)
    for tile, lane in zip(*np.nonzero(outi[:, 0].numpy() >= 0)):
        blk = int(outi[tile, 0, lane]) // 128
        valid = k[tile][k[tile] != v7.INVALID]
        key = valid[(valid & id_mask) == blk]
        assert key.numel() == 1
        entry = torch.tensor(int(key[0]) & ~id_mask, dtype=torch.int32).view(torch.float32)
        assert float(entry) <= float(outf[tile, 0, lane])


def test_cpu_wrapper_counts_no_launch(scenes_pair):
    _, tscene = scenes_pair
    o, d, tmin, tmax, _ = _rays(None, seed=4)
    before = v7.trace_blocks.launches
    v7.v7_closest(tscene, *(torch.from_numpy(x) for x in (o, d, tmin, tmax)))
    assert v7.trace_blocks.launches == before


def test_cull_keys_zero_entries_are_positive():
    """A bundle whose origin lies on a box's max-x face, looking in, has the
    box entry (+0 * -1) = -0; the block key carries +0 (key = block id), not
    the sign bit, which would make the key negative and its entry bits lower
    than every ray's limit, empty lanes' included."""
    cl_min = torch.zeros((4, 3))
    cl_max = torch.ones((4, 3))
    n = 128
    o = torch.tensor([1.0, 0.5, 0.5]).expand(n, 3)
    d = torch.tensor([-1.0, 0.0, 0.0]).expand(n, 3)
    rays, _, _ = v7._pack_rays(o, d, torch.full((n,), 1e-3), torch.full((n,), 10.0))
    ent = v7._sub_entries(rays, cl_min, cl_max)
    assert bool((ent == 0).all()) and bool(torch.signbit(ent).all())   # CPU clamp_min keeps -0
    keys, id_mask = v7.cull_keys(rays, cl_min, cl_max)
    assert int(keys.reshape(-1)[0]) == 0
    assert bool((keys >= 0).all())
