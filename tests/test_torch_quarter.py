"""v9 traversal of the PyTorch port (render/quarter_backend.py) and the SAH
repacking it reads (ops/repack.py).

On the CPU the port's plain twin is held against the JAX package's Pallas
kernel (quarter_closest, interpret mode) on one compiled scene and the same
rays.  Tolerances, as for v7 (tests/test_torch_v7.py): hit masks equal; ids
equal, or else the two t equal (a quantized-t tie resolves by visit order);
t to rtol 1e-6, except that against JAX a t may sit one quantization step
(2^-16 relative) away on at most 5% of hits, because XLA on the CPU
contracts a*b+c into FMAs and the port does not.  The repacking and the
quarter cull are host/tensor code and must agree exactly.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from realtimeraytracer_tpu import scenes as jax_scenes
from realtimeraytracer_tpu.config import RenderConfig as JaxConfig
from realtimeraytracer_tpu.ops.repack import build_q_panels_np as jax_build_q_panels
from realtimeraytracer_tpu.render.pallas_backend import (
    _pack_rays as jax_pack_rays, cull_quarter_keys as jax_cull_quarter_keys)
from realtimeraytracer_tpu.render.quarter_backend import quarter_closest as jax_quarter_closest
from realtimeraytracer_torch.ops.repack import build_q_panels_np
from realtimeraytracer_torch.render import quarter_backend as qb
from realtimeraytracer_torch.render import v7_backend as v7
from realtimeraytracer_torch.scene.gpu_scene import from_numpy_leaves

torch.set_num_threads(2)

BIG_T = 3.0e38
N_RAYS = 300          # not a multiple of the 128-ray tile


def _scenes(n):
    gpu = jax_scenes.procedural_mesh(n).compile()
    leaves = {k: np.asarray(v) for k, v in gpu._asdict().items() if v is not None}
    return gpu, from_numpy_leaves(leaves)


@pytest.fixture(scope="module")
def scenes_pair():
    return _scenes(2000)


def _rays(common, seed, n=N_RAYS):
    r = np.random.default_rng(seed)
    o = r.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    if common == "origin":
        o[:] = o[0]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, 1e4, np.float32)
    empty = np.arange(n) % 7 == 3            # inactive lanes: [BIG, -BIG)
    tmin[empty], tmax[empty] = BIG_T, -BIG_T
    return o, d, tmin, tmax, empty


def _check_closest(t_ref, id_ref, t_got, id_got):
    np.testing.assert_array_equal(id_got >= 0, id_ref >= 0)
    hit = id_ref >= 0
    assert hit.sum() > 20
    dt = np.abs(t_got[hit] - t_ref[hit])
    close = dt <= 1e-6 * np.abs(t_ref[hit])
    one_step = dt <= 2.0 ** -15 * np.abs(t_ref[hit])
    assert one_step.all() and (~close).mean() <= 0.05
    assert ((id_got == id_ref) | (t_got == t_ref))[hit].all()
    assert (id_got[~hit] == -1).all()


def test_repack_matches_jax(scenes_pair):
    jgpu, _ = scenes_pair
    tv = [np.asarray(getattr(jgpu, f"bvh_tri_v{i}")) for i in range(3)]
    want = jax_build_q_panels(*tv)
    got = build_q_panels_np(*tv)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(g, w)


def test_scene_carries_q_panels(scenes_pair):
    """The JAX compile's q_* leaves reach the TorchScene unchanged, and the
    port's own compile builds them with the same shapes."""
    jgpu, tscene = scenes_pair
    for name in ("q_panels", "q_cl_min", "q_cl_max", "q_group_off"):
        np.testing.assert_array_equal(getattr(tscene, name).numpy(),
                                      np.asarray(getattr(jgpu, name)))
    from realtimeraytracer_torch import scenes

    own = scenes.procedural_mesh(2000).compile()
    cq = own.q_panels.shape[0]
    assert own.q_panels.shape == (cq, 12, 128)
    assert own.q_cl_min.shape == own.q_cl_max.shape == (cq * 4, 3)
    assert own.q_group_off.shape == (cq * 4,) and own.q_group_off.dtype == torch.int32
    lean = scenes.procedural_mesh(2000).compile(quarter_panels=False)
    assert lean.q_panels is None and lean.q_group_off is None
    np.testing.assert_array_equal(lean.pallas_panels.numpy(), own.pallas_panels.numpy())


@pytest.mark.parametrize("common", [None, "origin"])
def test_cull_quarter_keys_match_jax(scenes_pair, common):
    _, tscene = scenes_pair
    o, d, tmin, tmax, _ = _rays(common, seed=5)
    jrays = jax_pack_rays(*(jnp.asarray(x) for x in (o, d, tmin, tmax)))[0]
    want, want_mask = jax_cull_quarter_keys(jrays, jnp.asarray(tscene.q_cl_min.numpy()),
                                            jnp.asarray(tscene.q_cl_max.numpy()))
    trays = v7._pack_rays(*(torch.from_numpy(x) for x in (o, d, tmin, tmax)))[0]
    got, got_mask = v7.cull_quarter_keys(trays, tscene.q_cl_min, tscene.q_cl_max,
                                         chunk_tiles=2)
    assert got_mask == want_mask
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_tris,common", [(2000, None), (2000, "origin"), (100, None)])
def test_closest_plain_matches_jax(scenes_pair, n_tris, common):
    jgpu, tscene = scenes_pair if n_tris == 2000 else _scenes(n_tris)
    o, d, tmin, tmax, empty = _rays(common, seed=1)
    if common == "origin":
        o[:] = 0.0           # inside the mesh: most rays hit
    want = jax_quarter_closest(jgpu, JaxConfig(), jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(tmin), jnp.asarray(tmax), common=common)
    got = qb.quarter_closest(tscene, torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(tmin), torch.from_numpy(tmax),
                             common=common)
    id_got = got.prim_id.numpy()
    assert (id_got[empty] == -1).all()
    _check_closest(np.asarray(want.t), np.asarray(want.prim_id), got.t.numpy(), id_got)


def test_plain_matches_v7_twin(scenes_pair):
    """v9 and v7 reduce the same packed keys over conservative candidate
    sets: t bit-equal, ids equal or t equal, on the port's twins alone."""
    _, tscene = scenes_pair
    o, d, tmin, tmax, _ = _rays(None, seed=7)
    args = [torch.from_numpy(x) for x in (o, d, tmin, tmax)]
    a = v7.v7_closest(tscene, *args)
    b = qb.quarter_closest(tscene, *args)
    np.testing.assert_array_equal(b.t.numpy(), a.t.numpy())
    assert ((b.prim_id == a.prim_id) | (b.t == a.t)).all()


def test_cpu_wrapper_counts_no_launch(scenes_pair):
    _, tscene = scenes_pair
    o, d, tmin, tmax, _ = _rays(None, seed=4)
    before = qb.trace_blocks_quarter.launches
    qb.quarter_closest(tscene, *(torch.from_numpy(x) for x in (o, d, tmin, tmax)))
    assert qb.trace_blocks_quarter.launches == before


def test_kernel_refuses_cpu_tensors(scenes_pair):
    _, tscene = scenes_pair
    o, d, tmin, tmax, _ = _rays(None, seed=3)
    rays = v7._pack_rays(*(torch.from_numpy(x) for x in (o, d, tmin, tmax)))[0]
    with pytest.raises(ValueError, match="CUDA"):
        qb.trace_quarter_kernel(rays, tscene.q_cl_min, tscene.q_cl_max, tscene.q_panels,
                                tscene.q_group_off)
