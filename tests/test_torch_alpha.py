"""Alpha-tested any-hit of the PyTorch port against the JAX package.

Held here, on scenes compiled by the JAX package (its default path: the
native OBJ tokenizer and SAH BVH builder) and carried across with from_numpy_leaves: the
alpha-mask builder; the masked twins of v7, v9 and v8 against the JAX
kernels in interpret mode, on a baked foliage_field (its leaf cards have
wide transparent margins, so the masks reject hits; textured_obj's disc
cutouts leave no 8x8 cell fully transparent and its masks are all ones);
hit_alpha, step_past and the closest and occlusion ladders against JAX's
wrap_backend_with_alpha on the JAX hybrid route, on textured_obj.  The
rays start at the camera and aim at random points of the alpha-mapped
cards, so they meet transparent and opaque texels.
(The 32x32 alpha-tested frames are in tests/test_torch_textures.py.)

Tolerances: mask panels equal; hit masks and occluded flags equal, ids
equal or else t equal, t to rtol 1e-6 except one 2^-16 quantization step
on at most 5% of hits (XLA on the CPU contracts multiply-adds into FMAs);
opacities rtol 1e-5, atol 1e-6; ladders as the kernels, except that a ray
whose opacity sits within 1e-5 of the threshold may resolve differently;
frames by the whole-frame rule of tests/test_torch_slice.py (no NaN, under
0.5% of values off by more than 2e-3).  Masked and unmasked ladders agree
except on rays that exhaust the ladder, which the masks let resolve
further (PARITY.md, round-5 notes; ROADMAP queue C).
"""

import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import realtimeraytracer_tpu as jax_rt
from realtimeraytracer_tpu import scenes as jax_scenes
from realtimeraytracer_tpu.ops import alpha_mask as jax_amask
from realtimeraytracer_tpu.render import alpha as jax_alpha
from realtimeraytracer_tpu.render.backends import make_backend as jax_make_backend
from realtimeraytracer_tpu.render.hier_backend import hier_closest as jax_hier_closest
from realtimeraytracer_tpu.render.pallas_backend import pallas_closest as jax_pallas_closest
from realtimeraytracer_tpu.render.quarter_backend import quarter_closest as jax_quarter_closest
import realtimeraytracer_torch as rt
from realtimeraytracer_torch import scenes
from realtimeraytracer_torch.ops import alpha_mask
from realtimeraytracer_torch.ops.intersect import HitRecord
from realtimeraytracer_torch.render import alpha
from realtimeraytracer_torch.render import hier_backend as hb
from realtimeraytracer_torch.render import quarter_backend as qb
from realtimeraytracer_torch.render import v7_backend as v7
from realtimeraytracer_torch.render.backends import make_backend, make_hybrid_backend
from realtimeraytracer_torch.scene.gpu_scene import from_numpy_leaves

torch.set_num_threads(2)

N_RAYS = 400
FOLIAGE_TRIS = 12_000        # the smallest baked foliage_field with plants


def _scene_and_rays(build):
    """A JAX-compiled scene, the port's copy of it, and N_RAYS rays from
    the camera to random points of its alpha-mapped triangles."""
    jscene, jgpu = build()
    leaves = {k: np.asarray(v) for k, v in jgpu._asdict().items() if v is not None}
    tgpu = from_numpy_leaves(leaves)
    rng = np.random.default_rng(5)
    cards = np.nonzero(leaves["obj_tex"][leaves["face_obj"], 3] >= 0)[0]
    f = leaves["faces"][rng.choice(cards, N_RAYS)]
    w = rng.dirichlet((1, 1, 1), N_RAYS)
    target = (leaves["vertices"][f] * w[..., None]).sum(1)
    o = np.broadcast_to(np.asarray(jscene.camera.position, np.float32), target.shape)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return jgpu, tgpu, np.ascontiguousarray(o, np.float32), d


@pytest.fixture(scope="module")
def alpha_scene(tmp_path_factory):
    def build():
        jscene = jax_scenes.textured_obj(str(tmp_path_factory.mktemp("obj")))
        return jscene, jscene.compile()
    return _scene_and_rays(build)


@pytest.fixture(scope="module")
def foliage_scene():
    def build():
        jscene = jax_scenes.foliage_field(target_tris=FOLIAGE_TRIS)
        return jscene, jscene.compile(bake_instances=True)
    return _scene_and_rays(build)


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _t(*xs):
    return [torch.from_numpy(np.array(x, order="C")) for x in xs]


def _same_hits(t_got, id_got, t_ref, id_ref, min_hits=20):
    np.testing.assert_array_equal(id_got >= 0, id_ref >= 0)
    hit = id_ref >= 0
    assert hit.sum() >= min_hits
    dt = np.abs(t_got[hit] - t_ref[hit])
    close = dt <= 1e-6 * np.abs(t_ref[hit])
    assert (dt <= 2.0 ** -15 * np.abs(t_ref[hit])).all() and (~close).mean() <= 0.05
    assert ((id_got == id_ref) | (t_got == t_ref))[hit].all()


def test_face_masks_match_jax():
    """Random uv triangles over a blocky alpha atlas; identity and slot
    packing."""
    rng = np.random.default_rng(7)
    atlas = np.zeros((2, 32, 32, 4), np.float32)
    for i in range(2):
        atlas[i, :, :, 0] = np.kron((rng.random((4, 4)) > 0.5), np.ones((8, 8)))
    sizes = np.array([[32, 32], [32, 24]], np.int32)
    f = 300
    uv0, uv1, uv2 = (rng.random((f, 2)).astype(np.float32) * 2 - 0.5 for _ in range(3))
    tex = (np.arange(f) % 3 - 1).astype(np.int32)
    want = jax_amask.build_face_masks_np(uv0, uv1, uv2, tex, atlas[..., 0], sizes, 0.9)
    got = alpha_mask.build_face_masks_np(uv0, uv1, uv2, tex, atlas[..., 0], sizes, 0.9)
    np.testing.assert_array_equal(got, want)
    assert (got[tex >= 0] != 0xFFFFFFFF).any()
    slots = rng.permutation(np.concatenate([np.arange(f), -np.ones(84, np.int64)]))
    for s in (None, slots):
        np.testing.assert_array_equal(alpha_mask.pack_amask_np(got, 3, s),
                                      jax_amask.pack_amask_np(want, 3, s))


@pytest.mark.parametrize("kernel", ["v7", "v9", "v8"])
def test_masked_twins_match_jax(foliage_scene, kernel):
    """Camera rays (common origin) through the masked twin and the masked
    JAX kernel in interpret mode; the masks reject some hits."""
    jgpu, tgpu, o, d = foliage_scene
    n = o.shape[0]
    tmin, tmax = np.full(n, 1e-3, np.float32), np.full(n, 1e4, np.float32)
    jcfg = jax_rt.RenderConfig()
    if kernel == "v7":
        want = jax_pallas_closest(jgpu, jcfg, *_j(o, d, tmin, tmax), common="origin",
                                  amask=jgpu.pallas_amask)
        fn = v7.v7_closest
    elif kernel == "v9":
        want = jax_quarter_closest(jgpu, jcfg, *_j(o, d, tmin, tmax), common="origin",
                                   use_amask=True)
        fn = qb.quarter_closest
    else:
        want = jax_hier_closest(jgpu, jcfg, *_j(o, d, tmin, tmax), common="origin",
                                use_amask=True)
        fn = hb.hier_closest
    got = fn(tgpu, *_t(o, d, tmin, tmax), common="origin", use_amask=True)
    _same_hits(got.t.numpy(), got.prim_id.numpy(), np.asarray(want.t), np.asarray(want.prim_id))
    unmasked = fn(tgpu, *_t(o, d, tmin, tmax), common="origin")
    assert (unmasked.prim_id != got.prim_id).sum() > 5


@pytest.fixture(scope="module")
def ladders(alpha_scene):
    """The JAX hybrid route's alpha ladders (interpret mode) and the
    port's on the same rays: primaries (common origin), shadow segments to
    a light (general rays) and sun segments (common direction)."""
    jgpu, tgpu, o, d = alpha_scene
    n = o.shape[0]
    # Two rounds (three for occlusion) keep the interpret-mode ladders short.
    jcfg = jax_rt.RenderConfig(backend="hybrid", alpha_test=True, alpha_rounds=2)
    tcfg = rt.RenderConfig(backend="hybrid", alpha_test=True, alpha_rounds=2)
    jbe, tbe = jax_make_backend(jgpu, jcfg), make_backend(tgpu, tcfg)
    out = {}
    jp = jbe.closest(*_j(o, d), 1e-3, 1e4, common="origin")
    tp = tbe.closest(*_t(o, d), 1e-3, 1e4, common="origin")
    out["primary"] = (jp, tp)
    hit = np.asarray(jp.prim_id) >= 0
    p = o + d * np.where(hit, np.asarray(jp.t), 0.0)[:, None] - d * 1e-3
    p = p.astype(np.float32)
    rng = np.random.default_rng(3)
    ab = rng.uniform(0, 0.5, (n, 2)).astype(np.float32)
    lv = [np.asarray(getattr(jgpu, f"lt_v{k}"))[0] for k in range(3)]
    delta = lv[0] + ab[:, :1] * (lv[1] - lv[0]) + ab[:, 1:] * (lv[2] - lv[0]) - p
    dist = np.linalg.norm(delta, axis=1)
    sdir = (delta / dist[:, None]).astype(np.float32)
    lo = np.where(hit, 1e-3, 3e38).astype(np.float32)
    hi = np.where(hit, dist - 0.5, -3e38).astype(np.float32)
    sun = np.broadcast_to(np.asarray(jgpu.sun_direction), p.shape).astype(np.float32)
    shi = np.where(hit, 1e4, -3e38).astype(np.float32)
    out["shadow"] = (np.asarray(jbe.occluded(*_j(p, sdir, lo, hi))),
                     tbe.occluded(*_t(p, sdir, lo, hi)).numpy())
    out["sun"] = (np.asarray(jbe.occluded(*_j(p, sun, lo, shi), common="dir")),
                  tbe.occluded(*_t(p, sun, lo, shi), common="dir").numpy())
    out["alpha"] = (np.asarray(jax_alpha.hit_alpha(jgpu, jp, *_j(o, d))),
                    alpha.hit_alpha(tgpu, HitRecord(*_t(*(np.asarray(x) for x in jp[:4]))),
                                    *_t(o, d)).numpy())
    out["args"] = (p, sdir, lo, hi, sun, shi)
    return out


def test_hit_alpha_matches_jax(ladders):
    want, got = ladders["alpha"]
    assert (want < 0.9).sum() > 0 and (want >= 0.9).sum() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_step_past_matches_jax():
    t = np.random.default_rng(0).uniform(0, 300, 1000).astype(np.float32)
    np.testing.assert_array_equal(alpha.step_past(torch.from_numpy(t)).numpy(),
                                  np.asarray(t + jnp.maximum(jnp.float32(1e-4),
                                                             jnp.asarray(t) * jnp.float32(3.1e-5))))


def test_closest_ladder_matches_jax(ladders):
    jp, tp = ladders["primary"]
    _same_hits(tp.t.numpy(), tp.prim_id.numpy(), np.asarray(jp.t), np.asarray(jp.prim_id))
    want, _ = ladders["alpha"]
    assert (want >= 0.9).mean() > 0.9   # the ladder stepped past transparent hits


@pytest.mark.parametrize("query", ["shadow", "sun"])
def test_occlusion_ladder_matches_jax(ladders, query):
    want, got = ladders[query]
    assert 5 < want.sum() < want.size - 5
    np.testing.assert_array_equal(got, want)


def test_masked_ladder_agrees_with_unmasked(foliage_scene):
    """The port's masked and unmasked ladders (hybrid route, twins) on the
    baked foliage: equal except on rays that exhaust the unmasked ladder,
    where the masked one reaches a hit at least as far.  (At 1080p a few
    rays also differ because the unmasked ladder stepped past an opaque hit
    just behind a transparent one; chip_smoke.py phase 13 counts them.)"""
    _, tgpu, o, d = foliage_scene
    cfg = rt.RenderConfig(alpha_test=True)
    masked = alpha.wrap_backend_with_alpha(make_hybrid_backend(tgpu, cfg, use_amask=True), tgpu, cfg)
    plain = alpha.wrap_backend_with_alpha(make_hybrid_backend(tgpu, cfg, use_amask=False), tgpu, cfg)
    o_t, d_t = _t(o, d)
    hm = masked.closest(o_t, d_t, 1e-3, 1e4, common="origin")
    hn = plain.closest(o_t, d_t, 1e-3, 1e4, common="origin")
    exhausted = (alpha.hit_alpha(tgpu, hn, o_t, d_t) < 0.9) & hn.hit
    agree = ~exhausted
    assert exhausted.any() and agree.sum() > 300
    np.testing.assert_array_equal(hm.prim_id[agree].numpy(), hn.prim_id[agree].numpy())
    np.testing.assert_array_equal(hm.t[agree].numpy(), hn.t[agree].numpy())
    assert (hm.t[exhausted] >= hn.t[exhausted]).all()
    # Occlusion toward the sun from the primary hits.
    hit = hn.hit.numpy()
    p = (o + d * np.where(hit, hn.t.numpy(), 0.0)[:, None] - d * 1e-3).astype(np.float32)
    sun = np.broadcast_to(tgpu.sun_direction.numpy(), p.shape).astype(np.float32)
    lo = np.where(hit, 1e-3, 3e38).astype(np.float32)
    hi = np.where(hit, 1e4, -3e38).astype(np.float32)
    om = masked.occluded(*_t(p, sun, lo, hi), common="dir").numpy()
    on = plain.occluded(*_t(p, sun, lo, hi), common="dir").numpy()
    assert on.any() and (om | ~on).all()


def test_ladder_counts_its_host_syncs(alpha_scene):
    """One sync per ladder decision, recorded with the rays that need the
    round; a round runs only when some ray needs it."""
    _, tgpu, o, d = alpha_scene
    cfg = rt.RenderConfig(alpha_test=True)
    record = []
    syncs, rounds = alpha.wrap_backend_with_alpha.syncs, alpha.wrap_backend_with_alpha.rounds
    be = alpha.wrap_backend_with_alpha(make_hybrid_backend(tgpu, cfg, use_amask=False), tgpu, cfg,
                                       record=record)
    be.closest(*_t(o, d), 1e-3, 1e4, common="origin")
    assert record and all(q == "closest" for q, _ in record)
    assert alpha.wrap_backend_with_alpha.syncs - syncs == 1 + len(record)
    assert alpha.wrap_backend_with_alpha.rounds - rounds == sum(n > 0 for _, n in record)
    assert record[-1][1] == 0 or len(record) == cfg.alpha_rounds
    assert be.occluded_hinted is None


def test_wrap_leaves_scenes_without_opacity_maps(alpha_scene):
    cfg = rt.RenderConfig(alpha_test=True)
    plain = scenes.procedural_mesh(300).compile()
    be = make_hybrid_backend(plain, cfg)
    assert alpha.wrap_backend_with_alpha(be, plain, cfg) is be
    _, tgpu, _, _ = alpha_scene
    no_opacity = tgpu.__class__(**{**tgpu.__dict__,
                                   "obj_tex": torch.where(torch.arange(4) == 3, -1, tgpu.obj_tex)})
    be = make_hybrid_backend(no_opacity, cfg)
    assert alpha.wrap_backend_with_alpha(be, no_opacity, cfg) is be
    assert make_backend(tgpu, cfg).occluded_hinted is None
    assert make_backend(tgpu, cfg.replace(alpha_test=False)).occluded_hinted is not None


def test_render_resolves_alpha_test(monkeypatch):
    """alpha_test=None resolves from the meshes' opacity maps (JAX
    render_pipeline), so textured_obj renders alpha-tested and a scene
    without opacity maps does not."""
    seen = []
    real = make_backend

    def spy(gpu, cfg):
        seen.append(cfg.alpha_test)
        return real(gpu, cfg)

    mk = importlib.import_module("realtimeraytracer_torch.render.megakernel")
    monkeypatch.setattr(mk, "make_backend", spy)
    cfg = rt.RenderConfig(width=8, height=8, primary_rays=1, shadow_rays=1)
    rt.render(scenes.textured_obj(), cfg, device="cpu")
    rt.render(scenes.procedural_mesh(300), cfg, device="cpu")
    assert seen == [True, False]
