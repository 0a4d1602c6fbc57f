"""The two occlusion options of the PyTorch port against the JAX package.

``alpha_split`` (render/alpha.py): the compile's opaque/alpha panel split
(scene/scene.py), held leaf for leaf against the JAX compile of the baked
``foliage_field(target_tris=12_000)`` and of ``textured_obj``; the port's
own leaf ``pallas_amask_alp`` against ``pack_amask_np`` of the alpha faces'
masks; the two-phase occlusion against the classic ladder on the CPU twins,
and against JAX's split and classic ladders on v8 ("hier", interpret mode)
on one batch of rays: shadow segments toward light triangle 0 and the sun
from random points of opaque triangles, and short segments that end just
past an alpha-mapped triangle where it is opaque but JAX's split reads a
zero bit of the whole scene's masks (the fault of the reference that
ROADMAP queue C records).  The JAX ladders run with alpha_rounds=0 (one
re-trace) to keep interpret mode short.

``batch_occlusion`` (render/megakernel.py): batched and separate
render_components bit-equal on the port's v8 and hybrid routes and on an
alpha-tested scene (where one ladder replaces lights x samples ladders),
and the port's batched components against JAX's (its 32x24 test of
tests/test_hier.py); the gates of both options.

Tolerances: leaves and masks equal; occlusion flags equal (on the rays the
classic ladder resolves within its rounds where a ladder is compared with
the split); the port's batched and separate components bit-equal; against
JAX's components the whole-frame rule of tests/test_torch_slice.py (no
NaN, under 0.5% of values off by more than 2e-3), which covers the FMA
allowance of ROADMAP queue C (t one 2^-16 step apart on a few hits).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import realtimeraytracer_tpu as jax_rt
from realtimeraytracer_tpu import scenes as jax_scenes
from realtimeraytracer_tpu.ops import alpha_mask as jax_amask
from realtimeraytracer_tpu.render import alpha as jax_alpha
from realtimeraytracer_tpu.render.backends import make_backend as jax_make_backend
from realtimeraytracer_tpu.render.hier_backend import make_hier_backend as jax_make_hier_backend
from realtimeraytracer_tpu.render.megakernel import render_components as jax_render_components
import realtimeraytracer_torch as rt
from realtimeraytracer_torch import scenes
from realtimeraytracer_torch.ops.alpha_mask import build_face_masks_np, pack_amask_np
from realtimeraytracer_torch.ops.intersect import HitRecord
from realtimeraytracer_torch.render import alpha, megakernel
from realtimeraytracer_torch.render.backends import make_backend, make_hybrid_backend
from realtimeraytracer_torch.render.hier_backend import make_hier_backend
from realtimeraytracer_torch.render.megakernel import render_components
from realtimeraytracer_torch.scene.gpu_scene import alpha_subset_amask, from_numpy_leaves
from realtimeraytracer_torch.utils import log

torch.set_num_threads(2)

FOLIAGE_TRIS = 12_000        # the smallest baked foliage_field with plants
SPLIT_LEAVES = ("pallas_panels_opq", "pallas_cl_min_opq", "pallas_cl_max_opq",
                "pallas_panels_alp", "pallas_cl_min_alp", "pallas_cl_max_alp", "alpha_tri_id")
JAX_ROUNDS = 0               # the JAX oracles' alpha_rounds: one re-trace
N_SEGMENTS = 150             # segments toward light 0, and as many toward the sun
N_FAULT = 48                 # segments that meet the JAX split's mask fault


def _leaves(jgpu) -> dict:
    return {k: np.asarray(v) for k, v in jgpu._asdict().items() if v is not None}


@pytest.fixture(scope="module")
def foliage():
    """The JAX compile of the baked foliage, the port's copy of it, and
    the port's own compile of the same scene."""
    jgpu = jax_scenes.foliage_field(target_tris=FOLIAGE_TRIS).compile(bake_instances=True)
    own = scenes.foliage_field(target_tris=FOLIAGE_TRIS).compile(bake_instances=True)
    return jgpu, from_numpy_leaves(_leaves(jgpu)), own


def test_split_leaves_match_jax(foliage):
    jgpu, carried, own = foliage
    for name in SPLIT_LEAVES:
        want = np.asarray(getattr(jgpu, name))
        np.testing.assert_array_equal(getattr(own, name).numpy(), want)
        np.testing.assert_array_equal(getattr(carried, name).numpy(), want)
        assert getattr(own, name).dtype == getattr(carried, name).dtype
    assert own.has_alpha_split and carried.has_alpha_split
    assert own.pallas_panels_alp.shape[0] < own.pallas_panels.shape[0]
    # The port's own leaf: the alpha faces' masks on the subset's panels;
    # a scene carried from JAX (no such leaf) builds the same.
    faces = own.faces.long().numpy()
    uv = own.uvs.numpy()
    face_tex = own.obj_tex[own.face_obj.long(), 3].numpy()
    fmasks = build_face_masks_np(uv[faces[:, 0]], uv[faces[:, 1]], uv[faces[:, 2]], face_tex,
                                 own.tex_atlas[..., 0].numpy(), own.tex_size.numpy(), 0.9)
    ids = own.alpha_tri_id.numpy()
    want = pack_amask_np(fmasks[ids], own.pallas_panels_alp.shape[0])
    np.testing.assert_array_equal(own.pallas_amask_alp.numpy(), want)
    assert carried.pallas_amask_alp is None
    np.testing.assert_array_equal(alpha_subset_amask(carried).numpy(), want)
    np.testing.assert_array_equal(
        want, jax_amask.pack_amask_np(fmasks[ids], own.pallas_panels_alp.shape[0]))
    # Not the whole scene's blocks: the JAX split reads those.
    assert not np.array_equal(want, own.pallas_amask[:want.shape[0]].numpy())


def test_split_leaves_textured_obj_and_none_when_instanced(tmp_path):
    jgpu = jax_scenes.textured_obj(str(tmp_path)).compile()
    own = scenes.textured_obj().compile()
    for name in SPLIT_LEAVES:
        np.testing.assert_array_equal(getattr(own, name).numpy(), np.asarray(getattr(jgpu, name)))
    assert 0 < own.alpha_tri_id.shape[0] < own.num_tris
    inst = scenes.foliage_field(target_tris=20_000).compile()
    assert inst.instanced and not inst.has_alpha_split
    opaque = scenes.procedural_mesh(300).compile()
    assert not opaque.has_alpha_split and opaque.pallas_amask_alp is None


def _segments(g, rng):
    """Shadow segments from random points of opaque triangles (offset
    toward the sun's side): N_SEGMENTS toward random points of light
    triangle 0 (margin 0.5), N_SEGMENTS toward the sun; then N_FAULT
    segments from 0.05 in front of an alpha-mapped triangle to 0.05 past
    it, at points where the triangle is opaque but the whole scene's mask
    word of the same block and lane (what JAX's split traces the alpha
    subset with) has a zero bit.  Returns (o, d, t_lo, t_hi, fault)."""
    face_tex = g.obj_tex[g.face_obj.long(), 3].numpy()
    opaque = np.nonzero(face_tex < 0)[0]
    n = N_SEGMENTS
    f = g.faces[torch.from_numpy(rng.choice(opaque, n))].long()
    w = torch.from_numpy(rng.dirichlet((1, 1, 1), n).astype(np.float32))
    v = [g.vertices[f[:, k]] for k in range(3)]
    p = v[0] * w[:, :1] + v[1] * w[:, 1:2] + v[2] * w[:, 2:]
    nrm = torch.linalg.cross(v[1] - v[0], v[2] - v[0])
    nrm = nrm / nrm.norm(dim=1, keepdim=True)
    nrm = torch.where((nrm @ g.sun_direction)[:, None] < 0, -nrm, nrm)
    o = p + nrm * 0.01
    ab = torch.from_numpy(rng.uniform(0, 0.5, (n, 2)).astype(np.float32))
    l0, l1, l2 = g.lt_v0[0], g.lt_v1[0], g.lt_v2[0]
    delta = l0 + ab[:, :1] * (l1 - l0) + ab[:, 1:] * (l2 - l0) - o
    dist = delta.norm(dim=1)

    # Fault segments: random barycentric points of alpha triangles.
    a_ids = g.alpha_tri_id.long()
    m = 300_000
    j = torch.from_numpy(rng.integers(0, a_ids.shape[0], m))
    u = torch.from_numpy(rng.random(m).astype(np.float32))
    vv = torch.from_numpy(rng.random(m).astype(np.float32))
    over = u + vv > 1
    u, vv = torch.where(over, 1 - u, u), torch.where(over, 1 - vv, vv)
    fa = g.faces[a_ids[j]].long()
    va = [g.vertices[fa[:, k]] for k in range(3)]
    pa = va[0] * (1 - u - vv)[:, None] + va[1] * u[:, None] + va[2] * vv[:, None]
    na = torch.linalg.cross(va[1] - va[0], va[2] - va[0])
    na = na / na.norm(dim=1, keepdim=True)
    oa, da = pa + na * 0.05, -na
    opacity = alpha.hit_alpha(g, HitRecord(t=torch.full((m,), 0.05), prim_id=a_ids[j].int(),
                                           u=u, v=vv), oa, da)
    word = g.pallas_amask[j // 128, :, j % 128]        # the whole scene's slot j
    b = torch.clamp((vv * 8).int(), 0, 7) * 8 + torch.clamp((u * 8).int(), 0, 7)
    bit = (torch.where(b < 32, word[:, 0], word[:, 1]) >> (b & 31)) & 1
    pick = torch.nonzero((opacity >= 0.9) & (bit == 0)).flatten()[:N_FAULT]
    assert pick.numel() == N_FAULT

    k = pick.numel()
    o_all = torch.cat([o, o, oa[pick]])
    d_all = torch.cat([delta / dist[:, None], g.sun_direction.expand(n, 3), da[pick]])
    lo = torch.full((2 * n + k,), 1e-3)
    hi = torch.cat([dist - 0.5, torch.full((n,), 1e4), torch.full((k,), 0.1)])
    fault = torch.cat([torch.zeros(2 * n, dtype=torch.bool), torch.ones(k, dtype=torch.bool)])
    return o_all.contiguous(), d_all.contiguous(), lo, hi, fault


@pytest.fixture(scope="module")
def segments(foliage):
    _, g, _ = foliage
    return _segments(g, np.random.default_rng(11))


@pytest.mark.parametrize("masks", [True, False])
def test_split_matches_classic_ladder(foliage, segments, masks):
    """On the CPU twins (hybrid route), with and without in-kernel masks:
    the split's flags equal the classic ladder's on every ray the classic
    ladder resolves within its rounds (alpha_rounds 4); the split resolves
    the others at least as far."""
    _, g, _ = foliage
    o, d, lo, hi, _ = segments
    cfg = rt.RenderConfig(alpha_test=True, alpha_split=True)
    hybrid = make_hybrid_backend(g, cfg, use_amask=masks)
    classic, unresolved = alpha.occlusion_ladder(hybrid, g, cfg, o, d, lo, hi)
    record = []
    split = alpha.wrap_backend_with_alpha(hybrid, g, cfg, record=record).occluded(o, d, lo, hi)
    resolved = ~unresolved
    assert resolved.sum() > 250 and 50 < classic.sum() < o.shape[0] - 50
    assert torch.equal(split[resolved], classic[resolved])
    assert (split | ~classic).all()
    # Phase 2 ran, on the lanes phase 1 left unresolved.
    raw = hybrid.occluded(o, d, lo, hi)
    assert record and 0 < record[0][1] <= int((~raw).sum())


@pytest.fixture(scope="module")
def jax_ladders(foliage, segments):
    """JAX's classic ladder and split with masks, and its split without
    masks, on v8 in interpret mode (alpha_rounds=0); the port's on its v8
    twin with the same configs, and its classic ladder's unresolved rays."""
    jgpu, g, _ = foliage
    o, d, lo, hi, fault = segments
    args_j = [jnp.asarray(x.numpy()) for x in (o, d, lo, hi)]
    out = {}
    for name, alpha_test, split in (("classic", True, False), ("split", True, True),
                                    ("split_off", None, True)):
        jcfg = jax_rt.RenderConfig(backend="hier", alpha_test=alpha_test, alpha_split=split,
                                   alpha_rounds=JAX_ROUNDS)
        jbe = jax_alpha.wrap_backend_with_alpha(jax_make_hier_backend(jgpu, jcfg), jgpu, jcfg)
        tcfg = rt.RenderConfig(backend="hier", alpha_test=alpha_test, alpha_split=split,
                               alpha_rounds=JAX_ROUNDS)
        tbe = alpha.wrap_backend_with_alpha(make_hier_backend(g, tcfg), g, tcfg)
        out[name] = (np.asarray(jax.jit(jbe.occluded)(*args_j)), tbe.occluded(o, d, lo, hi).numpy())
    cfg = rt.RenderConfig(backend="hier", alpha_test=True, alpha_rounds=JAX_ROUNDS)
    out["unresolved"] = alpha.occlusion_ladder(make_hier_backend(g, cfg), g, cfg,
                                               o, d, lo, hi)[1].numpy()
    out["fault"] = fault.numpy()
    return out


@pytest.mark.parametrize("masks", ["off", "on_divergent"])
def test_split_matches_jax(jax_ladders, masks):
    """Without masks the port's split equals JAX's on every ray.  With
    masks JAX's split reads the whole scene's mask panels for the alpha
    subset's blocks (its alpha.py builds the subset backend with the
    scene's pallas_amask) and loses occluders that a zero bit of another
    triangle's mask rejects: JAX's split and classic ladder disagree, JAX's
    split is the side at fault, and the port's split is held to JAX's
    classic ladder (ROADMAP queue C)."""
    out = jax_ladders
    if masks == "off":
        want, got = out["split_off"]
        assert 50 < want.sum() < want.size - 50
        np.testing.assert_array_equal(got, want)
        return
    classic_j, classic_t = out["classic"]
    split_j, split_t = out["split"]
    np.testing.assert_array_equal(classic_t, classic_j)
    resolved = ~out["unresolved"]
    np.testing.assert_array_equal(split_t[resolved], classic_j[resolved])
    fault = out["fault"]
    # The reference's fault: segments that end just past an opaque texel
    # of an alpha-mapped triangle are occluded (unless the one re-trace
    # ran out behind a transparent hit), and JAX's split drops some.
    assert classic_j[fault & resolved].all() and split_t[fault & resolved].all()
    lost = classic_j & ~split_j
    assert lost[fault].sum() >= N_FAULT // 4
    assert not (split_j & ~classic_j)[resolved].any()


def _opaque_scene():
    jscene = jax_scenes.procedural_mesh(600, sun=True)
    return jscene, jscene.compile(bvh_threshold=0)


def _components_cfg(**kw):
    return dict(width=32, height=24, primary_rays=1, jitter=False, shadow_rays=3,
                denoise_iterations=0, shadow_ray_margin=0.05, **kw)


def _counting(backend, calls):
    """The backend with its occluded calls counted (rays per call)."""
    def occluded(o, d, lo, hi, common=None):
        calls.append(o.shape[0])
        return backend.occluded(o, d, lo, hi, common=common)
    return backend._replace(occluded=occluded)


@pytest.mark.parametrize("route", ["hier", "hybrid"])
def test_batched_equals_separate(route):
    """One occluded call for all six area segments (2 light triangles x 3
    shadow rays) and one for the sun, against hint-chained traces per
    segment: the components bit-equal."""
    scene = scenes.procedural_mesh(600, sun=True)
    gpu = scene.compile(bvh_threshold=0)
    frame = scene.camera.viewport_frame(32, 24)
    base = rt.RenderConfig(**_components_cfg(backend=route))
    got = {}
    for batch in (True, False):
        cfg = base.replace(batch_occlusion=batch, batch_occlusion_min_rays=0)
        calls = []
        be = _counting(make_backend(gpu, cfg), calls)
        got[batch] = (render_components(gpu, frame, cfg, 0, be), calls)
    (a, calls_b), (b, calls_s) = got[True], got[False]
    r = 32 * 24
    assert calls_b == [6 * r] and calls_s == []     # separate traces are hinted, sun too
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert (a.shadowed != a.unshadowed).any()


def test_batched_matches_jax():
    """The port's batched components against JAX's (v8, interpret mode;
    tests/test_hier.py's 32x24 case) on JAX's compile of the scene."""
    jscene, jgpu = _opaque_scene()
    tgpu = from_numpy_leaves(_leaves(jgpu))
    frame_j = jscene.camera.viewport_frame(32, 24)
    jcfg = jax_rt.RenderConfig(**_components_cfg(backend="hier"), batch_occlusion=True,
                               batch_occlusion_min_rays=0)
    want = jax.jit(lambda g_, f_: jax_render_components(g_, f_, jcfg, 0, jax_make_backend(g_, jcfg)))(
        jgpu, frame_j)
    frame_t = scenes.procedural_mesh(600, sun=True).camera.viewport_frame(32, 24)
    tcfg = rt.RenderConfig(**_components_cfg(backend="hier"), batch_occlusion=True,
                           batch_occlusion_min_rays=0)
    got = render_components(tgpu, frame_t, tcfg, 0, make_backend(tgpu, tcfg))
    for name in ("analytic", "shadowed", "unshadowed"):
        w, g_ = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert np.isfinite(g_).all()
        assert (np.abs(g_ - w) > 2e-3).mean() < 5e-3, name
    assert (np.asarray(want.shadowed) != np.asarray(want.unshadowed)).any()


def test_batched_alpha_scene_runs_one_ladder():
    """On textured_obj (4 light triangles, alpha-tested, hybrid twins) the
    batched frame runs one occlusion ladder for its 8 area segments in
    place of 8, with fewer host syncs, and is bit-equal."""
    scene = scenes.textured_obj()
    gpu = scene.compile()
    frame = scene.camera.viewport_frame(24, 16)
    base = rt.RenderConfig(width=24, height=16, primary_rays=1, shadow_rays=2,
                           denoise_iterations=0, alpha_test=True)
    got = {}
    for batch in (True, False):
        cfg = base.replace(batch_occlusion=batch, batch_occlusion_min_rays=0)
        calls = []
        syncs = alpha.wrap_backend_with_alpha.syncs
        be = _counting(make_backend(gpu, cfg), calls)
        comp = render_components(gpu, frame, cfg, 0, be)
        got[batch] = (comp, calls, alpha.wrap_backend_with_alpha.syncs - syncs)
    (a, calls_b, syncs_b), (b, calls_s, syncs_s) = got[True], got[False]
    r = 24 * 16
    assert calls_b == [8 * r, r] and calls_s == [r] * 9
    assert syncs_b < syncs_s
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_batch_occlusion_gates(monkeypatch):
    """Below batch_occlusion_min_rays, on a per-tile route ("pallas") and
    above 8 light triangles (with one warning) the segments trace per
    light."""
    scene = scenes.procedural_mesh(600, sun=True)
    gpu = scene.compile(bvh_threshold=0)
    frame = scene.camera.viewport_frame(16, 8)
    base = rt.RenderConfig(width=16, height=8, primary_rays=1, jitter=False, shadow_rays=2,
                           denoise_iterations=0, batch_occlusion=True)

    def occluded_calls(g, cfg):
        calls = []
        be = _counting(make_backend(g, cfg), calls)
        render_components(g, frame, cfg, 0, be)
        return calls

    r = 16 * 8
    assert occluded_calls(gpu, base.replace(backend="hier")) == []          # 128 < 65536
    assert occluded_calls(gpu, base.replace(backend="hier", batch_occlusion_min_rays=r)) == [4 * r]
    assert occluded_calls(gpu, base.replace(backend="pallas", batch_occlusion_min_rays=0)) == [r] * 5
    many = dataclasses.replace(gpu, **{k: torch.cat([getattr(gpu, k)] * 5) for k in (
        "lt_v0", "lt_v1", "lt_v2", "lt_color", "lt_intensity", "lt_two_sided", "lt_valid",
        "lt_obj")})
    assert many.num_light_tris == 10
    messages = []
    monkeypatch.setattr(log, "_sink", messages.append)
    monkeypatch.setattr(megakernel, "_batch_warned", False)
    cfg = base.replace(backend="hier", batch_occlusion_min_rays=0)
    assert occluded_calls(many, cfg) == []
    assert occluded_calls(many, cfg) == []
    assert len(messages) == 1 and "batch_occlusion is ignored" in messages[0]
    assert occluded_calls(gpu, cfg) == [4 * r]


def test_split_gates(foliage, monkeypatch):
    """The split engages on per-ray-culling routes of a scene with the
    split leaves, building its two backends once per wrapped backend; not
    on the "pallas" route, not without the option, not on a scene without
    the leaves, not on an instanced scene."""
    _, g, _ = foliage
    built = []
    real = alpha.split_backends
    monkeypatch.setattr(alpha, "split_backends", lambda *a, **k: built.append(1) or real(*a, **k))
    o = torch.tensor([[0.0, 5.0, 0.0]] * 3)
    d = torch.tensor([[0.0, -1.0, 0.0]] * 3)
    cfg = rt.RenderConfig(alpha_test=True, alpha_split=True)

    def wrapped(g_, c_):
        be = make_backend(g_, c_)
        be.occluded(o, d, 1e-3, 1e4)
        be.occluded(o, d, 1e-3, 1e4)
        return len(built)

    assert wrapped(g, cfg) == 1
    assert wrapped(g, cfg.replace(backend="hier")) == 2
    assert wrapped(g, cfg.replace(backend="pallas")) == 2
    assert wrapped(g, cfg.replace(alpha_split=False)) == 2
    no_leaves = dataclasses.replace(g, pallas_panels_opq=None, alpha_tri_id=None)
    assert wrapped(no_leaves, cfg) == 2
    inst = scenes.foliage_field(target_tris=20_000).compile()
    assert wrapped(inst, cfg) == 2


def test_entry_points_run_with_the_options():
    """render, render_pipeline_gpu, render_wavefront and radiance_loss take
    either option through the same entry points (CPU here); frames under
    the frame rule against the options off."""
    from realtimeraytracer_torch.diff.optimize import radiance_loss
    from realtimeraytracer_torch.ops.camera_rays import generate_rays
    from realtimeraytracer_torch.render.pipeline import render_pipeline_gpu
    from realtimeraytracer_torch.render.wavefront import render_wavefront

    scene = scenes.textured_obj()
    on = dict(alpha_split=True, batch_occlusion=True, batch_occlusion_min_rays=0)
    cfg = rt.RenderConfig(width=16, height=12, primary_rays=1, shadow_rays=2,
                          denoise_iterations=1)
    a = rt.render(scene, cfg.replace(**on), device="cpu").numpy()
    b = rt.render(scene, cfg, device="cpu").numpy()
    assert a.shape == (12, 16, 3) and (np.abs(a - b) > 2e-3).mean() < 5e-3
    gpu = scene.compile()
    frame = scene.camera.viewport_frame(16, 12)
    acfg = cfg.replace(alpha_test=True, **on)
    np.testing.assert_array_equal(render_pipeline_gpu(gpu, frame, acfg).numpy(), a)
    wcfg = acfg.replace(max_bounces=2, shadow_rays=1, denoise_iterations=0)
    w = render_wavefront(gpu, frame, wcfg).numpy()
    w0 = render_wavefront(gpu, frame, wcfg.replace(alpha_split=False)).numpy()
    assert np.isfinite(w).all() and (np.abs(w - w0) > 2e-3).mean() < 5e-3
    o, d = generate_rays(frame, 16, 12, jitter=False)
    seed = torch.arange(o.shape[0])
    params = {"obj_color": gpu.obj_color.clone().requires_grad_(True)}
    losses = []
    for c in (acfg, cfg.replace(alpha_test=True)):
        loss = radiance_loss(params, gpu, c, o, d, seed, torch.zeros(o.shape[0], 3))
        loss.backward()
        losses.append(float(loss.detach()))
    assert losses[0] == losses[1] and params["obj_color"].grad.abs().sum() > 0


def test_split_follows_apply_transforms():
    """apply_transforms repacks the split's panels from the moved
    triangles (the JAX package keeps the compile's; ROADMAP queue C): the
    moved scene's subset panels equal a fresh pack of its moved subsets,
    and its split equals its classic ladder."""
    from realtimeraytracer_torch.ops.refit import apply_transforms, identity_transforms
    from realtimeraytracer_torch.scene.panels import pack_clusters_np

    gpu = scenes.textured_obj().compile()
    mats = identity_transforms(gpu)
    mats[:, :3, 3] = torch.tensor([0.3, -0.2, 0.5])
    moved = apply_transforms(gpu, mats)
    alp = np.zeros(gpu.num_tris, bool)
    alp[gpu.alpha_tri_id.numpy()] = True
    tv = [getattr(moved, f"bvh_tri_v{k}").numpy() for k in range(3)]
    for part, keep in (("opq", ~alp), ("alp", alp)):
        want = pack_clusters_np(*(v[keep] for v in tv))
        for name, w in zip(("pallas_panels", "pallas_cl_min", "pallas_cl_max"), want):
            got = getattr(moved, f"{name}_{part}").numpy()
            np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-5, err_msg=name)
            assert not np.allclose(got, getattr(gpu, f"{name}_{part}").numpy())
    frame = scenes.textured_obj().camera.viewport_frame(24, 16)
    cfg = rt.RenderConfig(width=24, height=16, primary_rays=1, shadow_rays=2,
                          denoise_iterations=0, alpha_test=True)
    a = render_components(moved, frame, cfg.replace(alpha_split=True), 0)
    b = render_components(moved, frame, cfg, 0)
    assert (a.shadowed != a.unshadowed).any()
    assert (np.abs(a.shadowed.numpy() - b.shadowed.numpy()) > 2e-3).mean() < 5e-3
