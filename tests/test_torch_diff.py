"""Gradients of the PyTorch port against the JAX package: the losses,
the training step, fit and checkpointing (diff/), the A-Trous pair's
backward (ops/denoise_kernel.py, the plain version of the B5b kernel),
the straight-through traversal and the refit's transforms.

Scenes come over as the JAX compile's NumPy leaves (from_numpy_leaves);
JAX runs its brute-force route and its per-image XLA denoise stencil,
never Pallas in interpret mode.  Tolerances: cross-package gradients rtol
1e-4 with atol 1e-6 x the largest gradient entry of the call (float32
forwards that round apart by an ulp or so, summed over a few hundred
pixels); the port's routes against its brute force rtol 2e-5 (the traces
return the same hit ids and the continuous quantities are recomputed
outside them, as JAX's test_backend_grad_equivalence); the Adam step rtol
1e-6.  Two conditions of the reference data are handled, not tolerated:

* At a pixel whose primary ray runs along the surface normal (the image
  centre of an even-sized frame: cornell_box's back wall, sphere_plane's
  sphere) the LTC tangent frame is the normalized rounding residue of
  v - n (n.v), so the two packages' analytic radiance there differs by up
  to 0.2; where N.V rounds to 1, the LUT coordinate sqrt(1 - N.V) has an
  infinite derivative, which JAX's max(., 0) multiplies into NaN for every
  leaf upstream (the port's guard takes the zero branch there).  The
  radiance comparisons drop the rays whose N.V rounds to 1; every
  comparison then renders both images (from the target's gradient) and
  gives each pixel where they disagree by more than 1e-4 its package's own
  image as target, so the pixel carries no gradient; the test asserts that
  at most 1% of the pixels are so treated.
* JAX's gradient of the sphere leaves is NaN as soon as one ray misses
  the sphere: ray_sphere's sqrt(max(disc, 0)) has an infinite derivative
  at 0, which JAX's max multiplies by its zero mask (torch's clamp backward
  selects instead).  The sphere comparison feeds both packages the rays
  that hit the sphere; the port's gradient over every ray is finite.

The clamp of the A-Trous weights (min(exp, 1)) passes the whole gradient
at a tie in the port (torch.clamp_max) and half in JAX (jnp.minimum); a
tie needs a squared difference under about 6e-8 phi, which random data
meets only at the centre tap, whose difference and gradient are 0.
"""

import dataclasses
import functools

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

import realtimeraytracer_tpu as jax_rt
from realtimeraytracer_tpu import scenes as jax_scenes
from realtimeraytracer_tpu.diff import optimize as jax_opt
from realtimeraytracer_tpu.ops import refit as jax_refit
from realtimeraytracer_tpu.ops.camera_rays import generate_rays as jax_generate_rays
from realtimeraytracer_tpu.ops.denoise import atrous_denoise as jax_atrous_denoise
from realtimeraytracer_tpu.scene.camera import Camera as JaxCamera
from realtimeraytracer_tpu.scene.geometry import TriangleMesh as JaxMesh
from realtimeraytracer_tpu.scene.lights import AreaLight as JaxAreaLight
from realtimeraytracer_tpu.scene.materials import Material as JaxMaterial
from realtimeraytracer_tpu.scene.scene import Scene as JaxScene
import realtimeraytracer_torch as rt
from realtimeraytracer_torch import scenes
from realtimeraytracer_torch.diff import checkpoint, optimize as opt
from realtimeraytracer_torch.ops import camera_rays, refit
from realtimeraytracer_torch.ops import denoise_kernel as dk
from realtimeraytracer_torch.ops.camera_rays import generate_rays
from realtimeraytracer_torch.ops.vecmath import normalize
from realtimeraytracer_torch.parallel.mesh import make_ray_mesh
from realtimeraytracer_torch.render import hier_backend as hb
from realtimeraytracer_torch.render import quarter_backend as qb
from realtimeraytracer_torch.render import v7_backend as v7
from realtimeraytracer_torch.render.backends import make_backend, make_bruteforce_backend
from realtimeraytracer_torch.render.megakernel import shade_sample
from realtimeraytracer_torch.render.pipeline import render_pipeline_gpu
from realtimeraytracer_torch.render.surface import resolve_surface
from realtimeraytracer_torch.scene.gpu_scene import from_numpy_leaves

torch.set_num_threads(2)

# JAX tests/test_diff.py's CFG.
KW = dict(width=24, height=24, primary_rays=1, shadow_rays=1, denoise_iterations=0,
          jitter=False, use_bvh=False, shadow_ray_margin=0.02)
PHIS = (1.0, 0.001, 0.001)


def _cfgs(**kw):
    kw = {**KW, **kw}
    return jax_rt.RenderConfig(**kw), rt.RenderConfig(**kw)


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(JAX GPUScene, the port's TorchScene of the same leaves)."""
    jgpu = getattr(jax_scenes, name)().compile()
    return jgpu, from_numpy_leaves({k: np.asarray(v) for k, v in jgpu._asdict().items()
                                    if v is not None})


def _frames(name, w, h):
    return (getattr(jax_scenes, name)().camera.viewport_frame(w, h),
            getattr(scenes, name)().camera.viewport_frame(w, h))


def _rays(name, w=24, h=24):
    o, d = jax_generate_rays(_frames(name, w, h)[0], w, h, jitter=False)
    return np.array(o), np.array(d)


def _port_grads(loss, params: dict, target: np.ndarray):
    """loss(params, target) differentiated by the port: (grads, target's)."""
    p = {n: v.detach().clone().requires_grad_() for n, v in params.items()}
    t = torch.from_numpy(target).requires_grad_()
    loss(p, t).backward()
    return {n: v.grad.numpy() for n, v in p.items()}, t.grad.numpy()


def _agreeing(jax_fn, port_fn, target: np.ndarray):
    """Both packages' gradients, the disagreeing pixels (more than 1e-4 apart
    in any channel) given each package's own image as target; returns
    (jax grads, port grads, disagreeing pixels).  jax_fn / port_fn:
    target -> (param grads, target grad); an image is target - grad_target
    x size / 2, the MSE's own derivative."""
    half = target.size / 2.0
    gj, tj = jax_fn(target)
    gp, tp = port_fn(target)
    img_j, img_p = target - tj * half, target - tp * half
    bad = np.abs(img_j - img_p).max(-1) > 1e-4
    if bad.any():
        gj, _ = jax_fn(np.where(bad[..., None], img_j, target).astype(np.float32))
        gp, _ = port_fn(np.where(bad[..., None], img_p, target).astype(np.float32))
    return gj, gp, int(bad.sum())


def _close(got: dict, want: dict, rtol=1e-4):
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    assert scale > 0
    for n, w in want.items():
        w = np.asarray(w)
        assert np.isfinite(w).all() and np.isfinite(got[n]).all(), n
        np.testing.assert_allclose(got[n], w, rtol=rtol, atol=1e-6 * scale, err_msg=n)


def _along_normal(tg, cfg, o, d) -> np.ndarray:
    """The rays whose N.V rounds to 1 at their hit (the port's surface)."""
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    surf = resolve_surface(tg, make_bruteforce_backend(tg, cfg).closest(o, d, cfg.t_min,
                                                                        cfg.t_max), o, d)
    ndotv = (surf.normal * normalize(o - surf.position)).sum(-1)
    return (surf.valid & (ndotv >= 1.0)).numpy()


def _radiance_grads(name, names, target_value, ray_sel=None):
    """radiance_loss gradients of both packages on the 24x24 CFG primaries
    (optionally a subset of them), less the rays along their hit's normal,
    against a constant target."""
    jg, tg = _scene(name)
    jcfg, tcfg = _cfgs()
    o, d = _rays(name)
    keep = ~_along_normal(tg, tcfg, o, d)
    if ray_sel is not None:
        keep &= ray_sel
    o, d = o[keep], d[keep]
    seed = np.arange(o.shape[0])
    jo, jd, js = jnp.asarray(o), jnp.asarray(d), jnp.asarray(seed, jnp.uint32)
    to, td, ts = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(seed)
    jparams = {n: getattr(jg, n) for n in names}
    f = jax.jit(jax.grad(lambda p, t: jax_opt.radiance_loss(p, jg, jcfg, jo, jd, js, t),
                         argnums=(0, 1)))

    def jax_fn(t):
        g, gt = f(jparams, jnp.asarray(t))
        return {n: np.asarray(v) for n, v in g.items()}, np.asarray(gt)

    def port_fn(t):
        return _port_grads(lambda p, tt: opt.radiance_loss(p, tg, tcfg, to, td, ts, tt),
                           {n: getattr(tg, n) for n in names}, t)

    target = np.full((o.shape[0], 3), target_value, np.float32)
    return _agreeing(jax_fn, port_fn, target)


# ---- losses against jax.grad ---------------------------------------------------

def test_radiance_loss_grads_match_jax_cornell():
    """obj_color, lt_intensity, sun_intensity, env_color and vertices in one
    call, on JAX's CFG (cornell_box, 24x24)."""
    names = ("obj_color", "lt_intensity", "sun_intensity", "env_color", "vertices")
    gj, gp, bad = _radiance_grads("cornell_box", names, 0.1)
    assert bad <= 24 * 24 // 100
    _close(gp, gj)
    assert np.abs(gp["obj_color"]).sum() > 0 and np.abs(gp["vertices"]).sum() > 0


def test_radiance_loss_grads_match_jax_spheres():
    """vertices, sph_center and sph_radius on sphere_plane, over the rays
    that hit the sphere (JAX's sphere gradient is NaN with a ray that
    misses it)."""
    _, tg = _scene("sphere_plane")
    _, tcfg = _cfgs()
    o, d = (torch.from_numpy(x) for x in _rays("sphere_plane"))
    hit = make_bruteforce_backend(tg, tcfg).closest(o, d, tcfg.t_min, tcfg.t_max).prim_id
    on_sphere = hit == tg.num_tris
    assert 10 < int(on_sphere.sum()) < hit.numel()
    names = ("vertices", "sph_center", "sph_radius")
    gj, gp, bad = _radiance_grads("sphere_plane", names, 0.1, ray_sel=on_sphere.numpy())
    assert bad <= 24 * 24 // 100
    _close(gp, gj)
    assert np.abs(gp["sph_center"]).sum() > 0 and np.abs(gp["sph_radius"]).sum() > 0
    # Over every ray, misses included, the port's gradient stays finite.
    all_grads, _ = _port_grads(
        lambda p, t: opt.radiance_loss(p, tg, tcfg, o, d, torch.arange(o.shape[0]), t),
        {n: getattr(tg, n) for n in names}, np.full((o.shape[0], 3), 0.1, np.float32))
    assert all(np.isfinite(v).all() for v in all_grads.values())


@pytest.mark.parametrize("kind", ["hybrid", "pallas", "wide"])
def test_route_grads_match_brute_force(kind):
    """Gradients through the port's BVH routes (the kernels' plain twins on
    the CPU) equal its brute force's: the traces return the same hit ids
    and the surface recomputes every continuous quantity."""
    scene = scenes.procedural_mesh(500, sun=True)
    gpu = scene.compile()
    cfg_b = rt.RenderConfig(**{**KW, "width": 16, "height": 16, "use_bvh": True,
                               "backend": "brute"})
    cfg_k = cfg_b.replace(backend=kind)
    o, d = generate_rays(scene.camera.viewport_frame(16, 16), 16, 16, jitter=False)
    seed = torch.arange(o.shape[0])
    target = np.zeros((o.shape[0], 3), np.float32)

    def grads(cfg):
        return _port_grads(lambda p, t: opt.radiance_loss(p, gpu, cfg, o, d, seed, t),
                           {"obj_color": gpu.obj_color, "vertices": gpu.vertices}, target)[0]

    g_b, g_k = grads(cfg_b), grads(cfg_k)
    for name in ("obj_color", "vertices"):
        np.testing.assert_allclose(g_k[name], g_b[name], rtol=2e-5, atol=1e-7,
                                   err_msg=f"{kind} vs brute: {name}")
        assert np.abs(g_b[name]).sum() > 0


LT_SCALES = (1.0, 1.1, 0.9)


@functools.lru_cache(maxsize=None)
def _pipeline_hypotheses():
    """pipeline_loss (denoise_iterations=2) gradients for obj_color and
    lt_intensity at three light-intensity hypotheses: JAX's by
    vmap(grad) (rows), the port's by a loop; plus the disagreeing pixels
    of each."""
    jg, tg = _scene("cornell_box")
    jcfg, tcfg = _cfgs(denoise_iterations=2)
    jframe, tframe = _frames("cornell_box", 24, 24)
    batch = {"obj_color": jg.obj_color,
             "lt_intensity": jnp.stack([jg.lt_intensity * s for s in LT_SCALES])}
    f = jax.jit(jax.vmap(jax.grad(
        lambda p, t: jax_opt.pipeline_loss(p, jg, jcfg, jframe, 0, t), argnums=(0, 1)),
        in_axes=({"obj_color": None, "lt_intensity": 0}, 0)))
    cache = {}

    def jax_rows(targets):
        key = targets.tobytes()
        if key not in cache:
            g, gt = f(batch, jnp.asarray(targets))
            cache[key] = {n: np.asarray(v) for n, v in g.items()}, np.asarray(gt)
        return cache[key]

    zeros = np.zeros((len(LT_SCALES), 24, 24, 3), np.float32)
    rows = []
    for i, s in enumerate(LT_SCALES):
        params = {"obj_color": tg.obj_color, "lt_intensity": tg.lt_intensity * s}

        def jax_fn(t, i=i):
            targets = zeros.copy()
            targets[i] = t
            g, gt = jax_rows(targets)
            return {n: v[i] for n, v in g.items()}, gt[i]

        def port_fn(t, params=params):
            return _port_grads(lambda p, tt: opt.pipeline_loss(p, tg, tcfg, tframe, 0, tt),
                               params, t)

        rows.append(_agreeing(jax_fn, port_fn, zeros[i]))
    return rows


def test_pipeline_loss_grads_match_jax():
    """The full frame (denoise_iterations=2: the pair and its backward)
    against JAX's (its per-image XLA stencil under AD)."""
    gj, gp, bad = _pipeline_hypotheses()[0]
    assert bad <= 24 * 24 // 100
    _close(gp, gj)
    assert np.abs(gp["obj_color"]).sum() > 0 and np.abs(gp["lt_intensity"]).sum() > 0


def test_pipeline_grads_per_hypothesis_match_jax_vmap():
    """JAX's vmap(grad) over three light-intensity hypotheses: the port
    loops over them (torch.func.vmap through the kernels is not ported),
    each gradient equal to JAX's row."""
    for gj, gp, bad in _pipeline_hypotheses():
        assert bad <= 24 * 24 // 100
        _close(gp, gj)


def test_wavefront_loss_grads_match_jax():
    """The multi-bounce frame, 16x16, 2 bounces, unsorted."""
    jg, tg = _scene("cornell_box")
    jcfg, tcfg = _cfgs(width=16, height=16, max_bounces=2, sort_bounces=False)
    jframe, tframe = _frames("cornell_box", 16, 16)
    f = jax.jit(jax.grad(lambda p, t: jax_opt.wavefront_loss(p, jg, jcfg, jframe, 0, t),
                         argnums=(0, 1)))

    def jax_fn(t):
        g, gt = f({"obj_color": jg.obj_color}, jnp.asarray(t))
        return {"obj_color": np.asarray(g["obj_color"])}, np.asarray(gt)

    def port_fn(t):
        return _port_grads(lambda p, tt: opt.wavefront_loss(p, tg, tcfg, tframe, 0, tt),
                           {"obj_color": tg.obj_color}, t)

    gj, gp, bad = _agreeing(jax_fn, port_fn, np.zeros((16, 16, 3), np.float32))
    assert bad <= 16 * 16 // 100
    _close(gp, gj)
    assert np.abs(gp["obj_color"]).sum() > 0


# ---- the A-Trous pair's backward -----------------------------------------------

def _denoise_data(h, w, seed, dtype=np.float32):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    pos = np.stack([xx * 0.01, yy * 0.01, np.zeros_like(xx)], -1) + r.normal(0, 0.01, (h, w, 3))
    nrm = np.stack([0.1 * np.sin(xx * 0.3), np.ones_like(xx), 0.1 * np.cos(yy * 0.2)], -1)
    nrm += r.normal(0, 0.01, nrm.shape)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    unsh = r.uniform(0.2, 1.0, (h, w, 3))
    shad = unsh * (r.uniform(size=(h, w, 1)) > 0.4)
    return [np.ascontiguousarray(a, dtype) for a in (shad, unsh, nrm, pos)]


@pytest.mark.parametrize("step", [1, 2, 3])
def test_pair_backward_gradcheck(step):
    """The pair iteration's backward (the VJP kernel's plain version on CPU
    tensors) against finite differences in float64, 8x8, all four inputs
    (gradcheck's fast mode: random projections of the Jacobian, the
    full Jacobian taking a minute a step)."""
    ins = [torch.from_numpy(a).requires_grad_() for a in _denoise_data(8, 8, step, np.float64)]
    assert torch.autograd.gradcheck(
        lambda *x: dk.AtrousPairIteration.apply(*x, step, *PHIS), ins, fast_mode=True)


def test_pair_backward_matches_jax_vjp():
    """Two pair iterations backward against jax.vjp of JAX's per-image
    atrous_denoise on each image (normal and position gradients summed over
    the two), 16x16."""
    s, u, n, p = _denoise_data(16, 16, 7)
    r = np.random.default_rng(8)
    gs, gu = (r.normal(size=s.shape).astype(np.float32) for _ in range(2))

    def image_vjp(c, g):
        _, vjp = jax.vjp(lambda c_, n_, p_: jax_atrous_denoise(c_, n_, p_, 2, *PHIS),
                         *(jnp.asarray(a) for a in (c, n, p)))
        return [np.asarray(x) for x in vjp(jnp.asarray(g))]

    (gs_c, gn_s, gp_s), (gu_c, gn_u, gp_u) = image_vjp(s, gs), image_vjp(u, gu)
    want = [gs_c, gu_c, gn_s + gn_u, gp_s + gp_u]
    ins = [torch.from_numpy(a).requires_grad_() for a in (s, u, n, p)]
    out_s, out_u = dk.atrous_denoise_pair(*ins, 2, *PHIS)
    torch.autograd.backward((out_s, out_u), (torch.from_numpy(gs), torch.from_numpy(gu)))
    for name, x, w in zip(("shadowed", "unshadowed", "normal", "position"), ins, want):
        got = x.grad.numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-6 * np.abs(w).max(), err_msg=name)


def test_pair_backward_skips_geometry_unless_asked():
    """Colour-only gradients (material and light parameters) compute no
    normal or position gradient; the colour gradients are the same."""
    s, u, n, p = (torch.from_numpy(a) for a in _denoise_data(12, 10, 3))
    g = torch.ones_like(s)
    full = dk.atrous_pair_iteration_vjp_plain(s, u, n, p, 2, *PHIS, g, g, True)
    colour = dk.atrous_pair_iteration_vjp_plain(s, u, n, p, 2, *PHIS, g, g, False)
    assert colour[2] is None and colour[3] is None and full[2] is not None
    torch.testing.assert_close(colour[0], full[0], rtol=0, atol=0)
    torch.testing.assert_close(colour[1], full[1], rtol=0, atol=0)


# ---- straight-through traversal ------------------------------------------------

def test_render_then_gradient_in_one_process():
    """A frame under inference mode first (it builds the block permutation's
    cached tensors), then a pipeline_loss gradient that gathers by them."""
    camera_rays._block_permutation_on.cache_clear()
    scene = scenes.cornell_box()
    gpu = scene.compile()
    cfg = rt.RenderConfig(width=20, height=12, primary_rays=1, shadow_rays=1,
                          denoise_iterations=1)
    frame = scene.camera.viewport_frame(20, 12)
    target = render_pipeline_gpu(gpu, frame, cfg)
    assert target.is_inference()
    params = {"obj_color": (gpu.obj_color * 0.5).requires_grad_()}
    opt.pipeline_loss(params, gpu, cfg, frame, 0, target).backward()
    assert params["obj_color"].grad.abs().sum() > 0


_TRACES = ((v7, "cull_keys"), (v7, "trace_keys_plain"), (qb, "cull_quarter_keys"),
           (qb, "trace_quarter_plain"), (hb, "trace_hier_plain"), (hb, "trace_hier_multi_plain"))


def test_no_trace_receives_a_gradient(monkeypatch):
    """Every trace the losses run (v9 and v8 on the hybrid route, v7 on the
    "pallas" route, the fused multi-segment v8) is handed tensors that
    carry no gradient, while the gradients of the vertices reach them."""
    calls = {}

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*a, **k):
            for x in list(a) + list(k.values()):
                assert not (isinstance(x, torch.Tensor) and x.requires_grad), name
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(module, name, wrapped)

    for module, name in _TRACES:
        spy(module, name)
    scene = scenes.procedural_mesh(500, sun=True)
    gpu = scene.compile()
    cfg = rt.RenderConfig(width=16, height=16, primary_rays=1, shadow_rays=2,
                          denoise_iterations=1)
    frame = scene.camera.viewport_frame(16, 16)
    o, d = generate_rays(frame, 16, 16, jitter=False)
    seed, target = torch.arange(o.shape[0]), torch.zeros(o.shape)
    for backend in ("hybrid", "pallas"):
        params = {"vertices": gpu.vertices.clone().requires_grad_(),
                  "obj_color": gpu.obj_color.clone().requires_grad_()}
        opt.radiance_loss(params, gpu, cfg.replace(backend=backend), o, d, seed,
                          target).backward()
        assert params["vertices"].grad.abs().sum() > 0
    params = {"vertices": gpu.vertices.clone().requires_grad_()}
    opt.pipeline_loss(params, gpu, cfg, frame, 0, torch.zeros(16, 16, 3)).backward()
    g = opt.apply_params(gpu, params)
    be = make_backend(g, cfg)
    be = be._replace(occluded_multi=lambda o_, ds, lo, hs: hb.hier_occluded_multi(
        g, cfg, o_, ds, lo, hs))
    shade_sample(g, cfg, o, d, seed, be).analytic.sum().backward()
    assert calls.keys() == {name for _, name in _TRACES}, calls


# ---- training step, fit, checkpoints -------------------------------------------

def test_adam_step_matches_optax():
    """One port step from JAX params and optax.adam state carried by
    train_state_from_numpy against optax's update of the same gradient."""
    jg, tg = _scene("cornell_box")
    _, tcfg = _cfgs()
    o, d = (torch.from_numpy(x) for x in _rays("cornell_box"))
    seed, target = torch.arange(o.shape[0]), torch.full(o.shape, 0.1)
    r = np.random.default_rng(4)
    params = {"obj_color": np.asarray(jg.obj_color) * 0.5 + 0.2,
              "lt_intensity": np.asarray(jg.lt_intensity) * 0.8}
    mu = {n: r.normal(0, 0.05, v.shape).astype(np.float32) for n, v in params.items()}
    nu = {n: r.uniform(1e-4, 1e-2, v.shape).astype(np.float32) for n, v in params.items()}
    state = opt.train_state_from_numpy(params, mu, nu, 3, 5e-2)
    step = opt.make_train_step(tcfg, make_ray_mesh(device="cpu"), state.optimizer)
    state, _ = step(state, tg, o, d, seed, target)
    grads = {n: p.grad.numpy() for n, p in state.params.items()}

    optimizer = optax.adam(5e-2)
    jparams = {n: jnp.asarray(v) for n, v in params.items()}
    adam_state, rest = optimizer.init(jparams)
    adam_state = adam_state._replace(count=jnp.asarray(3, jnp.int32),
                                     mu={n: jnp.asarray(v) for n, v in mu.items()},
                                     nu={n: jnp.asarray(v) for n, v in nu.items()})
    updates, (adam_state, _) = optimizer.update(
        {n: jnp.asarray(v) for n, v in grads.items()}, (adam_state, rest), jparams)
    want = optax.apply_updates(jparams, updates)
    for n in params:
        np.testing.assert_allclose(state.params[n].detach().numpy(), np.asarray(want[n]),
                                   rtol=1e-6, err_msg=n)
        saved = state.optimizer.state[state.params[n]]
        np.testing.assert_allclose(saved["exp_avg"].numpy(), np.asarray(adam_state.mu[n]),
                                   rtol=1e-6, err_msg=n)
        np.testing.assert_allclose(saved["exp_avg_sq"].numpy(), np.asarray(adam_state.nu[n]),
                                   rtol=1e-6, err_msg=n)
        assert float(saved["step"]) == 4 == int(adam_state.count)


def _cornell_fit_setup():
    scene = scenes.cornell_box()
    gpu = scene.compile()
    cfg = rt.RenderConfig(**KW)
    o, d = generate_rays(scene.camera.viewport_frame(24, 24), 24, 24, jitter=False)
    seed = torch.arange(o.shape[0])
    target = shade_sample(gpu, cfg, o, d, seed, make_backend(gpu, cfg)).analytic.detach()
    wrong = dataclasses.replace(gpu, obj_color=gpu.obj_color * 0.5 + 0.2)
    return wrong, cfg, o, d, seed, target


def test_fit_radiance_recovers_albedo():
    wrong, cfg, o, d, seed, target = _cornell_fit_setup()
    params, losses = opt.fit(wrong, cfg, o, d, seed, target, param_names=("obj_color",),
                             learning_rate=5e-2, steps=10)
    assert len(losses) == 10 and losses[-1] < losses[0] * 0.5
    assert not params["obj_color"].requires_grad


def test_fit_pipeline_recovers_albedo():
    """fit(loss='pipeline') on a target rendered first (under inference
    mode): the denoised frame is the training signal."""
    scene = scenes.cornell_box()
    cfg = rt.RenderConfig(**{**KW, "width": 16, "height": 16, "denoise_iterations": 1})
    gpu = scene.compile()
    frame = scene.camera.viewport_frame(16, 16)
    target = render_pipeline_gpu(gpu, frame, cfg)
    wrong = dataclasses.replace(gpu, obj_color=gpu.obj_color * 0.4 + 0.3)
    start = float(opt.pipeline_loss({"obj_color": wrong.obj_color}, wrong, cfg, frame, 0,
                                    target))
    _, losses = opt.fit(wrong, cfg, target=target, frame=frame, loss="pipeline", steps=12,
                        learning_rate=5e-2)
    assert losses[-1] < start * 0.5


def test_fit_refusals():
    wrong, cfg, o, d, seed, target = _cornell_fit_setup()
    with pytest.raises(TypeError, match="RayMesh"):
        opt.fit(wrong, cfg, o, d, seed, target, mesh=object())
    with pytest.raises(TypeError, match="RayMesh"):
        opt.make_train_step(cfg, object(), opt.adam({"obj_color": wrong.obj_color}, 0.1))
    with pytest.raises(ValueError, match="frame="):
        opt.fit(wrong, cfg, target=target, loss="pipeline")
    with pytest.raises(ValueError, match="unknown loss"):
        opt.fit(wrong, cfg, o, d, seed, target, loss="bogus")
    with pytest.raises(ValueError, match="meta"):
        opt.fit(wrong, cfg, o, d, seed, torch.empty(target.shape, device="meta"), steps=1)


def test_extract_params_rejects_other_leaves():
    gpu = _scene("cornell_box")[1]
    assert set(opt.extract_params(gpu, ("obj_color", "vertices"))) == {"obj_color", "vertices"}
    with pytest.raises(ValueError, match="faces"):
        opt.extract_params(gpu, ("obj_color", "faces"))


def test_checkpoint_round_trip(tmp_path):
    """Save at step 3 and restore: the next step equals the uninterrupted
    one; a checkpoint of another structure is refused."""
    wrong, cfg, o, d, seed, target = _cornell_fit_setup()
    params = {n: t.detach().clone().requires_grad_()
              for n, t in opt.extract_params(wrong, ("obj_color", "lt_intensity")).items()}
    state = opt.TrainState(params, opt.adam(params, 5e-2))
    step = opt.make_train_step(cfg, make_ray_mesh(device="cpu"), state.optimizer)
    for _ in range(3):
        state, _ = step(state, wrong, o, d, seed, target)
    checkpoint.save_checkpoint(str(tmp_path), state, 3)
    assert checkpoint.latest_step(str(tmp_path)) == 3
    restored = checkpoint.restore_checkpoint(str(tmp_path), state, 3)
    state, loss_a = step(state, wrong, o, d, seed, target)
    restored, loss_b = opt.make_train_step(cfg, make_ray_mesh(device="cpu"),
                                           restored.optimizer)(restored, wrong, o, d, seed, target)
    assert float(loss_a) == float(loss_b)
    for n in params:
        assert torch.equal(state.params[n], restored.params[n])
    other = {"obj_color": params["obj_color"]}
    with pytest.raises(ValueError, match="holds params"):
        checkpoint.restore_checkpoint(str(tmp_path), opt.TrainState(other, opt.adam(other, 0.1)), 3)
    shaped = {"obj_color": params["obj_color"], "lt_intensity": torch.zeros(5)}
    with pytest.raises(ValueError, match="lt_intensity"):
        checkpoint.restore_checkpoint(str(tmp_path), opt.TrainState(shaped, opt.adam(shaped, 0.1)), 3)


# ---- refit ---------------------------------------------------------------------

def _weighted_sum(leaves: dict, weights: dict, lib):
    return sum(lib.sum(leaves[n] * weights[n]) for n in weights)


@pytest.mark.parametrize("leaves", ["scene", "panels"])
def test_apply_transforms_grads_match_jax(leaves):
    """The gradient of the moved leaves, weighted at random, with respect
    to the transform table (through translate, which adds into a copy):
    the vertices, normals, lights, the BVH soup and its refit boxes; then
    the repacked v7/v8 panels alone.  The panels' rows divide by each
    triangle's |n|^2, so their gradient sums terms up to thousands over 600
    triangles in float32: rtol 1e-3 with atol 1e-4 x the largest entry
    there (the other leaves agree bit for bit)."""
    jg = jax_scenes.procedural_mesh(600).compile()
    tg = from_numpy_leaves({k: np.asarray(v) for k, v in jg._asdict().items() if v is not None})
    names = (("pallas_panels",) if leaves == "panels" else
             ("vertices", "normals", "lt_v0", "lt_v1", "lt_v2", "bvh_tri_v0", "bvh_tri_v1",
              "bvh_tri_v2", "bvh_node_min", "bvh_node_max", "pallas_cl_min", "pallas_cl_max"))
    r = np.random.default_rng(5)
    weights = {n: r.normal(size=getattr(tg, n).shape).astype(np.float32) for n in names}
    o = tg.obj_color.shape[0]
    base = (np.eye(4, dtype=np.float32)[None].repeat(o, 0)
            + np.pad(r.normal(0, 0.05, (o, 3, 4)), ((0, 0), (0, 1), (0, 0))).astype(np.float32))
    offset = (0.3, -0.2, 0.5)

    def jax_loss(t):
        moved = jax_refit.apply_transforms(jg, jax_refit.translate(t, o - 1, offset))
        return _weighted_sum(moved._asdict(), {n: jnp.asarray(w) for n, w in weights.items()}, jnp)

    want = np.asarray(jax.jit(jax.grad(jax_loss))(jnp.asarray(base)))
    table = torch.from_numpy(base).requires_grad_()
    moved = refit.apply_transforms(tg, refit.translate(table, o - 1, offset))
    _weighted_sum({n: getattr(moved, n) for n in names},
                  {n: torch.from_numpy(w) for n, w in weights.items()}, torch).backward()
    got = table.grad.numpy()
    assert np.abs(want).max() > 0
    rtol, atol = (1e-3, 1e-4) if leaves == "panels" else (1e-4, 1e-6)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * np.abs(want).max())


def test_apply_instance_transforms_grads_match_jax():
    """inst_fwd, inst_inv and the pairs' world boxes, weighted at random,
    differentiated with respect to the instances' matrices."""
    r = np.random.default_rng(6)
    base_tri = r.uniform(-1, 1, (40, 1, 3))
    v = (base_tri + r.normal(0, 0.15, (40, 3, 3))).astype(np.float32).reshape(-1, 3)
    f = np.arange(120, dtype=np.int32).reshape(40, 3)
    s = JaxScene(camera=JaxCamera(position=(0, 4, 10), look_at=(0, 0.5, 0)))
    light = JaxAreaLight(intensity=6.0)
    light.rotate("x", 90).scale(3.0).move(0, 6, 0)
    s.add(light)
    mats = []
    for i in range(3):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = (3.0 * i - 3.0, 1.0, 0.0)
        mats.append(m)
    s.add_instances(JaxMesh(vertices=v, faces=f, material=JaxMaterial()), mats)
    jg = s.compile()
    tg = from_numpy_leaves({k: np.asarray(x) for k, x in jg._asdict().items() if x is not None})
    assert jg.instanced and tg.instanced
    n_inst = tg.inst_inv.shape[0]
    all_t = np.eye(4, dtype=np.float32)[None].repeat(n_inst, 0)
    all_t[-3:] = np.stack(mats)
    all_t[-3:, :3, :] += r.normal(0, 0.05, (3, 3, 4)).astype(np.float32)
    names = ("inst_fwd", "inst_inv", "pair_panel")
    weights = {n: r.normal(size=getattr(tg, n).shape).astype(np.float32) for n in names}
    # Only the valid pairs' boxes move; the padding rows are constants.
    want = np.asarray(jax.grad(lambda t: _weighted_sum(
        jax_refit.apply_instance_transforms(jg, t)._asdict(),
        {n: jnp.asarray(w) for n, w in weights.items()}, jnp))(jnp.asarray(all_t)))
    t = torch.from_numpy(all_t).requires_grad_()
    moved = refit.apply_instance_transforms(tg, t)
    _weighted_sum({n: getattr(moved, n) for n in names},
                  {n: torch.from_numpy(w) for n, w in weights.items()}, torch).backward()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-4, atol=1e-6 * np.abs(want).max())
