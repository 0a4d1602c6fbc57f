"""Leaf ops of the PyTorch port against the JAX package on the same inputs.

Inputs are made with NumPy from a seed and fed to both.  Tolerances: the RNG
hash and the block permutation are bit-equal; camera rays rtol 1e-6;
vecmath, tonemap, texture, shading, the LTC table fetch and intersection
rtol 1e-5, atol 1e-6 (both sides are float32; transcendental functions and
rsqrt are different implementations, which moves results by a few ulp).
The LTC polygon integral takes rtol 1e-4, atol 1e-5: it sums three edge
integrals of nearly cancelling vectors, which amplifies those ulps (seen:
one value in 512 at 6.5e-5 relative).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from realtimeraytracer_tpu.ops import camera_rays as jcam
from realtimeraytracer_tpu.ops import intersect as jint
from realtimeraytracer_tpu.ops import ltc as jltc
from realtimeraytracer_tpu.ops import rng as jrng
from realtimeraytracer_tpu.ops import shading as jsh
from realtimeraytracer_tpu.ops import texture as jtex
from realtimeraytracer_tpu.ops import tonemap as jtm
from realtimeraytracer_tpu.ops import vecmath as jvm
from realtimeraytracer_tpu.scene.camera import Camera as JaxCamera
from realtimeraytracer_tpu.scene.scene import load_ltc_tables
from realtimeraytracer_torch.ops import camera_rays as tcam
from realtimeraytracer_torch.ops import intersect as tint
from realtimeraytracer_torch.ops import ltc as tltc
from realtimeraytracer_torch.ops import rng as trng
from realtimeraytracer_torch.ops import shading as tsh
from realtimeraytracer_torch.ops import texture as ttex
from realtimeraytracer_torch.ops import tonemap as ttm
from realtimeraytracer_torch.ops import vecmath as tvm
from realtimeraytracer_torch.scene.camera import Camera as TorchCamera

torch.set_num_threads(2)

N = 512


def close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def unit(r, n=N):
    v = r.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def both(*arrays):
    """(jax arrays, torch tensors) of the same NumPy inputs."""
    return ([jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays])


# ---- rng, camera rays, block permutation --------------------------------

def test_hash_bit_equal():
    seeds = np.concatenate([
        np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], np.uint32),
        np.random.default_rng(0).integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)])
    want = np.asarray(jrng.hash_u32(jnp.asarray(seeds)))
    got = trng.hash_u32(torch.from_numpy(seeds.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    np.testing.assert_array_equal(
        trng.uniform(torch.from_numpy(seeds.astype(np.int64))).numpy(),
        np.asarray(jrng.uniform(jnp.asarray(seeds))))


@pytest.mark.parametrize("jitter,sample", [(True, 0), (True, 3), (False, 0)])
def test_generate_rays(jitter, sample):
    kw = dict(position=(0.3, 2.0, 7.0), look_at=(0.0, 0.5, 0.0), fov_y_degrees=47.0)
    w, h = 37, 21
    jf = JaxCamera(**kw).viewport_frame(w, h)
    tf = TorchCamera(**kw).viewport_frame(w, h)
    for a, b in zip(jf, tf):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jo, jd = jcam.generate_rays(jf, w, h, sample_index=sample, jitter=jitter)
    to, td = tcam.generate_rays(tf, w, h, sample_index=sample, jitter=jitter)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    close(td, jd, rtol=1e-6, atol=0)


@pytest.mark.parametrize("w,h", [(37, 21), (64, 16)])
def test_block_permutation(w, h):
    jp, ji = jcam.block_permutation(w, h)
    tp, ti = tcam.block_permutation(w, h)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ---- vecmath, tonemap ----------------------------------------------------

@pytest.mark.parametrize("name", ["dot", "cross", "length", "normalize", "reflect", "mix"])
def test_vecmath(name):
    r = np.random.default_rng(1)
    a = r.normal(size=(N, 3)).astype(np.float32)
    b = r.normal(size=(N, 3)).astype(np.float32)
    a[0] = 0.0                                       # normalize's zero guard
    (ja, jb), (ta, tb) = both(a, b)
    if name == "mix":
        t = r.uniform(size=(N, 1)).astype(np.float32)
        close(tvm.mix(ta, tb, torch.from_numpy(t)), jvm.mix(ja, jb, jnp.asarray(t)))
    elif name in ("dot", "cross", "reflect"):
        close(getattr(tvm, name)(ta, tb), getattr(jvm, name)(ja, jb))
    else:
        close(getattr(tvm, name)(ta), getattr(jvm, name)(ja))


@pytest.mark.parametrize("mode", ["aces", "lut", "none"])
def test_tonemap(mode):
    x = np.random.default_rng(2).uniform(-0.5, 9.0, (N, 3)).astype(np.float32)
    close(ttm.tonemap(torch.from_numpy(x), mode), jtm.tonemap(jnp.asarray(x), mode))
    close(ttm.srgb_to_linear(torch.from_numpy(x)), jtm.srgb_to_linear(jnp.asarray(x)))


# ---- texture subset ------------------------------------------------------

@pytest.mark.parametrize("wrap", [True, False])
def test_sample_bilinear_and_packed(wrap):
    r = np.random.default_rng(3)
    img = r.uniform(size=(13, 17, 4)).astype(np.float32)
    u = r.uniform(-0.5, 1.5, N).astype(np.float32)
    v = r.uniform(-0.5, 1.5, N).astype(np.float32)
    (ji, ju, jv), (ti, tu, tv) = both(img, u, v)
    close(ttex.sample_bilinear(ti, tu, tv, wrap=wrap), jtex.sample_bilinear(ji, ju, jv, wrap=wrap))
    close(ttex.sample_bilinear_packed(ttex.pack_bilinear_neighbors(ti, wrap=wrap), tu, tv, wrap=wrap),
          jtex.sample_bilinear_packed(jtex.pack_bilinear_neighbors(ji, wrap=wrap), ju, jv, wrap=wrap))


def test_sample_equirect():
    """On the scenes' sky texture.  atan2/acos differ by an ulp between the
    two libraries, which moves the sample point by ~1e-7 texels: on a
    smooth environment that stays inside the tolerance."""
    from realtimeraytracer_tpu.scenes import make_sky_gradient

    r = np.random.default_rng(4)
    hdri = make_sky_gradient(16, 32)
    d = unit(r)
    (jh, jd), (th, td) = both(hdri, d)
    close(ttex.sample_equirect(th, td), jtex.sample_equirect(jh, jd))


# ---- shading, LTC ----------------------------------------------------------

def _shade_inputs(seed):
    r = np.random.default_rng(seed)
    n = unit(r)
    view = unit(r)
    view = np.where((view * n).sum(1, keepdims=True) < 0, -view, view).astype(np.float32)
    light = unit(r)
    rough = r.uniform(0.05, 1.0, N).astype(np.float32)
    albedo = r.uniform(size=(N, 3)).astype(np.float32)
    metal = r.uniform(size=N).astype(np.float32)
    return n, view, light, rough, albedo, metal


@pytest.mark.parametrize("clamps", [(0.1, 0.1), (5.0, 1e-4)])
def test_shading(clamps):
    n, view, light, rough, albedo, metal = _shade_inputs(5)
    (jn, jv, jl, jr, ja, jm), (tn, tv, tl, tr, ta, tm) = both(n, view, light, rough, albedo, metal)
    jd, jf0 = jsh.base_color_split(ja, jm)
    td, tf0 = tsh.base_color_split(ta, tm)
    close(td, jd)
    close(tf0, jf0)
    close(tsh.lambert_diffuse(ta, tm), jsh.lambert_diffuse(ja, jm))
    close(tsh.cook_torrance_specular(tv, tl, tn, tr, tf0, *clamps),
          jsh.cook_torrance_specular(jv, jl, jn, jr, jf0, *clamps))


@pytest.mark.parametrize("fast", [False, True])
def test_ltc(fast):
    r = np.random.default_rng(6)
    n, view, _, rough, _, _ = _shade_inputs(6)
    p = r.uniform(-1, 1, (N, 3)).astype(np.float32)
    tri = np.array([[-1, 3, -1], [1, 3, -1], [0, 3, 1]], np.float32)
    ln = np.array([0, -1, 0], np.float32)
    two = (np.arange(N) % 3 == 0)
    ltc1, ltc2 = (np.asarray(x, np.float32) for x in load_ltc_tables())
    ndotv = np.clip((n * view).sum(1), 0, 1).astype(np.float32)
    (jn, jv, jp, jr, jnd, jl1, jl2, jtw), (tn, tv, tp, tr, tnd, tl1, tl2, ttw) = both(
        n, view, p, rough, ndotv, ltc1, ltc2, two)
    jminv, jt2 = jltc.fetch_ltc_params(jl1, jl2, jr, jnd, fast=fast)
    tminv, tt2 = tltc.fetch_ltc_params(tl1, tl2, tr, tnd, fast=fast)
    for a, b in zip(tminv, jminv):
        close(a, b)
    close(tt2, jt2)
    j0, j1, j2, jln = (jnp.asarray(x) for x in (*tri, ln))
    t0, t1, t2, tln = (torch.from_numpy(x) for x in (*tri, ln))
    for tm_, jm_ in ((None, None), (tminv, jminv)):
        close(tltc.ltc_evaluate(tn, tv, tp, tm_, t0, t1, t2, tln, ttw, tl2, fast=fast),
              jltc.ltc_evaluate(jn, jv, jp, jm_, j0, j1, j2, jln, jtw, jl2, fast=fast),
              rtol=1e-4, atol=1e-5)


# ---- intersection --------------------------------------------------------

def _soup(seed, n_tris=200):
    r = np.random.default_rng(seed)
    verts = (r.uniform(-3, 3, (n_tris, 1, 3)) + r.normal(0, 0.5, (n_tris, 3, 3))).astype(np.float32)
    o = r.uniform(-5, 5, (N, 3)).astype(np.float32)
    return verts.reshape(-1, 3), np.arange(3 * n_tris, dtype=np.int32).reshape(-1, 3), o, unit(r)


def test_bruteforce_closest_and_occluded():
    verts, faces, o, d = _soup(7)
    tmax = np.random.default_rng(8).uniform(1, 8, N).astype(np.float32)
    (jv, jf, jo, jd, jt), (tv, tf, to, td, tt) = both(verts, faces, o, d, tmax)
    want = jint.intersect_tris_bruteforce(jo, jd, jv, jf, 1e-3, jt, chunk=128)
    got = tint.intersect_tris_bruteforce(to, td, tv, tf.long(), 1e-3, tt, chunk=128)
    np.testing.assert_array_equal(got.prim_id.numpy(), np.asarray(want.prim_id))
    close(got.t, want.t, atol=0)
    hit = np.asarray(want.prim_id) >= 0
    close(got.u.numpy()[hit], np.asarray(want.u)[hit], atol=1e-5)
    np.testing.assert_array_equal(
        tint.occluded_tris_bruteforce(to, td, tv, tf.long(), 1e-3, tt, chunk=128).numpy(),
        np.asarray(jint.occluded_tris_bruteforce(jo, jd, jv, jf, 1e-3, jt, chunk=128)))


def test_spheres():
    r = np.random.default_rng(9)
    _, _, o, d = _soup(9)
    c = r.uniform(-3, 3, (4, 3)).astype(np.float32)
    rad = r.uniform(0.5, 2.0, 4).astype(np.float32)
    (jo, jd, jc, jr), (to, td, tc, tr) = both(o, d, c, rad)
    want = jint.intersect_spheres(jo, jd, jc, jr, 1e-3, 1e4)
    got = tint.intersect_spheres(to, td, tc, tr, 1e-3, 1e4)
    np.testing.assert_array_equal(got.prim_id.numpy(), np.asarray(want.prim_id))
    close(got.t, want.t)


# ---- the package stays jax-free -----------------------------------------

def test_import_without_jax():
    """Every module of the package (found by walking it, not listed by
    hand, the native host library's bindings and the demo CLI among them)
    imports without loading jax or the JAX package, and so does a build and
    use of the native library."""
    code = ("import importlib, pkgutil, sys, realtimeraytracer_torch as p; "
            "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]; "
            "[importlib.import_module(m) for m in mods]; "
            "assert len(mods) > 30, mods; "
            "assert {'realtimeraytracer_torch.utils.native', 'realtimeraytracer_torch.demo'} "
            "<= set(mods), mods; "
            "from realtimeraytracer_torch.utils import native; "
            "assert native.load_library() is not None; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', "
            "'realtimeraytracer_tpu'))); print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr
