"""A-Trous denoiser of the PyTorch port against the JAX package.

Tolerance rtol 1e-5, atol 1e-6 throughout: the port's per-image stencil and
its pair twin follow the JAX term order, but XLA on the CPU contracts
multiply-adds into FMAs and exp differs by an ulp between libraries.  The
JAX reference is the XLA stencil (ops/denoise.atrous_denoise), which the
JAX Pallas pair kernel is itself pinned to; one small interpret-mode run of
that Pallas kernel is compared directly.  The CUDA pair kernel is held
against the pair twin in tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import realtimeraytracer_tpu as jax_rt
from realtimeraytracer_tpu.ops import denoise as jdn
from realtimeraytracer_tpu.ops.denoise_pallas import atrous_denoise_pair as jax_pair
from realtimeraytracer_tpu.render.megakernel import RenderComponents as JaxComponents
from realtimeraytracer_tpu.render.pipeline import denoise_and_combine as jax_combine
import realtimeraytracer_torch as rt
from realtimeraytracer_torch.ops import denoise as tdn
from realtimeraytracer_torch.ops.denoise_kernel import atrous_denoise_pair
from realtimeraytracer_torch.render.megakernel import RenderComponents
from realtimeraytracer_torch.render.pipeline import denoise_and_combine

torch.set_num_threads(2)

PHIS = (1.0, 0.001, 0.001)


def _data(h, w, seed):
    """Shadowed/unshadowed colour, unit normals and positions smooth enough
    that the edge-stopping weights are neither all 0 nor all 1."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    pos = np.stack([xx * 0.01, yy * 0.01, np.zeros_like(xx)], -1)
    pos += r.normal(0, 0.01, pos.shape)
    nrm = np.stack([0.1 * np.sin(xx * 0.3), np.ones_like(xx), 0.1 * np.cos(yy * 0.2)], -1)
    nrm += r.normal(0, 0.01, nrm.shape)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    unsh = r.uniform(0.2, 1.0, (h, w, 3))
    shad = unsh * (r.uniform(size=(h, w, 1)) > 0.4)
    return [np.ascontiguousarray(a, np.float32) for a in (shad, unsh, nrm, pos)]


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("image", [0, 1])
def test_atrous_denoise_matches_jax(image):
    """4 iterations, H not a multiple of the TPU kernel's 8-row tile."""
    data = _data(37, 52, seed=1)
    color, nrm, pos = data[image], data[2], data[3]
    want = jdn.atrous_denoise(*(jnp.asarray(a) for a in (color, nrm, pos)), 4, *PHIS)
    got = tdn.atrous_denoise(*(torch.from_numpy(a) for a in (color, nrm, pos)), 4, *PHIS)
    close(got, want)


def test_pair_twin_matches_jax_stencil():
    s, u, n, p = _data(37, 52, seed=2)
    ws = jdn.atrous_denoise(*(jnp.asarray(a) for a in (s, n, p)), 4, *PHIS)
    wu = jdn.atrous_denoise(*(jnp.asarray(a) for a in (u, n, p)), 4, *PHIS)
    before = atrous_denoise_pair.launches
    gs, gu = atrous_denoise_pair(*(torch.from_numpy(a) for a in (s, u, n, p)), 4, *PHIS)
    assert atrous_denoise_pair.launches == before        # CPU: the twin runs
    close(gs, ws)
    close(gu, wu)


def test_pair_twin_matches_jax_pallas_interpret():
    s, u, n, p = _data(20, 36, seed=3)
    ws, wu = jax_pair(*(jnp.asarray(a) for a in (s, u, n, p)), 2, *PHIS, interpret=True)
    gs, gu = atrous_denoise_pair(*(torch.from_numpy(a) for a in (s, u, n, p)), 2, *PHIS)
    close(gs, ws)
    close(gu, wu)


@pytest.mark.parametrize("iterations,phis", [(2, (0.5, 0.01, 0.02)), (6, PHIS)])
def test_denoise_and_combine_matches_jax(iterations, phis):
    """The frame's denoise at the config's phis, including more iterations
    than the JAX pair kernel takes (the port runs its pair path at any
    count; JAX runs its per-image stencil)."""
    s, u, n, p = _data(37, 52, seed=5)      # the shape above: JAX's eager ops are compiled already
    a = np.random.default_rng(6).uniform(0, 1, s.shape).astype(np.float32)
    kw = dict(denoise_iterations=iterations, denoise_c_phi=phis[0],
              denoise_n_phi=phis[1], denoise_p_phi=phis[2])
    want = jax_combine(JaxComponents(*(jnp.asarray(x) for x in (a, s, u, n, p))),
                       jax_rt.RenderConfig(**kw))
    before = atrous_denoise_pair.launches
    got = denoise_and_combine(RenderComponents(*(torch.from_numpy(x) for x in (a, s, u, n, p))),
                              rt.RenderConfig(**kw))
    assert atrous_denoise_pair.launches == before        # CPU: the twin runs
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_ratio_combine_matches_jax():
    r = np.random.default_rng(4)
    a, s, u = (r.uniform(0, 1, (9, 11, 3)).astype(np.float32) for _ in range(3))
    u[0, 0] = 0.0
    close(tdn.ratio_combine(*(torch.from_numpy(x) for x in (a, s, u))),
          jdn.ratio_combine(*(jnp.asarray(x) for x in (a, s, u))))
