"""Mip-mapped and anisotropic textures of the PyTorch port (ops/texture.py,
the mip leaves of scene/scene.py and scene/gpu_scene.py, the mip branch of
render/surface.py) against the JAX package.

Tolerances: mip chains, packed twins and uv densities equal (the same
NumPy float32 arithmetic); the samplers rtol 1e-5, atol 1e-6 (the lerp
weights of XLA and torch can differ in the last ulp); the 32x32
textured_obj frame by PERF.md's frame rule (no NaN, under 0.5% of values
off by more than 2e-3) against JAX's brute-force frame.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import realtimeraytracer_tpu as jax_rt
from realtimeraytracer_tpu import scenes as jax_scenes
from realtimeraytracer_tpu.ops import texture as jax_tex
from realtimeraytracer_tpu.render.megakernel import render_components as jax_components
from realtimeraytracer_tpu.render.pipeline import denoise_and_combine as jax_combine
from realtimeraytracer_tpu.scene.gpu_scene import GPUScene
import realtimeraytracer_torch as rt
from realtimeraytracer_torch import scenes
from realtimeraytracer_torch.ops import texture
from realtimeraytracer_torch.render.pipeline import render_pipeline, render_pipeline_gpu
from realtimeraytracer_torch.scene.gpu_scene import from_numpy_leaves

torch.set_num_threads(2)

MIP_LEAVES = ("tex_mip_atlas", "tex_mip_atlas_packed", "face_uv_density")


def _atlas():
    """Three seeded textures of odd and even sides in one padded atlas."""
    g = np.random.default_rng(12)
    sizes = np.array([[37, 24], [16, 16], [5, 40]], np.int32)
    atlas = np.zeros((3, 40, 40, 4), np.float32)
    for i, (h, w) in enumerate(sizes):
        atlas[i, :h, :w] = g.uniform(0, 1, (h, w, 4))
    return atlas, sizes


def test_mip_chain_and_packed_twin_match_jax():
    atlas, sizes = _atlas()
    got, levels = texture.build_mip_atlas_np(atlas, sizes)
    want, jlevels = jax_tex.build_mip_atlas_np(atlas, sizes)
    assert levels == jlevels == 6
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(texture.pack_mip_atlas_neighbors_np(got, sizes, levels),
                                  jax_tex.pack_mip_atlas_neighbors_np(want, sizes, levels))
    empty, one = texture.build_mip_atlas_np(np.zeros((0, 8, 8, 4), np.float32),
                                            np.zeros((0, 2), np.int32))
    assert empty.shape == (0, 16, 8, 4) and one == 1


@pytest.mark.parametrize("taps", [1, 3, 4])
@pytest.mark.parametrize("packed", [False, True])
def test_samplers_match_jax(taps, packed):
    atlas, sizes = _atlas()
    mips, levels = texture.build_mip_atlas_np(atlas, sizes)
    table = texture.pack_mip_atlas_neighbors_np(mips, sizes, levels) if packed else None
    g = np.random.default_rng(13)
    n = 2048
    tid = g.integers(-1, 3, n).astype(np.int32)
    u, v = (g.uniform(-1.5, 2.5, n).astype(np.float32) for _ in range(2))
    lod = g.uniform(-1.0, levels + 1.0, n).astype(np.float32)
    duv = g.normal(0, 0.05, (n, 2)).astype(np.float32)
    j = [jnp.asarray(x) for x in (mips, sizes, tid, u, v, lod, duv)]
    t = [torch.from_numpy(x) for x in (mips, sizes, tid, u, v, lod, duv)]
    jp = None if table is None else jnp.asarray(table)
    tp = None if table is None else torch.from_numpy(table)
    want = jax_tex.sample_atlas_aniso(j[0], j[1], levels, *j[2:6], j[6], taps, packed=jp)
    got = texture.sample_atlas_aniso(t[0], t[1], levels, *t[2:6], t[6], taps, packed=tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    if taps == 1:
        trilinear = texture.sample_atlas_mip(t[0], t[1], levels, *t[2:6], packed=tp)
        assert torch.equal(trilinear, got)
        np.testing.assert_allclose(trilinear.numpy(), np.asarray(
            jax_tex.sample_atlas_mip(j[0], j[1], levels, *j[2:6], packed=jp)), rtol=1e-5, atol=1e-6)


def _jax_leaves(jscene, **kw):
    gpu = jscene.compile(**kw)
    return {k: np.asarray(v) for k, v in gpu._asdict().items() if v is not None}


@pytest.fixture(scope="module")
def textured(tmp_path_factory):
    """textured_obj in both packages (the JAX leaves always carry mips)."""
    jdir, tdir = tmp_path_factory.mktemp("jax_obj"), tmp_path_factory.mktemp("torch_obj")
    jscene = jax_scenes.textured_obj(str(jdir))
    return jscene, _jax_leaves(jscene), scenes.textured_obj(str(tdir))


@pytest.mark.parametrize("name", ["textured_obj", "procedural_mesh"])
def test_mip_leaves_match_jax_after_the_bvh_permutation(textured, name):
    """The compile builds the mip leaves only when asked; face_uv_density is
    indexed by the BVH-ordered face (prim id), as JAX's."""
    if name == "textured_obj":
        _, want, tscene = textured
    else:
        want, tscene = _jax_leaves(jax_scenes.procedural_mesh(600)), scenes.procedural_mesh(600)
    assert not set(MIP_LEAVES) & set(tscene.compile_leaves())
    got = tscene.compile_leaves(mip_textures=True)
    assert got["bvh_node_min"].shape[0] > 1
    for key in MIP_LEAVES:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_array_equal(got["faces"], want["faces"])
    ts = from_numpy_leaves(want)
    assert ts.has_mips == (name == "textured_obj")


def test_instanced_compile_mip_leaf_matches_jax():
    jscene, tscene = jax_scenes.foliage_field(target_tris=20_000), scenes.foliage_field(20_000)
    want = _jax_leaves(jscene)
    got = tscene.compile_leaves(mip_textures=True)
    assert "inst_inv" in got and got["face_uv_density"].shape == got["faces"].shape[:1]
    for key in MIP_LEAVES:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert from_numpy_leaves(got).has_mips


def test_textured_frame_with_mips_matches_jax(textured):
    """32x32 textured_obj with trilinear mips and 4 anisotropic taps, the
    alpha ladder off so that every fetch is the surface's."""
    jscene, leaves, tscene = textured
    kw = dict(width=32, height=32, primary_rays=1, shadow_rays=1, denoise_iterations=0,
              alpha_test=False, mip_textures=True, aniso_taps=4)
    jcfg = jax_rt.RenderConfig(backend="brute", **kw)
    jgpu = GPUScene(**{k: jnp.asarray(v) for k, v in leaves.items()})
    comp = jax.jit(lambda g, f: jax_components(g, f, jcfg, 0))(
        jgpu, jscene.camera.viewport_frame(32, 32))
    want = np.asarray(jax.jit(lambda c: jax_combine(c, jcfg))(comp))
    cfg = rt.RenderConfig(**kw)
    got = render_pipeline(tscene, cfg, device="cpu").numpy()
    base = render_pipeline(tscene, cfg.replace(mip_textures=False, aniso_taps=1),
                           device="cpu").numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all() and want.std() > 0
    assert (np.abs(got - want) > 2e-3).mean() < 5e-3
    assert (np.abs(got - base) > 2e-3).mean() > 0.01        # the mips do filter
    # A scene compiled without the chain refuses the mip path.
    gpu = tscene.compile()
    with pytest.raises(ValueError, match="mip_textures=True"):
        render_pipeline_gpu(gpu, tscene.camera.viewport_frame(32, 32), cfg)
