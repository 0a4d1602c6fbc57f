"""Scene compilation of the PyTorch port against the JAX package.

The port's own ``Scene.compile`` is held leaf by leaf against the JAX
compile of the same scene built by both packages' ``scenes`` modules from
one seed, both on their default path (the native binned-SAH BVH builds of
the same sources with the same flags), and once more with both packages
patched to their NumPy LBVH builder.  Tolerance: integer and boolean
leaves equal; float leaves rtol 1e-6 (both are the same NumPy float32
arithmetic, so they are in fact equal).
"""

import numpy as np
import pytest
import torch

import realtimeraytracer_tpu.utils.native as jax_native
import realtimeraytracer_torch.utils.native as native
from realtimeraytracer_tpu import scenes as jax_scenes
from realtimeraytracer_tpu.scene.scene import Scene as JaxScene
from realtimeraytracer_tpu.scene.geometry import TriangleMesh as JaxMesh
from realtimeraytracer_tpu.scene.materials import Material as JaxMaterial
from realtimeraytracer_torch import RenderConfig, scenes
from realtimeraytracer_torch.config import UNPORTED_FIELDS, check_supported
from realtimeraytracer_torch.render.backends import make_backend, resolve_backend_kind
from realtimeraytracer_torch.scene.gpu_scene import LEAF_NAMES, from_numpy_leaves
from realtimeraytracer_torch.scene.geometry import TriangleMesh
from realtimeraytracer_torch.scene.materials import Material

torch.set_num_threads(2)


def _jax_leaves(scene):
    gpu = scene.compile()
    return {k: np.asarray(v) for k, v in gpu._asdict().items() if v is not None}


def _compare(got, want):
    assert set(got) <= set(want)
    for key, g in got.items():
        w = want[key]
        assert g.shape == w.shape, key
        assert g.dtype == w.dtype, key
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize("name,args", [
    ("procedural_mesh", (600,)),
    ("procedural_mesh", (300, 5, False)),
    ("cornell_box", ()),
    ("sphere_plane", ()),
    ("sky_sphere", ()),
])
def test_compile_matches_jax(name, args):
    _compare(getattr(scenes, name)(*args).compile_leaves(),
             _jax_leaves(getattr(jax_scenes, name)(*args)))


def test_compile_matches_jax_numpy_builder(monkeypatch):
    """Both packages patched to their NumPy LBVH builder (the port's
    fallback without a C++ compiler): the leaves equal, and the order is
    not the default SAH order."""
    sah = scenes.procedural_mesh(600).compile_leaves()
    monkeypatch.setattr(jax_native, "native_build_bvh", lambda *a, **k: None)
    monkeypatch.setattr(native, "native_build_bvh", lambda *a, **k: None)
    got = scenes.procedural_mesh(600).compile_leaves()
    _compare(got, _jax_leaves(jax_scenes.procedural_mesh(600)))
    assert not np.array_equal(got["faces"], sah["faces"])


def test_from_numpy_leaves_roundtrip():
    leaves = _jax_leaves(jax_scenes.procedural_mesh(300))
    ts = from_numpy_leaves(leaves)
    assert ts.has_bvh and ts.num_tris == leaves["faces"].shape[0]
    for name in LEAF_NAMES:
        if name in leaves:
            np.testing.assert_array_equal(getattr(ts, name).numpy(), leaves[name])


def test_unported_scene_features_raise():
    """Textured and instanced scenes compile, on JAX leaves and in the
    port's own compile, and a config may ask for the mip fields."""
    tex = JaxScene()
    idx = tex.add_texture(np.ones((4, 4, 3), np.float32))
    tex.add(JaxMesh(vertices=np.eye(3, dtype=np.float32), faces=np.array([[0, 1, 2]]),
                    material=JaxMaterial(color_map=idx)))
    assert from_numpy_leaves(_jax_leaves(tex)).has_textures
    inst = JaxScene().add_instances(
        JaxMesh(vertices=np.eye(3, dtype=np.float32), faces=np.array([[0, 1, 2]])),
        [np.eye(4, dtype=np.float32)])
    assert from_numpy_leaves(_jax_leaves(inst)).instanced
    mapped = scenes.sphere_plane()
    mapped.add_texture(np.ones((4, 4, 3), np.float32))
    mapped.add(TriangleMesh(vertices=np.eye(3, dtype=np.float32), faces=np.array([[0, 1, 2]]),
                            material=Material(color_map=0)))
    assert mapped.compile().obj_tex[:, 0].max() == 0
    mapped.add_instances(mapped.meshes[-1], [np.eye(4, dtype=np.float32)])
    assert mapped.compile().instanced
    assert mapped.compile(bake_instances=True).num_tris == 4
    for field, value in (("mip_textures", True), ("aniso_taps", 4)):
        assert field not in UNPORTED_FIELDS
        check_supported(RenderConfig(**{field: value}))


@pytest.mark.parametrize("backend", ["wide", "hier", "quarter", "hybrid"])
def test_unported_backends_raise(backend):
    """Every backend of the JAX package's registry has its port: the wide
    backend, v8, v9 and the hybrid route build and trace, with alpha
    testing too (on a scene without opacity maps the alpha ladder leaves
    the backend as it is)."""
    gpu = scenes.procedural_mesh(200).compile()
    plain = make_backend(gpu, RenderConfig(backend=backend))
    assert plain.num_tris == gpu.num_tris
    alpha = make_backend(gpu, RenderConfig(backend=backend, alpha_test=True))
    assert alpha.num_tris == gpu.num_tris
    assert (alpha.occluded_hinted is None) == (plain.occluded_hinted is None)
    o = torch.tensor([[0.0, 3.0, 14.0]]).expand(8, 3)
    d = torch.nn.functional.normalize(torch.tensor([[0.0, -0.3, -1.0]]).expand(8, 3), dim=1)
    brute = make_backend(gpu, RenderConfig(backend="brute"))
    assert torch.equal(plain.closest(o, d, 1e-3, 1e4).prim_id, brute.closest(o, d, 1e-3, 1e4).prim_id)
    assert torch.equal(plain.occluded(o, d, 1e-3, 10.0), brute.occluded(o, d, 1e-3, 10.0))


@pytest.mark.parametrize("field", sorted(UNPORTED_FIELDS))
def test_unported_fields_raise_when_set(field):
    default = RenderConfig.__dataclass_fields__[field].default
    value = (True if default is None else not default if isinstance(default, bool)
             else default * 2 + 1)
    check_supported(RenderConfig())
    with pytest.raises(NotImplementedError, match=field):
        check_supported(RenderConfig(**{field: value}))


@pytest.mark.parametrize("field", ["cluster_size", "max_cluster_visits", "max_traversal_steps",
                                   "wide_tile"])
def test_traversal_cap_fields_are_supported(field):
    """The wide backend's fields and the lane traversal's step cap have
    their code paths (render/wide_backend.py, render/attic/): check_supported
    accepts them set away from their defaults and the wide backend builds."""
    assert field not in UNPORTED_FIELDS
    value = RenderConfig.__dataclass_fields__[field].default // 2
    cfg = RenderConfig(backend="wide", **{field: value})
    check_supported(cfg)
    gpu = scenes.procedural_mesh(200).compile()
    assert make_backend(gpu, cfg).num_tris == gpu.num_tris


@pytest.mark.parametrize("field,value", [
    ("alpha_split", True), ("batch_occlusion", True), ("batch_occlusion_min_rays", 0),
    ("batch_occlusion_min_rays", 1 << 20)])
def test_occlusion_fields_are_supported(field, value):
    """alpha_split (render/alpha.py) and batch_occlusion with its ray
    threshold (render/megakernel.py) are ported: check_supported accepts
    them and the backends build with them."""
    assert field not in UNPORTED_FIELDS
    cfg = RenderConfig(**{field: value})
    check_supported(cfg)
    gpu = scenes.procedural_mesh(200).compile()
    assert make_backend(gpu, cfg.replace(alpha_test=True)).num_tris == gpu.num_tris


def test_per_image_denoise_is_refused():
    """use_pallas_denoise=False (the per-image stencil) is accepted now,
    as None and True are; only the packet fields and a dtype other than
    float32 are refused."""
    for value in (None, True, False):
        check_supported(RenderConfig(use_pallas_denoise=value))
    assert sorted(UNPORTED_FIELDS) == ["packet_size", "traversal_unroll"]
    with pytest.raises(ValueError, match="float32"):
        check_supported(RenderConfig(dtype="bfloat16"))


def test_backend_resolution():
    bvh = scenes.procedural_mesh(200).compile()
    small = scenes.sphere_plane().compile()
    assert resolve_backend_kind(bvh, RenderConfig()) == "hybrid"
    assert resolve_backend_kind(bvh, RenderConfig(backend="pallas")) == "pallas"
    assert resolve_backend_kind(bvh, RenderConfig(use_bvh=False)) == "brute"
    assert resolve_backend_kind(small, RenderConfig()) == "brute"
    assert resolve_backend_kind(small, RenderConfig(backend="pallas")) == "brute"
    assert resolve_backend_kind(bvh, RenderConfig(alpha_test=True)) == "hybrid"
    assert resolve_backend_kind(bvh, RenderConfig(backend="wide")) == "wide"
    assert resolve_backend_kind(small, RenderConfig(backend="wide")) == "brute"
    assert resolve_backend_kind(bvh, RenderConfig(backend="wide", use_bvh=False)) == "wide"
    for kind in ("lane", "packet"):
        with pytest.raises(ValueError, match="unknown backend"):
            resolve_backend_kind(bvh, RenderConfig(backend=kind))


@pytest.mark.parametrize("field,value", [
    ("alpha_rounds", 2), ("alpha_threshold", 0.95), ("serialize_shadow_samples", True),
    ("serialize_shadow_samples", False), ("alpha_test", True)])
def test_alpha_fields_are_supported(field, value):
    """The alpha-tested frame reads these fields; serialize_shadow_samples
    is read and has nothing to fence in eager PyTorch."""
    assert field not in UNPORTED_FIELDS
    check_supported(RenderConfig(**{field: value}))


@pytest.mark.parametrize("field,value", [
    ("max_bounces", 3), ("sort_bounces", False), ("tile_rays", 4096),
    ("mip_textures", True), ("aniso_taps", 4), ("debug_traversal", True)])
def test_bounce_and_texture_fields_are_supported(field, value):
    """The wavefront reads max_bounces and sort_bounces, the mip path
    mip_textures and aniso_taps, make_backend debug_traversal; tile_rays
    is read by no code of either package and is accepted as in JAX."""
    assert field not in UNPORTED_FIELDS
    check_supported(RenderConfig(**{field: value}))
