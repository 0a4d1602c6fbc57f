"""Scene compilation of the PyTorch port against the JAX package.

The port's own ``Scene.compile`` is held leaf by leaf against the JAX
compile of the same scene built by both packages' ``scenes`` modules from
one seed.  The JAX side is patched to its NumPy BVH builder (its native C++
builder orders triangles differently).  Tolerance: integer and boolean
leaves equal; float leaves rtol 1e-6 (both are the same NumPy float32
arithmetic, so they are in fact equal).
"""

import numpy as np
import pytest
import torch

import realtimeraytracer_tpu.utils.native as jax_native
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


def _jax_leaves(scene, monkeypatch):
    monkeypatch.setattr(jax_native, "native_build_bvh", lambda *a, **k: None)
    gpu = scene.compile()
    return {k: np.asarray(v) for k, v in gpu._asdict().items() if v is not None}


@pytest.mark.parametrize("name,args", [
    ("procedural_mesh", (600,)),
    ("procedural_mesh", (300, 5, False)),
    ("cornell_box", ()),
    ("sphere_plane", ()),
    ("sky_sphere", ()),
])
def test_compile_matches_jax(monkeypatch, name, args):
    want = _jax_leaves(getattr(jax_scenes, name)(*args), monkeypatch)
    got = getattr(scenes, name)(*args).compile_leaves()
    assert set(got) <= set(want)
    for key, g in got.items():
        w = want[key]
        assert g.shape == w.shape, key
        assert g.dtype == w.dtype, key
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


def test_from_numpy_leaves_roundtrip(monkeypatch):
    leaves = _jax_leaves(jax_scenes.procedural_mesh(300), monkeypatch)
    ts = from_numpy_leaves(leaves)
    assert ts.has_bvh and ts.num_tris == leaves["faces"].shape[0]
    for name in LEAF_NAMES:
        if name in leaves:
            np.testing.assert_array_equal(getattr(ts, name).numpy(), leaves[name])


def test_unported_scene_features_raise(monkeypatch):
    """Textured scenes compile since the third slice and instanced ones, on
    JAX leaves and in the port's own compile, since the fourth; the mip
    path still raises where a config asks for it."""
    tex = JaxScene()
    idx = tex.add_texture(np.ones((4, 4, 3), np.float32))
    tex.add(JaxMesh(vertices=np.eye(3, dtype=np.float32), faces=np.array([[0, 1, 2]]),
                    material=JaxMaterial(color_map=idx)))
    assert from_numpy_leaves(_jax_leaves(tex, monkeypatch)).has_textures
    inst = JaxScene().add_instances(
        JaxMesh(vertices=np.eye(3, dtype=np.float32), faces=np.array([[0, 1, 2]])),
        [np.eye(4, dtype=np.float32)])
    assert from_numpy_leaves(_jax_leaves(inst, monkeypatch)).instanced
    mapped = scenes.sphere_plane()
    mapped.add_texture(np.ones((4, 4, 3), np.float32))
    mapped.add(TriangleMesh(vertices=np.eye(3, dtype=np.float32), faces=np.array([[0, 1, 2]]),
                            material=Material(color_map=0)))
    assert mapped.compile().obj_tex[:, 0].max() == 0
    mapped.add_instances(mapped.meshes[-1], [np.eye(4, dtype=np.float32)])
    assert mapped.compile().instanced
    assert mapped.compile(bake_instances=True).num_tris == 4
    for field, value in (("mip_textures", True), ("aniso_taps", 4)):
        with pytest.raises(NotImplementedError, match=field):
            check_supported(RenderConfig(**{field: value}))


@pytest.mark.parametrize("backend", ["wide", "hier", "quarter", "hybrid"])
def test_unported_backends_raise(backend):
    """Only the wide XLA backend has no port; the v8, v9 and hybrid
    backends build, with alpha testing too (on a scene without opacity
    maps the alpha ladder leaves the backend as it is)."""
    gpu = scenes.procedural_mesh(200).compile()
    if backend == "wide":
        with pytest.raises(NotImplementedError):
            make_backend(gpu, RenderConfig(backend=backend))
        return
    plain = make_backend(gpu, RenderConfig(backend=backend))
    assert plain.num_tris == gpu.num_tris
    alpha = make_backend(gpu, RenderConfig(backend=backend, alpha_test=True))
    assert alpha.num_tris == gpu.num_tris
    assert (alpha.occluded_hinted is None) == (plain.occluded_hinted is None)


@pytest.mark.parametrize("field", sorted(UNPORTED_FIELDS))
def test_unported_fields_raise_when_set(field):
    default = RenderConfig.__dataclass_fields__[field].default
    value = (True if default is None else not default if isinstance(default, bool)
             else default * 2 + 1)
    check_supported(RenderConfig())
    with pytest.raises(NotImplementedError, match=field):
        check_supported(RenderConfig(**{field: value}))


def test_per_image_denoise_is_refused():
    check_supported(RenderConfig(use_pallas_denoise=True))
    with pytest.raises(ValueError, match="use_pallas_denoise"):
        check_supported(RenderConfig(use_pallas_denoise=False))


def test_backend_resolution():
    bvh = scenes.procedural_mesh(200).compile()
    small = scenes.sphere_plane().compile()
    assert resolve_backend_kind(bvh, RenderConfig()) == "hybrid"
    assert resolve_backend_kind(bvh, RenderConfig(backend="pallas")) == "pallas"
    assert resolve_backend_kind(bvh, RenderConfig(use_bvh=False)) == "brute"
    assert resolve_backend_kind(small, RenderConfig()) == "brute"
    assert resolve_backend_kind(small, RenderConfig(backend="pallas")) == "brute"
    assert resolve_backend_kind(bvh, RenderConfig(alpha_test=True)) == "hybrid"
    with pytest.raises(NotImplementedError):
        resolve_backend_kind(bvh, RenderConfig(backend="wide"))


@pytest.mark.parametrize("field,value", [
    ("alpha_rounds", 2), ("alpha_threshold", 0.95), ("serialize_shadow_samples", True),
    ("serialize_shadow_samples", False), ("alpha_test", True)])
def test_alpha_fields_are_supported(field, value):
    """The alpha-tested frame reads these fields; serialize_shadow_samples
    is read and has nothing to fence in eager PyTorch."""
    assert field not in UNPORTED_FIELDS
    check_supported(RenderConfig(**{field: value}))
