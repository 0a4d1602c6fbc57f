"""Shared-geometry instancing and refit of the PyTorch port against the JAX
package.

Scenes: ``foliage_field(target_tris=20_000)`` (273 instances and 273
(instance, super) pairs on 3 pages; at 8_000 it places no instance at all)
and the ``_blob`` scene of tests/test_instancing.py (nine instances of one
random triangle soup, some scaled).  The JAX side is patched to its NumPy
BVH builder, as in tests/test_torch_scene.py, and its v8 kernel runs in
interpret mode.

Tolerances:
  * compiled leaves: integer and boolean leaves equal, float leaves rtol
    1e-6 (the same NumPy float32 arithmetic on both sides);
  * the instanced twin against JAX's instanced kernel on jittered rays: hit
    masks and occluded flags equal, |dt| <= max(1e-3, 1e-4 t) (the bound
    tests/test_foliage_field.py uses: XLA on the CPU contracts a*b+c into
    FMAs in the inverse transform and the intersection, the port does
    not), instance and triangle ids equal where t is equal;
  * surfaces and opacities resolved from one hit record: rtol 1e-5, atol
    1e-5 (float32 rounding of the two packages' transforms);
  * the instanced frame against the baked one in the port: atol 2e-5 (the
    bound of tests/test_instancing.py); against JAX's baked brute-force
    frame, under 0.5% of values off by more than 2e-3 (the frame rule of
    tests/test_pallas.py);
  * transforms and refits: rtol 1e-5, atol 1e-5 (matrix inverses and
    products of the two libraries round differently).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import realtimeraytracer_tpu.utils.native as jax_native
from realtimeraytracer_tpu import scenes as jax_scenes
from realtimeraytracer_tpu.config import RenderConfig as JaxConfig
from realtimeraytracer_tpu.ops import refit as jax_refit
from realtimeraytracer_tpu.ops.intersect import HitRecord as JaxHit
from realtimeraytracer_tpu.render.alpha import hit_alpha as jax_hit_alpha
from realtimeraytracer_tpu.render.hier_backend import (
    hier_closest as jax_hier_closest, hier_occluded as jax_hier_occluded)
from realtimeraytracer_tpu.render.megakernel import render_components as jax_components
from realtimeraytracer_tpu.render.pipeline import denoise_and_combine as jax_combine
from realtimeraytracer_tpu.render.surface import resolve_surface as jax_resolve_surface
from realtimeraytracer_tpu.scene.camera import Camera as JaxCamera
from realtimeraytracer_tpu.scene.geometry import (
    TriangleMesh as JaxMesh, make_grid_plane as jax_grid_plane)
from realtimeraytracer_tpu.scene.lights import AreaLight as JaxAreaLight
from realtimeraytracer_tpu.scene.materials import Material as JaxMaterial
from realtimeraytracer_tpu.scene.scene import Scene as JaxScene
from realtimeraytracer_torch import RenderConfig, scenes
from realtimeraytracer_torch.ops import bvh as port_bvh
from realtimeraytracer_torch.ops import refit
from realtimeraytracer_torch.ops.camera_rays import generate_rays
from realtimeraytracer_torch.ops.intersect import HitRecord
from realtimeraytracer_torch.render import hier_backend as hb
from realtimeraytracer_torch.render.alpha import hit_alpha
from realtimeraytracer_torch.render.backends import make_backend, resolve_backend_kind
from realtimeraytracer_torch.render.megakernel import render_components
from realtimeraytracer_torch.render.pipeline import denoise_and_combine
from realtimeraytracer_torch.render.surface import resolve_surface
from realtimeraytracer_torch.scene.camera import Camera
from realtimeraytracer_torch.scene.geometry import MeshInstance, TriangleMesh, make_grid_plane
from realtimeraytracer_torch.scene.gpu_scene import from_numpy_leaves
from realtimeraytracer_torch.scene.lights import AreaLight
from realtimeraytracer_torch.scene.materials import Material
from realtimeraytracer_torch.scene.panels import pack_clusters, pack_clusters_np
from realtimeraytracer_torch.scene.scene import Scene

torch.set_num_threads(2)

FOLIAGE_TRIS = 20_000
N_RAYS = 512                  # four tiles


def _leaves(gpu):
    return {k: np.asarray(v) for k, v in gpu._asdict().items() if v is not None}


@pytest.fixture
def numpy_builder(monkeypatch):
    monkeypatch.setattr(jax_native, "native_build_bvh", lambda *a, **k: None)


# ---- the _blob scene of tests/test_instancing.py, in both packages ------

def _blob_arrays(n=300, seed=0):
    r = np.random.default_rng(seed)
    base = r.uniform(-1, 1, (n, 1, 3))
    tris = (base + r.normal(0, 0.15, (n, 3, 3))).astype(np.float32)
    return tris.reshape(-1, 3), np.arange(3 * n, dtype=np.int32).reshape(n, 3)


def _transforms(k=9, shift=(0.0, 0.0, 0.0)):
    ts = []
    for i in range(k):
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = np.add(((i % 3) * 3 - 3, 1.0, (i // 3) * 3 - 3), shift)
        if i % 2:
            t[:3, :3] *= 0.7           # scale: normals by the inverse transpose
        ts.append(t)
    return ts


def _blob_scene(jax_side: bool, k=9, shift=(0.0, 0.0, 0.0)):
    v, f = _blob_arrays()
    mesh_cls, mat_cls, scene_cls, cam_cls, light_cls, plane = (
        (JaxMesh, JaxMaterial, JaxScene, JaxCamera, JaxAreaLight, jax_grid_plane) if jax_side
        else (TriangleMesh, Material, Scene, Camera, AreaLight, make_grid_plane))
    mesh = mesh_cls(vertices=v, faces=f, material=mat_cls(color=(0.6, 0.3, 0.2), specular=0.3))
    s = scene_cls(camera=cam_cls(position=(0, 4, 10), look_at=(0, 0.5, 0), fov_y_degrees=55))
    light = light_cls(intensity=6.0)
    light.rotate("x", 90).scale(3.0).move(0, 6, 0)
    s.add(light, plane(size=30.0))
    s.add_instances(mesh, _transforms(k, shift))
    return s


# ---- foliage: one JAX compile, shared by the port as leaves ---------------

@pytest.fixture(scope="module")
def foliage():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "native_build_bvh", lambda *a, **k: None)
        jg = jax_scenes.foliage_field(target_tris=FOLIAGE_TRIS).compile()
    tg = from_numpy_leaves(_leaves(jg))
    assert jg.instanced and tg.instanced
    scene = scenes.foliage_field(target_tris=FOLIAGE_TRIS)
    o, d = generate_rays(scene.camera.viewport_frame(64, 36), 64, 36, jitter=True)
    sel = torch.arange(0, o.shape[0], 4)[:N_RAYS]
    o, d = o[sel].contiguous(), d[sel].contiguous()
    tmin, tmax = torch.full((N_RAYS,), 1e-3), torch.full((N_RAYS,), 1e4)
    return jg, tg, (o, d, tmin, tmax)


def _j(*xs):
    return [jnp.asarray(x.numpy()) for x in xs]


def _shadow_segments(tg, rays, hit):
    """From the primary hits toward a point of light triangle 0; misses get
    the empty window [BIG, -BIG)."""
    o, d, _, _ = rays
    found = hit.prim_id >= 0
    p = o + d * torch.where(found, hit.t, 0.0)[:, None] - d * 1e-3
    ab = torch.from_numpy(np.random.default_rng(5).uniform(0, 0.5, (N_RAYS, 2)).astype(np.float32))
    l0, l1, l2 = tg.lt_v0[0], tg.lt_v1[0], tg.lt_v2[0]
    delta = l0 + ab[:, :1] * (l1 - l0) + ab[:, 1:] * (l2 - l0) - p
    dist = delta.norm(dim=1)
    return (p, delta / dist[:, None], torch.where(found, 1e-3, 3.0e38),
            torch.where(found, dist - 0.05, -3.0e38))


def _assert_closest_matches(got: HitRecord, want):
    hp, hj = got.prim_id.numpy() >= 0, np.asarray(want.prim_id) >= 0
    np.testing.assert_array_equal(hp, hj)
    tp, tj = got.t.numpy()[hp], np.asarray(want.t)[hj]
    assert (np.abs(tp - tj) <= np.maximum(1e-3, 1e-4 * tj)).all()
    eq = tp == tj
    np.testing.assert_array_equal(got.inst.numpy()[hp][eq], np.asarray(want.inst)[hj][eq])
    np.testing.assert_array_equal(got.prim_id.numpy()[hp][eq], np.asarray(want.prim_id)[hj][eq])
    np.testing.assert_array_equal(got.inst.numpy()[~hp], -1)


# ---- compile ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["foliage_20k", "blob"])
def test_instanced_compile_matches_jax(numpy_builder, name):
    if name == "blob":
        want = _leaves(_blob_scene(True).compile())
        got = _blob_scene(False).compile_leaves()
    else:
        want = _leaves(jax_scenes.foliage_field(target_tris=FOLIAGE_TRIS).compile())
        got = scenes.foliage_field(target_tris=FOLIAGE_TRIS).compile_leaves()
    assert got["inst_inv"].shape[0] > 1 and got["pair_tab"][:, 3].sum() >= 9
    # The port carries no mip atlas or uv density (ROADMAP A1).
    assert set(want) - set(got) <= {"tex_mip_atlas", "tex_mip_atlas_packed", "face_uv_density"}
    assert set(got) <= set(want)
    for key, g in got.items():
        w = want[key]
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


def test_from_numpy_leaves_keeps_instancing(foliage):
    jg, tg, _ = foliage
    for name in ("inst_inv", "inst_fwd", "inst_obj", "pair_panel", "pair_tab", "blk_panel",
                 "pair_mesh_aabb", "pallas_amask"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)))
    assert not tg.has_bvh and tg.num_tris == tg.pallas_panels.shape[0] * 128
    assert hb.padded_pair_pages(tg).shape == (hb.SPAGES, 8, 128)


# ---- the instanced v8 twin against JAX's instanced kernel -----------------

@pytest.mark.parametrize("query", ["closest", "occluded", "masked_closest"])
def test_instanced_twin_matches_jax(foliage, query):
    jg, tg, rays = foliage
    jcfg = JaxConfig()
    if query == "occluded":
        seg = _shadow_segments(tg, rays, hb.hier_closest(tg, *rays))
        got = hb.hier_occluded(tg, *seg).numpy()
        want = np.asarray(jax_hier_occluded(jg, jcfg, *_j(*seg)))
        assert 0 < got.sum() < got.size
        np.testing.assert_array_equal(got, want)
        return
    masked = query == "masked_closest"
    got = hb.hier_closest(tg, *rays, use_amask=masked)
    want = jax_hier_closest(jg, jcfg, *_j(*rays), use_amask=masked)
    assert got.inst is not None and 0 < int((got.prim_id >= 0).sum()) < N_RAYS
    _assert_closest_matches(got, want)
    if masked:
        # The masks reject some hits the unmasked trace keeps.
        open_ = hb.hier_closest(tg, *rays)
        assert bool((open_.prim_id != got.prim_id).any())


def test_instanced_trace_blocks_contract(foliage):
    """outi row 2 carries the instance; hints raise; the plain entry
    equals the dispatching one on CPU tensors."""
    _, tg, (o, d, tmin, tmax) = foliage
    rays = hb._pack_rays(o, d, tmin, tmax)[0]
    a = hb.trace_blocks_hier(tg, rays, "closest")
    b = hb.trace_blocks_hier_plain(tg, rays, "closest")
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    hit = a[1][:, 0] >= 0
    assert bool((a[1][:, 2][hit] >= 0).all()) and bool((a[1][:, 2][~hit] == -1).all())
    with pytest.raises(ValueError, match="hints"):
        hb.trace_blocks_hier(tg, rays, "occluded",
                             hints=torch.zeros((rays.shape[0], 2), dtype=torch.int32))
    backend = hb.make_hier_backend(tg, RenderConfig())
    assert backend.occluded_hinted is None and backend.perray_cull


# ---- instance-aware surface and alpha --------------------------------------

@pytest.mark.parametrize("what", ["surface", "alpha"])
def test_instance_aware_resolve_matches_jax(foliage, what):
    jg, tg, rays = foliage
    o, d, _, _ = rays
    hit = hb.hier_closest(tg, *rays)
    jhit = JaxHit(t=jnp.asarray(hit.t.numpy()), prim_id=jnp.asarray(hit.prim_id.numpy()),
                  u=jnp.asarray(hit.u.numpy()), v=jnp.asarray(hit.v.numpy()),
                  inst=jnp.asarray(hit.inst.numpy()))
    jo, jd = _j(o, d)
    if what == "alpha":
        got = hit_alpha(tg, hit, o, d).numpy()
        want = np.asarray(jax_hit_alpha(jg, jhit, jo, jd))
        assert (got < 0.9).any() and (got >= 0.9).any()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        return
    got = resolve_surface(tg, hit, o, d)
    want = jax_resolve_surface(jg, jhit, jo, jd)
    for name in ("valid", "hit_light", "missed", "obj_id"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert len(set(got.obj_id[got.valid].tolist())) > 3
    for name in ("position", "normal", "uv", "albedo", "roughness", "metallic", "light_color"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_per_instance_materials():
    """Each instance carries its own object row: red on the left, green on
    the right."""
    v, f = _blob_arrays()
    mesh = TriangleMesh(vertices=v, faces=f, material=Material(color=(0.6, 0.3, 0.2)))
    s = Scene(camera=Camera(position=(0, 2, 8), look_at=(0, 0.5, 0)))
    for x, color in ((-2.0, (1.0, 0.0, 0.0)), (2.0, (0.0, 1.0, 0.0))):
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = (x, 1, 0)
        s.add(MeshInstance(mesh=mesh, transform=t, material=Material(color=color)))
    gpu = s.compile()
    cfg = RenderConfig(width=48, height=32, backend="hier")
    o, d = generate_rays(s.camera.viewport_frame(48, 32), 48, 32, jitter=False)
    be = make_backend(gpu, cfg)
    hit = be.closest(o, d, cfg.t_min, cfg.t_max)
    surf = resolve_surface(gpu, hit, o, d)
    left = surf.valid & (hit.inst == 0)
    right = surf.valid & (hit.inst == 1)
    assert bool(left.any()) and bool(right.any())
    assert bool((surf.albedo[left, 0] > surf.albedo[left, 1]).all())
    assert bool((surf.albedo[right, 1] > surf.albedo[right, 0]).all())


# ---- routing ----------------------------------------------------------------

@pytest.mark.parametrize("backend", ["auto", "hybrid", "hier", "pallas", "quarter", "brute"])
def test_instanced_scene_routes_to_v8(backend):
    gpu = _blob_scene(False, k=2).compile()
    cfg = RenderConfig(backend=backend)
    if backend == "brute":
        with pytest.raises(ValueError, match="instanced"):
            make_backend(gpu, cfg)
        return
    assert resolve_backend_kind(gpu, cfg) == "hier"
    be = make_backend(gpu, cfg)
    assert be.perray_cull and be.occluded_hinted is None and be.num_tris == gpu.num_tris


# ---- the whole frame ----------------------------------------------------------

CFG = dict(width=32, height=32, primary_rays=1, jitter=False, shadow_rays=1,
           denoise_iterations=2, shadow_ray_margin=0.02)


def test_instanced_frame_matches_baked():
    """The instanced frame (v8's instanced twin) against the port's baked
    brute-force frame and against JAX's baked brute-force frame."""
    s = _blob_scene(False)
    frame = s.camera.viewport_frame(32, 32)
    cfg_i = RenderConfig(**CFG, backend="hier")
    cfg_b = RenderConfig(**CFG, backend="brute", use_bvh=False)
    with torch.inference_mode():
        img_i = denoise_and_combine(render_components(s.compile(), frame, cfg_i, 0), cfg_i).numpy()
        img_b = denoise_and_combine(
            render_components(s.compile(bake_instances=True), frame, cfg_b, 0), cfg_b).numpy()
    assert img_i.std() > 0
    np.testing.assert_allclose(img_i, img_b, atol=2e-5)

    js = _blob_scene(True)
    jcfg = JaxConfig(**CFG, backend="brute", use_bvh=False)
    jgpu = js.compile(bake_instances=True)
    comp = jax.jit(lambda g, f: jax_components(g, f, jcfg, 0))(jgpu, js.camera.viewport_frame(32, 32))
    want = np.asarray(jax.jit(lambda c: jax_combine(c, jcfg))(comp))
    assert np.isfinite(img_i).all() and np.isfinite(want).all()
    assert (np.abs(img_i - want) > 2e-3).mean() < 5e-3


# ---- refit ----------------------------------------------------------------------

def _moved_transforms(n_fixed):
    eye = np.broadcast_to(np.eye(4, dtype=np.float32), (n_fixed, 4, 4))
    return np.concatenate([eye, np.stack(_transforms(9, (0.5, 0.4, -0.3)))])


def test_apply_instance_transforms_matches_jax(numpy_builder):
    jg = _blob_scene(True).compile()
    tg = _blob_scene(False).compile()
    all_t = _moved_transforms(tg.inst_inv.shape[0] - 9)
    want = jax_refit.apply_instance_transforms(jg, jnp.asarray(all_t))
    got = refit.apply_instance_transforms(tg, torch.from_numpy(all_t))
    for name in ("inst_fwd", "inst_inv", "pair_panel"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got.vertices.numpy(), tg.vertices.numpy())
    # Traced after the move, as a fresh compile at the moved transforms.
    fresh = _blob_scene(False, shift=(0.5, 0.4, -0.3)).compile()
    o, d = generate_rays(_blob_scene(False).camera.viewport_frame(24, 16), 24, 16, jitter=True)
    tmin, tmax = torch.full((o.shape[0],), 1e-3), torch.full((o.shape[0],), 1e4)
    a, b = hb.hier_closest(got, o, d, tmin, tmax), hb.hier_closest(fresh, o, d, tmin, tmax)
    np.testing.assert_array_equal(a.inst.numpy(), b.inst.numpy())
    hit = a.prim_id >= 0
    assert bool(hit.any())
    torch.testing.assert_close(a.t[hit], b.t[hit], rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="instanced"):
        refit.apply_instance_transforms(_blob_scene(False).compile(bake_instances=True), all_t)


def test_apply_transforms_matches_jax(numpy_builder):
    """A per-object table on a world-space scene: vertices, normals,
    lights, the BVH soup, its refit node boxes and the repacked panels."""
    jg = jax_scenes.procedural_mesh(600).compile()
    tg = scenes.procedural_mesh(600).compile()
    table = refit.identity_transforms(tg)
    table = refit.translate(table, tg.obj_color.shape[0] - 1, (0.3, -0.2, 0.5))
    rot = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    table[0, :3, :3] = rot * 1.5
    jt = jax_refit.translate(jax_refit.identity_transforms(jg), tg.obj_color.shape[0] - 1,
                             (0.3, -0.2, 0.5))
    jt = jt.at[0, :3, :3].set(jnp.asarray(rot.numpy()) * 1.5)
    np.testing.assert_array_equal(table.numpy(), np.asarray(jt))
    want = jax.jit(jax_refit.apply_transforms)(jg, jt)
    got = refit.apply_transforms(tg, table)
    assert got.q_panels is None and want.q_panels is None
    for name in ("vertices", "normals", "lt_v0", "lt_v1", "lt_v2", "bvh_tri_v0", "bvh_tri_v1",
                 "bvh_tri_v2", "bvh_node_min", "bvh_node_max", "pallas_panels",
                 "pallas_cl_min", "pallas_cl_max"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    with pytest.raises(ValueError, match="apply_instance_transforms"):
        refit.apply_transforms(_blob_scene(False, k=2).compile(), table)


def test_refit_nodes_match_refit_numpy():
    """The device-side range reductions against the host sweep, on moved
    vertices; and the in-graph panel pack against the host one."""
    s = scenes.procedural_mesh(700)
    leaves = s.compile_leaves()
    v = leaves["vertices"]
    f = leaves["faces"]
    bvh = port_bvh.build_bvh(v[f[:, 0]], v[f[:, 1]], v[f[:, 2]], leaf_size=4)
    moved = v + np.random.default_rng(3).normal(0, 0.2, v.shape).astype(np.float32)
    want = port_bvh.refit_numpy(bvh, moved[f[:, 0]], moved[f[:, 1]], moved[f[:, 2]])
    ns, ne = refit.subtree_ranges(bvh.node_first, bvh.node_count, bvh.node_skip)
    gpu = from_numpy_leaves({**leaves, "bvh_node_tri_start": ns, "bvh_node_tri_end": ne,
                             "bvh_tri_v0": want.tri_v0, "bvh_tri_v1": want.tri_v1,
                             "bvh_tri_v2": want.tri_v2})
    lo, hi = refit.refit_nodes(gpu, gpu.bvh_tri_v0, gpu.bvh_tri_v1, gpu.bvh_tri_v2)
    np.testing.assert_array_equal(lo.numpy(), want.node_min)
    np.testing.assert_array_equal(hi.numpy(), want.node_max)
    for g, w in zip(pack_clusters(gpu), pack_clusters_np(want.tri_v0, want.tri_v1, want.tri_v2)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)
