"""Scene container and scene compilation (host scene -> TorchScene).

Counterpart of realtimeraytracer_tpu/scene/scene.py (``Scene``,
``Scene.compile`` and its shared-geometry ``_compile_instanced``,
``compile(bake_instances=True)``, ``_pack_textures``, ``load_ltc_tables``).

Scenes without instances compile to one world-space vertex/index pool
(lights first, tlas.cppm:77-82) with the object and light tables (texture
ids included), the texture atlas and its packed-neighbour twin (with
``mip_textures=True`` also its mip chain, the chain's packed twin and the
per-face uv density that the mip LOD reads), the BVH (the native
binned-SAH build of utils/native.py; the NumPy LBVH of ops/bvh.py only on
a machine without a C++ compiler) with its per-node refit ranges (ops/refit.py), the v7 coefficient panels
and, for scenes of at most RESIDENT_CB blocks, the v9 repacked panels
(ops/repack.py), the conservative alpha masks of both panel sets
(ops/alpha_mask.py), and the LTC LUTs.

Scenes holding ``MeshInstance`` objects compile to the shared-geometry form
(geometry_builder.cppm:178-198, tlas.cppm:60-67): mesh-space pools with one
coefficient-panel set per unique mesh, a per-instance transform and object
table, and world-space (instance, supercluster) box pages for the v8
kernel's instanced top level (render/hier_backend.py); each unique mesh
above CB triangles is sorted by its own native SAH build.  The leaves
equal the JAX compile's: both build through the same native sources with
the same flags, or both through the NumPy builder.

The JAX compile builds the mip leaves for every textured scene; the port
builds them only when asked (``compile(mip_textures=True)``, which
``render_pipeline`` sets from ``cfg.mip_textures``), so frames without
mips keep their compile time and device bytes (ROADMAP queue C).  A
scene without instances that holds both opaque and alpha-mapped triangles
also gets the opaque/alpha panel split that ``alpha_split`` traces
(render/alpha.py): the JAX compile's seven leaves, equal to its, and the
alpha subset's own masks, ``pallas_amask_alp``, which the JAX compile
lacks.  The instanced compile builds no split, as in JAX.
"""

from __future__ import annotations

import copy
import dataclasses
from pathlib import Path

import numpy as np

from realtimeraytracer_torch.scene.camera import Camera
from realtimeraytracer_torch.scene.geometry import MeshInstance, Sphere, TriangleMesh
from realtimeraytracer_torch.scene.gpu_scene import TorchScene, from_numpy_leaves
from realtimeraytracer_torch.scene.lights import AreaLight, DirectionalLight
from realtimeraytracer_torch.scene.materials import Material
from realtimeraytracer_torch.scene.panels import CB, RESIDENT_CB

ASSET_DIR = Path(__file__).resolve().parents[2] / "assets"
# Instanced top level: (instance, supercluster) pairs of at most SPAGES
# pages of 128, as in the JAX package (render/hier_backend.py's SPAGES and
# SUP, kept here so the compile imports no render module).
SPAGES = 24
SUP = 128


def load_ltc_tables() -> tuple[np.ndarray, np.ndarray]:
    """The two 64x64x4 LTC LUTs shipped in assets/."""
    return (np.load(ASSET_DIR / "ltc_1.npy"), np.load(ASSET_DIR / "ltc_2.npy"))


def _transform_points(mat: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ mat[:3, :3].T + mat[:3, 3]


def _transform_normals(mat: np.ndarray, nrm: np.ndarray) -> np.ndarray:
    nmat = np.linalg.inv(mat[:3, :3]).T
    out = nrm @ nmat.T
    n = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.maximum(n, 1e-20)


def _tex_id(ref) -> int:
    if ref is None:
        return -1
    if isinstance(ref, int):
        return ref
    raise ValueError(
        f"texture path {ref!r} not resolved: register it with add_texture "
        "or load it through scene.obj_loader.load_obj_scene")


def _mat_row(mat: Material, is_light: int, color=None):
    c = color if color is not None else mat.color
    return (np.asarray(c, np.float32), np.float32(mat.specular),
            np.float32(mat.metallic), np.int32(is_light),
            np.array([_tex_id(mat.color_map), _tex_id(mat.specular_map),
                      _tex_id(mat.metallic_map), _tex_id(mat.opacity_map)],
                     np.int32))


def _pack_textures(textures) -> tuple[np.ndarray, np.ndarray]:
    """Pack variable-size textures into one padded (T, S, S, 4) stack and
    their true (h, w) sizes; S is the largest side rounded up to a multiple
    of 8.  No textures: a (0, 8, 8, 4) sentinel that lets consumers skip
    texture sampling."""
    if not textures:
        return np.zeros((0, 8, 8, 4), np.float32), np.zeros((0, 2), np.int32)
    s = max(max(t.shape[0], t.shape[1]) for t in textures)
    s = max(8, -(-s // 8) * 8)
    atlas = np.zeros((len(textures), s, s, 4), np.float32)
    sizes = np.zeros((len(textures), 2), np.int32)
    for i, t in enumerate(textures):
        h, w = t.shape[:2]
        atlas[i, :h, :w, : t.shape[2]] = t
        sizes[i] = (h, w)
    return atlas, sizes


def _uv_density(v0, v1, v2, uv0, uv1, uv2) -> np.ndarray:
    """Per-face sqrt(uv area / world area): the texture-LOD density of the
    mip path."""
    world_a2 = np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    e1uv, e2uv = uv1 - uv0, uv2 - uv0
    uv_a2 = np.abs(e1uv[:, 0] * e2uv[:, 1] - e1uv[:, 1] * e2uv[:, 0])
    return np.sqrt(uv_a2 / np.maximum(world_a2, 1e-20)).astype(np.float32)


def _cat(parts, empty_shape, dtype=np.float32):
    if parts:
        return np.concatenate(parts).astype(dtype)
    return np.zeros(empty_shape, dtype)


class _Lights:
    """The light-triangle table, filled light by light (world space)."""

    def __init__(self):
        self.v0, self.v1, self.v2, self.col, self.inten, self.two, self.obj = \
            [], [], [], [], [], [], []

    def add(self, light: AreaLight, v: np.ndarray, obj_id: int) -> None:
        f = light.mesh.faces
        self.v0.append(v[f[:, 0]]); self.v1.append(v[f[:, 1]]); self.v2.append(v[f[:, 2]])
        self.col.append(np.tile(np.asarray(light.color, np.float32), (len(f), 1)))
        self.inten.append(np.full(len(f), light.intensity, np.float32))
        self.two.append(np.full(len(f), bool(light.two_sided)))
        self.obj.append(np.full(len(f), obj_id, np.int32))

    def leaves(self) -> dict[str, np.ndarray]:
        if sum(len(x) for x in self.v0):
            return dict(
                lt_v0=_cat(self.v0, (0, 3)), lt_v1=_cat(self.v1, (0, 3)),
                lt_v2=_cat(self.v2, (0, 3)), lt_color=_cat(self.col, (0, 3)),
                lt_intensity=_cat(self.inten, (0,)),
                lt_two_sided=_cat(self.two, (0,), bool),
                lt_valid=np.ones(sum(len(x) for x in self.v0), bool),
                lt_obj=_cat(self.obj, (0,), np.int32))
        # One invalid entry keeps shapes non-zero; it contributes 0.
        z3 = np.zeros((1, 3), np.float32)
        return dict(lt_v0=z3, lt_v1=z3, lt_v2=z3, lt_color=z3,
                    lt_intensity=np.zeros(1, np.float32),
                    lt_two_sided=np.zeros(1, bool), lt_valid=np.zeros(1, bool),
                    lt_obj=np.zeros(1, np.int32))


def _obj_leaves(obj_rows) -> dict[str, np.ndarray]:
    if obj_rows:
        oc, osp, om, ol, ot = (np.stack([r[k] for r in obj_rows]) for k in range(5))
    else:
        oc = np.zeros((1, 3), np.float32); osp = np.zeros(1, np.float32)
        om = np.zeros(1, np.float32); ol = np.zeros(1, np.int32)
        ot = -np.ones((1, 4), np.int32)
    return dict(obj_color=oc, obj_specular=osp, obj_metallic=om,
                obj_is_light=ol, obj_tex=ot)


def _sphere_leaves(spheres, obj_rows) -> dict[str, np.ndarray]:
    """The analytic spheres; each appends its object row."""
    center, radius, obj = [], [], []
    for sph in spheres:
        obj.append(np.int32(len(obj_rows)))
        obj_rows.append(_mat_row(sph.material, is_light=0))
        center.append(_transform_points(
            sph.transform, np.asarray([sph.center], np.float32))[0])
        radius.append(np.float32(sph.radius))
    return dict(sph_center=(np.stack(center).astype(np.float32) if center
                            else np.zeros((0, 3), np.float32)),
                sph_radius=np.asarray(radius, np.float32),
                sph_obj=np.asarray(obj, np.int32))


_BVH_DUMMIES = dict(
    bvh_node_min=np.zeros((1, 3), np.float32), bvh_node_max=np.zeros((1, 3), np.float32),
    bvh_node_skip=np.zeros(1, np.int32), bvh_node_first=np.zeros(1, np.int32),
    bvh_node_count=np.zeros(1, np.int32), bvh_tri_v0=np.zeros((1, 3), np.float32),
    bvh_tri_v1=np.zeros((1, 3), np.float32), bvh_tri_v2=np.zeros((1, 3), np.float32),
    bvh_tri_id=np.zeros(1, np.int32))


@dataclasses.dataclass
class Scene:
    """A host-side scene: camera + objects + lights + environment."""

    camera: Camera = dataclasses.field(default_factory=Camera)
    meshes: list[TriangleMesh] = dataclasses.field(default_factory=list)
    instances: list[MeshInstance] = dataclasses.field(default_factory=list)
    spheres: list[Sphere] = dataclasses.field(default_factory=list)
    area_lights: list[AreaLight] = dataclasses.field(default_factory=list)
    sun: DirectionalLight | None = None
    hdri: np.ndarray | None = None          # (H, W, 3) sRGB-encoded float
    env_color: tuple[float, float, float] = (0.0, 0.0, 0.0)
    textures: list[np.ndarray] = dataclasses.field(default_factory=list)

    def add(self, *items) -> "Scene":
        for it in items:
            if isinstance(it, MeshInstance):
                self.instances.append(it)
            elif isinstance(it, TriangleMesh):
                self.meshes.append(it)
            elif isinstance(it, Sphere):
                self.spheres.append(it)
            elif isinstance(it, AreaLight):
                self.area_lights.append(it)
            elif isinstance(it, DirectionalLight):
                self.sun = it
            else:
                raise TypeError(f"cannot add {type(it)} to Scene")
        return self

    def add_instances(self, mesh: TriangleMesh, transforms) -> "Scene":
        """Instance one shared mesh at each (4, 4) transform
        (geometry_builder.cppm:178-198 / tlas.cppm:60-67 parity)."""
        for t in transforms:
            self.instances.append(
                MeshInstance(mesh=mesh, transform=np.asarray(t, np.float32)))
        return self

    def add_texture(self, image: np.ndarray) -> int:
        """Register a texture (H, W, C) float [0,1]; returns its index.
        Grey maps repeat to four channels, RGB gains alpha 1."""
        img = np.asarray(image, np.float32)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 4, axis=-1)
        elif img.shape[-1] == 3:
            img = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
        self.textures.append(img)
        return len(self.textures) - 1

    def compile(self, bvh_leaf_size: int = 4, bvh_threshold: int = 64,
                quarter_panels: bool = True, bake_instances: bool = False,
                mip_textures: bool = False) -> TorchScene:
        """Compile to a TorchScene on the CPU (``.to(device)`` moves it)."""
        return from_numpy_leaves(self.compile_leaves(
            bvh_leaf_size, bvh_threshold, quarter_panels, bake_instances,
            mip_textures))

    def _baked(self) -> "Scene":
        """A copy whose instances are world-space meshes (transform =
        instance transform @ mesh transform; the instance's material if it
        has one)."""
        baked = copy.copy(self)
        baked.meshes = list(self.meshes)
        baked.instances = []
        for inst in self.instances:
            m = inst.mesh
            baked.meshes.append(TriangleMesh(
                vertices=m.vertices, faces=m.faces, normals=m.normals,
                uvs=m.uvs, material=inst.material or m.material,
                transform=np.asarray(inst.transform, np.float32) @ m.transform,
                name=inst.name or m.name))
        return baked

    def _env_leaves(self, mip_textures: bool = False) -> dict[str, np.ndarray]:
        """Sun, environment, LTC tables and the texture atlas (with its mip
        chain when asked)."""
        sun = self.sun
        sun_dir = sun.normalized_direction() if sun else np.zeros(3, np.float32)
        hdri = np.ones((1, 1, 3), np.float32) if self.hdri is None else self.hdri
        ltc1, ltc2 = load_ltc_tables()
        atlas, tex_size = _pack_textures(self.textures)
        mips = {}
        if len(self.textures):
            from realtimeraytracer_torch.ops import texture

            atlas_packed = texture.pack_atlas_neighbors_np(atlas, tex_size)
            if mip_textures:
                mip_atlas, n_levels = texture.build_mip_atlas_np(atlas, tex_size)
                mips = dict(tex_mip_atlas=mip_atlas,
                            tex_mip_atlas_packed=texture.pack_mip_atlas_neighbors_np(
                                mip_atlas, tex_size, n_levels))
        else:
            atlas_packed = np.zeros((0, 8, 8, 16), np.float32)
        if mip_textures and not mips:
            mips = dict(tex_mip_atlas=np.zeros((0, 16, 8, 4), np.float32),
                        tex_mip_atlas_packed=np.zeros((0, 16, 8, 16), np.float32))
        return dict(
            sun_direction=np.asarray(sun_dir, np.float32),
            sun_color=np.asarray(sun.color if sun else (0, 0, 0), np.float32),
            sun_intensity=np.asarray(sun.intensity if sun else 0.0, np.float32),
            hdri=np.asarray(hdri, np.float32),
            env_color=np.asarray(self.env_color, np.float32),
            ltc1=ltc1, ltc2=ltc2, tex_atlas=atlas, tex_size=tex_size,
            tex_atlas_packed=atlas_packed, **mips)

    def compile_leaves(self, bvh_leaf_size: int = 4, bvh_threshold: int = 64,
                       quarter_panels: bool = True, bake_instances: bool = False,
                       mip_textures: bool = False) -> dict[str, np.ndarray]:
        """The compiled leaves as NumPy arrays (TorchScene field names).
        Builds the LBVH and v7 panels when the soup exceeds bvh_threshold
        triangles, and the v9 repacked panels too unless quarter_panels is
        False (the JAX compile always builds them; a route that runs no v9
        trace skips the repack's host time).  Scenes with instances compile
        to the shared-geometry form (``_compile_instanced``; the BVH
        arguments do not apply there), or with bake_instances=True to
        world-space copies of every instance (the JAX package's oracle for
        its instanced form).  mip_textures=True adds the mip chain of the
        atlas, its packed twin and the per-face uv density (face_uv_density,
        in the compiled face order)."""
        if self.instances:
            if not bake_instances:
                return self._compile_instanced(mip_textures)
            return self._baked().compile_leaves(bvh_leaf_size, bvh_threshold,
                                                quarter_panels, mip_textures=mip_textures)
        verts, norms, uvs, faces, face_obj, vert_obj = [], [], [], [], [], []
        obj_rows: list[tuple] = []
        lights = _Lights()
        vtx_base = 0

        def push_mesh(mesh: TriangleMesh, obj_id: int, xform: np.ndarray):
            nonlocal vtx_base
            v = _transform_points(xform, mesh.vertices)
            n = _transform_normals(xform, mesh.normals)
            verts.append(v.astype(np.float32))
            norms.append(n.astype(np.float32))
            uvs.append(mesh.uvs.astype(np.float32))
            faces.append(mesh.faces.astype(np.int32) + vtx_base)
            face_obj.append(np.full(len(mesh.faces), obj_id, np.int32))
            vert_obj.append(np.full(len(v), obj_id, np.int32))
            vtx_base += len(v)
            return v

        for light in self.area_lights:
            obj_id = len(obj_rows)
            obj_rows.append(_mat_row(Material(), is_light=1, color=light.color))
            v = push_mesh(light.mesh, obj_id, light.transform @ light.mesh.transform)
            lights.add(light, v, obj_id)

        for mesh in self.meshes:
            obj_id = len(obj_rows)
            obj_rows.append(_mat_row(mesh.material, is_light=0))
            push_mesh(mesh, obj_id, mesh.transform)

        sph = _sphere_leaves(self.spheres, obj_rows)

        vertices = _cat(verts, (0, 3))
        normals = _cat(norms, (0, 3))
        uv_arr = _cat(uvs, (0, 2))
        faces_arr = _cat(faces, (0, 3), np.int32)
        face_obj_arr = _cat(face_obj, (0,), np.int32)
        vert_obj_arr = _cat(vert_obj, (0,), np.int32)
        if len(faces_arr) == 0:
            # One degenerate triangle keeps every gather non-empty; it can
            # never hit (zero determinant).
            vertices = np.zeros((3, 3), np.float32)
            normals = np.tile(np.array([[0, 0, 1]], np.float32), (3, 1))
            uv_arr = np.zeros((3, 2), np.float32)
            faces_arr = np.array([[0, 1, 2]], np.int32)
            face_obj_arr = np.zeros(1, np.int32)
            vert_obj_arr = np.zeros(3, np.int32)

        objs = _obj_leaves(obj_rows)
        ot = objs["obj_tex"]
        env = self._env_leaves(mip_textures)
        atlas, tex_size = env["tex_atlas"], env["tex_size"]

        if len(faces_arr) > bvh_threshold:
            from realtimeraytracer_torch.ops.bvh import build_bvh
            from realtimeraytracer_torch.ops.refit import subtree_ranges
            from realtimeraytracer_torch.scene.panels import pack_clusters_np
            from realtimeraytracer_torch.utils.native import native_build_bvh

            # The native binned-SAH builder first (the NumPy LBVH without a
            # C++ compiler), as the JAX compile does.
            tv0, tv1, tv2 = (vertices[faces_arr[:, k]] for k in range(3))
            bvh = native_build_bvh(tv0, tv1, tv2, bvh_leaf_size)
            if bvh is None:
                bvh = build_bvh(tv0, tv1, tv2, leaf_size=bvh_leaf_size)
            # Faces in BVH order: the traversal's sorted id IS the face id.
            perm = np.asarray(bvh.tri_id, np.int64)
            faces_arr = faces_arr[perm]
            face_obj_arr = face_obj_arr[perm]
            panels, p_lo, p_hi = pack_clusters_np(bvh.tri_v0, bvh.tri_v1,
                                                  bvh.tri_v2)
            bvh_fields = dict(
                bvh_node_min=bvh.node_min, bvh_node_max=bvh.node_max,
                bvh_node_skip=bvh.node_skip, bvh_node_first=bvh.node_first,
                bvh_node_count=bvh.node_count,
                bvh_tri_v0=bvh.tri_v0, bvh_tri_v1=bvh.tri_v1,
                bvh_tri_v2=bvh.tri_v2,
                bvh_tri_id=np.arange(len(perm), dtype=np.int32),
                pallas_panels=panels, pallas_cl_min=p_lo, pallas_cl_max=p_hi)
            # SAH-repacked v9 panels: only where the hybrid route can send
            # traces to v9, and only if the repacked table fits as well.
            q_slots = None
            if quarter_panels and panels.shape[0] <= RESIDENT_CB:
                from realtimeraytracer_torch.ops.repack import build_q_panels_np

                qp, q_lo, q_hi, q_off, q_slots = build_q_panels_np(
                    bvh.tri_v0, bvh.tri_v1, bvh.tri_v2)
                if qp.shape[0] <= RESIDENT_CB:
                    bvh_fields.update(q_panels=qp, q_cl_min=q_lo,
                                      q_cl_max=q_hi, q_group_off=q_off)
                else:
                    q_slots = None
            # Conservative barycentric alpha masks aligned with both panel
            # sets: v9's by repacked slot, pad lanes 0.
            face_tex = ot[face_obj_arr, 3]
            if (face_tex >= 0).any():
                from realtimeraytracer_torch.config import RenderConfig
                from realtimeraytracer_torch.ops.alpha_mask import (
                    build_face_masks_np, pack_amask_np)

                fmasks = build_face_masks_np(
                    uv_arr[faces_arr[:, 0]], uv_arr[faces_arr[:, 1]],
                    uv_arr[faces_arr[:, 2]], face_tex, atlas[..., 0],
                    tex_size, RenderConfig.alpha_threshold)
                bvh_fields.update(pallas_amask=pack_amask_np(fmasks, panels.shape[0]))
                if q_slots is not None:
                    bvh_fields.update(q_amask=pack_amask_np(fmasks, qp.shape[0], q_slots))
            # Opaque/alpha panel split for the two-phase alpha occlusion
            # (render/alpha.py, cfg.alpha_split): only when both subsets
            # are non-empty, as in the JAX compile.  The alpha subset's
            # masks are packed for its own panels (pallas_amask_alp; the
            # JAX compile has none and its split reads the whole scene's,
            # ROADMAP queue C).
            amask = face_tex >= 0
            if amask.any() and not amask.all():
                o_p, o_lo, o_hi = pack_clusters_np(
                    bvh.tri_v0[~amask], bvh.tri_v1[~amask], bvh.tri_v2[~amask])
                a_p, a_lo, a_hi = pack_clusters_np(
                    bvh.tri_v0[amask], bvh.tri_v1[amask], bvh.tri_v2[amask])
                bvh_fields.update(
                    pallas_panels_opq=o_p, pallas_cl_min_opq=o_lo, pallas_cl_max_opq=o_hi,
                    pallas_panels_alp=a_p, pallas_cl_min_alp=a_lo, pallas_cl_max_alp=a_hi,
                    alpha_tri_id=np.nonzero(amask)[0].astype(np.int32),
                    pallas_amask_alp=pack_amask_np(fmasks[amask], a_p.shape[0]))
            # Per-node sorted-triangle ranges for the refit (ops/refit.py).
            ns, ne = subtree_ranges(bvh.node_first, bvh.node_count, bvh.node_skip)
            bvh_fields.update(bvh_node_tri_start=ns, bvh_node_tri_end=ne)
        else:
            bvh_fields = dict(_BVH_DUMMIES)
        if mip_textures:
            # After the BVH face permutation, so that it is indexed by prim id.
            bvh_fields.update(face_uv_density=_uv_density(
                *(vertices[faces_arr[:, k]] for k in range(3)),
                *(uv_arr[faces_arr[:, k]] for k in range(3))))

        return dict(
            vertices=vertices, normals=normals, uvs=uv_arr,
            faces=faces_arr, face_obj=face_obj_arr, **objs, **sph,
            **lights.leaves(), vert_obj=vert_obj_arr, **env, **bvh_fields)

    def _compile_instanced(self, mip_textures: bool = False) -> dict[str, np.ndarray]:
        """Shared-geometry leaves: one coefficient-panel set per unique mesh
        (the BLAS analogue), a per-instance transform and object table, and
        world-space (instance, supercluster) box pages for the v8 kernel's
        top level.  N instances of one mesh cost about 1x mesh memory.

        Pools (vertices, normals, uvs, faces) are mesh-space; the sorted
        prim id maps 1:1 to padded face rows (each mesh's faces are
        sorted by their BVH build, then padded to a multiple of 128), so the kernel and
        the surface resolver index without per-mesh offset tables.  Each
        light quad is its own world-space mesh with an identity instance
        (lights first, tlas.cppm:77-82); meshes and then instances follow,
        one object row each.  With mip_textures, face_uv_density is the
        mesh-space density of each pool face (instance scale taken as 1, as
        in the JAX package)."""
        from realtimeraytracer_torch.ops.bvh import build_bvh
        from realtimeraytracer_torch.scene.panels import pack_clusters_np
        from realtimeraytracer_torch.utils.native import native_build_bvh

        obj_rows: list[tuple] = []
        mesh_entries: list[tuple] = []   # (verts, norms, uvs, faces), mesh space
        inst_list: list[tuple] = []      # (mesh index, 4x4 mesh->world, obj id)
        lights = _Lights()

        for light in self.area_lights:
            obj_id = len(obj_rows)
            obj_rows.append(_mat_row(Material(), is_light=1, color=light.color))
            xform = light.transform @ light.mesh.transform
            v = _transform_points(xform, light.mesh.vertices).astype(np.float32)
            n = _transform_normals(xform, light.mesh.normals).astype(np.float32)
            mesh_entries.append((v, n, light.mesh.uvs.astype(np.float32),
                                 light.mesh.faces.astype(np.int32)))
            inst_list.append((len(mesh_entries) - 1, np.eye(4, dtype=np.float32), obj_id))
            lights.add(light, v, obj_id)

        # Unique object meshes, deduplicated by object identity.
        uniq: dict[int, int] = {}

        def mesh_index(mesh: TriangleMesh) -> int:
            if id(mesh) not in uniq:
                uniq[id(mesh)] = len(mesh_entries)
                mesh_entries.append((
                    np.asarray(mesh.vertices, np.float32),
                    np.asarray(mesh.normals, np.float32),
                    np.asarray(mesh.uvs, np.float32),
                    np.asarray(mesh.faces, np.int32)))
            return uniq[id(mesh)]

        placements = [(m, m.material, np.asarray(m.transform, np.float32))
                      for m in self.meshes]
        placements += [(i.mesh, i.material or i.mesh.material,
                        np.asarray(i.transform, np.float32)
                        @ np.asarray(i.mesh.transform, np.float32))
                       for i in self.instances]
        for mesh, mat, xform in placements:
            obj_id = len(obj_rows)
            obj_rows.append(_mat_row(mat, is_light=0))
            inst_list.append((mesh_index(mesh), xform, obj_id))

        sph = _sphere_leaves(self.spheres, obj_rows)

        # ---- per-unique-mesh pools (mesh space, BVH-sorted) -------------
        verts_p, norms_p, uvs_p, faces_p, dens_p = [], [], [], [], []
        coeff_l, clmin_l, clmax_l, blk_rows = [], [], [], []
        mesh_block_base, mesh_sup_base, mesh_sup_aabbs = [], [], []
        vtx_base = blk_base = sup_base = 0
        for v, n, uv, f in mesh_entries:
            tv0, tv1, tv2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
            if len(f) > CB:
                bvh = native_build_bvh(tv0, tv1, tv2, 4)
                if bvh is None:
                    bvh = build_bvh(tv0, tv1, tv2, leaf_size=4)
                perm = np.asarray(bvh.tri_id, np.int64)
            else:
                perm = np.arange(len(f))
            fs = f[perm]
            coeff, clmin, clmax = pack_clusters_np(tv0[perm], tv1[perm], tv2[perm])
            nb = coeff.shape[0]
            coeff_l.append(coeff); clmin_l.append(clmin); clmax_l.append(clmax)
            fpad = nb * CB - len(fs)
            faces_p.append(np.concatenate([fs + vtx_base, np.zeros((fpad, 3), np.int32)]))
            verts_p.append(v); norms_p.append(n); uvs_p.append(uv)
            if mip_textures:
                dens = _uv_density(tv0[perm], tv1[perm], tv2[perm],
                                   uv[fs[:, 0]], uv[fs[:, 1]], uv[fs[:, 2]])
                dens_p.append(np.concatenate([dens, np.zeros(fpad, np.float32)]))

            bmin = clmin.reshape(nb, 4, 3).min(axis=1)
            bmax = clmax.reshape(nb, 4, 3).max(axis=1)
            nsup = -(-nb // SUP)
            saabbs = np.zeros((nsup, 2, 3), np.float32)
            for k in range(nsup):
                lo, hi = k * SUP, min((k + 1) * SUP, nb)
                row = np.zeros((8, 128), np.float32)
                row[0:3, :] = 3.0e38
                row[3:6, :] = -3.0e38
                row[0:3, : hi - lo] = bmin[lo:hi].T
                row[3:6, : hi - lo] = bmax[lo:hi].T
                blk_rows.append(row)
                saabbs[k, 0] = bmin[lo:hi].min(axis=0)
                saabbs[k, 1] = bmax[lo:hi].max(axis=0)
            mesh_sup_aabbs.append(saabbs)
            mesh_block_base.append(blk_base)
            mesh_sup_base.append(sup_base)
            vtx_base += len(v)
            blk_base += nb
            sup_base += nsup

        vertices = np.concatenate(verts_p).astype(np.float32)
        uv_arr = np.concatenate(uvs_p).astype(np.float32)
        faces_arr = np.concatenate(faces_p).astype(np.int32)
        coeff = np.concatenate(coeff_l)

        # ---- instances + (instance, super) pairs ------------------------
        n_inst = len(inst_list)
        inst_fwd = np.zeros((n_inst, 12), np.float32)
        inst_inv = np.zeros((n_inst, 12), np.float32)
        inst_obj = np.zeros((n_inst,), np.int32)
        pair_rows, pair_aabb = [], []       # (inst, blk row, block base); world box
        for i, (mi, xf, obj_id) in enumerate(inst_list):
            inst_fwd[i, :9] = xf[:3, :3].reshape(-1)
            inst_fwd[i, 9:] = xf[:3, 3]
            inv = np.linalg.inv(xf)
            inst_inv[i, :9] = inv[:3, :3].reshape(-1)
            inst_inv[i, 9:] = inv[:3, 3]
            inst_obj[i] = obj_id
            for k in range(mesh_sup_aabbs[mi].shape[0]):
                lo, hi = mesh_sup_aabbs[mi][k]
                corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                                    for y in (lo[1], hi[1]) for z in (lo[2], hi[2])],
                                   np.float32)
                wc = _transform_points(xf, corners)
                # Block base in blocks: the kernel's cid = base + lane.
                pair_rows.append((i, mesh_sup_base[mi] + k, mesh_block_base[mi] + k * SUP))
                pair_aabb.append((wc.min(axis=0), wc.max(axis=0)))
        n_pairs = len(pair_rows)
        if n_pairs > SPAGES * 128:
            raise ValueError(
                f"{n_pairs} (instance, supercluster) pairs exceed the v8 "
                f"kernel's {SPAGES * 128}; split the scene")
        pp = max(1, -(-n_pairs // 128))
        pair_panel = np.zeros((pp, 8, 128), np.float32)
        pair_panel[:, 0:3, :] = 3.0e38
        pair_panel[:, 3:6, :] = -3.0e38
        pair_tab = np.zeros((pp * 128, 4), np.int32)
        pair_mesh_aabb = np.zeros((pp * 128, 6), np.float32)
        pair_mesh_aabb[:, 0:3] = 3.0e38
        pair_mesh_aabb[:, 3:6] = -3.0e38
        for p, ((i, bp, bb), (lo, hi)) in enumerate(zip(pair_rows, pair_aabb)):
            pair_panel[p // 128, 0:3, p % 128] = lo
            pair_panel[p // 128, 3:6, p % 128] = hi
            pair_tab[p] = (i, bp, bb, 1)
            mi = inst_list[i][0]
            k = bp - mesh_sup_base[mi]
            pair_mesh_aabb[p, 0:3] = mesh_sup_aabbs[mi][k, 0]
            pair_mesh_aabb[p, 3:6] = mesh_sup_aabbs[mi][k, 1]

        objs = _obj_leaves(obj_rows)
        ot = objs["obj_tex"]
        env = self._env_leaves(mip_textures)
        if mip_textures:
            env["face_uv_density"] = np.concatenate(dens_p).astype(np.float32)

        # Conservative alpha masks over the pools.  A pool face's opacity
        # map is its instances' material's; where the instances of one
        # mesh disagree, the mask must hold for all of them: all ones.
        amask = {}
        if len(self.textures) and any(int(ot[o, 3]) >= 0 for _, _, o in inst_list):
            from realtimeraytracer_torch.config import RenderConfig
            from realtimeraytracer_torch.ops.alpha_mask import (
                build_face_masks_np, pack_amask_np)

            per_mesh = [set() for _ in mesh_entries]
            for mi, _, obj_id in inst_list:
                per_mesh[mi].add(int(ot[obj_id, 3]))
            face_tex_parts = []
            for m, c in enumerate(coeff_l):
                texs = {t for t in per_mesh[m] if t >= 0}
                if not texs:
                    t_choice = -1                  # no opacity map: all ones
                elif len(texs) == 1 and all(t >= 0 for t in per_mesh[m]):
                    t_choice = texs.pop()
                else:
                    t_choice = -2                  # mixed: all ones
                face_tex_parts.append(np.full(c.shape[0] * CB, t_choice, np.int32))
            fmasks = build_face_masks_np(
                uv_arr[faces_arr[:, 0]], uv_arr[faces_arr[:, 1]],
                uv_arr[faces_arr[:, 2]], np.concatenate(face_tex_parts),
                env["tex_atlas"][..., 0], env["tex_size"], RenderConfig.alpha_threshold)
            amask = dict(pallas_amask=pack_amask_np(fmasks, coeff.shape[0]))

        return dict(
            vertices=vertices, normals=np.concatenate(norms_p).astype(np.float32),
            uvs=uv_arr, faces=faces_arr,
            face_obj=np.zeros(len(faces_arr), np.int32), **objs, **sph,
            **lights.leaves(), vert_obj=np.zeros(len(vertices), np.int32), **env,
            **_BVH_DUMMIES,
            pallas_panels=coeff, pallas_cl_min=np.concatenate(clmin_l),
            pallas_cl_max=np.concatenate(clmax_l), **amask,
            inst_inv=inst_inv, inst_fwd=inst_fwd, inst_obj=inst_obj,
            pair_panel=pair_panel, pair_tab=pair_tab,
            blk_panel=np.stack(blk_rows), pair_mesh_aabb=pair_mesh_aabb)
