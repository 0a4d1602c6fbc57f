"""Scene container and scene compilation (host scene -> TorchScene).

Counterpart of realtimeraytracer_tpu/scene/scene.py (``Scene``,
``Scene.compile`` on its non-instanced path, ``compile(bake_instances=True)``,
``_pack_textures``, ``load_ltc_tables``): collect lights then objects into
one world-space vertex/index pool (lights first, tlas.cppm:77-82), build
the object and light tables (texture ids included), pack the textures into
a padded atlas and its packed-neighbour twin, build the LBVH, the v7
coefficient panels and, for scenes of at most RESIDENT_CB blocks, the v9
repacked panels (ops/repack.py), the conservative alpha masks of both
panel sets (ops/alpha_mask.py), and attach the LTC LUTs.  The leaves equal
the JAX compile's when both use the NumPy BVH builder.

Not ported yet (ROADMAP queue A): the mip atlas, the shared-geometry
instanced compile (instanced scenes compile only with
bake_instances=True), and the native C++ BVH builder.  The opaque/alpha
panel split of the JAX compile belongs to ``alpha_split``, which is not
ported.
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
from realtimeraytracer_torch.scene.panels import RESIDENT_CB

ASSET_DIR = Path(__file__).resolve().parents[2] / "assets"


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
                quarter_panels: bool = True,
                bake_instances: bool = False) -> TorchScene:
        """Compile to a TorchScene on the CPU (``.to(device)`` moves it)."""
        return from_numpy_leaves(self.compile_leaves(
            bvh_leaf_size, bvh_threshold, quarter_panels, bake_instances))

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

    def compile_leaves(self, bvh_leaf_size: int = 4, bvh_threshold: int = 64,
                       quarter_panels: bool = True,
                       bake_instances: bool = False) -> dict[str, np.ndarray]:
        """The compiled leaves as NumPy arrays (TorchScene field names).
        Builds the LBVH and v7 panels when the soup exceeds bvh_threshold
        triangles, and the v9 repacked panels too unless quarter_panels is
        False (the JAX compile always builds them; a route that runs no v9
        trace skips the repack's host time).  Scenes with instances compile
        only with bake_instances=True, which expands every instance into a
        world-space copy (the JAX package's oracle for its instanced form)."""
        if self.instances:
            if not bake_instances:
                raise NotImplementedError(
                    "the shared-geometry compile of instanced scenes is not "
                    "ported yet (ROADMAP queue A, A4); compile with "
                    "bake_instances=True")
            return self._baked().compile_leaves(bvh_leaf_size, bvh_threshold,
                                                quarter_panels)
        verts, norms, uvs, faces, face_obj, vert_obj = [], [], [], [], [], []
        obj_rows: list[tuple] = []
        lt_v0, lt_v1, lt_v2, lt_col, lt_int, lt_two, lt_obj = \
            [], [], [], [], [], [], []
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
            f = light.mesh.faces
            lt_v0.append(v[f[:, 0]]); lt_v1.append(v[f[:, 1]]); lt_v2.append(v[f[:, 2]])
            lt_col.append(np.tile(np.asarray(light.color, np.float32), (len(f), 1)))
            lt_int.append(np.full(len(f), light.intensity, np.float32))
            lt_two.append(np.full(len(f), bool(light.two_sided)))
            lt_obj.append(np.full(len(f), obj_id, np.int32))

        for mesh in self.meshes:
            obj_id = len(obj_rows)
            obj_rows.append(_mat_row(mesh.material, is_light=0))
            push_mesh(mesh, obj_id, mesh.transform)

        sph_center, sph_radius, sph_obj = [], [], []
        for sph in self.spheres:
            obj_id = len(obj_rows)
            obj_rows.append(_mat_row(sph.material, is_light=0))
            sph_center.append(_transform_points(
                sph.transform, np.asarray([sph.center], np.float32))[0])
            sph_radius.append(np.float32(sph.radius))
            sph_obj.append(np.int32(obj_id))

        def cat(parts, empty_shape, dtype=np.float32):
            if parts:
                return np.concatenate(parts).astype(dtype)
            return np.zeros(empty_shape, dtype)

        vertices = cat(verts, (0, 3))
        normals = cat(norms, (0, 3))
        uv_arr = cat(uvs, (0, 2))
        faces_arr = cat(faces, (0, 3), np.int32)
        face_obj_arr = cat(face_obj, (0,), np.int32)
        vert_obj_arr = cat(vert_obj, (0,), np.int32)
        if len(faces_arr) == 0:
            # One degenerate triangle keeps every gather non-empty; it can
            # never hit (zero determinant).
            vertices = np.zeros((3, 3), np.float32)
            normals = np.tile(np.array([[0, 0, 1]], np.float32), (3, 1))
            uv_arr = np.zeros((3, 2), np.float32)
            faces_arr = np.array([[0, 1, 2]], np.int32)
            face_obj_arr = np.zeros(1, np.int32)
            vert_obj_arr = np.zeros(3, np.int32)

        if obj_rows:
            oc, osp, om, ol, ot = (np.stack([r[k] for r in obj_rows])
                                   for k in range(5))
        else:
            oc = np.zeros((1, 3), np.float32); osp = np.zeros(1, np.float32)
            om = np.zeros(1, np.float32); ol = np.zeros(1, np.int32)
            ot = -np.ones((1, 4), np.int32)

        n_lt = sum(len(x) for x in lt_v0)
        if n_lt:
            ltv0, ltv1, ltv2 = cat(lt_v0, (0, 3)), cat(lt_v1, (0, 3)), cat(lt_v2, (0, 3))
            ltc, lti = cat(lt_col, (0, 3)), cat(lt_int, (0,))
            ltt, lto = cat(lt_two, (0,), bool), cat(lt_obj, (0,), np.int32)
            ltvld = np.ones(n_lt, bool)
        else:
            # One invalid entry keeps shapes non-zero; it contributes 0.
            ltv0 = ltv1 = ltv2 = np.zeros((1, 3), np.float32)
            ltc = np.zeros((1, 3), np.float32); lti = np.zeros(1, np.float32)
            ltt = np.zeros(1, bool); ltvld = np.zeros(1, bool)
            lto = np.zeros(1, np.int32)

        sun = self.sun
        sun_dir = sun.normalized_direction() if sun else np.zeros(3, np.float32)
        sun_col = np.asarray(sun.color if sun else (0, 0, 0), np.float32)
        sun_int = np.float32(sun.intensity if sun else 0.0)
        hdri = np.ones((1, 1, 3), np.float32) if self.hdri is None else self.hdri
        ltc1, ltc2 = load_ltc_tables()

        atlas, tex_size = _pack_textures(self.textures)
        if len(self.textures):
            from realtimeraytracer_torch.ops.texture import pack_atlas_neighbors_np

            atlas_packed = pack_atlas_neighbors_np(atlas, tex_size)
        else:
            atlas_packed = np.zeros((0, 8, 8, 16), np.float32)

        if len(faces_arr) > bvh_threshold:
            from realtimeraytracer_torch.ops.bvh import build_bvh
            from realtimeraytracer_torch.scene.panels import pack_clusters_np

            bvh = build_bvh(vertices[faces_arr[:, 0]], vertices[faces_arr[:, 1]],
                            vertices[faces_arr[:, 2]], leaf_size=bvh_leaf_size)
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
        else:
            z3 = np.zeros((1, 3), np.float32)
            z1 = np.zeros(1, np.int32)
            bvh_fields = dict(
                bvh_node_min=z3, bvh_node_max=z3, bvh_node_skip=z1,
                bvh_node_first=z1, bvh_node_count=z1,
                bvh_tri_v0=z3, bvh_tri_v1=z3, bvh_tri_v2=z3, bvh_tri_id=z1)

        return dict(
            vertices=vertices, normals=normals, uvs=uv_arr,
            faces=faces_arr, face_obj=face_obj_arr,
            obj_color=oc, obj_specular=osp, obj_metallic=om,
            obj_is_light=ol, obj_tex=ot,
            sph_center=(np.stack(sph_center).astype(np.float32) if sph_center
                        else np.zeros((0, 3), np.float32)),
            sph_radius=np.asarray(sph_radius, np.float32),
            sph_obj=np.asarray(sph_obj, np.int32),
            lt_v0=ltv0, lt_v1=ltv1, lt_v2=ltv2, lt_color=ltc,
            lt_intensity=lti, lt_two_sided=ltt, lt_valid=ltvld, lt_obj=lto,
            vert_obj=vert_obj_arr,
            sun_direction=np.asarray(sun_dir, np.float32), sun_color=sun_col,
            sun_intensity=np.asarray(sun_int, np.float32),
            hdri=np.asarray(hdri, np.float32),
            env_color=np.asarray(self.env_color, np.float32),
            ltc1=ltc1, ltc2=ltc2, tex_atlas=atlas, tex_size=tex_size,
            tex_atlas_packed=atlas_packed, **bvh_fields)
