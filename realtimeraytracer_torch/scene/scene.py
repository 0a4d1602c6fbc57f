"""Scene container and scene compilation (host scene -> TorchScene).

Counterpart of realtimeraytracer_tpu/scene/scene.py (``Scene``,
``Scene.compile`` on its non-instanced path, ``load_ltc_tables``): collect
lights then objects into one world-space vertex/index pool (lights first,
tlas.cppm:77-82), build the object and light tables, the LBVH, the v7 coefficient panels
and, for scenes of at most RESIDENT_CB blocks, the v9 repacked panels
(ops/repack.py), and attach the LTC LUTs.  The leaves equal the JAX
compile's when both use the NumPy BVH builder.

Not ported yet (ROADMAP queue A): textures and mips, alpha masks,
instancing (the JAX shared-geometry compile) and the native C++ BVH
builder.  Scenes that need them raise.
"""

from __future__ import annotations

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


def _mat_row(mat: Material, is_light: int, color=None):
    maps = (mat.color_map, mat.specular_map, mat.metallic_map, mat.opacity_map)
    if any(m is not None for m in maps):
        raise NotImplementedError(
            "texture maps are not ported yet (ROADMAP queue A)")
    c = color if color is not None else mat.color
    return (np.asarray(c, np.float32), np.float32(mat.specular),
            np.float32(mat.metallic), np.int32(is_light),
            np.full(4, -1, np.int32))


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

    def compile(self, bvh_leaf_size: int = 4, bvh_threshold: int = 64,
                quarter_panels: bool = True) -> TorchScene:
        """Compile to a TorchScene on the CPU (``.to(device)`` moves it)."""
        return from_numpy_leaves(self.compile_leaves(
            bvh_leaf_size, bvh_threshold, quarter_panels))

    def compile_leaves(self, bvh_leaf_size: int = 4, bvh_threshold: int = 64,
                       quarter_panels: bool = True) -> dict[str, np.ndarray]:
        """The compiled leaves as NumPy arrays (TorchScene field names).
        Builds the LBVH and v7 panels when the soup exceeds bvh_threshold
        triangles, and the v9 repacked panels too unless quarter_panels is
        False (the JAX compile always builds them; a route that runs no v9
        trace skips the repack's host time)."""
        if self.instances:
            raise NotImplementedError(
                "instanced scenes are not ported yet (ROADMAP queue A)")
        if self.textures:
            raise NotImplementedError(
                "textured scenes are not ported yet (ROADMAP queue A)")
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
            if quarter_panels and panels.shape[0] <= RESIDENT_CB:
                from realtimeraytracer_torch.ops.repack import build_q_panels_np

                qp, q_lo, q_hi, q_off, _ = build_q_panels_np(
                    bvh.tri_v0, bvh.tri_v1, bvh.tri_v2)
                if qp.shape[0] <= RESIDENT_CB:
                    bvh_fields.update(q_panels=qp, q_cl_min=q_lo,
                                      q_cl_max=q_hi, q_group_off=q_off)
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
            ltc1=ltc1, ltc2=ltc2, **bvh_fields)
