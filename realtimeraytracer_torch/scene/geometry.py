"""Host-side geometry: triangle meshes and analytic spheres.

Copy of realtimeraytracer_tpu/scene/geometry.py (host NumPy, unchanged): the JAX
package cannot be imported without jax, so the port carries its own.

Parity targets: scene::Object's renderable mesh with a 3x4 transform and
move/scale/rotate ops (scene/object.cppm:158-195), the built-in "square"
unit quad used for default lights (app/setup/geometry_builder.cppm:82-90),
and scene::Sphere {center, radius, material} (scene/sphere.cppm:8-42) which
the reference left orphaned but BASELINE.json promotes to a first-class
analytic primitive.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from realtimeraytracer_torch.scene.materials import Material


def _identity() -> np.ndarray:
    return np.eye(4, dtype=np.float32)


@dataclasses.dataclass
class Transformable:
    transform: np.ndarray = dataclasses.field(default_factory=_identity)

    def move(self, x: float, y: float, z: float):
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = (x, y, z)
        self.transform = t @ self.transform
        return self

    def scale(self, x: float, y: float = None, z: float = None):
        y = x if y is None else y
        z = x if z is None else z
        s = np.diag(np.array([x, y, z, 1.0], np.float32))
        self.transform = s @ self.transform
        return self

    def rotate(self, axis: str, degrees: float):
        a = math.radians(degrees)
        c, s = math.cos(a), math.sin(a)
        r = np.eye(4, dtype=np.float32)
        i = {"x": 0, "y": 1, "z": 2}[axis]
        j, k = (i + 1) % 3, (i + 2) % 3
        r[j, j], r[j, k], r[k, j], r[k, k] = c, -s, s, c
        self.transform = r @ self.transform
        return self


@dataclasses.dataclass
class TriangleMesh(Transformable):
    """An indexed triangle mesh with optional per-vertex normals and uvs."""

    vertices: np.ndarray = None   # (V, 3) f32
    faces: np.ndarray = None      # (F, 3) i32
    normals: np.ndarray = None    # (V, 3) f32 or None -> face normals
    uvs: np.ndarray = None        # (V, 2) f32 or None -> zeros
    material: Material = dataclasses.field(default_factory=Material)
    name: str = ""

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, np.float32)
        self.faces = np.asarray(self.faces, np.int32)
        if self.normals is None:
            self.normals = compute_vertex_normals(self.vertices, self.faces)
        else:
            self.normals = np.asarray(self.normals, np.float32)
        if self.uvs is None:
            self.uvs = np.zeros((len(self.vertices), 2), np.float32)
        else:
            self.uvs = np.asarray(self.uvs, np.float32)


@dataclasses.dataclass
class MeshInstance(Transformable):
    """One placement of a SHARED TriangleMesh (BLAS-instancing parity:
    geometry_builder.cppm:178-198 builds one BLAS per unique mesh and
    tlas.cppm:60-67 instances it with per-instance transforms + custom
    index).  Instances of the same mesh object share geometry, BVH order
    and traversal panels at compile — N instances cost ~1x mesh memory.

    material=None inherits the mesh's material; a non-None material gives
    this instance its own object-table row (the reference's per-instance
    ObjectInfo)."""

    mesh: TriangleMesh = None
    material: Material | None = None
    name: str = ""


@dataclasses.dataclass
class Sphere(Transformable):
    center: tuple[float, float, float] = (0.0, 0.0, 0.0)
    radius: float = 1.0
    material: Material = dataclasses.field(default_factory=Material)
    name: str = ""


def compute_vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (for OBJ files without vn records)."""
    v0, v1, v2 = (vertices[faces[:, i]] for i in range(3))
    fn = np.cross(v1 - v0, v2 - v0)
    out = np.zeros_like(vertices)
    for i in range(3):
        np.add.at(out, faces[:, i], fn)
    n = np.linalg.norm(out, axis=1, keepdims=True)
    return (out / np.maximum(n, 1e-20)).astype(np.float32)


def unit_quad() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The built-in "square": a unit quad in the XY plane, 2 triangles.

    Matches the default light geometry the reference builds in
    geometry_builder.cppm:82-90 (corners at +-0.5, facing +Z).
    """
    verts = np.array(
        [[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [0.5, 0.5, 0.0], [-0.5, 0.5, 0.0]],
        np.float32,
    )
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    normals = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (4, 1))
    uvs = verts[:, :2] + 0.5
    return verts, faces, normals, uvs


def make_quad_mesh(material: Material | None = None, name: str = "square") -> TriangleMesh:
    v, f, n, uv = unit_quad()
    return TriangleMesh(vertices=v, faces=f, normals=n, uvs=uv,
                        material=material or Material(), name=name)


def make_grid_plane(size: float = 10.0, y: float = 0.0,
                    material: Material | None = None) -> TriangleMesh:
    """A ground plane (two triangles) in the XZ plane at height y."""
    s = size * 0.5
    v = np.array([[-s, y, -s], [s, y, -s], [s, y, s], [-s, y, s]], np.float32)
    f = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    n = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (4, 1))
    uv = (v[:, [0, 2]] / size) + 0.5
    return TriangleMesh(vertices=v, faces=f, normals=n, uvs=uv,
                        material=material or Material(), name="plane")
