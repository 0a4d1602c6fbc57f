"""Built-in example scenes.

Counterpart of realtimeraytracer_tpu/scenes.py: ``sphere_plane``,
``cornell_box``, ``procedural_mesh``, ``make_sky_gradient`` and
``sky_sphere``, copied so that the same seed gives the same arrays.  The
textured and instanced scenes (``foliage_field``, ``textured_obj``) wait for
the texture, alpha and instancing work (ROADMAP queue A).
"""

from __future__ import annotations

import numpy as np

from realtimeraytracer_torch.scene.camera import Camera
from realtimeraytracer_torch.scene.geometry import (
    Material,
    Sphere,
    TriangleMesh,
    make_grid_plane,
)
from realtimeraytracer_torch.scene.lights import AreaLight, DirectionalLight
from realtimeraytracer_torch.scene.scene import Scene


def sphere_plane() -> Scene:
    """BASELINE config 1: sphere + plane, sun light, gradient-friendly."""
    scene = Scene(
        camera=Camera(position=(0.0, 1.2, 3.5), look_at=(0.0, 0.7, 0.0),
                      fov_y_degrees=50.0)
    )
    scene.add(
        Sphere(center=(0.0, 0.7, 0.0), radius=0.7,
               material=Material(color=(0.7, 0.25, 0.2), specular=0.4, metallic=0.1)),
        make_grid_plane(size=20.0, y=0.0,
                        material=Material(color=(0.6, 0.6, 0.6), specular=0.2)),
        DirectionalLight(direction=(-1.0, 1.0, -0.5), color=(1.0, 1.0, 0.5),
                         intensity=0.2),
    )
    return scene


def cornell_box(light_intensity: float = 2.0) -> Scene:
    """BASELINE config 2: classic Cornell box (~36 tris) with an area light."""
    white = Material(color=(0.73, 0.73, 0.73), specular=0.1)
    red = Material(color=(0.65, 0.05, 0.05), specular=0.1)
    green = Material(color=(0.12, 0.45, 0.15), specular=0.1)

    def quad(p0, p1, p2, p3, mat, name):
        """Two-triangle quad wound so the normal faces the box interior."""
        v = np.array([p0, p1, p2, p3], np.float32)
        f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
        normal = np.cross(v[1] - v[0], v[2] - v[0])
        toward_center = np.array([0.0, 1.0, 0.0], np.float32) - v.mean(0)
        if np.dot(normal, toward_center) < 0:
            f = f[:, ::-1].copy()
        return TriangleMesh(vertices=v, faces=f, material=mat, name=name)

    s = 1.0  # half box size
    scene = Scene(
        camera=Camera(position=(0.0, 1.0, 3.6), look_at=(0.0, 1.0, 0.0),
                      fov_y_degrees=45.0)
    )
    scene.add(
        quad((-s, 0, -s), (s, 0, -s), (s, 0, s), (-s, 0, s), white, "floor"),
        quad((-s, 2, -s), (-s, 2, s), (s, 2, s), (s, 2, -s), white, "ceiling"),
        quad((-s, 0, -s), (-s, 2, -s), (s, 2, -s), (s, 0, -s), white, "back"),
        quad((-s, 0, s), (-s, 2, s), (-s, 2, -s), (-s, 0, -s), red, "left"),
        quad((s, 0, -s), (s, 2, -s), (s, 2, s), (s, 0, s), green, "right"),
    )
    # Two boxes.
    scene.add(_box((-0.35, 0.0, -0.3), (0.25, 1.2, 0.25), 18.0, white, "tall"),
              _box((0.4, 0.0, 0.35), (0.25, 0.6, 0.25), -15.0, white, "short"))
    light = AreaLight(color=(1.0, 0.9, 0.8), intensity=light_intensity,
                      two_sided=False)
    # Unit quad faces +Z; rotate to face downward (-Y) and place near ceiling.
    light.rotate("x", 90.0).scale(0.8).move(0.0, 1.98, 0.0)
    scene.add(light)
    return scene


def _box(base, half, yaw_degrees, material, name):
    """An axis-aligned box (12 tris) rotated by yaw, sitting on y=base[1]."""
    hx, hy, hz = half
    v = np.array(
        [
            [-hx, 0, -hz], [hx, 0, -hz], [hx, 0, hz], [-hx, 0, hz],
            [-hx, 2 * hy, -hz], [hx, 2 * hy, -hz], [hx, 2 * hy, hz], [-hx, 2 * hy, hz],
        ],
        np.float32,
    )
    f = np.array(
        [
            [0, 2, 1], [0, 3, 2],          # bottom
            [4, 5, 6], [4, 6, 7],          # top
            [0, 1, 5], [0, 5, 4],          # -z
            [2, 3, 7], [2, 7, 6],          # +z
            [1, 2, 6], [1, 6, 5],          # +x
            [3, 0, 4], [3, 4, 7],          # -x
        ],
        np.int32,
    )
    # Wind every face so its normal points away from the box centroid.
    centroid = v.mean(0)
    for i, tri in enumerate(f):
        n = np.cross(v[tri[1]] - v[tri[0]], v[tri[2]] - v[tri[0]])
        if np.dot(n, v[tri].mean(0) - centroid) < 0:
            f[i] = tri[::-1]
    mesh = TriangleMesh(vertices=v, faces=f, material=material, name=name)
    mesh.rotate("y", yaw_degrees).move(*base)
    return mesh


def procedural_mesh(num_tris: int = 10_000, seed: int = 0,
                    sun: bool = True) -> Scene:
    """BASELINE configs 3/4: a k-triangle procedural "rock field".

    Deterministic given (num_tris, seed): random triangles clustered into
    blobs over a ground plane — enough geometric incoherence to exercise the
    BVH the way a scanned OBJ would.
    """
    rng = np.random.default_rng(seed)
    n_blobs = max(1, num_tris // 64)
    centers = rng.uniform([-8, 0.2, -8], [8, 3.0, 8], (n_blobs, 3))
    tri_blob = rng.integers(0, n_blobs, num_tris)
    base = centers[tri_blob]
    scale = rng.uniform(0.05, 0.35, (num_tris, 1, 1))
    tris = base[:, None, :] + rng.normal(0, 1, (num_tris, 3, 3)) * scale
    verts = tris.reshape(-1, 3).astype(np.float32)
    faces = np.arange(num_tris * 3, dtype=np.int32).reshape(-1, 3)
    mesh = TriangleMesh(
        vertices=verts, faces=faces,
        material=Material(color=(0.55, 0.5, 0.45), specular=0.3, metallic=0.05),
        name=f"rocks_{num_tris}",
    )
    scene = Scene(
        camera=Camera(position=(0.0, 4.0, 14.0), look_at=(0.0, 1.0, 0.0),
                      fov_y_degrees=55.0)
    )
    scene.add(mesh, make_grid_plane(size=40.0, y=0.0,
                                    material=Material(color=(0.5, 0.5, 0.55))))
    light = AreaLight(color=(1.0, 0.95, 0.9), intensity=6.0)
    light.rotate("x", 90.0).scale(4.0).move(0.0, 8.0, 0.0)
    scene.add(light)
    if sun:
        scene.add(DirectionalLight())
    return scene


def make_sky_gradient(height: int = 64, width: int = 128,
                      sun_dir=(0.3, 0.8, 0.5)) -> np.ndarray:
    """Synthetic sRGB-encoded equirect sky: horizon-to-zenith gradient with
    a warm sun disk — a stand-in for the reference's sky4k.hdr (not shipped
    in its repo, SURVEY.md appendix).  Same storage contract as load_hdr
    (row 0 = bottom, v = 1 - acos(y)/pi points up)."""
    v = (np.arange(height, dtype=np.float32) + 0.5) / height      # 0=down
    u = (np.arange(width, dtype=np.float32) + 0.5) / width
    theta = (1.0 - v) * np.pi                                      # from +y
    phi = (u - 0.5) * 2.0 * np.pi
    y = np.cos(theta)[:, None] * np.ones((1, width), np.float32)
    x = np.sin(theta)[:, None] * np.cos(phi)[None, :]
    z = np.sin(theta)[:, None] * np.sin(phi)[None, :]
    horizon = np.array([0.85, 0.85, 0.95], np.float32)
    zenith = np.array([0.25, 0.45, 0.9], np.float32)
    tt = np.clip(y, 0.0, 1.0)[..., None]
    sky = horizon * (1 - tt) + zenith * tt
    ground = np.array([0.35, 0.3, 0.25], np.float32)
    sky = np.where(y[..., None] < 0.0, ground, sky)
    s = np.asarray(sun_dir, np.float32)
    s = s / np.linalg.norm(s)
    cosang = x * s[0] + y * s[1] + z * s[2]
    disk = np.clip((cosang - 0.995) / 0.005, 0.0, 1.0)[..., None]
    sun = np.array([1.0, 0.95, 0.8], np.float32)
    return np.clip(sky * (1 - disk) + sun * disk, 0.0, 1.0).astype(np.float32)


def sky_sphere() -> Scene:
    """Sphere + plane under a full HDRI environment (miss.rmiss parity):
    the reference's signature visual is its equirect sky on primary-ray
    miss (application.cppm:250, miss.rmiss:21-26)."""
    scene = sphere_plane()
    scene.hdri = make_sky_gradient()
    scene.env_color = (1.0, 1.0, 1.0)
    return scene
