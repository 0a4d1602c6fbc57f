"""Built-in example scenes.

Counterpart of realtimeraytracer_tpu/scenes.py: ``sphere_plane``,
``cornell_box``, ``procedural_mesh``, ``make_sky_gradient``, ``sky_sphere``
and the two textured, alpha-tested flagships ``textured_obj`` (through the
OBJ + MTL + PNG + Radiance-HDR loaders) and ``foliage_field`` (instanced
foliage: ``Scene.compile()`` gives its shared-geometry form, which only the
v8 kernel's instanced level traces; ``compile(bake_instances=True)`` its
world-space copies), copied so that the same seed gives the same arrays.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from realtimeraytracer_torch.scene.camera import Camera
from realtimeraytracer_torch.scene.geometry import (
    Material,
    Sphere,
    TriangleMesh,
    make_grid_plane,
)
from realtimeraytracer_torch.scene.lights import AreaLight, DirectionalLight
from realtimeraytracer_torch.scene.obj_loader import (
    encode_radiance_hdr, load_hdr, load_obj_scene)
from realtimeraytracer_torch.scene.scene import Scene
from realtimeraytracer_torch.utils.image_io import write_png


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


def foliage_field(target_tris: int = 120_000, seed: int = 9) -> Scene:
    """Reference-shaped flagship: >=100k textured triangles with
    alpha-tested instanced foliage over a textured terrain.

    The reference's shipped workload is the Bistro exterior — a
    multi-100k-tri OBJ with dozens of textures and dense alpha foliage
    (src/app/application.cppm:226-250); its assets are external
    (SURVEY.md appendix), so this composes the same asset classes
    procedurally: a heightfield terrain with color+specular maps,
    textured building prisms, and three instanced plant meshes
    (trunk prisms + alpha-cutout crossed leaf cards) — every asset class
    (textures, mips, aniso, alpha any-hit, instancing, HDRI, area
    lights, sun) in ONE scene at reference scale.  `target_tris` counts
    EFFECTIVE triangles (instances x mesh size).  ``compile()`` gives the
    shared-geometry form (at the default size 2,580 instances and 2,584
    (instance, super) pairs over a 72-block mesh pool);
    ``compile(bake_instances=True)`` the world-space copies.  At
    target_tris=8_000 the terrain alone meets the target and no plant is
    placed (12_000 places 83 instances).
    """
    rng = np.random.default_rng(seed)
    scene = Scene(camera=Camera(position=(0.0, 9.0, 26.0),
                                look_at=(0.0, 1.5, 0.0),
                                fov_y_degrees=55))

    # --- textures --------------------------------------------------------
    n = 64
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    checker = ((xx // 8 + yy // 8) % 2).astype(np.float32)
    noise = rng.random((n, n)).astype(np.float32)
    ground_kd = np.stack([0.18 + 0.25 * checker + 0.1 * noise,
                          0.22 + 0.30 * checker + 0.1 * noise,
                          0.12 + 0.10 * checker], axis=-1)
    t_ground = scene.add_texture(np.clip(ground_kd, 0, 1))
    t_gloss = scene.add_texture(
        np.clip(0.1 + 0.8 * (xx / (n - 1.0)), 0, 1).astype(np.float32))
    # Leaf cutout: one ragged central frond with WIDE fully-transparent
    # margins — the shape real foliage atlases have (one leaf cluster per
    # card, Bistro-style), and the shape that makes in-kernel alpha masks
    # effective: margin cells are definitely-transparent, so traversal
    # rejects those hits without any texture fetch or re-trace round.
    dyy = (yy - 34.0) / 22.0
    dxx = (xx - 32.0) / 16.0
    body = dxx * dxx + dyy * dyy + 0.25 * rng.random((n, n))
    stem = (np.abs(xx - 32) < 2.0) & (yy > 30)
    leaf_a = ((body < 1.0) | stem).astype(np.float32)
    t_leaf_a = scene.add_texture(leaf_a)
    leaf_kd = np.stack([0.08 + 0.10 * checker,
                        0.30 + 0.30 * (1 - checker) + 0.15 * noise,
                        0.06 + 0.04 * checker], axis=-1)
    t_leaf_kd = scene.add_texture(np.clip(leaf_kd, 0, 1))
    bark = np.stack([0.30 + 0.12 * noise, 0.20 + 0.08 * noise,
                     0.12 + 0.04 * noise], axis=-1)
    t_bark = scene.add_texture(np.clip(bark, 0, 1))
    brick = np.stack([0.45 + 0.3 * checker, 0.30 + 0.12 * checker,
                      0.25 + 0.05 * checker], axis=-1)
    t_brick = scene.add_texture(np.clip(brick, 0, 1))

    m_ground = Material(color=(1, 1, 1), specular=0.4,
                        color_map=t_ground, specular_map=t_gloss)
    m_leaf = Material(color=(1, 1, 1), specular=0.15,
                      color_map=t_leaf_kd, opacity_map=t_leaf_a)
    m_bark = Material(color=(1, 1, 1), specular=0.25, color_map=t_bark)
    m_brick = Material(color=(1, 1, 1), specular=0.5, color_map=t_brick)

    # --- terrain heightfield (one mesh) ----------------------------------
    S, NG = 30.0, 64
    gx = np.linspace(-S, S, NG + 1, dtype=np.float32)
    gz = np.linspace(-S, S, NG + 1, dtype=np.float32)
    gzz, gxx = np.meshgrid(gz, gx, indexing="ij")
    h = (0.35 * np.sin(gxx * 0.35) * np.cos(gzz * 0.3)
         + 0.15 * np.sin(gxx * 1.1 + 2.0)).astype(np.float32)
    tv = np.stack([gxx, h, gzz], axis=-1).reshape(-1, 3)
    tuv = np.stack([(gxx + S) / (2 * S) * 16.0,
                    (gzz + S) / (2 * S) * 16.0], axis=-1).reshape(-1, 2)
    idx = np.arange((NG + 1) * (NG + 1)).reshape(NG + 1, NG + 1)
    a, b = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()
    c, d = idx[1:, 1:].ravel(), idx[1:, :-1].ravel()
    tf = np.concatenate([np.stack([a, b, c], axis=1),
                         np.stack([a, c, d], axis=1)]).astype(np.int32)
    terrain = TriangleMesh(vertices=tv, faces=tf,
                           uvs=tuv.astype(np.float32), material=m_ground)
    scene.add(terrain)
    n_eff = len(tf)

    # --- building prisms (one mesh) --------------------------------------
    def prism_arrays(x0, z0, x1, z1, y0, h):
        v = np.array([[x0, y0, z0], [x1, y0, z0], [x1, y0 + h, z0],
                      [x0, y0 + h, z0], [x0, y0, z1], [x1, y0, z1],
                      [x1, y0 + h, z1], [x0, y0 + h, z1]], np.float32)
        f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
                      [0, 4, 7], [0, 7, 3], [1, 2, 6], [1, 6, 5],
                      [3, 7, 6], [3, 6, 2]], np.int32)
        uv = np.array([[0, 0], [2, 0], [2, 2], [0, 2],
                       [0, 0], [2, 0], [2, 2], [0, 2]], np.float32)
        return v, f, uv

    bv, bf, buv = [], [], []
    base = 0
    for _ in range(14):
        x0 = float(rng.uniform(-S + 3, S - 6))
        z0 = float(rng.uniform(-S + 3, -6.0))
        w, dpt = float(rng.uniform(1.5, 4.0)), float(rng.uniform(1.5, 4.0))
        v, f, uv = prism_arrays(x0, z0, x0 + w, z0 + dpt, -0.5,
                                float(rng.uniform(2.5, 7.0)))
        bv.append(v); bf.append(f + base); buv.append(uv)
        base += len(v)
    buildings = TriangleMesh(
        vertices=np.concatenate(bv), faces=np.concatenate(bf),
        uvs=np.concatenate(buv), material=m_brick)
    scene.add(buildings)
    n_eff += sum(len(f) for f in bf)

    # --- plant meshes (instanced) ----------------------------------------
    def card_stack(num_cards, w, h0, h1, rng):
        """Crossed alpha cards around a vertical axis."""
        v, f, uv = [], [], []
        for k in range(num_cards):
            ang = rng.uniform(0, np.pi)
            y0 = rng.uniform(h0, h1 - 0.5)
            hh = rng.uniform(0.6, 1.4)
            dx, dz = np.cos(ang) * w, np.sin(ang) * w
            ox, oz = rng.uniform(-0.5, 0.5), rng.uniform(-0.5, 0.5)
            b = len(v)
            v += [[ox - dx, y0, oz - dz], [ox + dx, y0, oz + dz],
                  [ox + dx, y0 + hh, oz + dz], [ox - dx, y0 + hh, oz - dz]]
            f += [[b, b + 1, b + 2], [b, b + 2, b + 3]]
            uv += [[0, 0], [1, 0], [1, 1], [0, 1]]
        return (np.asarray(v, np.float32), np.asarray(f, np.int32),
                np.asarray(uv, np.float32))

    rng_t = np.random.default_rng(seed + 1)
    # Tree: trunk prism + 56 leaf cards = 122 tris.
    tkv, tkf, tkuv = prism_arrays(-0.18, -0.18, 0.18, 0.18, 0.0, 2.2)
    trunk = TriangleMesh(vertices=tkv, faces=tkf, uvs=tkuv,
                         material=m_bark)
    lv, lf, luv = card_stack(56, 1.4, 1.6, 4.2, rng_t)
    tree_leaves = TriangleMesh(vertices=lv, faces=lf, uvs=luv,
                               material=m_leaf)
    bush_v, bush_f, bush_uv = card_stack(14, 0.9, 0.0, 1.3, rng_t)
    bush = TriangleMesh(vertices=bush_v, faces=bush_f, uvs=bush_uv,
                        material=m_leaf)
    grass_v, grass_f, grass_uv = card_stack(22, 0.5, 0.0, 0.7, rng_t)
    grass = TriangleMesh(vertices=grass_v, faces=grass_f, uvs=grass_uv,
                         material=m_leaf)

    def place(k, sc_lo, sc_hi):
        ts = []
        for _ in range(k):
            x = float(rng.uniform(-S + 2, S - 2))
            z = float(rng.uniform(-S + 2, S - 2))
            y = float(0.35 * np.sin(x * 0.35) * np.cos(z * 0.3)
                      + 0.15 * np.sin(x * 1.1 + 2.0))
            s = float(rng.uniform(sc_lo, sc_hi))
            ang = float(rng.uniform(0, 2 * np.pi))
            ca, sa = np.cos(ang), np.sin(ang)
            t = np.array([[s * ca, 0, s * sa, x],
                          [0, s, 0, y],
                          [-s * sa, 0, s * ca, z],
                          [0, 0, 0, 1]], np.float32)
            ts.append(t)
        return ts

    # Instance counts scaled to the triangle target.
    per_tree = len(tkf) + len(lf)
    per_bush = len(bush_f)
    per_grass = len(grass_f)
    remaining = max(target_tris - n_eff, 0)
    n_tree = int(remaining * 0.45 / per_tree)
    n_bush = int(remaining * 0.25 / per_bush)
    n_grass = int(remaining * 0.30 / per_grass)
    tree_t = place(n_tree, 0.7, 1.5)
    scene.add_instances(trunk, tree_t)
    scene.add_instances(tree_leaves, tree_t)
    scene.add_instances(bush, place(n_bush, 0.6, 1.3))
    scene.add_instances(grass, place(n_grass, 0.5, 1.1))
    n_eff += (n_tree * per_tree + n_bush * per_bush + n_grass * per_grass)
    scene.effective_tris = n_eff

    # --- sky + lights -----------------------------------------------------
    scene.hdri = make_sky_gradient(64, 128)
    scene.env_color = (1.0, 1.0, 1.0)
    warm = AreaLight(color=(1.0, 0.85, 0.6), intensity=6.0)
    warm.rotate("x", 90).scale(3.0).move(-4.0, 10.0, 8.0)
    cool = AreaLight(color=(0.6, 0.75, 1.0), intensity=4.0)
    cool.rotate("x", 110).scale(2.2).move(6.0, 9.0, -4.0)
    sun = DirectionalLight(direction=(0.35, 0.8, 0.45),
                           color=(1.0, 0.95, 0.85), intensity=0.7)
    scene.add(warm, cool, sun)
    return scene


def textured_obj(cache_dir: str | None = None) -> Scene:
    """Flagship textured-PBR scene through the FULL asset pipeline.

    The reference's shipped workload is a textured OBJ+MTL scene — color/
    specular/metallic/opacity maps (create_scene.cppm:75-136), alpha-tested
    foliage (opacity.rahit:55-61) and an HDRI sky (application.cppm:226-250).
    This builds the same composition end-to-end through the port's loaders:
    it writes an OBJ + MTL + PNG textures + a Radiance-RGBE .hdr to disk,
    then loads them back via load_obj_scene (OBJ parser, MTL resolution,
    texture dedup, the port's PNG codec) and load_hdr (RGBE decode).

    Contents: checker+gloss ground, two alpha-cutout foliage panels, a
    metallic-gradient pillar, a painted box, two area lights and the sun.
    Deterministic; writes its fixture files into cache_dir, or into a
    temporary directory that is removed once the scene has loaded them.
    """
    if cache_dir is None:
        with tempfile.TemporaryDirectory(prefix="rtrt_textured_obj_") as d:
            return textured_obj(d)
    d = cache_dir
    os.makedirs(d, exist_ok=True)

    # --- textures --------------------------------------------------------
    n = 64
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    checker = ((xx // 8 + yy // 8) % 2).astype(np.float32)
    ground_kd = np.stack([0.25 + 0.55 * checker,
                          0.22 + 0.40 * checker,
                          0.20 + 0.25 * checker], axis=-1)
    write_png(os.path.join(d, "ground_kd.png"), ground_kd)
    gloss = np.clip(xx / (n - 1.0), 0.05, 0.95).astype(np.float32)
    write_png(os.path.join(d, "ground_ks.png"),
              np.repeat(gloss[..., None], 3, axis=-1))

    leaf = np.zeros((n, n, 3), np.float32)
    leaf[..., 1] = 0.45 + 0.25 * checker
    leaf[..., 0] = 0.10 + 0.08 * checker
    leaf[..., 2] = 0.08
    write_png(os.path.join(d, "leaf_kd.png"), leaf)
    # Opacity cutouts: a grid of discs (alpha 1 inside, 0 outside).
    cy = (yy % 16) - 8.0
    cx = (xx % 16) - 8.0
    disc = ((cx * cx + cy * cy) < 36.0).astype(np.float32)
    write_png(os.path.join(d, "leaf_d.png"),
              np.repeat(disc[..., None], 3, axis=-1))

    metal_pm = np.clip(yy / (n - 1.0), 0.0, 1.0).astype(np.float32)
    write_png(os.path.join(d, "pillar_pm.png"),
              np.repeat(metal_pm[..., None], 3, axis=-1))

    sky = make_sky_gradient(64, 128)
    with open(os.path.join(d, "sky.hdr"), "wb") as f:
        f.write(encode_radiance_hdr(sky))

    # --- geometry (OBJ) --------------------------------------------------
    def quad(vs, lines, vt_ok=True):
        base = quad.v
        for p in vs:
            lines.append(f"v {p[0]} {p[1]} {p[2]}")
        if vt_ok:
            for t in [(0, 0), (1, 0), (1, 1), (0, 1)]:
                lines.append(f"vt {t[0]} {t[1]}")
        bt = quad.vt
        lines.append(f"f {base+1}/{bt+1} {base+3}/{bt+3} {base+2}/{bt+2}")
        lines.append(f"f {base+1}/{bt+1} {base+4}/{bt+4} {base+3}/{bt+3}")
        quad.v += 4
        quad.vt += 4

    quad.v = 0
    quad.vt = 0
    L = ["mtllib scene.mtl", "o ground", "usemtl ground"]
    # Tessellated ground: 24x24 cells, per-cell 0..1 UVs (tiling checker)
    # — puts the scene well past the BVH threshold so the flagship frame
    # runs the production hier/quarter kernels, not brute force.
    S = 14.0
    NG = 24
    step = 2 * S / NG
    for gi in range(NG):
        for gj in range(NG):
            x0 = -S + gi * step
            z0 = -S + gj * step
            quad([(x0, 0, z0), (x0, 0, z0 + step),
                  (x0 + step, 0, z0 + step), (x0 + step, 0, z0)], L)
    L.append("o foliage")
    L.append("usemtl leaf")
    # A 6x6 stand of two-sided crossed alpha cards.
    rngf = np.random.default_rng(5)
    for fi in range(6):
        for fj in range(6):
            cx = -9.0 + fi * 2.6 + float(rngf.uniform(-0.5, 0.5))
            cz = -9.0 + fj * 2.6 + float(rngf.uniform(-0.5, 0.5))
            hgt = float(rngf.uniform(1.6, 2.8))
            w2 = 0.9
            # Single-winding cards: duplicating both windings makes
            # coincident coplanar triangles whose closest-hit TIES
            # resolve differently per backend (normal flips) — the
            # golden-vs-oracle killer.  One-sided shading darkens the
            # back side, which is fine for cutout cards.
            for card in ([(cx - w2, 0, cz - w2), (cx + w2, 0, cz + w2),
                          (cx + w2, hgt, cz + w2), (cx - w2, hgt, cz - w2)],
                         [(cx - w2, 0, cz + w2), (cx + w2, 0, cz - w2),
                          (cx + w2, hgt, cz - w2), (cx - w2, hgt, cz + w2)]):
                quad(card, L)
    L.append("o pillar")
    L.append("usemtl metal")

    def prism(x0, z0, x1, z1, h, lines):
        for (p, q, r, t) in [
            ((x1, 0, z0), (x1, h, z0), (x0, h, z0), (x0, 0, z0)),
            ((x0, 0, z1), (x0, h, z1), (x1, h, z1), (x1, 0, z1)),
            ((x0, 0, z0), (x0, h, z0), (x0, h, z1), (x0, 0, z1)),
            ((x1, 0, z1), (x1, h, z1), (x1, h, z0), (x1, 0, z0)),
            ((x0, h, z0), (x1, h, z0), (x1, h, z1), (x0, h, z1)),
        ]:
            quad([p, q, r, t], lines)

    for pi in range(3):
        for pj in range(3):
            px = 2.0 + pi * 3.4
            pz = -5.0 + pj * 4.2
            prism(px, pz, px + 1.1, pz + 1.1, 3.0 + 0.8 * ((pi + pj) % 3), L)
    L.append("o box")
    L.append("usemtl paint")
    for bi in range(6):
        bx = -6.5 + bi * 2.3
        bz = 4.0 + (bi % 2) * 1.6
        prism(bx, bz, bx + 1.3, bz + 1.3, 0.9 + 0.25 * (bi % 3), L)
    with open(os.path.join(d, "scene.obj"), "w") as f:
        f.write("\n".join(L) + "\n")

    M = """newmtl ground
Kd 1.0 1.0 1.0
Ks 0.5 0.5 0.5
map_Kd ground_kd.png
map_Ks ground_ks.png

newmtl leaf
Kd 1.0 1.0 1.0
Ks 0.15 0.15 0.15
map_Kd leaf_kd.png
map_d leaf_d.png

newmtl metal
Kd 0.7 0.72 0.75
Ks 0.9 0.9 0.9
metallic 0.35
map_Pm pillar_pm.png

newmtl paint
Kd 0.75 0.15 0.1
Ks 0.65 0.65 0.65
"""
    with open(os.path.join(d, "scene.mtl"), "w") as f:
        f.write(M)

    # --- scene -----------------------------------------------------------
    scene = Scene(camera=Camera(position=(6.5, 4.0, 8.5),
                                look_at=(0.0, 1.2, 0.0),
                                fov_y_degrees=50))
    load_obj_scene(scene, os.path.join(d, "scene.obj"))
    scene.hdri = load_hdr(os.path.join(d, "sky.hdr"))
    scene.env_color = (1.0, 1.0, 1.0)

    warm = AreaLight(color=(1.0, 0.85, 0.6), intensity=5.0)
    warm.rotate("x", 90).scale(2.0).move(-2.0, 6.0, 4.0)
    cool = AreaLight(color=(0.6, 0.75, 1.0), intensity=3.5)
    cool.rotate("x", 115).scale(1.5).move(4.0, 5.0, -3.0)
    sun = DirectionalLight(direction=(0.35, 0.8, 0.45), color=(1.0, 0.95, 0.85),
                           intensity=0.6)
    scene.add(warm, cool, sun)
    return scene
