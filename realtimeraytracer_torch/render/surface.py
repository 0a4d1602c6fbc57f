"""Surface resolution: HitRecord -> interpolated shading attributes.

Counterpart of realtimeraytracer_tpu/render/surface.py::resolve_surface
(the closest-hit shader, closesthit.rchit) for triangles and analytic
spheres: light-hit detection by object row, barycentric interpolation of
position, normal and uv (barycentrics recomputed from the winning
triangle), materials from the object table with their color, specular and
metallic maps sampled bilinearly from the packed atlas at the hit's uv
(one gather per map), sRGB decode and roughness = 1 - specular.  The
instance-transform and mip branches are not ported yet (ROADMAP A4, A1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from realtimeraytracer_torch.ops.intersect import HitRecord, ray_triangle
from realtimeraytracer_torch.ops.texture import sample_atlas_packed
from realtimeraytracer_torch.ops.tonemap import srgb_to_linear
from realtimeraytracer_torch.ops.vecmath import normalize
from realtimeraytracer_torch.scene.gpu_scene import TorchScene


class Surface(NamedTuple):
    """Per-ray shading inputs (all leading dim R)."""

    valid: torch.Tensor       # bool: true surface hit (not miss, not light)
    hit_light: torch.Tensor   # bool
    missed: torch.Tensor      # bool
    position: torch.Tensor    # (R, 3)
    normal: torch.Tensor      # (R, 3) unit
    uv: torch.Tensor          # (R, 2)
    albedo: torch.Tensor      # (R, 3) linear
    roughness: torch.Tensor   # (R,)
    metallic: torch.Tensor    # (R,)
    light_color: torch.Tensor  # (R, 3)
    obj_id: torch.Tensor      # (R,)


def resolve_surface(gpu: TorchScene, hit: HitRecord, origins: torch.Tensor,
                    dirs: torch.Tensor) -> Surface:
    num_tris = gpu.num_tris
    num_spheres = gpu.num_spheres

    missed = hit.prim_id < 0
    is_tri = (hit.prim_id >= 0) & (hit.prim_id < num_tris)

    # All per-face data in one (F, 25) row, fetched with one gather.
    tid = torch.clamp(hit.prim_id, 0, max(num_tris - 1, 0)).long()
    f0, f1, f2 = (gpu.faces[:, k].long() for k in range(3))
    face_row = torch.cat([
        gpu.vertices[f0], gpu.vertices[f1], gpu.vertices[f2],
        gpu.normals[f0], gpu.normals[f1], gpu.normals[f2],
        gpu.uvs[f0], gpu.uvs[f1], gpu.uvs[f2],
        gpu.face_obj[:, None].to(torch.float32),
    ], dim=1)
    g = face_row[tid]
    v0, v1, v2 = g[..., 0:3], g[..., 3:6], g[..., 6:9]

    rt_t, rt_u, rt_v, rt_ok = ray_triangle(origins, dirs, v0, v1, v2)
    hit_u = torch.where(rt_ok, rt_u, hit.u)
    hit_v = torch.where(rt_ok, rt_v, hit.v)
    w0 = (1.0 - hit_u - hit_v)[..., None]
    w1 = hit_u[..., None]
    w2 = hit_v[..., None]
    tri_pos = v0 * w0 + v1 * w1 + v2 * w2
    tri_nrm = normalize(g[..., 9:12] * w0 + g[..., 12:15] * w1 + g[..., 15:18] * w2)
    tri_uv = g[..., 18:20] * w0 + g[..., 20:22] * w1 + g[..., 22:24] * w2
    tri_obj = g[..., 24].to(torch.int64)        # exact for < 2^24 objects

    if num_spheres:
        sid = torch.clamp(hit.prim_id.long() - num_tris, 0, num_spheres - 1)
        sph_c = gpu.sph_center[sid]
        sph_p = origins + hit.t[..., None] * dirs
        sph_n = normalize(sph_p - sph_c)
        su = torch.atan2(sph_n[..., 2], sph_n[..., 0]) / 6.28318530718 + 0.5
        sv = torch.acos(torch.clamp(sph_n[..., 1], -1.0, 1.0)) / 3.14159265359
        sph_uv = torch.stack([su, sv], dim=-1)
        sph_obj = gpu.sph_obj[sid].to(torch.int64)
        position = torch.where(is_tri[..., None], tri_pos, sph_p)
        normal = torch.where(is_tri[..., None], tri_nrm, sph_n)
        uv = torch.where(is_tri[..., None], tri_uv, sph_uv)
        obj = torch.where(is_tri, tri_obj, sph_obj)
    else:
        position, normal, uv, obj = tri_pos, tri_nrm, tri_uv, tri_obj

    obj = torch.where(missed, 0, obj)

    # Material row (O, 10) fetched once (closesthit.rchit:79-106).
    mat_row = torch.cat([
        gpu.obj_color,
        gpu.obj_specular[:, None], gpu.obj_metallic[:, None],
        gpu.obj_is_light[:, None].to(torch.float32),
        gpu.obj_tex.to(torch.float32),
    ], dim=1)
    m = mat_row[obj]
    color = m[..., 0:3]
    # Emitters keep the raw material color, never a texel
    # (closesthit.rchit:46-50).
    emit_color = color
    spec = m[..., 3]
    metal = m[..., 4]
    hit_light = (~missed) & (m[..., 5] > 0)
    tex = m[..., 6:10].to(torch.int32)
    valid = (~missed) & (~hit_light)

    # Non-hits carry overflow-prone positions (sphere path: o + BIG_T*d).
    position = torch.where(valid[..., None], position, 0.0)
    normal = torch.where(valid[..., None], normal, 0.0)

    if gpu.has_textures:
        # Texture overrides only where a map index is >= 0; one gather per
        # map from the packed atlas.
        def fetch(ch):
            return sample_atlas_packed(gpu.tex_atlas_packed, gpu.tex_size,
                                       tex[..., ch], uv[..., 0], uv[..., 1])
        color = torch.where((tex[..., 0] >= 0)[..., None], fetch(0)[..., :3], color)
        spec = torch.where(tex[..., 1] >= 0, fetch(1)[..., 0], spec)
        metal = torch.where(tex[..., 2] >= 0, fetch(2)[..., 0], metal)

    return Surface(
        valid=valid, hit_light=hit_light, missed=missed,
        position=position, normal=normal, uv=uv,
        albedo=srgb_to_linear(color), roughness=1.0 - spec, metallic=metal,
        light_color=emit_color, obj_id=obj,
    )
