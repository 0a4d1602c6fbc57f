"""Ray-primitive intersection (Moller-Trumbore triangles, analytic spheres).

Counterpart of realtimeraytracer_tpu/ops/intersect.py: ``BIG_T``,
``HitRecord``, ``ray_triangle``, the brute-force closest/occluded queries
(chunked over triangles, exact, for scenes without a BVH) and
``intersect_spheres``.  All math is float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from realtimeraytracer_torch.ops.vecmath import cross, dot

BIG_T = 3.0e38


class HitRecord(NamedTuple):
    """Closest-hit result for a batch of rays (all fields shape (R,))."""

    t: torch.Tensor        # hit distance (BIG_T if miss)
    prim_id: torch.Tensor  # unified prim id (-1 if miss)
    u: torch.Tensor
    v: torch.Tensor
    # Instance id on shared-geometry scenes (render/hier_backend.py): None
    # on non-instanced paths, -1 on misses and spheres.
    inst: torch.Tensor | None = None

    @property
    def hit(self) -> torch.Tensor:
        return self.prim_id >= 0


def ray_triangle(o, d, v0, v1, v2, eps: float = 1e-9):
    """Moller-Trumbore; broadcasts over matching batch shapes.
    Returns (t, u, v, valid); t is BIG_T where invalid."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    valid = det.abs() > eps
    inv_det = torch.where(valid, 1.0 / torch.where(valid, det, 1.0), 0.0)
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    valid = valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    t = torch.where(valid, t, BIG_T)
    return t, u, v, valid


def ray_sphere(o, d, center, radius):
    """Nearest positive root of |o + t d - c|^2 = r^2 (|d| = 1)."""
    oc = o - center
    b = dot(oc, d)
    c = dot(oc, oc) - radius * radius
    disc = b * b - c
    valid = disc >= 0.0
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 > 0.0, t0, t1)
    valid = valid & (t > 0.0)
    return torch.where(valid, t, BIG_T), valid


def as_per_ray(x, r: int, device) -> torch.Tensor:
    """Broadcast a scalar-or-(R,) ray-interval bound to (R,) float32."""
    return torch.as_tensor(x, dtype=torch.float32, device=device).expand(r)


def _face_chunks(vertices, faces, chunk):
    t = faces.shape[0]
    n_chunks = max(1, -(-t // chunk))
    pad = n_chunks * chunk - t
    faces_p = torch.nn.functional.pad(faces, (0, 0, 0, pad))  # vertex 0: degenerate
    return vertices[faces_p].reshape(n_chunks, chunk, 3, 3)


def intersect_tris_bruteforce(origins, dirs, vertices, faces, t_min, t_max,
                              chunk: int = 512) -> HitRecord:
    """Closest hit of every ray against the whole soup, in triangle chunks."""
    r = origins.shape[0]
    dev = origins.device
    t_min = as_per_ray(t_min, r, dev)
    t_max = as_per_ray(t_max, r, dev)
    tv = _face_chunks(vertices, faces, chunk)
    best_t = torch.full((r,), BIG_T, device=dev)
    best_id = torch.full((r,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(r, device=dev)
    best_v = torch.zeros(r, device=dev)
    rows = torch.arange(r, device=dev)
    for c in range(tv.shape[0]):
        t, u, v, valid = ray_triangle(origins[:, None, :], dirs[:, None, :],
                                      tv[c, None, :, 0], tv[c, None, :, 1],
                                      tv[c, None, :, 2])
        valid = valid & (t >= t_min[:, None]) & (t <= t_max[:, None])
        t = torch.where(valid, t, BIG_T)
        idx = torch.argmin(t, dim=1)
        tb = t[rows, idx]
        prim = torch.where(tb < BIG_T, c * chunk + idx, -1).to(torch.int32)
        closer = tb < best_t
        best_t = torch.where(closer, tb, best_t)
        best_id = torch.where(closer, prim, best_id)
        best_u = torch.where(closer, u[rows, idx], best_u)
        best_v = torch.where(closer, v[rows, idx], best_v)
    return HitRecord(t=best_t, prim_id=best_id, u=best_u, v=best_v)


def occluded_tris_bruteforce(origins, dirs, vertices, faces, t_min, t_max,
                             chunk: int = 512) -> torch.Tensor:
    """Any-hit: True where some triangle lies in [t_min, t_max)."""
    r = origins.shape[0]
    dev = origins.device
    t_min = as_per_ray(t_min, r, dev)
    t_max = as_per_ray(t_max, r, dev)
    tv = _face_chunks(vertices, faces, chunk)
    occ = torch.zeros(r, dtype=torch.bool, device=dev)
    for c in range(tv.shape[0]):
        t, _, _, valid = ray_triangle(origins[:, None, :], dirs[:, None, :],
                                      tv[c, None, :, 0], tv[c, None, :, 1],
                                      tv[c, None, :, 2])
        occ = occ | (valid & (t >= t_min[:, None])
                     & (t < t_max[:, None])).any(dim=1)
    return occ


def intersect_spheres(origins, dirs, centers, radii, t_min, t_max) -> HitRecord:
    """Closest hit against a (small) list of analytic spheres; prim_id
    indexes the sphere list."""
    r = origins.shape[0]
    dev = origins.device
    t_min = as_per_ray(t_min, r, dev)
    t_max = as_per_ray(t_max, r, dev)
    t, valid = ray_sphere(origins[:, None, :], dirs[:, None, :],
                          centers[None], radii[None])
    valid = valid & (t >= t_min[:, None]) & (t <= t_max[:, None])
    t = torch.where(valid, t, BIG_T)
    idx = torch.argmin(t, dim=1)
    tb = t[torch.arange(r, device=dev), idx]
    prim = torch.where(tb < BIG_T, idx, -1).to(torch.int32)
    zeros = torch.zeros(r, device=dev)
    return HitRecord(t=tb, prim_id=prim, u=zeros, v=zeros)
