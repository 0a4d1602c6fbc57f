"""Trace backends: how a ray batch is intersected against the scene.

Counterpart of realtimeraytracer_tpu/render/backends.py (``TraceBackend``,
``_merge_sphere_hits``, ``make_bruteforce_backend``, ``make_backend``).  A
backend is a pair of functions over ray batches:

    closest(origins, dirs, t_min, t_max, common=None)  -> HitRecord
    occluded(origins, dirs, t_min, t_max, common=None) -> bool mask

with unified prim ids: [0, F) triangles, [F, F+S) analytic spheres.  The
port has "brute" (chunked all-pairs, exact) and "pallas" (the v7 CUDA
kernel, render/v7_backend.py).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from realtimeraytracer_torch.config import RenderConfig, check_supported
from realtimeraytracer_torch.ops import intersect
from realtimeraytracer_torch.scene.gpu_scene import TorchScene


class TraceBackend(NamedTuple):
    closest: Callable
    occluded: Callable
    num_tris: int
    num_spheres: int
    # True when the backend culls per ray (the v8 kernel, not ported yet);
    # callers then skip their shadow-ray sort.
    perray_cull: bool = False


def _merge_sphere_hits(tri_hit: intersect.HitRecord,
                       sph_hit: intersect.HitRecord,
                       num_tris: int) -> intersect.HitRecord:
    use_sph = sph_hit.t < tri_hit.t
    return intersect.HitRecord(
        t=torch.where(use_sph, sph_hit.t, tri_hit.t),
        prim_id=torch.where(
            use_sph,
            torch.where(sph_hit.prim_id >= 0, sph_hit.prim_id + num_tris, -1),
            tri_hit.prim_id).to(torch.int32),
        u=torch.where(use_sph, sph_hit.u, tri_hit.u),
        v=torch.where(use_sph, sph_hit.v, tri_hit.v),
    )


def sphere_occluded(gpu: TorchScene, occ, origins, dirs, t_min, t_max):
    """OR the analytic spheres into a triangle occlusion mask."""
    if not gpu.num_spheres:
        return occ
    sph = intersect.intersect_spheres(origins, dirs, gpu.sph_center,
                                      gpu.sph_radius, t_min, float("inf"))
    t_max = intersect.as_per_ray(t_max, origins.shape[0], origins.device)
    return occ | (sph.t < t_max)


def make_bruteforce_backend(gpu: TorchScene, cfg: RenderConfig) -> TraceBackend:
    """All-pairs chunked intersection: exact, no build step; for small
    scenes without a BVH."""
    num_tris = gpu.num_tris
    num_spheres = gpu.num_spheres

    def closest(origins, dirs, t_min, t_max, common=None):
        hit = intersect.intersect_tris_bruteforce(
            origins, dirs, gpu.vertices, gpu.faces.long(), t_min, t_max)
        if num_spheres:
            sph = intersect.intersect_spheres(
                origins, dirs, gpu.sph_center, gpu.sph_radius, t_min, t_max)
            hit = _merge_sphere_hits(hit, sph, num_tris)
        return hit

    def occluded(origins, dirs, t_min, t_max, common=None):
        occ = intersect.occluded_tris_bruteforce(
            origins, dirs, gpu.vertices, gpu.faces.long(), t_min, t_max)
        return sphere_occluded(gpu, occ, origins, dirs, t_min, t_max)

    return TraceBackend(closest=closest, occluded=occluded,
                        num_tris=num_tris, num_spheres=num_spheres)


def resolve_backend_kind(gpu: TorchScene, cfg: RenderConfig) -> str:
    """The backend string a config selects for this scene."""
    check_supported(cfg)
    kind = cfg.backend
    if kind == "auto":
        kind = "pallas" if cfg.use_bvh and gpu.has_bvh else "brute"
    if kind == "pallas" and not gpu.has_bvh:
        kind = "brute"
    if kind not in ("pallas", "brute"):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    return kind


def make_backend(gpu: TorchScene, cfg: RenderConfig) -> TraceBackend:
    if resolve_backend_kind(gpu, cfg) == "pallas":
        from realtimeraytracer_torch.render.v7_backend import make_v7_backend

        return make_v7_backend(gpu, cfg)
    return make_bruteforce_backend(gpu, cfg)
