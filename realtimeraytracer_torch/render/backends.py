"""Trace backends: how a ray batch is intersected against the scene.

Counterpart of realtimeraytracer_tpu/render/backends.py (``TraceBackend``,
``_merge_sphere_hits``, ``make_bruteforce_backend``, ``make_backend``).  A
backend is a pair of functions over ray batches:

    closest(origins, dirs, t_min, t_max, common=None)  -> HitRecord
    occluded(origins, dirs, t_min, t_max, common=None) -> bool mask

with unified prim ids: [0, F) triangles, [F, F+S) analytic spheres.  The
port has "brute" (chunked all-pairs, exact), "pallas" (the v7 CUDA kernel,
render/v7_backend.py), "quarter" (v9, render/quarter_backend.py), "hier"
(v8, render/hier_backend.py), "hybrid", which routes each trace class to
one of them as the JAX package does on its accelerator, and "wide"
(render/wide_backend.py: plain torch cluster culling under the
``max_cluster_visits`` cap, the JAX package's route off its accelerator).
The attic's lane traversal (render/attic/) is not in the registry, as in
the JAX package.  Instanced
(shared-geometry) scenes trace only through v8's instanced kernel: the
BVH backends route there and "brute" raises.  With
``cfg.alpha_test`` set, ``make_backend`` wraps the backend in the alpha
re-trace ladder (render/alpha.py), and the closest traces of v7, v9 and
v8 apply the scene's in-kernel alpha masks (``masks_enabled``).
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
    # True when the backend culls per ray (the v8 kernel); callers then
    # skip their shadow-ray sort.
    perray_cull: bool = False
    # Fused shadow query: occluded_multi(origins, dirs_s, t_lo, t_hi_s) ->
    # list of S masks, the S shared-origin segments of one light triangle in
    # one trace (render/hier_backend.py::hier_occluded_multi).  None when the
    # backend has no fused path; no route supplies one, as in JAX.
    occluded_multi: Callable | None = None
    # Hint-chained occlusion (v8): occluded_hinted(o, d, lo, hi, hints=...,
    # common=...) -> (mask, hints_out); callers thread hints_out into the
    # next correlated occlusion query.  The mask never depends on hints.
    occluded_hinted: Callable | None = None


def _merge_sphere_hits(tri_hit: intersect.HitRecord,
                       sph_hit: intersect.HitRecord,
                       num_tris: int) -> intersect.HitRecord:
    use_sph = sph_hit.t < tri_hit.t
    inst = tri_hit.inst
    if inst is not None:
        inst = torch.where(use_sph, -1, inst)
    return intersect.HitRecord(
        t=torch.where(use_sph, sph_hit.t, tri_hit.t),
        prim_id=torch.where(
            use_sph,
            torch.where(sph_hit.prim_id >= 0, sph_hit.prim_id + num_tris, -1),
            tri_hit.prim_id).to(torch.int32),
        u=torch.where(use_sph, sph_hit.u, tri_hit.u),
        v=torch.where(use_sph, sph_hit.v, tri_hit.v),
        inst=inst,
    )


def stop_gradient(*xs) -> tuple:
    """xs with every gradient-carrying tensor detached (other tensors,
    numbers and None pass as they are).
    The BVH backends hand their traces (kernels and twins alike) detached
    rays, intervals and scene leaves, as the JAX package's backends hand
    theirs ``jax.lax.stop_gradient``: the hit search is discrete, and the
    surface resolver recomputes the continuous hit quantities from the
    scene's leaves, so a trace's outputs carry no gradient.  The analytic
    spheres and the brute-force backend stay differentiable."""
    return tuple(x.detach() if isinstance(x, torch.Tensor) and x.requires_grad else x
                 for x in xs)


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


def masks_enabled(cfg: RenderConfig) -> bool:
    """Whether closest traces apply the scene's in-kernel alpha masks: with
    the alpha ladder on, at a threshold no lower than the one the masks
    were built at (RenderConfig.alpha_threshold), so a 0 bit stays
    conservative (the JAX package's gate).  The JAX package masks only
    VMEM-resident scenes; the port has no resident split and masks at any
    size, which can move no result (ROADMAP queue C)."""
    return bool(cfg.alpha_test) and cfg.alpha_threshold >= RenderConfig.alpha_threshold


def make_hybrid_backend(gpu: TorchScene, cfg: RenderConfig,
                        plain: bool = False,
                        use_amask: bool | None = None) -> TraceBackend:
    """Route each trace class to a kernel, as the JAX package's
    make_hybrid_backend does: coherent closest traces (common origin or
    direction) go to v9 when the scene has at most RESIDENT_CB blocks and
    to v7 otherwise; incoherent closest traces and every occlusion go to
    v8, whose per-ray cull also makes the shadow-ray sort unnecessary.
    plain=True routes to the kernels' plain twins on any device (the
    reference the kernels are checked against on the card).  use_amask:
    closest traces apply the scene's alpha masks; None takes the config's
    gate (masks_enabled).  An instanced scene gets v8 alone, as
    make_backend routes it."""
    from realtimeraytracer_torch.render import hier_backend as v8m
    from realtimeraytracer_torch.render import quarter_backend as v9m
    from realtimeraytracer_torch.render import v7_backend as v7m
    from realtimeraytracer_torch.scene.panels import RESIDENT_CB

    v7_trace = v7m.trace_blocks_plain if plain else v7m.trace_blocks
    v8 = v8m.make_hier_backend(
        gpu, cfg, trace=v8m.trace_blocks_hier_plain if plain else v8m.trace_blocks_hier,
        use_amask=use_amask)
    if gpu.instanced:
        return v8
    resident = (gpu.pallas_panels is not None
                and gpu.pallas_panels.shape[0] <= RESIDENT_CB)
    if resident:
        coherent = v9m.make_quarter_backend(
            gpu, cfg, v7_trace=v7_trace,
            trace=v9m.trace_blocks_quarter_plain if plain else v9m.trace_blocks_quarter,
            use_amask=use_amask)
    else:
        coherent = v7m.make_v7_backend(gpu, cfg, trace=v7_trace, use_amask=use_amask)

    def closest(origins, dirs, t_min, t_max, common=None):
        be = coherent if common in ("origin", "dir") else v8
        return be.closest(origins, dirs, t_min, t_max, common=common)

    return TraceBackend(closest=closest, occluded=v8.occluded,
                        num_tris=v8.num_tris, num_spheres=v8.num_spheres,
                        perray_cull=True, occluded_multi=v8.occluded_multi,
                        occluded_hinted=v8.occluded_hinted)


def trace_primary_blocks(gpu: TorchScene, ray_blocks: torch.Tensor):
    """Closest hits of packed camera ray blocks (one origin a tile, as
    ops/camera_rays.py::generate_ray_blocks emits them) by the hybrid
    route's coherent rule, as bench.py's thin slice routes them: v9 on
    scenes of at most RESIDENT_CB blocks with repacked panels, v7 above.
    Returns the kernel's (outf, outi): row 0 the t and the sorted-triangle
    id; on CPU tensors the kernels' wrappers run their plain twins."""
    from realtimeraytracer_torch.render import quarter_backend as v9m
    from realtimeraytracer_torch.render import v7_backend as v7m
    from realtimeraytracer_torch.scene.panels import RESIDENT_CB

    if gpu.instanced or gpu.pallas_panels is None:
        raise ValueError("the thin slice traces a compiled BVH scene without instances")
    if gpu.q_panels is not None and gpu.pallas_panels.shape[0] <= RESIDENT_CB:
        return v9m.trace_blocks_quarter(gpu, ray_blocks, common="origin")
    return v7m.trace_blocks(gpu, ray_blocks, "closest", common="origin")


_BVH_KINDS = ("pallas", "quarter", "hier", "hybrid", "wide")


def resolve_backend_kind(gpu: TorchScene, cfg: RenderConfig) -> str:
    """The backend string a config selects for this scene: "auto" is
    "hybrid" when the scene has a BVH and use_bvh is set (the JAX
    package's choice on its accelerator; off it, the JAX package takes
    "wide"), else "brute"; a BVH backend ("wide" among them) on a
    scene without a BVH is "brute".  An instanced scene holds mesh-space
    pools that only v8's instanced level reads: every BVH backend and
    "auto" give "hier" there, and "brute" raises (JAX make_backend)."""
    check_supported(cfg)
    kind = cfg.backend
    if gpu.instanced:
        if kind in ("auto",) + _BVH_KINDS:
            return "hier"
        raise ValueError(f"backend {kind!r} cannot trace an instanced scene: use "
                         "'hier' (or compile with bake_instances=True)")
    if kind == "auto":
        kind = "hybrid" if cfg.use_bvh and gpu.has_bvh else "brute"
    if kind in _BVH_KINDS and not gpu.has_bvh:
        kind = "brute"
    if kind not in _BVH_KINDS + ("brute",):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    return kind


def make_backend(gpu: TorchScene, cfg: RenderConfig) -> TraceBackend:
    """The backend the config selects for this scene, passed through the
    traversal diagnostics when cfg.debug_traversal is set (which watch the
    "wide" backend's visit cap and leave the exact backends as they are)
    and wrapped in the alpha re-trace ladder when cfg.alpha_test is set
    (the ladder returns the backend unwrapped when the scene has no
    opacity map)."""
    kind = resolve_backend_kind(gpu, cfg)
    if kind == "pallas":
        from realtimeraytracer_torch.render.v7_backend import make_v7_backend

        backend = make_v7_backend(gpu, cfg)
    elif kind == "quarter":
        from realtimeraytracer_torch.render.quarter_backend import make_quarter_backend

        backend = make_quarter_backend(gpu, cfg)
    elif kind == "hier":
        from realtimeraytracer_torch.render.hier_backend import make_hier_backend

        backend = make_hier_backend(gpu, cfg)
    elif kind == "hybrid":
        backend = make_hybrid_backend(gpu, cfg)
    elif kind == "wide":
        from realtimeraytracer_torch.render.wide_backend import make_wide_backend

        backend = make_wide_backend(gpu, cfg)
    else:
        backend = make_bruteforce_backend(gpu, cfg)
    if cfg.debug_traversal:
        from realtimeraytracer_torch.render.diagnostics import wrap_backend_with_debug

        backend = wrap_backend_with_debug(backend, gpu, cfg)
    if cfg.alpha_test:
        from realtimeraytracer_torch.render.alpha import wrap_backend_with_alpha

        backend = wrap_backend_with_alpha(backend, gpu, cfg)
    return backend
