"""Traversal diagnostics: detect silent cap saturation.

Counterpart of realtimeraytracer_tpu/render/diagnostics.py
(``diagnose_traversal``, ``wrap_backend_with_debug``).  Two traversals
stop at a cap and may then drop hits without a sign: the "wide" backend
at ``max_cluster_visits`` cluster visits (render/wide_backend.py) and the
attic's lane traversal at ``max_traversal_steps`` steps
(render/attic/bvh_backend.py).  Each has ``return_stats=True``, which
counts the tiles or rays that still had work when the cap fired
(``cap_clipped``).  ``diagnose_traversal`` runs one trace with those
statistics, and ``cfg.debug_traversal=True`` makes ``make_backend`` wrap
a "wide" backend so that every trace that the cap clips logs a loud
warning.  The port's other backends (brute force and the v7, v9 and v8
kernels with their twins) run every ray to its exact stop rule: they
report zeros and pass through unwrapped.
"""

from __future__ import annotations

import torch

from realtimeraytracer_torch.config import RenderConfig
from realtimeraytracer_torch.ops import intersect
from realtimeraytracer_torch.render.backends import (
    TraceBackend, _merge_sphere_hits, make_backend, resolve_backend_kind, sphere_occluded,
    stop_gradient)
from realtimeraytracer_torch.scene.gpu_scene import TorchScene
from realtimeraytracer_torch.utils import log

# Exact, uncapped kinds.  JAX reports zeros for "pallas" and "brute"; the
# port's "quarter", "hier" and "hybrid" (and "auto", which resolves to one
# of them or to "brute") are exact as well.
_EXACT = ("pallas", "brute", "quarter", "hier", "hybrid", "auto")


def diagnose_traversal(gpu: TorchScene, cfg: RenderConfig, origins, dirs,
                       t_min, t_max, mode: str = "closest",
                       kind: str | None = None):
    """Run one trace with saturation stats: (result, stats), stats =
    {"cap_clipped": int32 count of the tiles ("wide") or rays ("lane")
    that the cap cut, "steps": loop steps taken, "cap": the cap}.  kind
    defaults to cfg.backend ("auto" is the exact hybrid route in the port;
    JAX's "auto" is "wide" off its accelerator).  Exact kinds report
    zeros; "packet" raises, as JAX's make_backend does."""
    kind = kind or cfg.backend
    if kind == "wide":
        from realtimeraytracer_torch.render.wide_backend import wide_closest, wide_occluded

        fn = wide_closest if mode == "closest" else wide_occluded
        return fn(gpu, cfg, origins, dirs, t_min, t_max, return_stats=True)
    if kind == "lane":
        from realtimeraytracer_torch.render.attic.bvh_backend import (
            traverse_closest, traverse_occluded)

        fn = traverse_closest if mode == "closest" else traverse_occluded
        return fn(gpu, cfg, origins, dirs, t_min, t_max, return_stats=True)
    if kind == "packet":
        raise ValueError("backend kind 'packet' was retired to the JAX package's "
                         "render/attic/ and is not ported (ROADMAP queue A)")
    if kind not in _EXACT:
        raise ValueError(f"unknown backend kind {kind!r}")
    be = make_backend(gpu, cfg.replace(backend=kind, alpha_test=False, debug_traversal=False))
    fn = be.closest if mode == "closest" else be.occluded
    out = fn(origins, dirs, t_min, t_max)
    zero = torch.zeros((), dtype=torch.int32, device=origins.device)
    return out, {"cap_clipped": zero, "steps": zero, "cap": 0}


def _warn(stats: dict, what: str) -> None:
    """The loud warning of a clipped trace (one host read of the count)."""
    clipped = int(stats["cap_clipped"])
    if clipped > 0:
        log.warn("WARNING traversal cap saturated: {} unfinished {} (cap {}) - hits may "
                 "be dropped; raise max_cluster_visits/max_traversal_steps",
                 clipped, what, stats["cap"])


def wrap_backend_with_debug(backend: TraceBackend, gpu: TorchScene,
                            cfg: RenderConfig) -> TraceBackend:
    """The backend that cfg.debug_traversal asks for: a "wide" backend
    whose every trace runs with its cap statistics and warns through
    utils/log.py when the cap clips, spheres merged as the backend merges
    them; every other (exact) backend passes through unchanged."""
    if resolve_backend_kind(gpu, cfg) != "wide":
        return backend
    num_tris = backend.num_tris
    sg_gpu = gpu.detach()

    def closest(origins, dirs, t_min, t_max, common=None):
        hit, stats = diagnose_traversal(sg_gpu, cfg,
                                        *stop_gradient(origins, dirs, t_min, t_max),
                                        "closest", "wide")
        _warn(stats, "tiles in closest")
        if backend.num_spheres:
            sph = intersect.intersect_spheres(
                origins, dirs, gpu.sph_center, gpu.sph_radius, t_min, t_max)
            hit = _merge_sphere_hits(hit, sph, num_tris)
        return hit

    def occluded(origins, dirs, t_min, t_max, common=None):
        occ, stats = diagnose_traversal(sg_gpu, cfg,
                                        *stop_gradient(origins, dirs, t_min, t_max),
                                        "occluded", "wide")
        _warn(stats, "tiles in occluded")
        return sphere_occluded(gpu, occ, origins, dirs, t_min, t_max)

    # The hint-chained path is dropped: callers would bypass the wrapped
    # traces through it (and diagnostic runs are not timed runs).
    return backend._replace(closest=closest, occluded=occluded, occluded_hinted=None)
