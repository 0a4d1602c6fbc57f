"""Traversal diagnostics: cap saturation, which the port's backends cannot
reach.

Counterpart of realtimeraytracer_tpu/render/diagnostics.py
(``diagnose_traversal``, ``wrap_backend_with_debug``).  In the JAX package
the wide XLA backend and the attic's lane backend stop at a visit or step
cap (``max_cluster_visits``, ``max_traversal_steps``) and can drop hits
silently there, so ``cfg.debug_traversal`` wraps them with a warning; its
exact backends pass through.  The port has no capped backend: brute force
and the v7, v9 and v8 kernels (with their twins) run every ray to its exact
stop rule.  So every ported kind reports zero clipped work, the wrap
returns each backend as it is, and the two capped kinds, which are not
ported (ROADMAP queue A, "Not to port"), raise.
"""

from __future__ import annotations

import torch

from realtimeraytracer_torch.config import RenderConfig
from realtimeraytracer_torch.render.backends import TraceBackend, make_backend
from realtimeraytracer_torch.scene.gpu_scene import TorchScene

# The JAX package's capped kinds; neither is ported.
_CAPPED = {
    "wide": "the wide XLA backend",
    "lane": "the attic's lane backend (render/attic/)",
}
# Exact, uncapped kinds.  JAX reports zeros for "pallas" and "brute" and
# knows no other; the port's "quarter", "hier" and "hybrid" (and "auto",
# which resolves to one of them or to "brute") are exact as well.
_EXACT = ("pallas", "brute", "quarter", "hier", "hybrid", "auto")


def diagnose_traversal(gpu: TorchScene, cfg: RenderConfig, origins, dirs,
                       t_min, t_max, mode: str = "closest",
                       kind: str | None = None):
    """Run one trace with saturation stats: (result, stats), stats =
    {"cap_clipped": int32 count of work cut by a cap, "steps": loop steps
    counted against it, "cap": the cap}.  kind defaults to cfg.backend.
    Every ported kind is exact and uncapped and reports zeros; "wide" and
    "lane" raise NotImplementedError."""
    kind = kind or cfg.backend
    if kind in _CAPPED:
        raise NotImplementedError(
            f"traversal diagnostics of {_CAPPED[kind]} are not ported: the kind is "
            "listed under 'Not to port' in ROADMAP queue A")
    if kind not in _EXACT:
        raise ValueError(f"unknown backend kind {kind!r}")
    be = make_backend(gpu, cfg.replace(backend=kind, alpha_test=False, debug_traversal=False))
    fn = be.closest if mode == "closest" else be.occluded
    out = fn(origins, dirs, t_min, t_max)
    zero = torch.zeros((), dtype=torch.int32, device=origins.device)
    return out, {"cap_clipped": zero, "steps": zero, "cap": 0}


def wrap_backend_with_debug(backend: TraceBackend, gpu: TorchScene,
                            cfg: RenderConfig) -> TraceBackend:
    """The backend that cfg.debug_traversal asks for: every ported backend
    is exact (no cap to saturate), so it passes through unchanged, as the
    JAX package's exact backends do."""
    return backend
