"""Alpha-tested transparency: the any-hit shader as a re-trace ladder.

Counterpart of realtimeraytracer_tpu/render/alpha.py (``_alpha_face_row``,
``hit_alpha`` with its instance branch, ``wrap_backend_with_alpha`` with its
closest and occlusion ladders and ``step_past``; the opaque/alpha panel
split belongs to ``alpha_split``, which is not ported).  Parity target: the
reference's opacity any-hit shader (opacity.rahit:31-64) ignores an
intersection whose sampled opacity is below 0.9, for closest and shadow
rays alike.

Here a closest trace is followed by an opacity evaluation at the accepted
hit, and the rays whose hit was rejected re-trace with t_min moved just
past it, at most ``alpha_rounds`` times; every other lane gets the empty
interval [BIG, -BIG) so its tile retires at once.  Occlusion is the same
ladder over closest traces (occluded iff an opaque hit lies in range,
alpha_rounds + 1 re-traces).  The traversal kernels' in-kernel alpha masks
(ops/alpha_mask.py) reject hits in definitely-transparent cells inside the
trace, so fewer rays need a round (the cells at a cutout's edge still do).

The JAX package skips a round under ``lax.cond`` when no ray needs it;
eager PyTorch decides on the host, so each round costs one host sync (the
count of rays that still need it, read back).  ``wrap_backend_with_alpha``
counts them in ``.syncs`` (and the rounds that ran in ``.rounds``), with one
more sync where a backend is wrapped (whether the scene has an opacity
map).  A skipped round means every later round is skipped too, so the
ladder stops there.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from realtimeraytracer_torch.config import RenderConfig
from realtimeraytracer_torch.ops.intersect import BIG_T, HitRecord, as_per_ray, ray_triangle
from realtimeraytracer_torch.ops.texture import sample_atlas_packed
from realtimeraytracer_torch.render.backends import TraceBackend
from realtimeraytracer_torch.render.hier_backend import to_mesh
from realtimeraytracer_torch.scene.gpu_scene import TorchScene


def _alpha_face_row(gpu: TorchScene) -> torch.Tensor:
    """Per-face row for hit_alpha, (F, 16): [v0 v1 v2 | uv0 uv1 uv2 | the
    opacity texture id], so each evaluation is one gather."""
    f0, f1, f2 = (gpu.faces[:, k].long() for k in range(3))
    tex = gpu.obj_tex[gpu.face_obj.long(), 3].to(torch.float32)
    return torch.cat([
        gpu.vertices[f0], gpu.vertices[f1], gpu.vertices[f2],
        gpu.uvs[f0], gpu.uvs[f1], gpu.uvs[f2], tex[:, None],
    ], dim=1)


def hit_alpha(gpu: TorchScene, hit: HitRecord, origins, dirs,
              face_row: torch.Tensor | None = None) -> torch.Tensor:
    """Opacity of each hit: 1 where the object has no opacity map, the hit
    is a sphere or the ray missed.  Barycentrics are recomputed from the
    winning triangle (the kernels return none); hit.u / hit.v are only the
    fallback for degenerate re-tests.

    On an instanced scene the pools are mesh-space and face_obj is zeros:
    the ray moves into mesh space by inst_inv[hit.inst] (directions not
    renormalized, as in the traversal kernel; barycentrics do not change
    under the affine map) and the opacity map is the instance's object's,
    obj_tex[inst_obj[hit.inst], 3]."""
    num_tris = gpu.num_tris
    is_tri = (hit.prim_id >= 0) & (hit.prim_id < num_tris)
    tid = torch.clamp(hit.prim_id, 0, max(num_tris - 1, 0)).long()
    if face_row is None:
        face_row = _alpha_face_row(gpu)
    g = face_row[tid]
    v0, v1, v2 = g[..., 0:3], g[..., 3:6], g[..., 6:9]
    instanced = gpu.instanced and hit.inst is not None
    if instanced:
        iid = torch.clamp(hit.inst, 0, gpu.inst_inv.shape[0] - 1).long()
        origins, dirs = to_mesh(gpu.inst_inv[iid], origins, dirs)
        is_tri = is_tri & (hit.inst >= 0)
    _, rt_u, rt_v, rt_ok = ray_triangle(origins, dirs, v0, v1, v2)
    hu = torch.where(rt_ok, rt_u, hit.u)
    hv = torch.where(rt_ok, rt_v, hit.v)
    w0 = (1.0 - hu - hv)[..., None]
    uv = g[..., 9:11] * w0 + g[..., 11:13] * hu[..., None] + g[..., 13:15] * hv[..., None]
    tex = g[..., 15].to(torch.int32)
    if instanced:
        tex = gpu.obj_tex[gpu.inst_obj[iid].long(), 3]
    a = sample_atlas_packed(gpu.tex_atlas_packed, gpu.tex_size, tex,
                            uv[..., 0], uv[..., 1])[..., 0]
    return torch.where(is_tri & (tex >= 0), a, 1.0)


def step_past(t: torch.Tensor) -> torch.Tensor:
    """A t_min that clears a rejected hit at t.  The kernels return t
    rounded down by up to t * 2^-16 (the packed (t | lane) key), so an
    absolute epsilon alone would re-find the same transparent triangle
    once t exceeds about 6; the step max(1e-4, t * 3.1e-5) is twice that
    bound, so each round advances past one surface."""
    return t + torch.clamp_min(t * 3.1e-5, 1e-4)


def _merge(mask, new: HitRecord, old: HitRecord) -> HitRecord:
    """new where mask holds, else old; inst stays None when the trace
    returns none (non-instanced scenes)."""
    return HitRecord(*(None if a is None else torch.where(mask, a, b)
                       for a, b in zip(new, old)))


def wrap_backend_with_alpha(backend: TraceBackend, gpu: TorchScene,
                            cfg: RenderConfig, record: list | None = None) -> TraceBackend:
    """The backend with alpha-tested closest and occlusion queries; the
    backend itself when the scene has no opacity map.  The result has no
    ``occluded_hinted`` and no ``occluded_multi`` (its occlusion is a ladder
    of closest traces), so the frame's hint chain turns off.  record: if a
    list, each ladder decision appends (query, rays that need the round),
    "closest" or "occluded"."""
    if not gpu.has_textures:
        return backend
    wrap_backend_with_alpha.syncs += 1
    if not bool((gpu.obj_tex[:, 3] >= 0).any()):
        return backend
    threshold = cfg.alpha_threshold
    # The ladder's opacities and step_past intervals are decisions, not
    # loss terms: they carry no gradient (the traces detach their inputs).
    sg_gpu = gpu.detach()
    face_row = _alpha_face_row(sg_gpu)

    def need(mask: torch.Tensor, query: str) -> bool:
        """Whether any ray needs the next round (one host sync)."""
        n = int(mask.sum())
        wrap_backend_with_alpha.syncs += 1
        if record is not None:
            record.append((query, n))
        if n:
            wrap_backend_with_alpha.rounds += 1
        return n > 0

    def alpha(hit, origins, dirs):
        with torch.no_grad():
            return hit_alpha(sg_gpu, hit, origins, dirs, face_row)

    def closest(origins, dirs, t_min, t_max, common=None):
        r = origins.shape[0]
        t_lo = as_per_ray(t_min, r, origins.device)
        t_hi = as_per_ray(t_max, r, origins.device)
        hit = backend.closest(origins, dirs, t_lo, t_max, common=common)
        rejected = hit.hit & (alpha(hit, origins, dirs) < threshold)
        for _ in range(cfg.alpha_rounds):
            if not need(rejected, "closest"):
                break
            with record_function("alpha.round"):
                t_lo = torch.where(rejected, step_past(hit.t.detach()), t_lo)
                re = backend.closest(origins, dirs, torch.where(rejected, t_lo, BIG_T),
                                     torch.where(rejected, t_hi, -BIG_T), common=common)
                hit = _merge(rejected, re, hit)
                rejected = hit.hit & (alpha(hit, origins, dirs) < threshold)
        return hit

    def occluded(origins, dirs, t_min, t_max, common=None):
        # Occluded iff some opaque hit lies in range: the same ladder,
        # stepping past transparent hits.
        r = origins.shape[0]
        t_lo = as_per_ray(t_min, r, origins.device)
        t_hi = as_per_ray(t_max, r, origins.device)
        hit = backend.closest(origins, dirs, t_lo, t_hi, common=common)
        a = alpha(hit, origins, dirs)
        in_range = hit.hit & (hit.t < t_hi)
        occ = in_range & (a >= threshold)
        transparent = in_range & (a < threshold)
        for _ in range(cfg.alpha_rounds + 1):
            if not need(transparent, "occluded"):
                break
            with record_function("alpha.round"):
                t_lo = torch.where(transparent, step_past(hit.t.detach()), t_lo)
                re = backend.closest(origins, dirs, torch.where(transparent, t_lo, BIG_T),
                                     torch.where(transparent, t_hi, -BIG_T), common=common)
                hit = _merge(transparent, re, hit)
                a = alpha(hit, origins, dirs)
                in_range = hit.hit & (hit.t < t_hi)
                occ = occ | (in_range & (a >= threshold))
                transparent = in_range & (a < threshold) & ~occ
        return occ

    # occluded_multi is not forwarded: alpha-tested occlusion re-traces
    # closest hits, which the fused multi-segment path does not do.
    return TraceBackend(closest=closest, occluded=occluded,
                        num_tris=backend.num_tris, num_spheres=backend.num_spheres,
                        perray_cull=backend.perray_cull)


wrap_backend_with_alpha.syncs = 0
wrap_backend_with_alpha.rounds = 0
