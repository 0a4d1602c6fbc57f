"""Alpha-tested transparency: the any-hit shader as a re-trace ladder.

Counterpart of realtimeraytracer_tpu/render/alpha.py (``_alpha_face_row``,
``hit_alpha`` with its instance branch, ``wrap_backend_with_alpha`` with its
closest and occlusion ladders, the two-phase occlusion of ``alpha_split``
and ``step_past``).  Parity target: the reference's opacity any-hit shader
(opacity.rahit:31-64) ignores an intersection whose sampled opacity is
below 0.9, for closest and shadow rays alike.

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

Two-phase occlusion (``cfg.alpha_split``): occluded iff some opaque
triangle lies in range, or some alpha-mapped one whose sampled opacity
reaches the threshold; the two are decided apart.  Phase 1 is v8's raw
occluded trace on the opaque triangles (and the spheres), exact and with no
ladder; phase 2 runs the occlusion ladder on the alpha-mapped triangles
alone, for the rays phase 1 left unresolved (every other lane gets [BIG,
-BIG)).  It engages where the JAX package's does: the option set, the
compile's split leaves present (scene/scene.py), the scene not instanced
and the backend culling per ray ("hier" and "hybrid"); on the "pallas",
"quarter" and "brute" routes the classic ladder runs, as in JAX.  The two
subset backends are v8's, built once per wrapped backend; the alpha
subset traces with its own masks (``gpu_scene.alpha_subset_amask``), never
with the whole scene's, which the JAX split reads (ROADMAP queue C).
Closest traces keep the classic ladder.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from realtimeraytracer_torch.config import RenderConfig
from realtimeraytracer_torch.ops.intersect import BIG_T, HitRecord, as_per_ray, ray_triangle
from realtimeraytracer_torch.ops.texture import sample_atlas_packed
from realtimeraytracer_torch.render.backends import TraceBackend
from realtimeraytracer_torch.render import hier_backend as v8m
from realtimeraytracer_torch.render.hier_backend import to_mesh
from realtimeraytracer_torch.scene.gpu_scene import TorchScene, alpha_subset_amask


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


def _need(mask: torch.Tensor, query: str, record: list | None) -> bool:
    """Whether any ray needs the next round of a ladder (one host sync,
    counted on wrap_backend_with_alpha; record, if a list, gets (query,
    rays that need the round))."""
    n = int(mask.sum())
    wrap_backend_with_alpha.syncs += 1
    if record is not None:
        record.append((query, n))
    if n:
        wrap_backend_with_alpha.rounds += 1
    return n > 0


def occlusion_ladder(backend: TraceBackend, gpu: TorchScene, cfg: RenderConfig,
                     origins, dirs, t_min, t_max, common=None,
                     face_row: torch.Tensor | None = None, record: list | None = None):
    """Alpha-tested occlusion from closest traces of `backend`: occluded
    iff an opaque hit lies in range, stepping past transparent hits at
    most alpha_rounds + 1 times.  face_row: the hit_alpha rows of the prim
    ids the backend returns (default: the scene's).  Returns (occluded,
    unresolved): unresolved marks the rays whose last hit in range was
    still transparent when the rounds ran out (reported not occluded)."""
    threshold = cfg.alpha_threshold
    gpu = gpu.detach()
    if face_row is None:
        face_row = _alpha_face_row(gpu)

    def alpha(hit):
        with torch.no_grad():
            return hit_alpha(gpu, hit, origins, dirs, face_row)

    r = origins.shape[0]
    t_lo = as_per_ray(t_min, r, origins.device)
    t_hi = as_per_ray(t_max, r, origins.device)
    hit = backend.closest(origins, dirs, t_lo, t_hi, common=common)
    a = alpha(hit)
    in_range = hit.hit & (hit.t < t_hi)
    occ = in_range & (a >= threshold)
    transparent = in_range & (a < threshold)
    for _ in range(cfg.alpha_rounds + 1):
        if not _need(transparent, "occluded", record):
            break
        with record_function("alpha.round"):
            t_lo = torch.where(transparent, step_past(hit.t.detach()), t_lo)
            re = backend.closest(origins, dirs, torch.where(transparent, t_lo, BIG_T),
                                 torch.where(transparent, t_hi, -BIG_T), common=common)
            hit = _merge(transparent, re, hit)
            a = alpha(hit)
            in_range = hit.hit & (hit.t < t_hi)
            occ = occ | (in_range & (a >= threshold))
            transparent = in_range & (a < threshold) & ~occ
    return occ, transparent


def split_backends(gpu: TorchScene, cfg: RenderConfig, plain: bool = False):
    """The two-phase occlusion's v8 backends (opaque, alpha) on the
    compile's subset scenes: each a copy of the scene with the subset's
    panels, boxes and masks; the alpha subset without spheres (spheres are
    opaque and go with phase 1), as in the JAX package.  plain=True traces
    through the kernels' plain twins on any device."""
    trace = v8m.trace_blocks_hier_plain if plain else v8m.trace_blocks_hier
    opq = dataclasses.replace(gpu, pallas_panels=gpu.pallas_panels_opq,
                              pallas_cl_min=gpu.pallas_cl_min_opq,
                              pallas_cl_max=gpu.pallas_cl_max_opq, pallas_amask=None)
    alp = dataclasses.replace(gpu, pallas_panels=gpu.pallas_panels_alp,
                              pallas_cl_min=gpu.pallas_cl_min_alp,
                              pallas_cl_max=gpu.pallas_cl_max_alp,
                              pallas_amask=alpha_subset_amask(gpu),
                              sph_center=gpu.sph_center[:0], sph_radius=gpu.sph_radius[:0],
                              sph_obj=gpu.sph_obj[:0])
    return (v8m.make_hier_backend(opq, cfg, trace=trace),
            v8m.make_hier_backend(alp, cfg, trace=trace))


def wrap_backend_with_alpha(backend: TraceBackend, gpu: TorchScene,
                            cfg: RenderConfig, record: list | None = None,
                            plain: bool = False) -> TraceBackend:
    """The backend with alpha-tested closest and occlusion queries; the
    backend itself when the scene has no opacity map.  The result has no
    ``occluded_hinted`` and no ``occluded_multi`` (its occlusion is a ladder
    of closest traces), so the frame's hint chain turns off.  record: if a
    list, each ladder decision appends (query, rays that need the round),
    "closest" or "occluded".  With cfg.alpha_split, occlusion takes two
    phases where the split engages (see the module docstring); plain=True
    builds its subset backends on the plain twins, as the wrapped backend
    of make_hybrid_backend(..., plain=True) traces."""
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
    split = (cfg.alpha_split and sg_gpu.has_alpha_split and not sg_gpu.instanced
             and backend.perray_cull)
    if split:
        opq_backend, alp_backend = split_backends(sg_gpu, cfg, plain)
        alpha_row = face_row[sg_gpu.alpha_tri_id.long()]

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
            if not _need(rejected, "closest", record):
                break
            with record_function("alpha.round"):
                t_lo = torch.where(rejected, step_past(hit.t.detach()), t_lo)
                re = backend.closest(origins, dirs, torch.where(rejected, t_lo, BIG_T),
                                     torch.where(rejected, t_hi, -BIG_T), common=common)
                hit = _merge(rejected, re, hit)
                rejected = hit.hit & (alpha(hit, origins, dirs) < threshold)
        return hit

    def occluded(origins, dirs, t_min, t_max, common=None):
        if not split:
            return occlusion_ladder(backend, sg_gpu, cfg, origins, dirs, t_min, t_max,
                                    common, face_row, record)[0]
        r = origins.shape[0]
        t_lo = as_per_ray(t_min, r, origins.device)
        t_hi = as_per_ray(t_max, r, origins.device)
        occ_opq = opq_backend.occluded(origins, dirs, t_lo, t_hi, common=common)
        # Only the lanes phase 1 left unresolved walk the alpha subset.
        live = ~occ_opq & (t_hi > t_lo)
        occ_alp, _ = occlusion_ladder(alp_backend, sg_gpu, cfg, origins, dirs,
                                      torch.where(live, t_lo, BIG_T),
                                      torch.where(live, t_hi, -BIG_T), common, alpha_row, record)
        return occ_opq | occ_alp

    # occluded_multi is not forwarded: alpha-tested occlusion re-traces
    # closest hits, which the fused multi-segment path does not do.
    return TraceBackend(closest=closest, occluded=occluded,
                        num_tris=backend.num_tris, num_spheres=backend.num_spheres,
                        perray_cull=backend.perray_cull)


wrap_backend_with_alpha.syncs = 0
wrap_backend_with_alpha.rounds = 0
