"""Wide two-level traversal: dense cluster culling + Baldwin-Weber intersection.

Counterpart of realtimeraytracer_tpu/render/wide_backend.py (``WideData``,
``build_wide``, ``wide_closest``, ``wide_occluded``, ``make_wide_backend``),
which is the JAX package's ``"auto"`` route off the TPU.  Plain torch ops:
the JAX version is plain XLA, with no Pallas kernel.

  1. **Cluster culling:** the BVH-sorted triangles are blocked into
     clusters of ``cluster_size`` consecutive triangles (the scene's BVH
     order, padded with degenerate triangles that never hit).  Each tile of
     ``wide_tile`` rays bounds every cluster's entry distance with an
     interval-arithmetic slab test against the tile's ray bundle, and sorts
     the clusters by that bound (stable, as ``jnp.argsort``).
  2. **Ordered visits:** each visit step, every tile still active tests all
     its rays against its next cluster (Baldwin-Weber rows, precomputed per
     triangle).  A tile stops when its next cluster's entry bound exceeds
     its worst outstanding hit (closest) or when every ray is occluded;
     the loop stops at ``min(max_cluster_visits, clusters)`` visits, the
     cap, and may then drop hits: ``return_stats`` counts the tiles it cut
     (``cap_clipped``), with the steps taken and the cap.

The JAX version runs the visit loop in ``lax.while_loop`` over every tile
and lets XLA fuse the (tiles, TILE, K) loop nest.  Eager PyTorch would
materialise it, so the port differs in two ways that change no value:

  * a visit computes only the tiles active at that step (JAX computes the
    others under a mask that discards their results), in chunks of at most
    ``_LANES`` ray-triangle lanes, so that each float32 temporary stays
    within 256 MiB;
  * the loop's condition, JAX's ``any(pending)``, is one host read a visit
    step (the list of active tiles: a tile pending after a step is exactly
    a tile active at the next), at most ``min(max_cluster_visits, C)``
    a trace.  ``wide_closest.host_reads`` and ``wide_occluded.host_reads``
    count them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from realtimeraytracer_torch.config import RenderConfig
from realtimeraytracer_torch.ops import intersect
from realtimeraytracer_torch.ops.intersect import BIG_T, HitRecord, as_per_ray
from realtimeraytracer_torch.ops.vecmath import cross
from realtimeraytracer_torch.render.backends import (
    TraceBackend, _merge_sphere_hits, sphere_occluded, stop_gradient)
from realtimeraytracer_torch.scene.gpu_scene import TorchScene

# Ray-triangle lanes of one eager chunk of a visit (tiles x TILE x K): each
# float32 (tiles, TILE, K) temporary stays at 256 MiB, about five of them
# live at once.  The cluster entries are chunked to the same lane count.
_LANES = 1 << 26


class WideData(NamedTuple):
    cl_min: torch.Tensor    # (C, 3) cluster AABB lows
    cl_max: torch.Tensor    # (C, 3)
    bw_rows: torch.Tensor   # (C, 3*K, 3) per-tri rows [n; r1; r2] per cluster
    bw_offs: torch.Tensor   # (C, 3*K) row offsets [n.A; r1.A; r2.A]
    num_tris: int           # true (unpadded) triangle count


def build_wide(gpu: TorchScene, cluster_size: int) -> WideData:
    """Cluster boxes and Baldwin-Weber rows from the BVH-sorted soup;
    padding triangles are degenerate rows that never give a valid hit and
    leave the last cluster's box as its real triangles make it."""
    v0, v1, v2 = gpu.bvh_tri_v0, gpu.bvh_tri_v1, gpu.bvh_tri_v2
    t = v0.shape[0]
    k = cluster_size
    c = -(-t // k)
    pad = c * k - t
    v0p, v1p, v2p = (F.pad(x, (0, 0, 0, pad)) for x in (v0, v1, v2))
    e1 = v1p - v0p
    e2 = v2p - v0p
    n = cross(e1, e2)
    # Inverse of [e1 e2 n] by its adjugate; det = n.n since n = e1 x e2.
    det = (n * n).sum(-1, keepdim=True)
    ok = det > 1e-24
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    r1 = cross(e2, n) * inv_det
    r2 = cross(n, e1) * inv_det

    rows = torch.stack([n, r1, r2], dim=1)              # (T, 3, 3)
    offs = (rows * v0p[:, None, :]).sum(-1)             # (T, 3): [n.A, r1.A, r2.A]

    tmin = torch.minimum(torch.minimum(v0p, v1p), v2p).reshape(c, k, 3)
    tmax = torch.maximum(torch.maximum(v0p, v1p), v2p).reshape(c, k, 3)
    if pad:
        valid = (torch.arange(c * k, device=v0.device) < t).reshape(c, k, 1)
        tmin = torch.where(valid, tmin, BIG_T)
        tmax = torch.where(valid, tmax, -BIG_T)
    return WideData(cl_min=tmin.amin(dim=1), cl_max=tmax.amax(dim=1),
                    bw_rows=rows.reshape(c, 3 * k, 3), bw_offs=offs.reshape(c, 3 * k),
                    num_tris=t)


def _bw_tuv(o, d, rows, offs, k):
    """Baldwin-Weber (t, u, v, valid) of shape (A, TILE, K) for A tiles of
    rays o, d (A, TILE, 3) against their clusters' rows (A, 3K, 3) and
    offsets (A, 3K); component-wise products as in the JAX version."""
    rows = rows.reshape(rows.shape[0], k, 3, 3)
    offs = offs.reshape(offs.shape[0], 1, k, 3)

    def dot_rays(vec, row_idx):
        r = rows[:, :, row_idx, :]                      # (A, K, 3)
        return (vec[:, :, None, 0] * r[:, None, :, 0]
                + vec[:, :, None, 1] * r[:, None, :, 1]
                + vec[:, :, None, 2] * r[:, None, :, 2])  # (A, TILE, K)

    n_d = dot_rays(d, 0)
    den_ok = n_d.abs() > 1e-12
    t = torch.where(den_ok, (offs[..., 0] - dot_rays(o, 0)) / torch.where(den_ok, n_d, 1.0),
                    BIG_T)
    del n_d
    u = dot_rays(o, 1) + t * dot_rays(d, 1) - offs[..., 1]
    v = dot_rays(o, 2) + t * dot_rays(d, 2) - offs[..., 2]
    valid = den_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, valid


def _bw_single(o, d, rows, offs, k_best):
    """(u, v) of one selected triangle per ray: rows (A, 3K, 3) and offsets
    (A, 3K) gathered at k_best (A, TILE)."""
    a, tile = k_best.shape
    rows = rows.reshape(a, -1, 9)
    offs = offs.reshape(a, -1, 3)
    sel_rows = torch.gather(rows, 1, k_best[:, :, None].expand(a, tile, 9)).reshape(a, tile, 3, 3)
    sel_offs = torch.gather(offs, 1, k_best[:, :, None].expand(a, tile, 3))
    n, r1, r2 = sel_rows[:, :, 0, :], sel_rows[:, :, 1, :], sel_rows[:, :, 2, :]
    n_d = (n * d).sum(-1)
    den_ok = n_d.abs() > 1e-12
    t = torch.where(den_ok, (sel_offs[..., 0] - (n * o).sum(-1)) / torch.where(den_ok, n_d, 1.0),
                    BIG_T)
    u = (r1 * o).sum(-1) + t * (r1 * d).sum(-1) - sel_offs[..., 1]
    v = (r2 * o).sum(-1) + t * (r2 * d).sum(-1) - sel_offs[..., 2]
    return u, v


def _tile_rays(origins, dirs, tile):
    """Rays in (Ts, tile, 3) tiles, the last padded with copies of ray 0."""
    r = origins.shape[0]
    ts = -(-r // tile)
    pad = ts * tile - r
    if pad:
        origins = torch.cat([origins, origins[:1].expand(pad, 3)])
        dirs = torch.cat([dirs, dirs[:1].expand(pad, 3)])
    return origins.reshape(ts, tile, 3), dirs.reshape(ts, tile, 3), r, pad


def _cluster_entries(o, d, wd, tmin_p, tmax_p):
    """Conservative per-tile cluster entry lower bounds, (Ts, C): an
    interval-arithmetic slab test of the tile's ray bundle (origin box x
    direction interval) against each cluster box.  It never excludes a
    cluster that a ray of the tile could hit, and it returns a lower bound
    of the entry distance, which keeps the ordered-visit stop rule exact."""
    big = BIG_T
    c = wd.cl_min.shape[0]
    bmin = wd.cl_min[None]                              # (1, C, 3)
    bmax = wd.cl_max[None]

    def safe(x):
        return torch.where(x.abs() > 1e-12, x, 1e-12)

    def times(a_lo, a_hi, b_lo, b_hi):
        p1, p2 = a_lo * b_lo, a_lo * b_hi
        p3, p4 = a_hi * b_lo, a_hi * b_hi
        return (torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4)),
                torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4)))

    parts = []
    step = max(1, _LANES // (3 * c))
    for a in range(0, o.shape[0], step):
        oc, dc = o[a:a + step], d[a:a + step]
        o_lo = oc.amin(dim=1)[:, None, :]               # (Ts, 1, 3)
        o_hi = oc.amax(dim=1)[:, None, :]
        d_lo = dc.amin(dim=1)[:, None, :]
        d_hi = dc.amax(dim=1)[:, None, :]
        # Reciprocal interval of the direction, per axis.
        pos = d_lo > 1e-12
        neg = d_hi < -1e-12
        inv_lo = torch.where(pos, 1.0 / safe(d_hi), torch.where(neg, 1.0 / safe(d_hi), -big))
        inv_hi = torch.where(pos, 1.0 / safe(d_lo), torch.where(neg, 1.0 / safe(d_lo), big))
        # t0 = (bmin - o) * inv, t1 = (bmax - o) * inv, as intervals per axis.
        t0_lo, t0_hi = times(bmin - o_hi, bmin - o_lo, inv_lo, inv_hi)
        t1_lo, t1_hi = times(bmax - o_hi, bmax - o_lo, inv_lo, inv_hi)
        tn_lo = torch.minimum(t0_lo, t1_lo).amax(dim=-1)  # (Ts, C)
        tf_hi = torch.maximum(t0_hi, t1_hi).amin(dim=-1)
        tmin_lb = tmin_p[a:a + step].amin(dim=1)[:, None]
        tmax_ub = tmax_p[a:a + step].amax(dim=1)[:, None]
        possible = (tn_lo <= tf_hi) & (tf_hi >= tmin_lb) & (tn_lo <= tmax_ub)
        parts.append(torch.where(possible, tn_lo.clamp_min(0.0), big))
    return torch.cat(parts)


def _prepare(gpu, cfg, origins, dirs, t_min, t_max, wd):
    """Tiles, padded intervals and each tile's clusters sorted by entry."""
    wd = wd if wd is not None else build_wide(gpu, cfg.cluster_size)
    tile = cfg.wide_tile
    r, dev = origins.shape[0], origins.device
    t_min = as_per_ray(t_min, r, dev)
    t_max = as_per_ray(t_max, r, dev)
    o, d, r_orig, pad = _tile_rays(origins, dirs, tile)
    if pad:
        t_min = torch.cat([t_min, torch.full((pad,), BIG_T, device=dev)])
        t_max = torch.cat([t_max, torch.full((pad,), -BIG_T, device=dev)])
    ts = o.shape[0]
    tmin_p = t_min.reshape(ts, tile)
    tmax_p = t_max.reshape(ts, tile)
    entry = _cluster_entries(o, d, wd, tmin_p, tmax_p)
    entry_sorted, order = torch.sort(entry, dim=1, stable=True)
    return wd, o, d, r_orig, tmin_p, tmax_p, entry_sorted, order


def _chunks(sel: torch.Tensor, tile: int, k: int):
    return sel.split(max(1, _LANES // (tile * k)))


def wide_closest(gpu: TorchScene, cfg: RenderConfig, origins, dirs, t_min, t_max,
                 return_stats: bool = False, wd: WideData | None = None):
    """Closest hits (t <= min(best, t_max)) by ordered cluster visits;
    with return_stats, (hit, {"cap_clipped", "steps", "cap"}).  wd: the
    scene's WideData when the caller built it once (make_wide_backend)."""
    k = cfg.cluster_size
    wd, o, d, r_orig, tmin_p, tmax_p, entry_sorted, order = _prepare(
        gpu, cfg, origins, dirs, t_min, t_max, wd)
    c = wd.cl_min.shape[0]
    ts, tile = tmin_p.shape
    dev = o.device
    max_visits = min(cfg.max_cluster_visits, c)
    k_range = torch.arange(k, device=dev)

    best_t = torch.full((ts, tile), BIG_T, device=dev)
    best_p = torch.full((ts, tile), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros((ts, tile), device=dev)
    best_v = torch.zeros((ts, tile), device=dev)
    pending = torch.ones(ts, dtype=torch.bool, device=dev)
    steps = 0
    while steps < max_visits:
        ent = entry_sorted[:, steps]
        worst = torch.minimum(best_t, tmax_p).amax(dim=1)
        active = (ent < BIG_T) & (ent <= worst)
        sel = active.nonzero()[:, 0]
        wide_closest.host_reads += 1
        if not sel.numel():
            # Nothing was pending after the last step (JAX's loop condition
            # fails), or, on the first step, which JAX always runs, nothing
            # is pending after it.
            if steps == 0:
                steps, pending = 1, active
            break
        cid_all = order[:, steps]
        for part in _chunks(sel, tile, k):
            cid = cid_all[part]
            rows, offs = wd.bw_rows[cid], wd.bw_offs[cid]
            last_valid = (wd.num_tris - cid * k - 1).clamp_max(k - 1)
            oc, dc, bt = o[part], d[part], best_t[part]
            t, _, _, valid = _bw_tuv(oc, dc, rows, offs, k)
            ok = (valid & (t >= tmin_p[part][..., None])
                  & (t <= torch.minimum(bt, tmax_p[part])[..., None])
                  & (k_range <= last_valid[:, None, None]))
            t = torch.where(ok, t, BIG_T)
            del ok, valid
            kb = t.argmin(dim=2)
            tb = t.gather(2, kb[..., None])[..., 0]
            del t
            better = tb < bt
            ub, vb = _bw_single(oc, dc, rows, offs, kb)
            best_t[part] = torch.where(better, tb, bt)
            best_p[part] = torch.where(better, cid[:, None] * k + kb, best_p[part])
            best_u[part] = torch.where(better, ub, best_u[part])
            best_v[part] = torch.where(better, vb, best_v[part])
        steps += 1
        nxt = entry_sorted[:, min(steps, c - 1)]
        worst = torch.minimum(best_t, tmax_p).amax(dim=1)
        pending = active & (steps < c) & (nxt < BIG_T) & (nxt <= worst)

    best_t = best_t.reshape(-1)[:r_orig]
    best_p = best_p.reshape(-1)[:r_orig]
    orig = torch.where(best_p >= 0, gpu.bvh_tri_id[best_p.clamp_min(0)], -1)
    hit = HitRecord(t=best_t, prim_id=orig.to(torch.int32),
                    u=best_u.reshape(-1)[:r_orig], v=best_v.reshape(-1)[:r_orig])
    if return_stats:
        # Tiles still pending at the exit had candidate clusters when the
        # cap cut them: their hits may be missing.
        return hit, {"cap_clipped": pending.sum(dtype=torch.int32), "steps": steps,
                     "cap": max_visits}
    return hit


def wide_occluded(gpu: TorchScene, cfg: RenderConfig, origins, dirs, t_min, t_max,
                  return_stats: bool = False, wd: WideData | None = None):
    """Any hit with t in [t_min, t_max) by ordered cluster visits; a tile
    stops once every ray is occluded.  return_stats and wd as wide_closest."""
    k = cfg.cluster_size
    wd, o, d, r_orig, tmin_p, tmax_p, entry_sorted, order = _prepare(
        gpu, cfg, origins, dirs, t_min, t_max, wd)
    c = wd.cl_min.shape[0]
    ts, tile = tmin_p.shape
    dev = o.device
    max_visits = min(cfg.max_cluster_visits, c)
    k_range = torch.arange(k, device=dev)

    occ = torch.zeros((ts, tile), dtype=torch.bool, device=dev)
    pending = torch.ones(ts, dtype=torch.bool, device=dev)
    steps = 0
    while steps < max_visits:
        ent = entry_sorted[:, steps]
        active = (ent < BIG_T) & (~occ).any(dim=1)
        sel = active.nonzero()[:, 0]
        wide_occluded.host_reads += 1
        if not sel.numel():
            if steps == 0:
                steps, pending = 1, active
            break
        cid_all = order[:, steps]
        for part in _chunks(sel, tile, k):
            cid = cid_all[part]
            last_valid = (wd.num_tris - cid * k - 1).clamp_max(k - 1)
            t, _, _, ok = _bw_tuv(o[part], d[part], wd.bw_rows[cid], wd.bw_offs[cid], k)
            hit = (ok & (t >= tmin_p[part][..., None]) & (t < tmax_p[part][..., None])
                   & (k_range <= last_valid[:, None, None]))
            del t, ok
            occ[part] |= hit.any(dim=2)
        steps += 1
        nxt = entry_sorted[:, min(steps, c - 1)]
        pending = active & (steps < c) & (nxt < BIG_T) & (~occ).any(dim=1)

    occ_flat = occ.reshape(-1)[:r_orig]
    if return_stats:
        return occ_flat, {"cap_clipped": pending.sum(dtype=torch.int32), "steps": steps,
                          "cap": max_visits}
    return occ_flat


wide_closest.host_reads = 0
wide_occluded.host_reads = 0


def make_wide_backend(gpu: TorchScene, cfg: RenderConfig) -> TraceBackend:
    """The "wide" backend: straight-through gradients like the other
    traversal backends (the traces take detached inputs), the analytic
    spheres merged in differentiably.  The clusters are built once."""
    num_tris, num_spheres = gpu.num_tris, gpu.num_spheres
    sg_gpu = gpu.detach()
    wd = build_wide(sg_gpu, cfg.cluster_size)

    def closest(origins, dirs, t_min, t_max, common=None):
        hit = wide_closest(sg_gpu, cfg, *stop_gradient(origins, dirs, t_min, t_max), wd=wd)
        if num_spheres:
            sph = intersect.intersect_spheres(
                origins, dirs, gpu.sph_center, gpu.sph_radius, t_min, t_max)
            hit = _merge_sphere_hits(hit, sph, num_tris)
        return hit

    def occluded(origins, dirs, t_min, t_max, common=None):
        occ = wide_occluded(sg_gpu, cfg, *stop_gradient(origins, dirs, t_min, t_max), wd=wd)
        return sphere_occluded(gpu, occ, origins, dirs, t_min, t_max)

    return TraceBackend(closest=closest, occluded=occluded,
                        num_tris=num_tris, num_spheres=num_spheres)
