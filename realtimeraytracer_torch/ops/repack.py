"""Build-time SAH re-packing of the sorted triangle order into tight
32-triangle subcluster groups for the v9 quarter kernel.

Counterpart of realtimeraytracer_tpu/ops/repack.py (``repack_slots_np``,
``build_q_panels_np``), kept here as the port's own NumPy copy: the JAX
module's package imports jax.

The traversal kernels chop the BVH-sorted triangle order into consecutive
32-triangle subclusters (scene/panels.py::pack_clusters_np).  A subcluster
that straddles a spatial break carries a fat box that passes the cull for
rays that need none of its triangles.  This module re-partitions the sorted
order (order is preserved; only the cut points move) into consecutive
groups of size [min_size, 32] by dynamic programming, minimizing the summed
box half-areas; ``lam`` adds a per-group penalty (in units of the median
full-window area) against splits whose pad lanes dilute 32-lane visits.
Groups smaller than 32 pad to the 32-lane boundary with degenerate
triangles at their group's box center: zero area (no intersection can
pass) and no box inflation.

Padding only shifts positions, so sorted_id = slot_id - pads_before(group):
the per-group offset table ``group_off`` lets the v9 kernel emit ids in the
original sorted space.
"""

from __future__ import annotations

import numpy as np

from realtimeraytracer_torch.scene.panels import CB, pack_clusters_np

GROUP = 32


def repack_slots_np(tmin: np.ndarray, tmax: np.ndarray,
                    min_size: int = 28, lam: float = 1.0):
    """DP re-partition of the sorted order into [min_size, 32]-sized
    consecutive groups minimizing summed box half-areas.

    tmin/tmax: (T, 3) per-triangle boxes in sorted order.  Returns (slots,
    n_groups): slots (n_groups*32,) int64 maps repacked slot -> sorted
    index, -1 for pad slots."""
    t = tmin.shape[0]
    if t == 0:
        return np.zeros((0,), np.int64), 0
    # hsa[s][i] = half-surface-area of the box of tris [i, i+s)
    hsa = np.full((GROUP + 1, t), np.inf)
    wmin = tmin.astype(np.float64).copy()
    wmax = tmax.astype(np.float64).copy()
    d = wmax - wmin
    hsa[1, :] = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
    for s in range(2, GROUP + 1):
        wmin = np.minimum(wmin[:-1], tmin[s - 1:])
        wmax = np.maximum(wmax[:-1], tmax[s - 1:])
        d = wmax - wmin
        hsa[s, :t - s + 1] = (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2]
                              + d[:, 2] * d[:, 0])
    full = hsa[GROUP, :t - GROUP + 1]
    lam_abs = lam * (np.median(full) if full.size else 0.0)

    cost = np.full(t + 1, np.inf)
    choice = np.zeros(t + 1, np.int32)
    cost[0] = 0.0
    sizes = range(min_size, GROUP + 1)
    for e in range(1, t + 1):
        best = np.inf
        bs = 0
        for s in sizes:
            if s <= e:
                c = cost[e - s] + hsa[s, e - s]
                if c < best:
                    best = c
                    bs = s
        if e < min_size:           # only reachable as the very first group
            best = hsa[e, 0]
            bs = e
        cost[e] = best + lam_abs
        choice[e] = bs

    groups = []
    e = t
    while e > 0:
        s = int(choice[e])
        groups.append((e - s, e))
        e -= s
    groups.reverse()
    slots = np.full(len(groups) * GROUP, -1, np.int64)
    for gi, (s, e) in enumerate(groups):
        slots[gi * GROUP: gi * GROUP + (e - s)] = np.arange(s, e)
    return slots, len(groups)


def build_q_panels_np(v0s: np.ndarray, v1s: np.ndarray, v2s: np.ndarray,
                      min_size: int = 28, lam: float = 1.0):
    """Repacked v9 coefficient panels + cull boxes + id-offset table.

    v0s/v1s/v2s: (T, 3) sorted triangle vertices.  Returns (coeff, cl_min,
    cl_max, group_off, slots): the pack_clusters_np layout over the
    repacked order; group_off (CBn*4,) int32 = pad slots before each
    32-lane group, so sorted_id = slot_id - group_off[slot // 32] (pad
    groups past the last real one carry the total pad count); slots
    (ng*32,) int64 maps repacked slot -> sorted id, -1 for pad lanes."""
    tmin = np.minimum(np.minimum(v0s, v1s), v2s)
    tmax = np.maximum(np.maximum(v0s, v1s), v2s)
    slots, ng = repack_slots_np(tmin, tmax, min_size, lam)
    pad = slots < 0
    idx = np.where(pad, 0, slots)
    rv0 = v0s[idx].astype(np.float32)
    rv1 = v1s[idx].astype(np.float32)
    rv2 = v2s[idx].astype(np.float32)
    # Degenerate pads at their group's box center: zero area and inside
    # the group box.
    g = np.arange(len(slots)) // GROUP
    gmin = np.full((ng, 3), np.inf)
    gmax = np.full((ng, 3), -np.inf)
    if (~pad).any():
        np.minimum.at(gmin, g[~pad], tmin[slots[~pad]])
        np.maximum.at(gmax, g[~pad], tmax[slots[~pad]])
    if pad.any():
        c = (((gmin + gmax) * 0.5)[g[pad]]).astype(np.float32)
        rv0[pad] = c
        rv1[pad] = c
        rv2[pad] = c
    coeff, cl_min, cl_max = pack_clusters_np(rv0, rv1, rv2)

    pads_in_group = np.bincount(g[pad], minlength=ng)
    group_off = np.zeros(ng, np.int64)
    group_off[1:] = np.cumsum(pads_in_group)[:-1]
    total_groups = coeff.shape[0] * (CB // GROUP)
    if total_groups > ng:
        group_off = np.concatenate([
            group_off,
            np.full(total_groups - ng, int(pads_in_group.sum()), np.int64),
        ])
    return coeff, cl_min, cl_max, group_off.astype(np.int32), slots
