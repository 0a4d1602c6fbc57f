"""Baldwin-Weber coefficient panels for the traversal kernels.

Counterpart of realtimeraytracer_tpu/render/pallas_backend.py::
pack_clusters_np (host NumPy, run once at scene compile), its in-graph twin
pack_clusters (tensors on any device, for the device-side refit of
ops/refit.py) and their layout constants, RESIDENT_CB included.  The port
keeps them in the scene package because the JAX module that holds them
imports Pallas.
"""

from __future__ import annotations

import numpy as np
import torch

from realtimeraytracer_torch.ops.intersect import BIG_T

TILE = 128          # rays per tile
CB = 128            # triangles per visit block
SUBK = 32           # triangles per cull subcluster (4 boxes per block)
CROWS = 12          # coefficient rows per block
# Coefficient blocks up to which the scene carries the v9 repacked panels,
# the hybrid route sends coherent closest traces to v9 and v8 takes shadow
# hints: the JAX package's VMEM-residency limit, kept because it decides
# the backend contract (the CUDA kernels read the table from global memory
# at every size).
RESIDENT_CB = 1024


def pack_clusters_np(tv0, tv1, tv2):
    """(T, 3) BVH-sorted triangle vertices -> (coeff, cl_min, cl_max):
    coeff (CBn, 12, 128) rows [n | -n.A | r1 | -r1.A | r2 | -r2.A] per
    128-triangle block (lanes = triangles); cl_min/cl_max (CBn*4, 3)
    SUBK-granular subcluster AABBs for the cull."""
    t = tv0.shape[0]
    cb = -(-t // CB)
    pad = cb * CB - t

    def padv(x):
        x = np.asarray(x, np.float32)
        return np.concatenate([x, np.zeros((pad, 3), np.float32)]) if pad else x

    v0, v1, v2 = padv(tv0), padv(tv1), padv(tv2)
    e1, e2 = v1 - v0, v2 - v0
    n = np.cross(e1, e2)
    det = (n * n).sum(-1, keepdims=True)
    inv = np.where(det > 1e-24, 1.0 / np.where(det > 1e-24, det, 1.0), 0.0)
    r1 = np.cross(e2, n) * inv
    r2 = np.cross(n, e1) * inv

    coeff = np.zeros((cb, CROWS, CB), np.float32)
    for rows, base in [(n, 0), (r1, 4), (r2, 8)]:
        offs = (rows * v0).sum(-1)
        coeff[:, base + 0] = rows[:, 0].reshape(cb, CB)
        coeff[:, base + 1] = rows[:, 1].reshape(cb, CB)
        coeff[:, base + 2] = rows[:, 2].reshape(cb, CB)
        coeff[:, base + 3] = -offs.reshape(cb, CB)

    c32 = cb * (CB // SUBK)
    tmin = np.minimum(np.minimum(v0, v1), v2).reshape(c32, SUBK, 3)
    tmax = np.maximum(np.maximum(v0, v1), v2).reshape(c32, SUBK, 3)
    if pad:
        valid = (np.arange(cb * CB) < t).reshape(c32, SUBK, 1)
        tmin = np.where(valid, tmin, np.float32(BIG_T))
        tmax = np.where(valid, tmax, np.float32(-BIG_T))
    return coeff, tmin.min(1).astype(np.float32), tmax.max(1).astype(np.float32)


def pack_clusters(v0, v1, v2):
    """pack_clusters_np on (T, 3) tensors of triangles in BVH-sorted order,
    on their device: (coeff, cl_min, cl_max) of the same layout."""
    t = v0.shape[0]
    cb = -(-t // CB)
    pad = cb * CB - t
    if pad:
        v0, v1, v2 = (torch.cat([x, x.new_zeros((pad, 3))]) for x in (v0, v1, v2))
    e1, e2 = v1 - v0, v2 - v0
    n = torch.linalg.cross(e1, e2)
    det = (n * n).sum(-1, keepdim=True)
    inv = torch.where(det > 1e-24, 1.0 / torch.where(det > 1e-24, det, 1.0), 0.0)
    r1 = torch.linalg.cross(e2, n) * inv
    r2 = torch.linalg.cross(n, e1) * inv
    parts = []
    for rows in (n, r1, r2):
        parts += [rows[:, 0], rows[:, 1], rows[:, 2], -(rows * v0).sum(-1)]
    coeff = torch.stack(parts).reshape(CROWS, cb, CB).permute(1, 0, 2).contiguous()

    c32 = cb * (CB // SUBK)
    tmin = torch.minimum(torch.minimum(v0, v1), v2).reshape(c32, SUBK, 3)
    tmax = torch.maximum(torch.maximum(v0, v1), v2).reshape(c32, SUBK, 3)
    if pad:
        valid = (torch.arange(cb * CB, device=v0.device) < t).reshape(c32, SUBK, 1)
        tmin = torch.where(valid, tmin, BIG_T)
        tmax = torch.where(valid, tmax, -BIG_T)
    return coeff, tmin.amin(dim=1), tmax.amax(dim=1)
