"""Object and instance transforms with the device-side BVH refit.

Counterpart of realtimeraytracer_tpu/ops/refit.py (``subtree_ranges``,
``_range_reduce``, ``refit_nodes``, ``apply_transforms``,
``identity_transforms``, ``translate``, ``apply_instance_transforms``): the
reference's TLAS::updateTransform and refit (tlas.cppm:60-67, 151-207), so
that animation needs no host rebuild.  Here they are plain PyTorch
functions on the scene's tensors, on its device; each returns a new
TorchScene and leaves its input as it was.  Their gradients are not ported
(ROADMAP A6).

Two forms of motion:
  * ``apply_transforms``: a per-object (O, 4, 4) transform table on a
    world-space (non-instanced) scene.  Vertices and normals move by their
    object ids (vert_obj), light triangles by lt_obj, sphere centres by
    sph_obj (radii scale by |det R|^(1/3): a non-uniform scale of a sphere
    is approximated by the volume-preserving uniform factor), the
    BVH-ordered soup by face_obj.  Node boxes are refit exactly by
    range-min/max over each node's contiguous sorted-triangle range
    (bvh_node_tri_start/end): the topology stays, so traversal stays
    correct for any motion and only its quality degrades, as with a
    hardware refit.  The v7/v8 coefficient panels are repacked
    (scene/panels.py::pack_clusters); the SAH-repacked v9 panels were
    built over the old geometry and are dropped (the v9 route then
    traces the repacked v7 panels).
  * ``apply_instance_transforms``: new (I, 4, 4) mesh-to-world matrices
    of a shared-geometry scene.  Geometry stays in mesh space, so only the
    per-instance rows and the (instance, super) world boxes change.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from realtimeraytracer_torch.ops.intersect import BIG_T
from realtimeraytracer_torch.scene.gpu_scene import TorchScene


def subtree_ranges(node_first: np.ndarray, node_count: np.ndarray,
                   node_skip: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-node [start, end) sorted-triangle range (host, once at compile).

    Every node of the DFS pre-order skip-link BVH covers a contiguous range
    of the sorted triangles; leaves carry (first, count) and an internal
    node is the union of its two children (a reverse sweep: children follow
    their parent in pre-order)."""
    n = len(node_first)
    start = np.zeros(n, np.int32)
    end = np.zeros(n, np.int32)
    for i in range(n - 1, -1, -1):
        if node_count[i] > 0:
            start[i] = node_first[i]
            end[i] = node_first[i] + node_count[i]
        else:
            left = i + 1
            right = node_skip[left]
            start[i] = start[left]
            end[i] = end[right]
    return start, end


def _range_reduce(values: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
                  op) -> torch.Tensor:
    """Range-min or -max of values (T, 3) over each [start, end) (N,) with
    1 <= end - start <= T, by a sparse table: ceil(log2 T) + 1 levels of
    strided reductions, then two gathers per query, the overlapping
    power-of-two blocks [s, s + 2^k) and [e - 2^k, e)."""
    t = values.shape[0]
    levels = [values]
    span = 1
    while span < t:
        prev = levels[-1]
        levels.append(op(prev, torch.cat([prev[span:], prev[-span:]])))
        span *= 2
    table = torch.stack(levels)                          # (K+1, T, 3)
    length = torch.clamp_min(end - start, 1)
    # floor(log2(length)), exact for integer lengths (the +0.5 keeps exact
    # powers of two from rounding down a level in float32).
    ks = torch.log2(length.to(torch.float32) + 0.5).to(torch.int64)
    start = start.long()
    lo = table[ks, start]
    hi = table[ks, torch.clamp_min(end.long() - (1 << ks), 0)]
    return op(lo, hi)


def refit_nodes(gpu: TorchScene, tv0, tv1, tv2):
    """Exact node boxes (node_min, node_max) of moved BVH-ordered triangles."""
    tri_min = torch.minimum(torch.minimum(tv0, tv1), tv2)
    tri_max = torch.maximum(torch.maximum(tv0, tv1), tv2)
    return (_range_reduce(tri_min, gpu.bvh_node_tri_start, gpu.bvh_node_tri_end,
                          torch.minimum),
            _range_reduce(tri_max, gpu.bvh_node_tri_start, gpu.bvh_node_tri_end,
                          torch.maximum))


def apply_transforms(gpu: TorchScene, obj_mats) -> TorchScene:
    """Apply a per-object (O, 4, 4) transform table to a compiled scene.
    The transforms compose on top of what the compile baked (identity
    rows leave their objects where they are)."""
    if gpu.instanced:
        raise ValueError("apply_transforms moves world-space scenes; move the "
                         "instances of a shared-geometry scene with "
                         "apply_instance_transforms")
    if gpu.vert_obj is None:
        raise ValueError("the scene carries no per-vertex object ids (vert_obj)")
    obj_mats = torch.as_tensor(obj_mats, dtype=torch.float32, device=gpu.device)
    rot = obj_mats[:, :3, :3]
    trn = obj_mats[:, :3, 3]
    nrm_mat = torch.linalg.inv(rot).transpose(1, 2)      # inverse-transpose

    def xf_points(pts, obj_ids):
        ids = obj_ids.long()
        return torch.einsum("pij,pj->pi", rot[ids], pts) + trn[ids]

    def xf_normals(nrm, obj_ids):
        out = torch.einsum("pij,pj->pi", nrm_mat[obj_ids.long()], nrm)
        return out / torch.clamp_min(torch.linalg.norm(out, dim=-1, keepdim=True), 1e-20)

    updates = dict(vertices=xf_points(gpu.vertices, gpu.vert_obj),
                   normals=xf_normals(gpu.normals, gpu.vert_obj))
    if gpu.num_light_tris and gpu.lt_obj is not None:
        updates.update(lt_v0=xf_points(gpu.lt_v0, gpu.lt_obj),
                       lt_v1=xf_points(gpu.lt_v1, gpu.lt_obj),
                       lt_v2=xf_points(gpu.lt_v2, gpu.lt_obj))
    if gpu.num_spheres:
        scale = torch.linalg.det(rot).abs() ** (1.0 / 3.0)
        updates.update(sph_center=xf_points(gpu.sph_center, gpu.sph_obj),
                       sph_radius=gpu.sph_radius * scale[gpu.sph_obj.long()])
    if not gpu.has_bvh:
        return dataclasses.replace(gpu, **updates)

    fo = gpu.face_obj                                    # already BVH-ordered
    tv0, tv1, tv2 = (xf_points(v, fo) for v in (gpu.bvh_tri_v0, gpu.bvh_tri_v1,
                                                  gpu.bvh_tri_v2))
    updates.update(bvh_tri_v0=tv0, bvh_tri_v1=tv1, bvh_tri_v2=tv2)
    if gpu.bvh_node_tri_start is not None:
        updates["bvh_node_min"], updates["bvh_node_max"] = refit_nodes(gpu, tv0, tv1, tv2)
    out = dataclasses.replace(gpu, **updates)
    if gpu.pallas_panels is not None:
        from realtimeraytracer_torch.scene.panels import pack_clusters

        panels, lo, hi = pack_clusters(out)
        out = dataclasses.replace(out, pallas_panels=panels, pallas_cl_min=lo,
                                  pallas_cl_max=hi)
    if gpu.q_panels is not None:
        # Their masks go with them (the slot order they follow is gone).
        out = dataclasses.replace(out, q_panels=None, q_cl_min=None, q_cl_max=None,
                                  q_group_off=None, q_amask=None)
    return out


def identity_transforms(gpu: TorchScene) -> torch.Tensor:
    """(O, 4, 4) identity table sized to the scene's object count."""
    o = gpu.obj_color.shape[0]
    return torch.eye(4, dtype=torch.float32, device=gpu.device).expand(o, 4, 4).clone()


def translate(mat_table: torch.Tensor, obj_id: int, offset) -> torch.Tensor:
    """A copy of the table with object obj_id translated by offset."""
    out = mat_table.clone()
    out[obj_id, :3, 3] += torch.as_tensor(offset, dtype=out.dtype, device=out.device)
    return out


def apply_instance_transforms(gpu: TorchScene, transforms) -> TorchScene:
    """Move the instances of a shared-geometry scene.

    transforms: (I, 4, 4) mesh-to-world matrices, in the compile's instance
    order (lights' identity rows first).  Only the per-instance rows
    (inst_fwd, inst_inv) and the (instance, super) world boxes
    (pair_panel) change: no vertex moves, no panel is repacked.  Lights and
    spheres are not instances; move those with apply_transforms on a baked
    scene."""
    if not gpu.instanced:
        raise ValueError("apply_instance_transforms needs an instanced scene "
                         "(compiled with MeshInstance objects)")
    t = torch.as_tensor(transforms, dtype=torch.float32, device=gpu.device)
    fwd = torch.cat([t[:, :3, :3].reshape(-1, 9), t[:, :3, 3]], dim=1)
    inv_m = torch.linalg.inv(t)
    inv = torch.cat([inv_m[:, :3, :3].reshape(-1, 9), inv_m[:, :3, 3]], dim=1)

    # World box per pair: the 8 transformed corners of its mesh-space box.
    pm = gpu.pair_mesh_aabb                              # (P, 6)
    pinst = gpu.pair_tab[:, 0].long().clamp(0, t.shape[0] - 1)
    pt = t[pinst]                                        # (P, 4, 4)
    corners = torch.stack([
        torch.stack([pm[:, 3 * (i & 1)], pm[:, 1 + 3 * ((i >> 1) & 1)],
                     pm[:, 2 + 3 * ((i >> 2) & 1)]], dim=-1)
        for i in range(8)], dim=1)                       # (P, 8, 3)
    wc = torch.einsum("pij,pcj->pci", pt[:, :3, :3], corners) + pt[:, None, :3, 3]
    valid = (gpu.pair_tab[:, 3] == 1)[:, None]
    lo = torch.where(valid, wc.amin(dim=1), BIG_T)
    hi = torch.where(valid, wc.amax(dim=1), -BIG_T)
    pp = gpu.pair_panel.shape[0]
    panel = torch.cat([lo.reshape(pp, 128, 3).transpose(1, 2),
                       hi.reshape(pp, 128, 3).transpose(1, 2),
                       lo.new_zeros((pp, 2, 128))], dim=1)
    return dataclasses.replace(gpu, inst_fwd=fwd, inst_inv=inv, pair_panel=panel.contiguous())
