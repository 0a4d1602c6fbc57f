"""Stackless skip-link BVH traversal: the lane traversal.

Counterpart of realtimeraytracer_tpu/render/attic/bvh_backend.py
(``_ray_aabb``, ``_leaf_test``, ``traverse_closest``,
``traverse_occluded``, ``make_bvh_backend``).  Every ray advances one node
a step, in lock-step: its state is its DFS node index; on a box hit it
descends (node + 1), otherwise it follows the node's skip link; a leaf
tests its consecutive BVH-sorted triangles and then follows its skip
link.  The loop ends when every ray has passed the last node or after
``cfg.max_traversal_steps`` steps, the cap, which may drop hits:
``return_stats`` counts the rays it cut (``cap_clipped``), with the steps
taken and the cap.

JAX's ``lax.while_loop`` tests ``any(node < N)`` before every step; the
port reads that test on the host once every ``_CHECK`` steps and counts on
the device the steps at which some ray was still in the tree, which is
JAX's step count: a step after the last ray has left changes nothing.
"""

from __future__ import annotations

import torch

from realtimeraytracer_torch.config import RenderConfig
from realtimeraytracer_torch.ops import intersect
from realtimeraytracer_torch.ops.intersect import BIG_T, HitRecord, as_per_ray
from realtimeraytracer_torch.render.backends import (
    TraceBackend, _merge_sphere_hits, sphere_occluded, stop_gradient)
from realtimeraytracer_torch.scene.gpu_scene import TorchScene

# Steps between two host reads of the loop's condition.
_CHECK = 16


def _ray_aabb(o, inv_d, bmin, bmax, t_lo, t_hi):
    """Slab test; true where the box overlaps [t_lo, t_hi]."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tn = torch.minimum(t0, t1).amax(dim=-1)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    return (tn <= tf) & (tf >= t_lo) & (tn <= t_hi)


def _leaf_test(gpu: TorchScene, leaf_first, leaf_count, o, d, leaf_size, t_lo, t_hi):
    """Each ray against up to leaf_size consecutive sorted triangles:
    (t, sorted id, u, v) of its best hit in the leaf (t BIG_T, id -1 on a
    miss); ties go to the first triangle."""
    num = gpu.bvh_tri_v0.shape[0]
    offs = torch.arange(leaf_size, device=o.device)[None, :]      # (1, L)
    ids = (leaf_first[:, None] + offs).clamp(0, num - 1)           # (R, L)
    in_leaf = offs < leaf_count[:, None]
    t, u, v, ok = intersect.ray_triangle(o[:, None, :], d[:, None, :], gpu.bvh_tri_v0[ids],
                                         gpu.bvh_tri_v1[ids], gpu.bvh_tri_v2[ids])
    ok = ok & in_leaf & (t >= t_lo[:, None]) & (t <= t_hi[:, None])
    t = torch.where(ok, t, BIG_T)
    j = t.argmin(dim=1, keepdim=True)
    tb = t.gather(1, j)[:, 0]
    sid = torch.where(tb < BIG_T, ids.gather(1, j)[:, 0], -1)
    return tb, sid, u.gather(1, j)[:, 0], v.gather(1, j)[:, 0]


def _inv_dirs(dirs):
    """1 / d, and a large reciprocal of d's sign where |d| <= 1e-12: 2e12
    for d > 0 and 1e12 for d = 0 as in the JAX package, -2e12 for d < 0.
    JAX's sign(d) * 1e12 + 1e12 is 0 for d in [-1e-12, 0), so such a ray
    misses every box it enters after t = 0 (a camera ray of a frame's
    centre column has |d.x| ~ 1e-17; ROADMAP queue C)."""
    tiny = torch.where(dirs < 0, -2e12, torch.sign(dirs) * 1e12 + 1e12)
    return torch.where(dirs.abs() > 1e-12, 1.0 / dirs, tiny)


def _walk(n_nodes: int, cap: int, node: torch.Tensor, body, counter) -> tuple[int, torch.Tensor]:
    """Run body(active) until no ray is in the tree or for cap steps;
    returns (JAX's step count, the final node of each ray)."""
    steps = torch.zeros((), dtype=torch.int64, device=node.device)
    it = taken = 0
    while it < cap:
        active = node < n_nodes
        steps += active.any()
        node = body(node, active)
        it += 1
        if it % _CHECK == 0 or it == cap:
            counter.host_reads += 1
            taken = int(steps)
            if taken < it:
                break
    return taken, node


def traverse_closest(gpu: TorchScene, cfg: RenderConfig, origins, dirs, t_min, t_max,
                     return_stats: bool = False):
    """Closest hits by the skip-link walk, boxes pruned against the
    running best t; with return_stats, (hit, {"cap_clipped", "steps",
    "cap"})."""
    r, dev = origins.shape[0], origins.device
    n_nodes = gpu.bvh_node_min.shape[0]
    leaf_size = max(cfg.bvh_leaf_size, 1)  # must match the compile-time build
    inv_d = _inv_dirs(dirs)
    tmin_v = as_per_ray(t_min, r, dev)
    t_max = as_per_ray(t_max, r, dev)
    best_t = torch.full((r,), BIG_T, device=dev)
    best_p = torch.full((r,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros(r, device=dev)
    best_v = torch.zeros(r, device=dev)

    def body(node, active):
        nc = node.clamp(0, n_nodes - 1)
        count = gpu.bvh_node_count[nc]
        t_hi = torch.minimum(best_t, t_max)
        box_hit = _ray_aabb(origins, inv_d, gpu.bvh_node_min[nc], gpu.bvh_node_max[nc],
                            tmin_v, t_hi) & active
        is_leaf = (count > 0) & box_hit
        lt, lp, lu, lv = _leaf_test(gpu, gpu.bvh_node_first[nc], torch.where(is_leaf, count, 0),
                                    origins, dirs, leaf_size, tmin_v, t_hi)
        better = is_leaf & (lt < best_t)
        best_t.copy_(torch.where(better, lt, best_t))
        best_p.copy_(torch.where(better, lp, best_p))
        best_u.copy_(torch.where(better, lu, best_u))
        best_v.copy_(torch.where(better, lv, best_v))
        nxt = torch.where(box_hit & (count == 0), node + 1, gpu.bvh_node_skip[nc])
        return torch.where(active, nxt, node)

    node = torch.zeros(r, dtype=torch.int64, device=dev)
    steps, node = _walk(n_nodes, cfg.max_traversal_steps, node, body, traverse_closest)
    # Sorted ids back to the soup's triangle ids.
    orig = torch.where(best_p >= 0, gpu.bvh_tri_id[best_p.clamp_min(0)], -1)
    hit = HitRecord(t=best_t, prim_id=orig.to(torch.int32), u=best_u, v=best_v)
    if return_stats:
        # Rays still in the tree at the exit were cut by the cap.
        return hit, {"cap_clipped": (node < n_nodes).sum(dtype=torch.int32), "steps": steps,
                     "cap": cfg.max_traversal_steps}
    return hit


def traverse_occluded(gpu: TorchScene, cfg: RenderConfig, origins, dirs, t_min, t_max,
                      return_stats: bool = False):
    """Any hit in [t_min, t_max) by the skip-link walk; a ray that finds
    one leaves the tree at once.  return_stats as traverse_closest."""
    r, dev = origins.shape[0], origins.device
    n_nodes = gpu.bvh_node_min.shape[0]
    leaf_size = cfg.bvh_leaf_size
    inv_d = _inv_dirs(dirs)
    t_max = as_per_ray(t_max, r, dev)
    tmin_v = as_per_ray(t_min, r, dev)
    occ = torch.zeros(r, dtype=torch.bool, device=dev)

    def body(node, active):
        nc = node.clamp(0, n_nodes - 1)
        count = gpu.bvh_node_count[nc]
        box_hit = _ray_aabb(origins, inv_d, gpu.bvh_node_min[nc], gpu.bvh_node_max[nc],
                            tmin_v, t_max) & active
        is_leaf = (count > 0) & box_hit
        lt, lp, _, _ = _leaf_test(gpu, gpu.bvh_node_first[nc], torch.where(is_leaf, count, 0),
                                  origins, dirs, leaf_size, tmin_v, t_max)
        found = is_leaf & (lp >= 0) & (lt < t_max)
        occ.logical_or_(found)
        nxt = torch.where(box_hit & (count == 0), node + 1, gpu.bvh_node_skip[nc])
        nxt = torch.where(found, n_nodes, nxt)      # early out: park at the sentinel
        return torch.where(active, nxt, node)

    node = torch.zeros(r, dtype=torch.int64, device=dev)
    steps, node = _walk(n_nodes, cfg.max_traversal_steps, node, body, traverse_occluded)
    if return_stats:
        return occ, {"cap_clipped": (node < n_nodes).sum(dtype=torch.int32), "steps": steps,
                     "cap": cfg.max_traversal_steps}
    return occ


traverse_closest.host_reads = 0
traverse_occluded.host_reads = 0


def make_bvh_backend(gpu: TorchScene, cfg: RenderConfig) -> TraceBackend:
    """The lane backend, with straight-through gradients: the traces take
    detached inputs and render/surface.py recomputes the continuous hit
    quantities from the selected primitive; the spheres stay
    differentiable.  Not in make_backend's registry, as in the JAX
    package."""
    num_tris, num_spheres = gpu.num_tris, gpu.num_spheres
    sg_gpu = gpu.detach()

    def closest(origins, dirs, t_min, t_max, common=None):
        hit = traverse_closest(sg_gpu, cfg, *stop_gradient(origins, dirs, t_min, t_max))
        if num_spheres:
            sph = intersect.intersect_spheres(
                origins, dirs, gpu.sph_center, gpu.sph_radius, t_min, t_max)
            hit = _merge_sphere_hits(hit, sph, num_tris)
        return hit

    def occluded(origins, dirs, t_min, t_max, common=None):
        occ = traverse_occluded(sg_gpu, cfg, *stop_gradient(origins, dirs, t_min, t_max))
        return sphere_occluded(gpu, occ, origins, dirs, t_min, t_max)

    return TraceBackend(closest=closest, occluded=occluded,
                        num_tris=num_tris, num_spheres=num_spheres)
