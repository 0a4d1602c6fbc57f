"""LBVH build: Morton-ordered bounding volume hierarchy with skip links.

The LBVH build, the host refit and the invariant check of
realtimeraytracer_tpu/ops/bvh.py (host NumPy, unchanged): the JAX package
cannot be imported without jax, so the port carries its own.
``refit_numpy`` is the oracle of the device-side refit (ops/refit.py).

The scene compile's default is the native binned-SAH build
(utils/native.py::native_build_bvh, native/bvh_sah.cpp), as in the JAX
package; this NumPy LBVH is its fallback on a machine without a C++
compiler, and gives the same order as the native LBVH
(``native_build_bvh(..., builder="lbvh")``).  Both builders emit the same
layout below, so the traversal, the panels and the refit read either.

TPU-native replacement for the reference's hardware acceleration structures
(BLAS per mesh + TLAS of instances, vulkan/raytracing/blas.cppm:75-167 and
tlas.cppm:44-149, built by Vulkan on the GPU).  A scene without instances
compiles to a world-space soup, and a single BVH over it plays the role of
BLAS+TLAS; the shared-geometry compile (scene/scene.py) sorts each unique
mesh by its own build, and the v8 kernel's (instance, super) pairs play
the TLAS.

Design for a *stackless, vectorized* traversal (render/bvh_backend.py):
  * triangles are sorted by the Morton code of their centroid, so every
    leaf covers a CONTIGUOUS range of the sorted triangle arrays — leaf
    intersection is a dense slab of consecutive triangles, not a gather
    of scattered ids;
  * nodes are emitted in DFS pre-order; each node carries a `skip` link
    (the DFS index of the next subtree).  Traversal state per ray is then
    a single node index: descend on AABB hit (i+1), follow skip otherwise
    — the classic GPU "threaded BVH" scheme, which on TPU means every ray
    lane advances through pure gathers + masked math inside one
    lax.while_loop; no per-lane stacks in registers.

The build itself runs in NumPy at scene-compile time (the reference also
builds its AS once at startup, application.cppm:230).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class BVHArrays(NamedTuple):
    """Flat BVH in DFS pre-order + Morton-sorted triangle data."""

    node_min: np.ndarray    # (N, 3) f32
    node_max: np.ndarray    # (N, 3) f32
    node_skip: np.ndarray   # (N,) i32 — DFS index of next subtree (N = end)
    node_first: np.ndarray  # (N,) i32 — first sorted-tri index (leaves)
    node_count: np.ndarray  # (N,) i32 — tri count (0 for internal nodes)
    tri_v0: np.ndarray      # (T, 3) f32 sorted triangle vertices
    tri_v1: np.ndarray
    tri_v2: np.ndarray
    tri_id: np.ndarray      # (T,) i32 — original (unsorted) triangle index


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of v so there are 2 zero bits between each."""
    v = v.astype(np.uint64)
    v = (v * np.uint64(0x00010001)) & np.uint64(0xFF0000FF)
    v = (v * np.uint64(0x00000101)) & np.uint64(0x0F00F00F)
    v = (v * np.uint64(0x00000011)) & np.uint64(0xC30C30C3)
    v = (v * np.uint64(0x00000005)) & np.uint64(0x49249249)
    return v


def morton_codes(points: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points normalized into the unit cube."""
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    ext = np.maximum(hi - lo, 1e-12)
    q = np.clip(((points - lo) / ext) * 1023.0, 0.0, 1023.0).astype(np.uint32)
    return (
        (_expand_bits(q[:, 0]) << np.uint64(2))
        | (_expand_bits(q[:, 1]) << np.uint64(1))
        | _expand_bits(q[:, 2])
    )


def build_bvh(
    v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, leaf_size: int = 4
) -> BVHArrays:
    """Build the LBVH over a world-space triangle soup.

    Median splits over the Morton order (equivalent to top-down LBVH bit
    splits but guaranteed balanced), emitted iteratively in DFS pre-order.
    """
    t = len(v0)
    if t == 0:
        raise ValueError("cannot build a BVH over zero triangles")
    centroids = (v0 + v1 + v2) / 3.0
    order = np.argsort(morton_codes(centroids), kind="stable").astype(np.int32)
    sv0, sv1, sv2 = v0[order], v1[order], v2[order]

    tri_min = np.minimum(np.minimum(sv0, sv1), sv2)
    tri_max = np.maximum(np.maximum(sv0, sv1), sv2)

    # DFS pre-order emission with an explicit stack of [start, end) ranges.
    ranges = []
    stack = [(0, t)]
    while stack:
        s, e = stack.pop()
        ranges.append((s, e))
        if e - s > leaf_size:
            m = (s + e) // 2
            stack.append((m, e))   # pushed first -> popped second (right)
            stack.append((s, m))   # popped first (left) => DFS pre-order
    n = len(ranges)

    node_min = np.empty((n, 3), np.float32)
    node_max = np.empty((n, 3), np.float32)
    node_first = np.zeros(n, np.int32)
    node_count = np.zeros(n, np.int32)

    for i, (s, e) in enumerate(ranges):
        node_min[i] = tri_min[s:e].min(axis=0)
        node_max[i] = tri_max[s:e].max(axis=0)
        if e - s <= leaf_size:
            node_first[i] = s
            node_count[i] = e - s

    # skip[i] = first node after i's subtree.  In DFS pre-order that is the
    # node whose range starts at i's range end; compute in O(n) by a reverse
    # sweep keeping a map from range-start -> node index.
    node_skip = np.full(n, n, np.int32)
    next_at_start: dict[int, int] = {}
    for i in range(n - 1, -1, -1):
        s, e = ranges[i]
        node_skip[i] = next_at_start.get(e, n)
        next_at_start[s] = i

    return BVHArrays(
        node_min=node_min, node_max=node_max, node_skip=node_skip,
        node_first=node_first, node_count=node_count,
        tri_v0=sv0.astype(np.float32), tri_v1=sv1.astype(np.float32),
        tri_v2=sv2.astype(np.float32), tri_id=order,
    )


def refit_numpy(bvh: BVHArrays, v0, v1, v2) -> BVHArrays:
    """Recompute AABBs for moved vertices, keeping topology (TLAS::refit
    parity, tlas.cppm:151-207). v0/v1/v2 are in ORIGINAL triangle order."""
    sv0, sv1, sv2 = v0[bvh.tri_id], v1[bvh.tri_id], v2[bvh.tri_id]
    tri_min = np.minimum(np.minimum(sv0, sv1), sv2)
    tri_max = np.maximum(np.maximum(sv0, sv1), sv2)
    node_min = bvh.node_min.copy()
    node_max = bvh.node_max.copy()
    # Nodes are in DFS pre-order and children follow parents, so a reverse
    # sweep sees both children of a node before the node.
    n = len(node_min)
    for i in range(n - 1, -1, -1):
        if bvh.node_count[i] > 0:
            s = bvh.node_first[i]
            e = s + bvh.node_count[i]
            node_min[i] = tri_min[s:e].min(axis=0)
            node_max[i] = tri_max[s:e].max(axis=0)
        else:
            left = i + 1
            right_skip = bvh.node_skip[left]
            node_min[i] = np.minimum(node_min[left], node_min[right_skip])
            node_max[i] = np.maximum(node_max[left], node_max[right_skip])
    return bvh._replace(
        node_min=node_min, node_max=node_max,
        tri_v0=sv0.astype(np.float32), tri_v1=sv1.astype(np.float32),
        tri_v2=sv2.astype(np.float32),
    )


def validate_bvh(bvh: BVHArrays) -> None:
    """Sanity invariants (raises AssertionError, as the JAX package's does):
    every triangle in exactly one leaf; skip links in range; no node box
    inverted."""
    n = len(bvh.node_min)
    t = len(bvh.tri_v0)
    covered = np.zeros(t, bool)
    for i in range(n):
        c = bvh.node_count[i]
        if c > 0:
            s = bvh.node_first[i]
            assert not covered[s:s + c].any(), "leaf overlap"
            covered[s:s + c] = True
    assert covered.all(), "leaves must cover all triangles"
    assert (bvh.node_skip >= 0).all() and (bvh.node_skip <= n).all()
    assert (bvh.node_min <= bvh.node_max + 1e-6).all()
