"""v8 traversal: a per-ray two-level hierarchy culled inside the kernel.

Counterpart of realtimeraytracer_tpu/render/hier_backend.py:
``pack_hierarchy``, ``trace_blocks_hier`` (the Pallas kernel, here the CUDA
kernel csrc/trace_v8.cu), ``hier_closest``, ``hier_occluded``,
``hier_occluded_hinted`` and ``make_hier_backend``.  Blocks of 128 sorted
triangles group into supers of 128 blocks; per tile the kernel slab-tests
every ray against the super boxes, pops supers in entry order, slab-tests
the rays against the popped super's block boxes under their live windows,
and visits blocks in entry order with an exact stop rule.  v7's cull is per
tile and outside the kernel; v8's is per ray, so the shadow-ray sort buys
nothing (``perray_cull``).  Occlusion traces emit per-tile hints (the
tile's least and greatest first-occluder block) that the next correlated
trace visits first.

Shared-geometry (instanced) scenes trace through the kernel's instanced
instantiation: the top level holds (instance, super) pairs with world
boxes (``pair_panel``, padded to SPAGES pages as in JAX); each popped pair
moves the tile's rays into mesh space by the instance's inverse transform
and culls and visits the shared mesh-space pools.  Closest traces return
the instance of each hit (``HitRecord.inst``); hints are off there.

Closest traces apply the scene's conservative alpha masks (pallas_amask)
when asked (``use_amask``, as in JAX): kernel and twin reject hits in
definitely-transparent barycentric cells.  Launches count on
``trace_blocks_hier``: ``launches`` and ``masked_launches``, and for the
instanced kernel ``launches_inst`` and ``masked_launches_inst``.

Not ported: the multi-segment occlusion kernel, which the JAX package
leaves unwired (ROADMAP B4).

``trace_blocks_hier`` launches the kernel for CUDA tensors and runs the
plain twin (``trace_hier_plain``, ``trace_hier_inst_plain``) for CPU
tensors, with no fallback between the two.  The twin slab-tests every
(ray, block) pair under the ray's whole window (supers only prune) and
intersects every pair that passes: closest keeps the least packed
(quantized t | lane) key, occluded takes any hit, and its hints come from
each ray's lowest occluding block.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from realtimeraytracer_torch import kernels
from realtimeraytracer_torch.config import RenderConfig
from realtimeraytracer_torch.ops import intersect
from realtimeraytracer_torch.ops.intersect import BIG_T, HitRecord
from realtimeraytracer_torch.render.backends import (
    TraceBackend, _merge_sphere_hits, sphere_occluded)
from realtimeraytracer_torch.render.v7_backend import (
    BIG, BIG_BITS, EPS, _COMMON, _INT64_MAX, _MODES, _check, _check_amask,
    _intersect_pairs, _pack_rays)
from realtimeraytracer_torch.scene.gpu_scene import TorchScene
from realtimeraytracer_torch.scene.panels import CROWS, RESIDENT_CB, TILE

SUP = 128            # blocks per supercluster
# Super-box pages of pack_hierarchy, as in the JAX package: SPAGES*128
# supers at most (50M triangles).  The kernel sorts the super keys in
# shared memory and takes as many.
SPAGES = 24
_NO_HIT = 1 << 30
# Rays per slab-test chunk and (ray, block) pairs per intersection chunk of
# the plain twin, on CUDA and elsewhere.
_RAY_CHUNK_CUDA, _RAY_CHUNK_CPU = 32768, 1024
_PAIR_CHUNK_CUDA, _PAIR_CHUNK_CPU = 32768, 512


def pack_hierarchy(cl_min: torch.Tensor, cl_max: torch.Tensor):
    """Subcluster boxes (NB*4, 3) -> (sup_panel, blk_panels) box pages.

    blk_panels (NSUP, 8, 128): rows [minx, miny, minz, maxx, maxy, maxz, 0,
    0], lanes = block within the super.  sup_panel (SPAGES, 8, 128): lanes =
    super index (page-major).  Pad lanes carry inverted (+BIG, -BIG) boxes,
    which the kernel's box-validity test masks."""
    c32 = cl_min.shape[0]
    nb = c32 // 4
    bmin = cl_min.reshape(nb, 4, 3).amin(dim=1)
    bmax = cl_max.reshape(nb, 4, 3).amax(dim=1)
    nsup = -(-nb // SUP)
    padb = nsup * SUP - nb
    if padb:
        bmin = torch.cat([bmin, bmin.new_full((padb, 3), BIG_T)])
        bmax = torch.cat([bmax, bmax.new_full((padb, 3), -BIG_T)])
    pad2 = bmin.new_zeros((nsup, 2, SUP))
    blk = torch.cat([bmin.reshape(nsup, SUP, 3).transpose(1, 2),
                     bmax.reshape(nsup, SUP, 3).transpose(1, 2), pad2], dim=1)

    smin = bmin.reshape(nsup, SUP, 3).amin(dim=1)
    smax = bmax.reshape(nsup, SUP, 3).amax(dim=1)
    if nsup > SPAGES * 128:
        raise ValueError(
            f"{nsup} superclusters exceed the {SPAGES * 128} the v8 kernel "
            f"takes ({SPAGES * 128 * SUP * 128} triangles)")
    pads = SPAGES * 128 - nsup
    smin = torch.cat([smin, smin.new_full((pads, 3), BIG_T)])
    smax = torch.cat([smax, smax.new_full((pads, 3), -BIG_T)])
    sup = torch.cat([smin.reshape(SPAGES, 128, 3).transpose(1, 2),
                     smax.reshape(SPAGES, 128, 3).transpose(1, 2),
                     smin.new_zeros((SPAGES, 2, 128))], dim=1)
    return sup.contiguous(), blk.contiguous()


def _box_rows(panel, n: int):
    """(n, 3) box mins and maxes of the first n lanes of (P, 8, 128) box
    pages (page-major)."""
    lo = panel[:, 0:3].transpose(1, 2).reshape(-1, 3)[:n]
    hi = panel[:, 3:6].transpose(1, 2).reshape(-1, 3)[:n]
    return lo, hi


def _slab_pass(o, inv, fl, tmin, limit, lo, hi):
    """(R, B) bool: ray windows [tmin, limit] that overlap each box (the
    kernel's slab test; parallel axes pass, inverted boxes fail)."""
    near = far = None
    for a in range(3):
        t0 = (lo[None, :, a] - o[:, a, None]) * inv[:, a, None]
        t1 = (hi[None, :, a] - o[:, a, None]) * inv[:, a, None]
        na = torch.where(fl[:, a, None], -BIG, torch.minimum(t0, t1))
        fa = torch.where(fl[:, a, None], BIG, torch.maximum(t0, t1))
        near = na if near is None else torch.maximum(near, na)
        far = fa if far is None else torch.minimum(far, fa)
    valid = (lo[:, 0] <= hi[:, 0])[None, :]
    return (valid & (near <= far) & (far >= tmin[:, None])
            & (near <= limit[:, None]))


def trace_hier_plain(rays, sup_panel, blk_panels, coeff, nsup: int, mode: str,
                     common: str | None = None, hints=None, amask=None):
    """Plain PyTorch twin of the v8 kernel, for any device.

    Per-ray block cull under each ray's window [t_min, t_max], then every
    passing (ray, block) pair is intersected.  Closest: the least (quantized
    t, block, lane) key per ray.  Occluded: any hit; outi row 0 = the
    ray's lowest occluding block, rows 3 and 4 = the tile's least and
    greatest of those (-1 if none).  Results do not depend on `hints` or
    on the super level, which only prune.  Row 1 of outi holds the tile's
    candidate block count; rows 5 and 6 the pairs and the slab tests the
    twin made for each live ray.  amask: (CB, 2, 128) alpha masks (closest
    mode only) or None."""
    del sup_panel, nsup, hints
    ts = rays.shape[0]
    dev = rays.device
    cb = coeff.shape[0]
    r_all = ts * TILE
    cuda = dev.type == "cuda"
    ray_chunk = _RAY_CHUNK_CUDA if cuda else _RAY_CHUNK_CPU
    chunk = _PAIR_CHUNK_CUDA if cuda else _PAIR_CHUNK_CPU
    rays = rays.clone()
    if common == "origin":
        rays[:, 0:3] = rays[:, 0:3, 0:1]
    elif common == "dir":
        rays[:, 3:6] = rays[:, 3:6, 0:1]
    per_ray = rays.permute(0, 2, 1).reshape(r_all, 8)
    o, d = per_ray[:, 0:3], per_ray[:, 3:6]
    tmin, tmax = per_ray[:, 6], per_ray[:, 7]
    fl = d.abs() <= EPS
    inv = 1.0 / torch.where(fl, 1.0, d)
    lo, hi = _box_rows(blk_panels, cb)

    pr, pb = [], []
    for s in range(0, r_all, ray_chunk):
        e = min(r_all, s + ray_chunk)
        ok = _slab_pass(o[s:e], inv[s:e], fl[s:e], tmin[s:e], tmax[s:e], lo, hi)
        ri, bi = ok.nonzero(as_tuple=True)
        pr.append(ri + s)
        pb.append(bi)
    pair_ray, pair_blk = torch.cat(pr), torch.cat(pb)

    closest = mode == "closest"
    lane = torch.arange(TILE, device=dev, dtype=torch.int32)
    best = torch.full((r_all,), _INT64_MAX, dtype=torch.int64, device=dev)
    first = torch.full((r_all,), _NO_HIT, dtype=torch.int64, device=dev)
    for s in range(0, pair_ray.shape[0], chunk):
        rr, bb = pair_ray[s:s + chunk], pair_blk[s:s + chunk]
        t, ok = _intersect_pairs(per_ray[rr][:, :, None], coeff[bb], None,
                                 None if amask is None else amask[bb])
        t, ok = t[:, 0], ok[:, 0]                               # (P, 128)
        if closest:
            tm = torch.where(ok, t, float("inf"))
            kbest = ((tm.view(torch.int32) & ~127) | lane).amin(dim=1)
            key64 = ((kbest & ~127).long() * (1 << 32) + (bb << 7)
                     + (kbest & 127).long())
            key64 = torch.where(kbest < BIG_BITS, key64, _INT64_MAX)
            best.scatter_reduce_(0, rr, key64, "amin")
        else:
            first.scatter_reduce_(0, rr, torch.where(ok.any(dim=1), bb, _NO_HIT),
                                  "amin")

    outf = torch.zeros((ts, 8, TILE), dtype=torch.float32, device=dev)
    outi = torch.zeros((ts, 8, TILE), dtype=torch.int32, device=dev)
    if closest:
        found = best != _INT64_MAX
        t = (best >> 32).to(torch.int32).view(torch.float32)
        ids = (best & 0xFFFFFFFF).to(torch.int32)     # block << 7 | lane
        outf[:, 0] = torch.where(found, t, BIG).reshape(ts, TILE)
        outi[:, 0] = torch.where(found, ids, -1).reshape(ts, TILE)
    else:
        occ = first != _NO_HIT
        outf[:, 0] = occ.to(torch.float32).reshape(ts, TILE)
        blk_first = torch.where(occ, first, -1).to(torch.int32).reshape(ts, TILE)
        outi[:, 0] = blk_first
        lo_h = torch.where(blk_first >= 0, blk_first, _NO_HIT).amin(dim=1)
        outi[:, 3] = torch.where(lo_h == _NO_HIT, -1, lo_h)[:, None]
        outi[:, 4] = blk_first.amax(dim=1)[:, None]
    cand = torch.zeros((ts, cb), dtype=torch.bool, device=dev)
    cand[pair_ray // TILE, pair_blk] = True
    outi[:, 1] = cand.sum(dim=1, dtype=torch.int32)[:, None]
    outi[:, 2] = -1
    pairs = torch.bincount(pair_ray, minlength=r_all) * TILE
    outi[:, 5] = pairs.to(torch.int32).reshape(ts, TILE)
    outi[:, 6] = torch.where(rays[:, 6] <= rays[:, 7], cb, 0)
    return outf, outi


def trace_hier_kernel(rays, sup_panel, blk_panels, coeff, nsup: int, mode: str,
                      common: str | None = None, hints=None, count: bool = False,
                      amask=None):
    """Launch csrc/trace_v8.cu (CUDA tensors only); adds one to
    ``trace_blocks_hier.launches``, or with alpha masks (amask (CB, 2, 128)
    int32, closest mode) to ``trace_blocks_hier.masked_launches``.  hints:
    (Ts, hn) int32 or None.
    count=True launches the variant that also writes its work counts
    (outi rows 5 and 6, the bound's operation count); the render path
    does not, as counting slows the kernel."""
    ts = rays.shape[0]
    cb = coeff.shape[0]
    _check(rays, "rays", torch.float32, (ts, 8, TILE))
    _check(sup_panel, "sup_panel", torch.float32, (SPAGES, 8, 128))
    _check(blk_panels, "blk_panels", torch.float32, (nsup, 8, 128))
    _check(coeff, "coeff", torch.float32, (cb, CROWS, TILE))
    if hints is not None:
        _check(hints, "hints", torch.int32, (ts, hints.shape[1]))
    for x in (sup_panel, blk_panels, coeff, hints):
        if x is not None and x.device != rays.device:
            raise ValueError("the v8 kernel's inputs must be on one device")
    if mode not in _MODES or common not in _COMMON:
        raise ValueError(f"bad mode/common {mode!r}/{common!r}")
    _check_amask(amask, coeff, mode)
    if not 0 < nsup <= SPAGES * 128 or nsup * SUP < cb:
        raise ValueError(f"{nsup} superclusters for {cb} blocks: the v8 kernel "
                         f"takes 1 to {SPAGES * 128} supers covering every block")
    l1_mask = (1 << max(7, (nsup - 1).bit_length())) - 1
    outf = torch.zeros((ts, 8, TILE), dtype=torch.float32, device=rays.device)
    outi = torch.zeros((ts, 8, TILE), dtype=torch.int32, device=rays.device)
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.launch("trace_v8", rays.data_ptr(), sup_panel.data_ptr(),
                       blk_panels.data_ptr(), coeff.data_ptr(),
                       None if amask is None else amask.data_ptr(),
                       None if hints is None else hints.data_ptr(),
                       outf.data_ptr(), outi.data_ptr(), ts, nsup, cb,
                       0 if hints is None else hints.shape[1], l1_mask,
                       _MODES[mode], _COMMON[common], int(count), stream)
    if amask is None:
        trace_blocks_hier.launches += 1
    else:
        trace_blocks_hier.masked_launches += 1
    return outf, outi


def to_mesh(xf, o, d):
    """Rays (n, 3) into mesh space by inverse rows xf (n, 12) [R | t]:
    ((r0 x + r1 y) + r2 z) + t, the kernel's order, as elementwise ops (a
    batched einsum runs as thousands of small GEMV launches on the card);
    directions are not renormalized (t stays the world t)."""
    mo = torch.stack([((xf[:, 3 * a] * o[:, 0] + xf[:, 3 * a + 1] * o[:, 1])
                       + xf[:, 3 * a + 2] * o[:, 2]) + xf[:, 9 + a] for a in range(3)], 1)
    md = torch.stack([(xf[:, 3 * a] * d[:, 0] + xf[:, 3 * a + 1] * d[:, 1])
                      + xf[:, 3 * a + 2] * d[:, 2] for a in range(3)], 1)
    return mo, md


def _slab_rows(o, inv, fl, tmin, limit, lo, hi):
    """(R, B) bool: _slab_pass with a box set of its own per ray (lo, hi
    (R, B, 3))."""
    near = far = None
    for a in range(3):
        t0 = (lo[:, :, a] - o[:, a, None]) * inv[:, a, None]
        t1 = (hi[:, :, a] - o[:, a, None]) * inv[:, a, None]
        na = torch.where(fl[:, a, None], -BIG, torch.minimum(t0, t1))
        fa = torch.where(fl[:, a, None], BIG, torch.maximum(t0, t1))
        near = na if near is None else torch.maximum(near, na)
        far = fa if far is None else torch.minimum(far, fa)
    valid = lo[:, :, 0] <= hi[:, :, 0]
    return (valid & (near <= far) & (far >= tmin[:, None])
            & (near <= limit[:, None]))


def trace_hier_inst_plain(rays, pair_pages, pair_tab, inst_inv, blk_panel, coeff,
                          mode: str, amask=None):
    """Plain PyTorch twin of the instanced v8 kernel, for any device.

    Slab-tests every (ray, pair) in world space under the ray's whole
    window [t_min, t_max]; for each pair that passes, moves the ray into
    the pair's mesh space (to_mesh), slab-tests it against the blocks of
    the pair's super, and intersects every (ray, block) that passes.
    Closest: the least (quantized t, block, lane) key per ray, then the
    least instance among the keys equal to it; outi row 2 = that instance.
    Occluded: any hit (outi rows 0, 3 and 4 as trace_hier_plain).  Row 1 of
    outi holds the tile's distinct (pair, block) candidates; rows 5, 6 and
    7 the pairs, slab tests and mesh-space transforms the twin made for
    each live ray.  amask: (CB, 2, 128) alpha masks (closest mode only) or
    None."""
    ts = rays.shape[0]
    dev = rays.device
    cb = coeff.shape[0]
    npair, nblk, ninst = pair_tab.shape[0], blk_panel.shape[0], inst_inv.shape[0]
    r_all = ts * TILE
    cuda = dev.type == "cuda"
    ray_chunk = _RAY_CHUNK_CUDA if cuda else _RAY_CHUNK_CPU
    chunk = _PAIR_CHUNK_CUDA if cuda else _PAIR_CHUNK_CPU
    per_ray = rays.permute(0, 2, 1).reshape(r_all, 8)
    o, d = per_ray[:, 0:3], per_ray[:, 3:6]
    tmin, tmax = per_ray[:, 6], per_ray[:, 7]
    fl = d.abs() <= EPS
    inv = 1.0 / torch.where(fl, 1.0, d)
    plo, phi = _box_rows(pair_pages, npair)
    tab = pair_tab.long()
    p_inst = tab[:, 0].clamp(0, ninst - 1)
    p_row = tab[:, 1].clamp(0, nblk - 1)
    p_base = tab[:, 2]
    blo = blk_panel[:, 0:3].transpose(1, 2)                  # (NSUP, 128, 3)
    bhi = blk_panel[:, 3:6].transpose(1, 2)
    lane = torch.arange(TILE, device=dev, dtype=torch.int32)

    closest = mode == "closest"
    first = torch.full((r_all,), _NO_HIT, dtype=torch.int64, device=dev)
    hit_r, hit_key, hit_inst = [], [], []
    n_cand = torch.zeros(ts, dtype=torch.int64, device=dev)
    n_pair_pass = torch.zeros(r_all, dtype=torch.int64, device=dev)
    n_blk_pass = torch.zeros(r_all, dtype=torch.int64, device=dev)
    for s in range(0, r_all, ray_chunk):
        e = min(r_all, s + ray_chunk)
        ok = _slab_pass(o[s:e], inv[s:e], fl[s:e], tmin[s:e], tmax[s:e], plo, phi)
        ri, pi = ok.nonzero(as_tuple=True)
        ri = ri + s
        n_pair_pass += torch.bincount(ri, minlength=r_all)
        cand = []
        for q in range(0, ri.shape[0], chunk):
            rr, pp = ri[q:q + chunk], pi[q:q + chunk]
            mo, md = to_mesh(inst_inv[p_inst[pp]], o[rr], d[rr])
            mfl = md.abs() <= EPS
            minv = 1.0 / torch.where(mfl, 1.0, md)
            ok2 = _slab_rows(mo, minv, mfl, tmin[rr], tmax[rr],
                             blo[p_row[pp]], bhi[p_row[pp]])
            j, b = ok2.nonzero(as_tuple=True)
            if not j.numel():
                continue
            ray_j = rr[j]
            n_blk_pass += torch.bincount(ray_j, minlength=r_all)
            cid = (p_base[pp[j]] + b).clamp(max=cb - 1)
            cand.append((ray_j // TILE) * (npair * TILE) + pp[j] * TILE + b)
            mrays = torch.cat([mo, md, tmin[rr, None], tmax[rr, None]], dim=1)
            for u in range(0, j.shape[0], chunk):
                jj, cc, rj = j[u:u + chunk], cid[u:u + chunk], ray_j[u:u + chunk]
                t, hit = _intersect_pairs(mrays[jj][:, :, None], coeff[cc], None,
                                          None if amask is None else amask[cc])
                t, hit = t[:, 0], hit[:, 0]                  # (P, 128)
                if closest:
                    tm = torch.where(hit, t, float("inf"))
                    kbest = ((tm.view(torch.int32) & ~127) | lane).amin(dim=1)
                    found = kbest < BIG_BITS
                    key64 = ((kbest & ~127).long() * (1 << 32) + (cc << 7)
                             + (kbest & 127).long())
                    hit_r.append(rj[found])
                    hit_key.append(key64[found])
                    hit_inst.append(p_inst[pp[jj]][found])
                else:
                    first.scatter_reduce_(0, rj, torch.where(hit.any(dim=1), cc, _NO_HIT),
                                          "amin")
        if cand:          # ray chunks hold whole tiles
            tiles = torch.unique(torch.cat(cand)) // (npair * TILE)
            n_cand += torch.bincount(tiles, minlength=ts)

    outf = torch.zeros((ts, 8, TILE), dtype=torch.float32, device=dev)
    outi = torch.zeros((ts, 8, TILE), dtype=torch.int32, device=dev)
    if closest:
        best = torch.full((r_all,), _INT64_MAX, dtype=torch.int64, device=dev)
        inst = torch.full((r_all,), _INT64_MAX, dtype=torch.int64, device=dev)
        if hit_r:
            hr, hk, hi_ = torch.cat(hit_r), torch.cat(hit_key), torch.cat(hit_inst)
            best.scatter_reduce_(0, hr, hk, "amin")
            inst.scatter_reduce_(0, hr, torch.where(hk == best[hr], hi_, _INT64_MAX), "amin")
        found = best != _INT64_MAX
        t = (best >> 32).to(torch.int32).view(torch.float32)
        ids = (best & 0xFFFFFFFF).to(torch.int32)     # block << 7 | lane
        outf[:, 0] = torch.where(found, t, BIG).reshape(ts, TILE)
        outi[:, 0] = torch.where(found, ids, -1).reshape(ts, TILE)
        outi[:, 2] = torch.where(found, inst, -1).to(torch.int32).reshape(ts, TILE)
    else:
        occ = first != _NO_HIT
        outf[:, 0] = occ.to(torch.float32).reshape(ts, TILE)
        blk_first = torch.where(occ, first, -1).to(torch.int32).reshape(ts, TILE)
        outi[:, 0] = blk_first
        lo_h = torch.where(blk_first >= 0, blk_first, _NO_HIT).amin(dim=1)
        outi[:, 2] = -1
        outi[:, 3] = torch.where(lo_h == _NO_HIT, -1, lo_h)[:, None]
        outi[:, 4] = blk_first.amax(dim=1)[:, None]
    outi[:, 1] = n_cand.to(torch.int32)[:, None]
    live = (tmin <= tmax).reshape(ts, TILE)
    outi[:, 5] = (n_blk_pass * TILE).to(torch.int32).reshape(ts, TILE)
    nvalid = int((pair_tab[:, 3] == 1).sum())
    outi[:, 6] = torch.where(live, nvalid + (n_pair_pass * TILE).to(torch.int32).reshape(ts, TILE), 0)
    outi[:, 7] = n_pair_pass.to(torch.int32).reshape(ts, TILE)
    return outf, outi


def trace_hier_inst_kernel(rays, pair_pages, pair_tab, inst_inv, blk_panel, coeff,
                           mode: str, count: bool = False, amask=None):
    """Launch the instanced instantiation of csrc/trace_v8.cu (CUDA tensors
    only); adds one to ``trace_blocks_hier.launches_inst``, or with alpha
    masks (amask (CB, 2, 128) int32, closest mode) to
    ``trace_blocks_hier.masked_launches_inst``.  pair_pages (SPAGES, 8,
    128) f32 world pair boxes (the first NP lanes, page-major, are pair
    rows); pair_tab (NP, 4) int32 [instance, blk row, block base, valid];
    inst_inv (I, 12) f32; blk_panel (NSUP, 8, 128) f32 mesh-space block
    boxes; coeff (CB, 12, 128) f32.  count=True launches the variant that
    also writes its work counts (outi rows 5 to 7)."""
    ts = rays.shape[0]
    cb = coeff.shape[0]
    npair, nblk, ninst = pair_tab.shape[0], blk_panel.shape[0], inst_inv.shape[0]
    _check(rays, "rays", torch.float32, (ts, 8, TILE))
    _check(pair_pages, "pair_pages", torch.float32, (SPAGES, 8, 128))
    _check(pair_tab, "pair_tab", torch.int32, (npair, 4))
    _check(inst_inv, "inst_inv", torch.float32, (ninst, 12))
    _check(blk_panel, "blk_panel", torch.float32, (nblk, 8, 128))
    _check(coeff, "coeff", torch.float32, (cb, CROWS, TILE))
    for x in (pair_pages, pair_tab, inst_inv, blk_panel, coeff):
        if x.device != rays.device:
            raise ValueError("the v8 kernel's inputs must be on one device")
    if mode not in _MODES:
        raise ValueError(f"bad mode {mode!r}")
    _check_amask(amask, coeff, mode)
    # The pair count and the blk row count are separate: a pair row names
    # its blk row and its block base, which the kernel clamps to nblk and cb.
    if not 0 < npair <= SPAGES * 128 or not ninst > 0 or not nblk > 0:
        raise ValueError(f"{npair} pairs, {ninst} instances, {nblk} blk rows: the v8 "
                         f"kernel takes 1 to {SPAGES * 128} pairs and at least one of each")
    l1_mask = (1 << max(7, (npair - 1).bit_length())) - 1
    outf = torch.zeros((ts, 8, TILE), dtype=torch.float32, device=rays.device)
    outi = torch.zeros((ts, 8, TILE), dtype=torch.int32, device=rays.device)
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.launch("trace_v8_inst", rays.data_ptr(), pair_pages.data_ptr(),
                       blk_panel.data_ptr(), coeff.data_ptr(),
                       None if amask is None else amask.data_ptr(),
                       pair_tab.data_ptr(), inst_inv.data_ptr(),
                       outf.data_ptr(), outi.data_ptr(), ts, npair, nblk, cb, ninst,
                       l1_mask, _MODES[mode], int(count), stream)
    if amask is None:
        trace_blocks_hier.launches_inst += 1
    else:
        trace_blocks_hier.masked_launches_inst += 1
    return outf, outi


def padded_pair_pages(gpu: TorchScene) -> torch.Tensor:
    """The instanced scene's pair boxes padded to SPAGES pages with
    inverted boxes, as the JAX wrapper pads them."""
    pp = gpu.pair_panel.shape[0]
    if pp >= SPAGES:
        return gpu.pair_panel.contiguous()
    pad = gpu.pair_panel.new_zeros((SPAGES - pp, 8, 128))
    pad[:, 0:3] = BIG_T
    pad[:, 3:6] = -BIG_T
    return torch.cat([gpu.pair_panel, pad]).contiguous()


def _inst_args(gpu: TorchScene):
    if gpu.pallas_panels is None:
        raise ValueError("instanced scene has no coefficient panels")
    return (padded_pair_pages(gpu), gpu.pair_tab, gpu.inst_inv, gpu.blk_panel,
            gpu.pallas_panels)


def _hier_inputs(gpu: TorchScene):
    if gpu.pallas_panels is None:
        raise ValueError("scene has no traversal panels (compile it with a BVH)")
    coeff = gpu.pallas_panels
    sup_panel, blk_panels = pack_hierarchy(gpu.pallas_cl_min, gpu.pallas_cl_max)
    return coeff, sup_panel, blk_panels, blk_panels.shape[0]


def trace_blocks_hier(gpu: TorchScene, ray_blocks, mode: str,
                      common: str | None = None, hints=None,
                      use_amask: bool = False):
    """Trace packed (Ts, 8, 128) ray tiles through the v8 hierarchy; the
    kernel's wrapper.  Returns (outf, outi), each (Ts, 8, 128): outf row 0 =
    t (3e38 on a miss) or the occluded flag; outi row 0 = sorted-triangle id
    or -1 (closest), row 1 = blocks visited, rows 3 and 4 (occluded) = the
    tile's hints for the next correlated trace, rows 5 and 6 = the
    ray-triangle pairs and slab tests each thread made.  hints ((Ts, hn) int32)
    are visited first, in occluded mode on scenes of at most RESIDENT_CB
    blocks; they never change the result.  use_amask: apply the scene's
    alpha masks (closest mode, when the scene has them).  CUDA tensors
    launch the kernel; CPU tensors run the plain twin.  On an instanced
    scene outi row 2 is the closest hit's instance and hints raise."""
    amask = gpu.pallas_amask if use_amask and mode == "closest" else None
    if gpu.instanced:
        if hints is not None:
            raise ValueError("the instanced v8 kernel takes no hints")
        args = _inst_args(gpu)
        with record_function(f"v8.{mode}"):
            if ray_blocks.device.type == "cuda":
                return trace_hier_inst_kernel(ray_blocks, *args, mode, amask=amask)
            if ray_blocks.device.type == "cpu":
                return trace_hier_inst_plain(ray_blocks, *args, mode, amask)
        raise ValueError(f"no v8 trace for device {ray_blocks.device}")
    coeff, sup_panel, blk_panels, nsup = _hier_inputs(gpu)
    if hints is not None and (mode != "occluded" or coeff.shape[0] > RESIDENT_CB):
        hints = None
    if hints is not None and (hints.ndim != 2 or hints.shape[0] != ray_blocks.shape[0]):
        raise ValueError(f"hints must be (Ts, hn) from a trace of the same ray layout "
                         f"({ray_blocks.shape[0]} tiles), got {tuple(hints.shape)}")
    with record_function(f"v8.{mode}"):
        if ray_blocks.device.type == "cuda":
            return trace_hier_kernel(ray_blocks, sup_panel, blk_panels, coeff,
                                     nsup, mode, common, hints, amask=amask)
        if ray_blocks.device.type == "cpu":
            return trace_hier_plain(ray_blocks, sup_panel, blk_panels, coeff,
                                    nsup, mode, common, hints, amask)
    raise ValueError(f"no v8 trace for device {ray_blocks.device}")


trace_blocks_hier.launches = 0
trace_blocks_hier.masked_launches = 0
trace_blocks_hier.launches_inst = 0
trace_blocks_hier.masked_launches_inst = 0


def trace_blocks_hier_plain(gpu: TorchScene, ray_blocks, mode: str,
                            common: str | None = None, hints=None,
                            use_amask: bool = False):
    """trace_blocks_hier through the plain twin on any device."""
    amask = gpu.pallas_amask if use_amask and mode == "closest" else None
    if gpu.instanced:
        if hints is not None:
            raise ValueError("the instanced v8 kernel takes no hints")
        return trace_hier_inst_plain(ray_blocks, *_inst_args(gpu), mode, amask)
    coeff, sup_panel, blk_panels, nsup = _hier_inputs(gpu)
    return trace_hier_plain(ray_blocks, sup_panel, blk_panels, coeff, nsup,
                            mode, common, hints, amask)


def _run(gpu, origins, dirs, t_min, t_max, mode, common, trace, hints=None,
         use_amask=False):
    r = origins.shape[0]
    t_min = intersect.as_per_ray(t_min, r, origins.device)
    t_max = intersect.as_per_ray(t_max, r, origins.device)
    rays, r_orig, _ = _pack_rays(origins, dirs, t_min, t_max)
    outf, outi = trace(gpu, rays, mode, common=common, hints=hints,
                       use_amask=use_amask)
    return (outf[:, 0, :].reshape(-1)[:r_orig], outi[:, 0, :].reshape(-1)[:r_orig],
            outi)


def hier_closest(gpu, origins, dirs, t_min, t_max, common=None,
                 trace=trace_blocks_hier, use_amask: bool = False) -> HitRecord:
    """Closest triangle hits; (u, v) are zeros (the surface resolver
    recomputes them); inst is each hit's instance on an instanced scene
    (-1 on a miss), else None.  use_amask: reject hits in
    definitely-transparent cells of the scene's alpha masks."""
    tb, kb, outi = _run(gpu, origins, dirs, t_min, t_max, "closest", common, trace,
                        use_amask=use_amask)
    zeros = torch.zeros_like(tb)
    inst = outi[:, 2, :].reshape(-1)[:tb.shape[0]] if gpu.instanced else None
    return HitRecord(t=tb, prim_id=torch.where(kb >= 0, kb, -1), u=zeros, v=zeros,
                     inst=inst)


def hier_occluded(gpu, origins, dirs, t_min, t_max, common=None,
                  trace=trace_blocks_hier):
    """Any triangle hit in [t_min, t_max]."""
    tb, _, _ = _run(gpu, origins, dirs, t_min, t_max, "occluded", common, trace)
    return tb > 0.5


def hier_occluded_hinted(gpu, origins, dirs, t_min, t_max, hints=None,
                         common=None, trace=trace_blocks_hier):
    """Occlusion with the cross-sample hint warm start: returns (mask,
    hints_out (Ts, 2) int32).  Feed hints_out to the next correlated trace
    (same ray layout, e.g. the next stochastic sample of the same light);
    the mask never depends on the hints."""
    tb, _, outi = _run(gpu, origins, dirs, t_min, t_max, "occluded", common,
                       trace, hints=hints)
    return tb > 0.5, outi[:, 3:5, 0].contiguous()


def make_hier_backend(gpu: TorchScene, cfg: RenderConfig,
                      trace=trace_blocks_hier,
                      use_amask: bool | None = None) -> TraceBackend:
    """The "hier" backend.  trace: trace_blocks_hier (kernel on CUDA, twin
    on CPU) or trace_blocks_hier_plain (twin everywhere).  Hinted
    occlusion exists for scenes of at most RESIDENT_CB blocks, as in the
    JAX package, and not on instanced scenes; the multi-segment query is
    not wired there either.  use_amask: closest traces apply the scene's alpha masks; None takes the
    config's gate (backends.masks_enabled)."""
    from realtimeraytracer_torch.render.backends import masks_enabled

    num_tris = gpu.num_tris
    num_spheres = gpu.num_spheres
    if use_amask is None:
        use_amask = masks_enabled(cfg)

    def closest(origins, dirs, t_min, t_max, common=None):
        hit = hier_closest(gpu, origins, dirs, t_min, t_max, common, trace,
                           use_amask)
        if num_spheres:
            sph = intersect.intersect_spheres(
                origins, dirs, gpu.sph_center, gpu.sph_radius, t_min, t_max)
            hit = _merge_sphere_hits(hit, sph, num_tris)
        return hit

    def occluded(origins, dirs, t_min, t_max, common=None):
        occ = hier_occluded(gpu, origins, dirs, t_min, t_max, common, trace)
        return sphere_occluded(gpu, occ, origins, dirs, t_min, t_max)

    def occluded_hinted(origins, dirs, t_min, t_max, hints=None, common=None):
        occ, h = hier_occluded_hinted(gpu, origins, dirs, t_min, t_max, hints,
                                      common, trace)
        return sphere_occluded(gpu, occ, origins, dirs, t_min, t_max), h

    hintable = (not gpu.instanced and gpu.pallas_panels is not None
                and gpu.pallas_panels.shape[0] <= RESIDENT_CB)
    return TraceBackend(closest=closest, occluded=occluded,
                        num_tris=num_tris, num_spheres=num_spheres,
                        perray_cull=True,
                        occluded_hinted=occluded_hinted if hintable else None)
