"""v9 traversal: closest hits from four per-quarter subcluster key streams,
composited into one 128-lane visit.

Counterpart of realtimeraytracer_tpu/render/quarter_backend.py:
``trace_blocks_quarter`` (the Pallas kernel, here the CUDA kernel
csrc/trace_v9.cu), ``quarter_closest`` and ``make_quarter_backend``.  v7
visits 128 consecutive sorted triangles, so a ray pays for the block-mates
of the 32-triangle subclusters it needs; v9 keeps the cull's subcluster
resolution: quarter q of every tile's candidates is its own ordered key
stream (v7_backend.cull_quarter_keys), and one visit tests the next
subcluster of each of the four streams.  Only scenes of at most
RESIDENT_CB blocks take v9 (the backend contract of the JAX package); the
kernel reads the SAH-repacked panels (scene.q_panels) when the scene has
them and maps slot ids back to sorted ids with q_group_off.

``trace_blocks_quarter`` launches the kernel for CUDA tensors and runs the
plain cull and the plain twin (``trace_quarter_plain``) for CPU tensors,
with no fallback between the two.  The kernel computes the quarter cull
itself, in its tile prologue, from the subcluster boxes: on the card no
key tensor exists.  The twin intersects every candidate subcluster of a
tile and keeps the least (quantized t, visit, lane) key per ray, the
kernel's tie rule, so the two agree bit for bit.
``trace_quarter_ordered`` runs the kernel's ordered visit loop on the
plain keys, which gives its visit and pair counts as well.

With ``use_amask`` (JAX ``use_amask``) the kernel and the twin reject
hits in definitely-transparent cells of the scene's alpha masks: q_amask,
laid out by repacked slot, on the repacked panels (else pallas_amask).
Each visit composites the mask rows by lane quarter, as it does the
coefficients.  The masked kernel counts its launches in
``trace_blocks_quarter.masked_launches``.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from realtimeraytracer_torch import kernels
from realtimeraytracer_torch.config import RenderConfig
from realtimeraytracer_torch.ops import intersect
from realtimeraytracer_torch.ops.intersect import HitRecord
from realtimeraytracer_torch.render.backends import (
    TraceBackend, _merge_sphere_hits, stop_gradient)
from realtimeraytracer_torch.render.v7_backend import (
    BIG, BIG_BITS, CPB, INVALID, _COMMON, _INT64_MAX, _check_aligned, _check_layout,
    _check_one_card, _id_bits, _intersect_pairs, _pack_rays, cull_quarter_keys, make_v7_backend,
    trace_blocks)
from realtimeraytracer_torch.scene.gpu_scene import TorchScene
from realtimeraytracer_torch.scene.panels import CB, CROWS, RESIDENT_CB, SUBK, TILE

NQ = CB // SUBK      # lane quarters per block (4)
# (tile, subcluster) pairs per chunk of the plain twin, on CUDA and elsewhere.
_PAIR_CHUNK_CUDA, _PAIR_CHUNK_CPU = 4096, 256
# Tiles per chunk of trace_quarter_ordered's visit step, on CUDA and elsewhere.
_TILE_CHUNK_CUDA, _TILE_CHUNK_CPU = 2048, 64
_KEY_PAD = 0x7FFFFFFF


def trace_quarter_plain(rays, keys, coeff, group_off, id_mask: int,
                        common: str | None = None, amask=None):
    """Plain PyTorch twin of the v9 kernel on culled quarter keys (Ts, 4,
    CBn, 8, 128), for any device.

    Intersects every candidate (tile, subcluster) pair in chunks.  Visit v
    of the kernel takes the v-th key of each quarter stream, so a hit's key
    is (quantized t bits, rank in its stream, composite lane): the least
    wins, which is the kernel's rule (nearest quantized t, then the
    earliest visit, then the lowest lane).  Row 1 of outi holds 4 x the
    longest stream (the kernel's visit count without the stop rule), row 5
    the pairs the twin tested for each live ray.  amask: (CB, 2, 128) alpha
    masks by slot, or None."""
    ts = rays.shape[0]
    dev = rays.device
    cb = coeff.shape[0]
    chunk = _PAIR_CHUNK_CUDA if dev.type == "cuda" else _PAIR_CHUNK_CPU
    sk = torch.sort(keys.reshape(ts, NQ, -1), dim=2).values
    cand = sk != INVALID
    tile_of, q_of, rank = cand.nonzero(as_tuple=True)
    cid = torch.clamp(sk[tile_of, q_of, rank] & id_mask, max=cb - 1).long()
    quarters = coeff.reshape(cb, CROWS, NQ, SUBK)
    mask_q = None if amask is None else amask.reshape(cb, 2, NQ, SUBK)
    sub_lane = torch.arange(SUBK, device=dev, dtype=torch.int32)
    lane = torch.arange(TILE, device=dev, dtype=torch.int32)
    best = torch.full((ts * TILE,), _INT64_MAX, dtype=torch.int64, device=dev)
    for s in range(0, tile_of.shape[0], chunk):
        tt, qq, rr = tile_of[s:s + chunk], q_of[s:s + chunk], rank[s:s + chunk]
        cc = cid[s:s + chunk]
        t, ok = _intersect_pairs(rays[tt], quarters[cc, :, qq, :], common,
                                 None if mask_q is None else mask_q[cc, :, qq, :])
        lanes = (qq[:, None].to(torch.int32) * SUBK + sub_lane)[:, None, :]
        tm = torch.where(ok, t, float("inf"))
        kbest = ((tm.view(torch.int32) & ~127) | lanes).amin(dim=2)
        key64 = ((kbest & ~127).long() * (1 << 32)
                 + (rr[:, None] << 7) + (kbest & 127).long())
        key64 = torch.where(kbest < BIG_BITS, key64, _INT64_MAX)
        ray_idx = (tt[:, None] * TILE + lane).reshape(-1)
        best.scatter_reduce_(0, ray_idx, key64.reshape(-1), "amin")

    found = best != _INT64_MAX
    t = (best >> 32).to(torch.int32).view(torch.float32)
    tile = torch.arange(ts * TILE, device=dev) // TILE
    win_lane = (best & 127).to(torch.int32)
    win_q = torch.where(found, win_lane // SUBK, 0).long()
    rk = torch.where(found, (best >> 7) & ((1 << 25) - 1), 0)
    blk = torch.clamp(sk[tile, win_q, rk] & id_mask, max=cb - 1)
    ids = blk * TILE + win_lane
    if group_off is not None:
        ids = ids - group_off[blk.long() * NQ + win_q]
    outf = torch.zeros((ts, 8, TILE), dtype=torch.float32, device=dev)
    outi = torch.zeros((ts, 8, TILE), dtype=torch.int32, device=dev)
    outf[:, 0] = torch.where(found, t, BIG).reshape(ts, TILE)
    outi[:, 0] = torch.where(found, ids, -1).reshape(ts, TILE)
    outi[:, 1] = NQ * cand.sum(dim=2, dtype=torch.int32).amax(dim=1)[:, None]
    n_sub = cand.sum(dim=(1, 2), dtype=torch.int32)[:, None]
    outi[:, 5] = torch.where(rays[:, 6] <= rays[:, 7], n_sub * SUBK, 0)
    return outf, outi


def trace_quarter_ordered(rays, keys, coeff, group_off, id_mask: int,
                          common: str | None = None, amask=None):
    """The v9 kernel's ordered visit loop in plain PyTorch, on culled
    quarter keys (Ts, 4, CBn, 8, 128), for any device: visit v composites
    the v-th key of every stream, and a tile stops, as the kernel does,
    once the least stream head's entry exceeds every ray's min(best_t,
    t_max).  Unlike the twin (trace_quarter_plain, which tests every
    candidate) it writes the kernel's own visit and pair counts: outi row 1
    = 4 x the composite visits, row 5 = the pairs each live ray tested on
    real subclusters.  A check of the kernel's in-kernel cull and visit
    order, row for row; t and ids are the twin's."""
    ts = rays.shape[0]
    dev = rays.device
    cb = coeff.shape[0]
    chunk = _TILE_CHUNK_CUDA if dev.type == "cuda" else _TILE_CHUNK_CPU
    sk = torch.sort(keys.reshape(ts, NQ, -1), dim=2).values
    n = (sk != INVALID).sum(dim=2)                                  # (Ts, NQ)
    quarters = coeff.reshape(cb, CROWS, NQ, SUBK)
    mask_q = None if amask is None else amask.reshape(cb, 2, NQ, SUBK)
    q_idx = torch.arange(NQ, device=dev)
    lane = torch.arange(TILE, device=dev, dtype=torch.int32)
    best_t = torch.full((ts, TILE), BIG, dtype=torch.float32, device=dev)
    best_k = torch.full((ts, TILE), -1, dtype=torch.int32, device=dev)
    visits = torch.zeros(ts, dtype=torch.int32, device=dev)
    pairs = torch.zeros((ts, TILE), dtype=torch.int32, device=dev)
    going = n.amax(dim=1) > 0
    for v in range(int(n.amax()) if ts else 0):
        has = v < n
        kv = sk[:, :, v]
        entry = torch.where(has, kv, _KEY_PAD).amin(dim=1) & ~id_mask
        limit = torch.minimum(best_t, rays[:, 7])
        going &= has.any(dim=1) & (limit.view(torch.int32) >= entry[:, None]).any(dim=1)
        tiles = going.nonzero()[:, 0]
        if not tiles.numel():
            break
        for s in range(0, tiles.numel(), chunk):
            tt = tiles[s:s + chunk]
            cid = torch.clamp(kv[tt] & id_mask, max=cb - 1).long()     # (P, NQ)
            live_q = has[tt]
            comp = torch.where(live_q[:, :, None, None], quarters[cid, :, q_idx, :], 0.0)
            comp = comp.permute(0, 2, 1, 3).reshape(-1, CROWS, TILE)
            m = None
            if mask_q is not None:
                m = torch.where(live_q[:, :, None, None], mask_q[cid, :, q_idx, :], 0)
                m = m.permute(0, 2, 1, 3).reshape(-1, 2, TILE)
            r = rays[tt].clone()
            r[:, 7] = limit[tt]
            t, ok = _intersect_pairs(r, comp, common, m)
            tm = torch.where(ok, t, float("inf"))
            kbest = ((tm.view(torch.int32) & ~127) | lane).amin(dim=2)      # (P, 128)
            better = kbest < best_t[tt].view(torch.int32)
            j = (kbest & 127).long()
            q = j // SUBK
            bcid = torch.gather(cid, 1, q)
            ids = bcid * TILE + j
            if group_off is not None:
                ids = ids - group_off[bcid * NQ + q]
            best_t[tt] = torch.where(better, (kbest & ~127).view(torch.float32), best_t[tt])
            best_k[tt] = torch.where(better, ids.to(torch.int32), best_k[tt])
            alive = r[:, 6] <= r[:, 7]
            pairs[tt] += alive.to(torch.int32) * (live_q.sum(dim=1, dtype=torch.int32) * SUBK)[:, None]
        visits += going.to(torch.int32)
    outf = torch.zeros((ts, 8, TILE), dtype=torch.float32, device=dev)
    outi = torch.zeros((ts, 8, TILE), dtype=torch.int32, device=dev)
    outf[:, 0] = best_t
    outi[:, 0] = best_k
    outi[:, 1] = NQ * visits[:, None]
    outi[:, 5] = pairs
    return outf, outi


def trace_quarter_kernel(rays, cl_min, cl_max, coeff, group_off,
                         common: str | None = None, amask=None):
    """Launch csrc/trace_v9.cu, which culls each tile against the
    subcluster boxes cl_min / cl_max (4 CB, 3) itself and traces the
    quarter streams (CUDA tensors only); adds one to
    ``trace_blocks_quarter.launches``, or with alpha masks to
    ``trace_blocks_quarter.masked_launches``.  Its outputs equal
    cull_quarter_keys followed by trace_quarter_plain (t, ids) and by
    trace_quarter_ordered (every row).  Layouts, capacity (at most
    RESIDENT_CB blocks) and devices are checked before the kernel is built
    or launched."""
    ts = rays.shape[0]
    cb = coeff.shape[0]
    _check_layout(rays, "rays", torch.float32, (ts, 8, TILE))
    _check_layout(coeff, "coeff", torch.float32, (cb, CROWS, TILE))
    _check_layout(cl_min, "cl_min", torch.float32, (cb * NQ, 3))
    _check_layout(cl_max, "cl_max", torch.float32, (cb * NQ, 3))
    if group_off is not None:
        _check_layout(group_off, "group_off", torch.int32, (cb * NQ,))
    if amask is not None:
        _check_layout(amask, "amask", torch.int32, (cb, 2, TILE))
    if not 0 < cb <= RESIDENT_CB:
        raise ValueError(f"the v9 kernel takes 1 to {RESIDENT_CB} blocks, "
                         f"got {cb}; route larger scenes to v8")
    if common not in _COMMON:
        raise ValueError(f"bad common {common!r}")
    _check_one_card("v9", rays=rays, cl_min=cl_min, cl_max=cl_max, coeff=coeff,
                    group_off=group_off, amask=amask)
    _check_aligned(coeff=coeff, amask=amask)
    id_mask = (1 << _id_bits(-(-cb // CPB) * CPB)) - 1
    outf = torch.zeros((ts, 8, TILE), dtype=torch.float32, device=rays.device)
    outi = torch.zeros((ts, 8, TILE), dtype=torch.int32, device=rays.device)
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.launch("trace_v9", rays.data_ptr(), cl_min.data_ptr(), cl_max.data_ptr(),
                       coeff.data_ptr(),
                       None if group_off is None else group_off.data_ptr(),
                       None if amask is None else amask.data_ptr(),
                       outf.data_ptr(), outi.data_ptr(), ts, cb, id_mask,
                       _COMMON[common], stream)
    if amask is None:
        trace_blocks_quarter.launches += 1
    else:
        trace_blocks_quarter.masked_launches += 1
    return outf, outi


def _quarter_panels(gpu: TorchScene, use_amask: bool = False):
    """(coeff, cl_min, cl_max, group_off, amask): the repacked panels (and
    their slot-ordered masks) when the scene has them, else the v7 panels
    with slot ids = sorted ids; amask None unless asked for and built."""
    if gpu.q_panels is not None:
        return (gpu.q_panels, gpu.q_cl_min, gpu.q_cl_max, gpu.q_group_off,
                gpu.q_amask if use_amask else None)
    if gpu.pallas_panels is None:
        raise ValueError("scene has no traversal panels (compile it with a BVH)")
    return (gpu.pallas_panels, gpu.pallas_cl_min, gpu.pallas_cl_max, None,
            gpu.pallas_amask if use_amask else None)


def trace_blocks_quarter(gpu: TorchScene, ray_blocks, common: str | None = None,
                         use_amask: bool = False):
    """Closest-hit trace of packed (Ts, 8, 128) ray tiles, v9 scheme; the
    kernel's wrapper.  Same output contract as v7's closest mode: outf row
    0 = t (3e38 on a miss); outi row 0 = sorted-triangle id or -1, row 1 =
    subclusters visited, row 5 = ray-triangle pairs each ray tested.
    use_amask: apply the scene's alpha masks.  CUDA tensors launch the
    kernel; CPU tensors run the plain twin."""
    coeff, cl_min, cl_max, group_off, amask = _quarter_panels(gpu, use_amask)
    if coeff.shape[0] > RESIDENT_CB:
        raise ValueError(f"the v9 kernel takes at most {RESIDENT_CB} blocks "
                         f"({coeff.shape[0]}); callers route larger scenes to v8")
    if ray_blocks.device.type == "cuda":
        with record_function("v9.closest"):       # the cull runs in the kernel
            return trace_quarter_kernel(ray_blocks, cl_min, cl_max, coeff, group_off,
                                        common, amask)
    if ray_blocks.device.type == "cpu":
        with record_function("v9.cull"):
            keys, id_mask = cull_quarter_keys(ray_blocks, cl_min, cl_max)
        with record_function("v9.closest"):
            return trace_quarter_plain(ray_blocks, keys, coeff, group_off,
                                       id_mask, common, amask)
    raise ValueError(f"no v9 trace for device {ray_blocks.device}")


trace_blocks_quarter.launches = 0
trace_blocks_quarter.masked_launches = 0


def trace_blocks_quarter_plain(gpu: TorchScene, ray_blocks,
                               common: str | None = None, use_amask: bool = False):
    """trace_blocks_quarter through the plain twin on any device."""
    coeff, cl_min, cl_max, group_off, amask = _quarter_panels(gpu, use_amask)
    keys, id_mask = cull_quarter_keys(ray_blocks, cl_min, cl_max)
    return trace_quarter_plain(ray_blocks, keys, coeff, group_off, id_mask, common,
                               amask)


def quarter_closest(gpu: TorchScene, origins, dirs, t_min, t_max,
                    common: str | None = None,
                    trace=trace_blocks_quarter, use_amask: bool = False) -> HitRecord:
    """Closest hits through v9 (v7's output contract): faces are in BVH
    order, so the sorted id is the face id; (u, v) are zeros (the surface
    resolver recomputes them).  use_amask: reject hits in
    definitely-transparent cells of the scene's alpha masks."""
    r = origins.shape[0]
    t_min = intersect.as_per_ray(t_min, r, origins.device)
    t_max = intersect.as_per_ray(t_max, r, origins.device)
    rays, r_orig, _ = _pack_rays(origins, dirs, t_min, t_max)
    outf, outi = trace(gpu, rays, common=common, use_amask=use_amask)
    tb = outf[:, 0, :].reshape(-1)[:r_orig]
    kb = outi[:, 0, :].reshape(-1)[:r_orig]
    zeros = torch.zeros_like(tb)
    return HitRecord(t=tb, prim_id=torch.where(kb >= 0, kb, -1), u=zeros, v=zeros)


def make_quarter_backend(gpu: TorchScene, cfg: RenderConfig,
                         trace=trace_blocks_quarter,
                         v7_trace=trace_blocks,
                         use_amask: bool | None = None) -> TraceBackend:
    """The "quarter" backend: v9 closest; occlusion delegates to v7, as in
    the JAX package (occlusion retires on any hit, so v9's finer visits buy
    nothing there).  trace / v7_trace: the wrappers (kernel on CUDA, twin
    on CPU) or their *_plain versions.  use_amask: closest traces apply the
    scene's alpha masks; None takes the config's gate."""
    from realtimeraytracer_torch.render.backends import masks_enabled

    num_tris = gpu.num_tris
    num_spheres = gpu.num_spheres
    if use_amask is None:
        use_amask = masks_enabled(cfg)
    v7 = make_v7_backend(gpu, cfg, trace=v7_trace, use_amask=use_amask)
    sg_gpu = gpu.detach()

    def closest(origins, dirs, t_min, t_max, common=None):
        hit = quarter_closest(sg_gpu, *stop_gradient(origins, dirs, t_min, t_max), common,
                              trace, use_amask)
        if num_spheres:
            sph = intersect.intersect_spheres(
                origins, dirs, gpu.sph_center, gpu.sph_radius, t_min, t_max)
            hit = _merge_sphere_hits(hit, sph, num_tris)
        return hit

    return TraceBackend(closest=closest, occluded=v7.occluded,
                        num_tris=num_tris, num_spheres=num_spheres)
