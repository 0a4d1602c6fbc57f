"""v7 traversal: cull 128-ray tiles against 32-triangle boxes, then visit
128-triangle blocks in entry order with an exact stop rule.

Counterpart of realtimeraytracer_tpu/render/pallas_backend.py: ``_pack_rays``,
``_sub_entries``, ``_pack_id_keys``, ``cull_keys`` (plain tensor ops here,
as they are XLA there), ``trace_blocks`` (the Pallas kernel, here the CUDA
kernel csrc/trace_v7.cu), ``pallas_closest`` / ``pallas_occluded`` (here
``v7_closest`` / ``v7_occluded``) and ``make_pallas_backend`` (here
``make_v7_backend``; the config string stays "pallas").

``trace_blocks`` launches the CUDA kernel for CUDA tensors and runs the
plain cull and the plain twin (``trace_keys_plain``) for CPU tensors;
there is no fallback between the two.  The kernel computes the cull
itself, in its tile prologue, from the subcluster boxes: on the card no
key tensor exists.  The twin intersects every culled candidate block of a
tile instead of running the ordered loop: the stop rule is exact, so it
finds the same hits.  It keeps the kernel's packed (t | lane) key and its
visit-order tie rule, so t and ids agree bit for bit.
``trace_keys_ordered`` runs the kernel's ordered visit loop on the plain
keys, which gives its visit and pair counts as well.

Closest traces take the scene's conservative alpha masks (pallas_amask,
ops/alpha_mask.py) when asked (``use_amask``; JAX ``amask``): kernel and
twin reject an accepted pair whose barycentric cell is definitely
transparent (``_mask_ok``).  The masked kernel is its own instantiation and
counts its launches in ``trace_blocks.masked_launches``.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from realtimeraytracer_torch import kernels
from realtimeraytracer_torch.config import RenderConfig
from realtimeraytracer_torch.ops import intersect
from realtimeraytracer_torch.ops.intersect import BIG_T, HitRecord
from realtimeraytracer_torch.render.backends import (
    TraceBackend, _merge_sphere_hits, sphere_occluded, stop_gradient)
from realtimeraytracer_torch.scene.gpu_scene import TorchScene
from realtimeraytracer_torch.scene.panels import CB, CROWS, SUBK, TILE

CPB = 1024              # block keys per key page
BIG = 3.0e38
EPS = 1e-12
INVALID = 0x7F800000    # +inf bits: no candidate
BIG_BITS = 0x7F61B1E6   # bits of float32(3e38), the miss value of best_t
_INT64_MAX = torch.iinfo(torch.int64).max
_MODES = {"closest": 0, "occluded": 1}
_COMMON = {None: 0, "origin": 1, "dir": 2}
_SMEM_LIMIT = 232448    # bytes of shared memory a Hopper CTA may opt into
# Static shared memory of csrc/trace_v7.cu (each warp's common-family dot
# products, the bundle's warp partials, the cull's warp counts).
_V7_STATIC_SMEM = 4 * (4 * 3 * TILE + 4 * 14 + 2 * 4)
_RANK_MAX_KEYS = 512    # the kernel's rank sort; a bitonic network above
# (tile, block) pairs per chunk of the plain twin, on CUDA and elsewhere.
_PAIR_CHUNK_CUDA, _PAIR_CHUNK_CPU = 1024, 64
# Tiles per chunk of trace_keys_ordered's visit step, on CUDA and elsewhere.
_TILE_CHUNK_CUDA, _TILE_CHUNK_CPU = 1024, 64


def _id_bits(total_blocks: int) -> int:
    return max(13, int(total_blocks - 1).bit_length())


def _pack_rays(origins, dirs, t_min, t_max):
    """(R,3)x2 + (R,)x2 -> (Ts, 8, 128) ray tiles [o | d | t_min | t_max];
    pad lanes repeat ray 0 with the empty interval [BIG_T, -BIG_T)."""
    r = origins.shape[0]
    ts = -(-r // TILE)
    pad = ts * TILE - r
    if pad:
        origins = torch.cat([origins, origins[:1].expand(pad, 3)])
        dirs = torch.cat([dirs, dirs[:1].expand(pad, 3)])
        t_min = torch.cat([t_min, t_min.new_full((pad,), BIG_T)])
        t_max = torch.cat([t_max, t_max.new_full((pad,), -BIG_T)])
    rows = torch.cat([origins.T, dirs.T, t_min[None], t_max[None]], dim=0)
    return rows.reshape(8, ts, TILE).permute(1, 0, 2).contiguous(), r, ts


def _sub_entries(rays, cl_min, cl_max):
    """(Ts, C32) conservative entry distance of every SUBK-triangle box for
    each tile's ray bundle (origin box x direction interval, interval
    arithmetic): max(entry, 0) where the box may be hit, +inf elsewhere.
    A lower bound, which keeps the ordered-visit stop rule exact."""
    tmin_lb = rays[:, 6].amin(dim=1, keepdim=True)
    tmax_ub = rays[:, 7].amax(dim=1, keepdim=True)

    def safe(x):
        return torch.where(x.abs() > EPS, x, EPS)

    def times(a_lo, a_hi, b_lo, b_hi):
        p1, p2 = a_lo * b_lo, a_lo * b_hi
        p3, p4 = a_hi * b_lo, a_hi * b_hi
        return (torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4)),
                torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4)))

    tn = tf = None
    for a in range(3):
        o_lo = rays[:, a].amin(dim=1, keepdim=True)
        o_hi = rays[:, a].amax(dim=1, keepdim=True)
        d_lo = rays[:, 3 + a].amin(dim=1, keepdim=True)
        d_hi = rays[:, 3 + a].amax(dim=1, keepdim=True)
        span = (d_lo > EPS) | (d_hi < -EPS)                # sign-definite
        inv_lo = torch.where(span, 1.0 / safe(d_hi), -BIG)
        inv_hi = torch.where(span, 1.0 / safe(d_lo), BIG)
        bmin = cl_min[None, :, a]
        bmax = cl_max[None, :, a]
        t0l, t0h = times(bmin - o_hi, bmin - o_lo, inv_lo, inv_hi)
        t1l, t1h = times(bmax - o_hi, bmax - o_lo, inv_lo, inv_hi)
        lo_a = torch.minimum(t0l, t1l)
        hi_a = torch.maximum(t0h, t1h)
        tn = lo_a if tn is None else torch.maximum(tn, lo_a)
        tf = hi_a if tf is None else torch.minimum(tf, hi_a)
    possible = (tn <= tf) & (tf >= tmin_lb) & (tn <= tmax_ub)
    return torch.where(possible, torch.clamp_min(tn, 0.0), float("inf"))


def _pack_id_keys(ent, ids, id_mask: int, pages: int):
    """Entry bounds + block ids -> ordered int32 keys (Ts, pages, 8, 128).
    Clearing the id bits rounds the entry down (still a lower bound);
    +inf entries become INVALID."""
    ts, n = ent.shape
    finite = torch.isfinite(ent)
    key = (torch.where(finite, ent, 0.0).view(torch.int32) & ~id_mask) | ids
    key = torch.where(finite, key, INVALID)
    pad = pages * CPB - n
    if pad:
        key = torch.cat([key, key.new_full((ts, pad), INVALID)], dim=1)
    return key.reshape(ts, pages, 8, 128)


def cull_keys(rays, cl_min, cl_max, chunk_tiles: int = 2048):
    """Per-tile packed block-candidate keys (Ts, CBn, 8, 128) int32 and the
    id mask: box entries reduce to 128-triangle block keys (entry = min over
    the block's boxes, plus +0.0: a -0 entry, from a box face on the
    bundle's origin bound, becomes +0, whose key is not negative and does
    not hang on which zero amin returns).  Chunked over tiles to bound the
    (Ts, C32) temporaries."""
    ts = rays.shape[0]
    c32 = cl_min.shape[0]
    cb = c32 // (CB // SUBK)
    cbn = -(-cb // CPB)
    id_mask = (1 << _id_bits(cbn * CPB)) - 1
    ids = torch.arange(cb, dtype=torch.int32, device=rays.device)[None, :]
    keys = torch.empty((ts, cbn, 8, 128), dtype=torch.int32, device=rays.device)
    for s in range(0, ts, chunk_tiles):
        e = min(ts, s + chunk_tiles)
        ent = _sub_entries(rays[s:e], cl_min, cl_max)
        ent = ent.reshape(e - s, cb, CB // SUBK).amin(dim=2) + 0.0
        keys[s:e] = _pack_id_keys(ent, ids, id_mask, cbn)
    return keys, id_mask


def cull_quarter_keys(rays, cl_min, cl_max, chunk_tiles: int = 2048):
    """Per-tile subcluster keys split by lane quarter, for the v9 kernel
    (cull_quarter_keys).  Subcluster s = 4B + q sits at lanes [32q, 32q+32)
    of coefficient block B, so quarter q's key carries the block id B and
    that subcluster's own entry bound.  Returns ((Ts, 4, CBn, 8, 128) int32,
    id_mask)."""
    ts = rays.shape[0]
    nq = CB // SUBK
    cb = cl_min.shape[0] // nq
    cbn = -(-cb // CPB)
    id_mask = (1 << _id_bits(cbn * CPB)) - 1
    ids = torch.arange(cb, dtype=torch.int32, device=rays.device)[None, :]
    keys = torch.empty((ts, nq, cbn, 8, 128), dtype=torch.int32, device=rays.device)
    for s in range(0, ts, chunk_tiles):
        e = min(ts, s + chunk_tiles)
        ent = _sub_entries(rays[s:e], cl_min, cl_max).reshape(e - s, cb, nq)
        for q in range(nq):
            keys[s:e, q] = _pack_id_keys(ent[:, :, q], ids, id_mask, cbn)
    return keys, id_mask


def _mask_ok(ok, u, v, m):
    """The in-kernel alpha-mask filter (JAX pallas_backend._mask_ok): m (P,
    2, L) mask rows of the pairs' triangles; bit b = 8*gj + gi of a
    triangle's 64-bit mask (word b >> 5, bit b & 31) is 0 where the cell
    (gi, gj) = (int(8u), int(8v)), clamped to [0, 7], is definitely
    transparent.  u, v of lanes that are not ok are garbage: the clamps
    bound them and ok masks the result."""
    gi = torch.clamp((u * 8.0).to(torch.int32), 0, 7)
    gj = torch.clamp((v * 8.0).to(torch.int32), 0, 7)
    b = gj * 8 + gi
    w = torch.where(b < 32, m[:, 0, None, :], m[:, 1, None, :])
    return ok & (((w >> (b & 31)) & 1) != 0)


def _intersect_pairs(r, c, common, m=None):
    """Baldwin-Weber t and hit mask of each (pair, ray, triangle): r (P, 8,
    128) ray tiles, c (P, 12, L) coefficient blocks, m (P, 2, L) their alpha
    mask rows or None.  Same expressions and association as the kernel."""
    if common == "origin":
        o = [r[:, a, 0:1, None] for a in range(3)]
    else:
        o = [r[:, a, :, None] for a in range(3)]
    if common == "dir":
        d = [r[:, 3 + a, 0:1, None] for a in range(3)]
    else:
        d = [r[:, 3 + a, :, None] for a in range(3)]

    def row(k):
        return c[:, k, None, :]

    def dot_o(base):
        return ((o[0] * row(base) + o[1] * row(base + 1))
                + o[2] * row(base + 2)) + row(base + 3)

    def dot_d(base):
        return (d[0] * row(base) + d[1] * row(base + 1)) + d[2] * row(base + 2)

    s0, s1 = dot_o(0), dot_d(0)
    den_ok = s1.abs() > EPS
    t = torch.where(den_ok, -s0 / torch.where(den_ok, s1, 1.0), BIG)
    u = dot_o(4) + t * dot_d(4)
    v = dot_o(8) + t * dot_d(8)
    ok = (den_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= r[:, 6, :, None]) & (t <= r[:, 7, :, None]))
    if m is not None:
        ok = _mask_ok(ok, u, v, m)
    return t, ok


def trace_keys_plain(rays, keys, coeff, id_mask: int, mode: str,
                     common: str | None = None, amask=None):
    """Plain PyTorch twin of the v7 kernel on culled keys, for any device.

    Intersects every candidate (tile, block) pair, in chunks.  Closest hits
    combine per ray by an int64 key (quantized t bits, visit rank, lane):
    the least quantized t wins, a tie goes to the block visited first and
    then the lowest lane — the ordered loop's rule.  Row 1 of outi holds
    the tile's candidate count (the kernel's visit count is at most that),
    row 5 the pairs the twin tested for each live ray.  amask: (CB, 2, 128)
    alpha masks (closest mode only) or None."""
    ts = rays.shape[0]
    dev = rays.device
    cb = coeff.shape[0]
    chunk = _PAIR_CHUNK_CUDA if dev.type == "cuda" else _PAIR_CHUNK_CPU
    sk = torch.sort(keys.reshape(ts, -1), dim=1).values
    cand = sk != INVALID
    tile_of, rank = cand.nonzero(as_tuple=True)
    cid = torch.clamp(sk[tile_of, rank] & id_mask, max=cb - 1).long()
    lane = torch.arange(TILE, device=dev, dtype=torch.int32)
    closest = mode == "closest"
    best = torch.full((ts * TILE,), _INT64_MAX, dtype=torch.int64, device=dev)
    hits = torch.zeros(ts * TILE, dtype=torch.int32, device=dev)
    for s in range(0, tile_of.shape[0], chunk):
        tt = tile_of[s:s + chunk]
        cc = cid[s:s + chunk]
        t, ok = _intersect_pairs(rays[tt], coeff[cc], common,
                                 None if amask is None else amask[cc])
        ray_idx = (tt[:, None] * TILE + lane).reshape(-1)
        if closest:
            tm = torch.where(ok, t, float("inf"))
            kbest = ((tm.view(torch.int32) & ~127) | lane).amin(dim=2)
            key64 = ((kbest & ~127).long() * (1 << 32)
                     + (rank[s:s + chunk, None] << 7) + (kbest & 127).long())
            key64 = torch.where(kbest < BIG_BITS, key64, _INT64_MAX)
            best.scatter_reduce_(0, ray_idx, key64.reshape(-1), "amin")
        else:
            hits.index_add_(0, ray_idx, ok.any(dim=2).to(torch.int32).reshape(-1))

    outf = torch.zeros((ts, 8, TILE), dtype=torch.float32, device=dev)
    outi = torch.zeros((ts, 8, TILE), dtype=torch.int32, device=dev)
    if closest:
        found = best != _INT64_MAX
        t = (best >> 32).to(torch.int32).view(torch.float32)
        tile = torch.arange(ts * TILE, device=dev) // TILE
        rk = torch.where(found, (best >> 7) & ((1 << 25) - 1), 0)
        blk = torch.clamp(sk[tile, rk] & id_mask, max=cb - 1)
        ids = blk * TILE + (best & 127).to(torch.int32)
        outf[:, 0] = torch.where(found, t, BIG).reshape(ts, TILE)
        outi[:, 0] = torch.where(found, ids, -1).reshape(ts, TILE)
    else:
        outf[:, 0] = (hits > 0).to(torch.float32).reshape(ts, TILE)
        outi[:, 0] = -1
    outi[:, 1] = cand.sum(dim=1, dtype=torch.int32)[:, None]
    outi[:, 5] = torch.where(rays[:, 6] <= rays[:, 7], outi[:, 1] * TILE, 0)
    return outf, outi


def trace_keys_ordered(rays, keys, coeff, id_mask: int, mode: str,
                       common: str | None = None, amask=None):
    """The v7 kernel's ordered visit loop in plain PyTorch, on culled keys
    (Ts, CBn, 8, 128), for any device: visit v takes each tile's v-th
    least key, and a tile stops, as the kernel does, once that key's entry
    exceeds every ray's min(best_t, t_max) (int32 f32 bits; an occluded
    ray's best_t is -3e38 after its first hit).  Unlike the twin
    (trace_keys_plain, which tests every candidate) it writes the kernel's
    own visit and pair counts: outi row 1 = the tile's visits, row 5 = the
    pairs each live ray tested (128 a visit, or up to and including its
    first hit in occluded mode).  A check of the kernel's in-kernel cull
    and visit order, row for row; t, ids and flags are the twin's."""
    ts = rays.shape[0]
    dev = rays.device
    cb = coeff.shape[0]
    chunk = _TILE_CHUNK_CUDA if dev.type == "cuda" else _TILE_CHUNK_CPU
    closest = mode == "closest"
    sk = torch.sort(keys.reshape(ts, -1), dim=1).values
    n = (sk != INVALID).sum(dim=1)
    lane = torch.arange(TILE, device=dev, dtype=torch.int32)
    best_t = torch.full((ts, TILE), BIG, dtype=torch.float32, device=dev)
    best_k = torch.full((ts, TILE), -1, dtype=torch.int32, device=dev)
    visits = torch.zeros(ts, dtype=torch.int32, device=dev)
    pairs = torch.zeros((ts, TILE), dtype=torch.int32, device=dev)
    going = n > 0
    for v in range(int(n.amax()) if ts else 0):
        kv = sk[:, v]
        limit = torch.minimum(best_t, rays[:, 7])
        going &= (v < n) & (limit.view(torch.int32) >= (kv & ~id_mask)[:, None]).any(dim=1)
        tiles = going.nonzero()[:, 0]
        if not tiles.numel():
            break
        for s in range(0, tiles.numel(), chunk):
            tt = tiles[s:s + chunk]
            cid = torch.clamp(kv[tt] & id_mask, max=cb - 1).long()
            r = rays[tt].clone()
            if closest:
                r[:, 7] = limit[tt]
            else:                      # a ray is live until its first hit
                r[:, 7] = torch.where(best_t[tt] >= 0.0, r[:, 7], -BIG)
            t, ok = _intersect_pairs(r, coeff[cid], common, None if amask is None else amask[cid])
            alive = r[:, 6] <= r[:, 7]
            if closest:
                tm = torch.where(ok, t, float("inf"))
                kbest = ((tm.view(torch.int32) & ~127) | lane).amin(dim=2)      # (P, 128)
                better = kbest < best_t[tt].view(torch.int32)
                ids = cid[:, None].to(torch.int32) * TILE + (kbest & 127)
                best_t[tt] = torch.where(better, (kbest & ~127).view(torch.float32), best_t[tt])
                best_k[tt] = torch.where(better, ids, best_k[tt])
                pairs[tt] += alive.to(torch.int32) * TILE
            else:
                hit = ok.any(dim=2)
                first = ok.to(torch.int32).argmax(dim=2) + 1
                pairs[tt] += torch.where(alive, torch.where(hit, first, TILE), 0).to(torch.int32)
                best_t[tt] = torch.where(hit, -BIG, best_t[tt])
        visits += going.to(torch.int32)
    outf = torch.zeros((ts, 8, TILE), dtype=torch.float32, device=dev)
    outi = torch.zeros((ts, 8, TILE), dtype=torch.int32, device=dev)
    outf[:, 0] = best_t if closest else (best_t < 0.0).to(torch.float32)
    outi[:, 0] = best_k
    outi[:, 1] = visits[:, None]
    outi[:, 5] = pairs
    return outf, outi


def _check_layout(x: torch.Tensor, name: str, dtype, shape) -> None:
    """dtype, shape and contiguity of a kernel input, on any device."""
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_on_card(x: torch.Tensor, name: str) -> None:
    """A kernel input lies on the card and needs no gradient (the backends
    hand their traces detached inputs, backends.stop_gradient; this guards
    a caller that skips them)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.requires_grad:
        raise ValueError(f"{name} requires grad; the traversal kernels have no backward "
                         "(trace through a backend, which detaches its inputs)")


def _check_one_card(kernel: str, **tensors) -> None:
    """Every given input (None: absent) lies on the card, on one device,
    and needs no gradient."""
    first = next(x for x in tensors.values() if x is not None)
    for name, x in tensors.items():
        if x is not None:
            _check_on_card(x, name)
            if x.device != first.device:
                raise ValueError(f"the {kernel} kernel's inputs must be on one device")


def _check_aligned(**tensors) -> None:
    """Inputs a kernel stages with 16-byte copies (cp.async) start on a
    16-byte boundary."""
    for name, x in tensors.items():
        if x is not None and x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel stages it with "
                             "16-byte copies)")


def _check(x: torch.Tensor, name: str, dtype, shape) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    _check_layout(x, name, dtype, shape)
    _check_on_card(x, name)


def _check_amask(amask, coeff, mode: str) -> None:
    if amask is None:
        return
    if mode != "closest":
        raise ValueError("alpha masks apply to closest traces only")
    _check(amask, "amask", torch.int32, (coeff.shape[0], 2, TILE))
    if amask.device != coeff.device:
        raise ValueError("amask and coeff must be on one device")


def _v7_dynamic_smem(cb: int, masked: bool) -> int:
    """Dynamic shared memory of a v7 launch (rt_trace_v7): the key room
    (cb keys, 16-byte aligned; above the rank sort's 512 keys the next
    power of two, for the bitonic network) and the two staging buffers."""
    cap = (cb + 3) & ~3 if cb <= _RANK_MAX_KEYS else 1 << (cb - 1).bit_length()
    return 4 * cap + 4 * (2 * CROWS * TILE + (2 * 2 * TILE if masked else 0))


def trace_v7_kernel(rays, cl_min, cl_max, coeff, mode: str, common: str | None = None,
                    amask=None):
    """Launch csrc/trace_v7.cu, which culls each tile against the
    subcluster boxes cl_min / cl_max (4 CB, 3) itself and visits the
    blocks in entry order (CUDA tensors only); adds one to
    ``trace_blocks.launches``, or with alpha masks (closest mode) to
    ``trace_blocks.masked_launches``.  Its outputs equal cull_keys followed
    by trace_keys_plain (t, ids, flags) and by trace_keys_ordered (every
    row).  The block count's shared memory, layouts and devices are checked
    before the kernel is built or launched."""
    ts = rays.shape[0]
    cb = coeff.shape[0]
    if mode not in _MODES or common not in _COMMON:
        raise ValueError(f"bad mode/common {mode!r}/{common!r}")
    if cb < 1 or _v7_dynamic_smem(cb, amask is not None) > _SMEM_LIMIT - _V7_STATIC_SMEM:
        raise ValueError(f"{cb} coefficient blocks: their keys do not fit the v7 kernel's "
                         "shared memory")
    _check_layout(rays, "rays", torch.float32, (ts, 8, TILE))
    _check_layout(coeff, "coeff", torch.float32, (cb, CROWS, TILE))
    _check_layout(cl_min, "cl_min", torch.float32, (cb * (CB // SUBK), 3))
    _check_layout(cl_max, "cl_max", torch.float32, (cb * (CB // SUBK), 3))
    if amask is not None:
        if mode != "closest":
            raise ValueError("alpha masks apply to closest traces only")
        _check_layout(amask, "amask", torch.int32, (cb, 2, TILE))
    _check_one_card("v7", rays=rays, cl_min=cl_min, cl_max=cl_max, coeff=coeff, amask=amask)
    _check_aligned(coeff=coeff, amask=amask)
    id_mask = (1 << _id_bits(-(-cb // CPB) * CPB)) - 1
    outf = torch.zeros((ts, 8, TILE), dtype=torch.float32, device=rays.device)
    outi = torch.zeros((ts, 8, TILE), dtype=torch.int32, device=rays.device)
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.launch("trace_v7", rays.data_ptr(), cl_min.data_ptr(), cl_max.data_ptr(),
                       coeff.data_ptr(), None if amask is None else amask.data_ptr(),
                       outf.data_ptr(), outi.data_ptr(), ts, cb, id_mask, _MODES[mode],
                       _COMMON[common], stream)
    if amask is None:
        trace_blocks.launches += 1
    else:
        trace_blocks.masked_launches += 1
    return outf, outi


def _panels(gpu: TorchScene, mode: str = "occluded", use_amask: bool = False):
    """(coeff, cl_min, cl_max, amask): amask is the scene's pallas_amask for
    a closest trace that asks for masks on a scene that has them, else
    None."""
    if gpu.pallas_panels is None:
        raise ValueError("scene has no v7 panels (compile it with a BVH)")
    amask = gpu.pallas_amask if use_amask and mode == "closest" else None
    return gpu.pallas_panels, gpu.pallas_cl_min, gpu.pallas_cl_max, amask


def trace_blocks(gpu: TorchScene, ray_blocks, mode: str,
                 common: str | None = None, use_amask: bool = False):
    """Trace packed (Ts, 8, 128) ray tiles; the kernel's wrapper.

    common: "origin" iff every ray of every tile shares one origin
    (pinhole primaries), "dir" iff one direction (sun shadows), else None.
    Returns (outf, outi), each (Ts, 8, 128): outf row 0 = t (3e38 on a
    miss) or the occluded flag; outi row 0 = sorted-triangle id or -1,
    row 1 = blocks visited, row 5 = ray-triangle pairs each ray tested.
    use_amask: apply the scene's alpha masks (closest mode, when the scene
    has them).  CUDA tensors launch the kernel; CPU tensors run the plain
    twin."""
    coeff, cl_min, cl_max, amask = _panels(gpu, mode, use_amask)
    if ray_blocks.device.type == "cuda":
        with record_function(f"v7.{mode}"):        # the cull runs in the kernel
            return trace_v7_kernel(ray_blocks, cl_min, cl_max, coeff, mode, common, amask)
    if ray_blocks.device.type == "cpu":
        with record_function("v7.cull"):
            keys, id_mask = cull_keys(ray_blocks, cl_min, cl_max)
        with record_function(f"v7.{mode}"):
            return trace_keys_plain(ray_blocks, keys, coeff, id_mask, mode, common, amask)
    raise ValueError(f"no v7 trace for device {ray_blocks.device}")


trace_blocks.launches = 0
trace_blocks.masked_launches = 0


def trace_blocks_plain(gpu: TorchScene, ray_blocks, mode: str,
                       common: str | None = None, use_amask: bool = False):
    """trace_blocks through the plain twin on any device (the reference
    the kernel is checked against on the card)."""
    coeff, cl_min, cl_max, amask = _panels(gpu, mode, use_amask)
    keys, id_mask = cull_keys(ray_blocks, cl_min, cl_max)
    return trace_keys_plain(ray_blocks, keys, coeff, id_mask, mode, common, amask)


def _run(gpu, origins, dirs, t_min, t_max, mode, common, trace, use_amask=False):
    r = origins.shape[0]
    t_min = intersect.as_per_ray(t_min, r, origins.device)
    t_max = intersect.as_per_ray(t_max, r, origins.device)
    rays, r_orig, _ = _pack_rays(origins, dirs, t_min, t_max)
    outf, outi = trace(gpu, rays, mode, common=common, use_amask=use_amask)
    return outf[:, 0, :].reshape(-1)[:r_orig], outi[:, 0, :].reshape(-1)[:r_orig]


def v7_closest(gpu, origins, dirs, t_min, t_max, common=None,
               trace=trace_blocks, use_amask: bool = False) -> HitRecord:
    """Closest triangle hits (pallas_closest).  Faces are in BVH order, so
    the sorted id is the face id; (u, v) are zeros — the surface resolver
    recomputes them from the winning triangle.  use_amask: reject hits in
    definitely-transparent cells of the scene's alpha masks."""
    tb, kb = _run(gpu, origins, dirs, t_min, t_max, "closest", common, trace,
                  use_amask)
    zeros = torch.zeros_like(tb)
    return HitRecord(t=tb, prim_id=torch.where(kb >= 0, kb, -1), u=zeros, v=zeros)


def v7_occluded(gpu, origins, dirs, t_min, t_max, common=None,
                trace=trace_blocks):
    """Any triangle hit in [t_min, t_max] (pallas_occluded)."""
    tb, _ = _run(gpu, origins, dirs, t_min, t_max, "occluded", common, trace)
    return tb > 0.5


def make_v7_backend(gpu: TorchScene, cfg: RenderConfig,
                    trace=trace_blocks, use_amask: bool | None = None) -> TraceBackend:
    """The "pallas" backend.  trace: trace_blocks (kernel on CUDA, twin on
    CPU) or trace_blocks_plain (twin everywhere, for comparisons).
    use_amask: closest traces apply the scene's alpha masks; None takes
    the config's gate (backends.masks_enabled)."""
    from realtimeraytracer_torch.render.backends import masks_enabled

    num_tris = gpu.num_tris
    num_spheres = gpu.num_spheres
    if use_amask is None:
        use_amask = masks_enabled(cfg)

    sg_gpu = gpu.detach()

    def closest(origins, dirs, t_min, t_max, common=None):
        hit = v7_closest(sg_gpu, *stop_gradient(origins, dirs, t_min, t_max), common, trace,
                         use_amask)
        if num_spheres:
            sph = intersect.intersect_spheres(
                origins, dirs, gpu.sph_center, gpu.sph_radius, t_min, t_max)
            hit = _merge_sphere_hits(hit, sph, num_tris)
        return hit

    def occluded(origins, dirs, t_min, t_max, common=None):
        occ = v7_occluded(sg_gpu, *stop_gradient(origins, dirs, t_min, t_max), common, trace)
        return sphere_occluded(gpu, occ, origins, dirs, t_min, t_max)

    return TraceBackend(closest=closest, occluded=occluded,
                        num_tris=num_tris, num_spheres=num_spheres)
