"""Bilinear and mip-mapped texture sampling (single maps, LUTs, equirect
HDRI, the texture atlas and its mip chain).

Counterpart of realtimeraytracer_tpu/ops/texture.py: ``sample_bilinear``,
``pack_bilinear_neighbors``, ``sample_bilinear_packed``, ``sample_equirect``;
the texture atlas: ``sample_atlas`` on a padded (T, S, S, 4) stack with
each texture's true (h, w), ``pack_atlas_neighbors_np`` and
``sample_atlas_packed`` (one gather per fetch, the same corners and lerp);
and its mip chain (image_sampler.cppm:11-51): ``build_mip_atlas_np``,
``pack_mip_atlas_neighbors_np``, trilinear ``sample_atlas_mip`` and the
N-tap anisotropic ``sample_atlas_aniso``.
"""

from __future__ import annotations

import numpy as np
import torch

from realtimeraytracer_torch.ops.vecmath import normalize

TWO_PI = 6.28318530718
PI = 3.14159265359


def _wrap(i: torch.Tensor, n) -> torch.Tensor:
    """Repeat addressing: floor-mod into [0, n)."""
    return torch.remainder(i, n)


def _corner_indices(u, v, h: int, w: int, wrap: bool):
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    return x0, y0, fx, fy


def sample_bilinear(image: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    wrap: bool = True) -> torch.Tensor:
    """Sample (H, W, C) at normalized (u, v), GL half-texel convention;
    wrap=True is repeat addressing, False clamps.  Returns (..., C)."""
    h, w = image.shape[0], image.shape[1]
    x0, y0, fx, fy = _corner_indices(u, v, h, w, wrap)
    if wrap:
        xi0, xi1 = torch.remainder(x0, w), torch.remainder(x0 + 1, w)
        yi0, yi1 = torch.remainder(y0, h), torch.remainder(y0 + 1, h)
    else:
        xi0, xi1 = torch.clamp(x0, 0, w - 1), torch.clamp(x0 + 1, 0, w - 1)
        yi0, yi1 = torch.clamp(y0, 0, h - 1), torch.clamp(y0 + 1, 0, h - 1)
    c00 = image[yi0, xi0]
    c01 = image[yi0, xi1]
    c10 = image[yi1, xi0]
    c11 = image[yi1, xi1]
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def pack_bilinear_neighbors(image: torch.Tensor, wrap: bool = False) -> torch.Tensor:
    """(H, W, C) -> (H, W, 4C): each texel carries its 2x2 bilinear
    footprint [c00 | c01 | c10 | c11], so a bilinear fetch is one gather."""
    if wrap:
        right = torch.roll(image, -1, dims=1)
        down = torch.roll(image, -1, dims=0)
        diag = torch.roll(down, -1, dims=1)
    else:
        right = torch.cat([image[:, 1:], image[:, -1:]], dim=1)
        down = torch.cat([image[1:], image[-1:]], dim=0)
        diag = torch.cat([down[:, 1:], down[:, -1:]], dim=1)
    return torch.cat([image, right, down, diag], dim=-1)


def sample_bilinear_packed(packed: torch.Tensor, u: torch.Tensor,
                           v: torch.Tensor, wrap: bool = False) -> torch.Tensor:
    """Bilinear sample from a pack_bilinear_neighbors table (same lerp
    order as sample_bilinear)."""
    h, w = packed.shape[0], packed.shape[1]
    c = packed.shape[2] // 4
    x0, y0, fx, fy = _corner_indices(u, v, h, w, wrap)
    if wrap:
        xi0, yi0 = torch.remainder(x0, w), torch.remainder(y0, h)
    else:
        xi0, yi0 = torch.clamp(x0, 0, w - 1), torch.clamp(y0, 0, h - 1)
    g = packed[yi0, xi0]
    c00, c01 = g[..., 0:c], g[..., c:2 * c]
    c10, c11 = g[..., 2 * c:3 * c], g[..., 3 * c:4 * c]
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def sample_equirect(hdri: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Equirectangular lookup by world direction (miss.rmiss:21-26):
    u = atan2(z, x)/2pi + 0.5, v = 1 - acos(y)/pi; sRGB decode is the
    caller's."""
    d = normalize(dirs)
    u = torch.atan2(d[..., 2], d[..., 0]) / TWO_PI + 0.5
    v = 1.0 - torch.acos(torch.clamp(d[..., 1], -1.0, 1.0)) / PI
    return sample_bilinear(hdri, u, v, wrap=True)


def _atlas_corners(sizes, tex_id, u, v, n_tex: int):
    """Clamped texture ids, the wrapped top-left texel and the bilinear
    fractions of per-ray (tex_id, u, v) over each texture's true extent."""
    tid = torch.clamp(tex_id, 0, n_tex - 1).long()
    hw = sizes[tid].to(torch.float32)            # (..., 2) as (h, w)
    h, w = hw[..., 0], hw[..., 1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    return (tid, x0f.to(torch.int32), y0f.to(torch.int32),
            w.to(torch.int32), h.to(torch.int32), fx, fy)


def sample_atlas(atlas: torch.Tensor, sizes: torch.Tensor, tex_id: torch.Tensor,
                 u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Sample a padded (T, S, S, 4) atlas at per-ray (tex_id, u, v).  tex_id
    < 0 is allowed (callers select constants afterwards; it samples texture
    0).  Repeat addressing over each texture's true (h, w).  Returns
    (..., 4)."""
    tid, x0, y0, wi, hi, fx, fy = _atlas_corners(sizes, tex_id, u, v, atlas.shape[0])
    xi0, xi1 = _wrap(x0, wi).long(), _wrap(x0 + 1, wi).long()
    yi0, yi1 = _wrap(y0, hi).long(), _wrap(y0 + 1, hi).long()
    c00 = atlas[tid, yi0, xi0]
    c01 = atlas[tid, yi0, xi1]
    c10 = atlas[tid, yi1, xi0]
    c11 = atlas[tid, yi1, xi1]
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def pack_atlas_neighbors_np(atlas: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """(T, S, S, 4) atlas -> (T, S, S, 16): each texel carries its 2x2
    bilinear footprint [c00 | c01 | c10 | c11] with each texture's
    true-extent repeat wrap baked in (host NumPy, once at compile)."""
    t, s = atlas.shape[0], atlas.shape[1]
    out = np.zeros((t, s, s, 16), np.float32)
    for ti in range(t):
        h, w = int(sizes[ti, 0]), int(sizes[ti, 1])
        a = atlas[ti, :h, :w]
        xr = (np.arange(w) + 1) % w
        yd = (np.arange(h) + 1) % h
        out[ti, :h, :w] = np.concatenate(
            [a, a[:, xr], a[yd, :], a[yd][:, xr]], axis=-1)
    return out


def sample_atlas_packed(packed: torch.Tensor, sizes: torch.Tensor,
                        tex_id: torch.Tensor, u: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """sample_atlas from a pack_atlas_neighbors_np table: one gather, the
    same corners and lerp order, so the same values bit for bit."""
    tid, x0, y0, wi, hi, fx, fy = _atlas_corners(sizes, tex_id, u, v, packed.shape[0])
    g = packed[tid, _wrap(y0, hi).long(), _wrap(x0, wi).long()]
    c00, c01 = g[..., 0:4], g[..., 4:8]
    c10, c11 = g[..., 8:12], g[..., 12:16]
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


# ---------------------------------------------------------------------------
# The mip chain of the atlas (built on the host once per compile)
# ---------------------------------------------------------------------------

def build_mip_atlas_np(atlas: np.ndarray, sizes: np.ndarray) -> tuple[np.ndarray, int]:
    """Box-filtered mip chain of a padded (T, S, S, 4) atlas in one
    (T, 2S, S, 4) array: level k occupies rows [2S - 2S/2^k, ...) whatever
    each texture's true size, and its level-k content, (ceil(h/2^k),
    ceil(w/2^k)) texels, fills the top left of that tile.  Returns
    (mip_atlas, num_levels)."""
    t, s = atlas.shape[0], atlas.shape[1]
    if t == 0:
        return np.zeros((0, 2 * s, s, 4), np.float32), 1
    levels = 1
    while (s >> levels) >= 1:
        levels += 1
    out = np.zeros((t, 2 * s, s, 4), np.float32)
    out[:, :s, :, :] = atlas
    for ti in range(t):
        h, w = int(sizes[ti, 0]), int(sizes[ti, 1])
        cur = atlas[ti, :h, :w, :]
        for k in range(1, levels):
            nh, nw = max(1, (h + 1) // 2), max(1, (w + 1) // 2)
            # 2x2 box filter, the edge repeated for odd sides.
            padded = np.pad(cur, ((0, cur.shape[0] % 2), (0, cur.shape[1] % 2), (0, 0)),
                            mode="edge")
            cur = 0.25 * (padded[0::2, 0::2] + padded[1::2, 0::2]
                          + padded[0::2, 1::2] + padded[1::2, 1::2])
            h, w = nh, nw
            y_off = 2 * s - (2 * s >> k)
            out[ti, y_off:y_off + h, :w, :] = cur
    return out, levels


def pack_mip_atlas_neighbors_np(mip_atlas: np.ndarray, sizes: np.ndarray,
                                num_levels: int) -> np.ndarray:
    """The (T, 2S, S, 16) packed twin of the mip atlas: each level's texels
    carry their 2x2 footprint with that level's true-extent wrap, at the
    same per-level row offsets."""
    t, s2, s = mip_atlas.shape[0], mip_atlas.shape[1], mip_atlas.shape[2]
    out = np.zeros((t, s2, s, 16), np.float32)
    for ti in range(t):
        for k in range(num_levels):
            h = max(1, int(sizes[ti, 0]) >> k)
            w = max(1, int(sizes[ti, 1]) >> k)
            y_off = s2 - (s2 >> k)
            a = mip_atlas[ti, y_off:y_off + h, :w]
            xr = (np.arange(w) + 1) % w
            yd = (np.arange(h) + 1) % h
            out[ti, y_off:y_off + h, :w] = np.concatenate(
                [a, a[:, xr], a[yd, :], a[yd][:, xr]], axis=-1)
    return out


def _level_corners(sizes, tex_id, u, v, k, n_tex: int, s: int):
    """At per-ray integer level k: the clamped texture ids, the top-left
    texel, the level's (w, h), its row offset and the bilinear
    fractions."""
    tid = torch.clamp(tex_id, 0, max(n_tex - 1, 0)).long()
    hw = sizes[tid].to(torch.int64)
    k = k.to(torch.int64)
    h = torch.clamp_min(hw[..., 0] >> k, 1).to(torch.float32)
    w = torch.clamp_min(hw[..., 1] >> k, 1).to(torch.float32)
    y_off = (2 * s) - ((2 * s) >> k)
    x = u * w - 0.5
    y = v * h - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0, y0 = x0f.to(torch.int32), y0f.to(torch.int32)
    wi, hi = w.to(torch.int32), h.to(torch.int32)
    return tid, x0, y0, wi, hi, y_off, fx, fy


def _sample_atlas_level(mip_atlas, sizes, tex_id, u, v, k):
    """Bilinear fetch at per-ray integer mip level k (four gathers)."""
    tid, x0, y0, wi, hi, y_off, fx, fy = _level_corners(
        sizes, tex_id, u, v, k, mip_atlas.shape[0], mip_atlas.shape[2])
    xi0, xi1 = _wrap(x0, wi).long(), _wrap(x0 + 1, wi).long()
    yi0, yi1 = _wrap(y0, hi).long() + y_off, _wrap(y0 + 1, hi).long() + y_off
    c00 = mip_atlas[tid, yi0, xi0]
    c01 = mip_atlas[tid, yi0, xi1]
    c10 = mip_atlas[tid, yi1, xi0]
    c11 = mip_atlas[tid, yi1, xi1]
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def _sample_atlas_level_packed(packed, sizes, tex_id, u, v, k):
    """_sample_atlas_level from the packed mip twin: one gather, the same
    values bit for bit."""
    tid, x0, y0, wi, hi, y_off, fx, fy = _level_corners(
        sizes, tex_id, u, v, k, packed.shape[0], packed.shape[2])
    g = packed[tid, _wrap(y0, hi).long() + y_off, _wrap(x0, wi).long()]
    c00, c01 = g[..., 0:4], g[..., 4:8]
    c10, c11 = g[..., 8:12], g[..., 12:16]
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def sample_atlas_mip(mip_atlas, sizes, num_levels: int, tex_id, u, v, lod,
                     packed=None):
    """Trilinear atlas sample: lod (per ray, 0 = base) clamped to the
    chain, two level fetches and a lerp.  packed: the
    pack_mip_atlas_neighbors_np twin, one gather a level instead of four."""
    lod = torch.clamp(lod, 0.0, float(num_levels - 1))
    k0 = torch.floor(lod).to(torch.int32)
    k1 = torch.clamp_max(k0 + 1, num_levels - 1)
    f = (lod - k0.to(torch.float32))[..., None]
    if packed is not None:
        c0 = _sample_atlas_level_packed(packed, sizes, tex_id, u, v, k0)
        c1 = _sample_atlas_level_packed(packed, sizes, tex_id, u, v, k1)
    else:
        c0 = _sample_atlas_level(mip_atlas, sizes, tex_id, u, v, k0)
        c1 = _sample_atlas_level(mip_atlas, sizes, tex_id, u, v, k1)
    return c0 * (1.0 - f) + c1 * f


def sample_atlas_aniso(mip_atlas, sizes, num_levels: int, tex_id, u, v,
                       lod_minor, duv_half, taps: int, packed=None):
    """Anisotropic sample: `taps` trilinear fetches spread evenly along the
    footprint's major axis (duv_half: (..., 2), half of it in uv), each at
    the minor-axis LOD, averaged (the N-tap approximation of the
    reference's maxAnisotropy)."""
    if taps <= 1:
        return sample_atlas_mip(mip_atlas, sizes, num_levels, tex_id, u, v,
                                lod_minor, packed=packed)
    acc = None
    for i in range(taps):
        c = (2.0 * (i + 0.5) / taps) - 1.0
        ci = sample_atlas_mip(mip_atlas, sizes, num_levels, tex_id,
                              u + c * duv_half[..., 0], v + c * duv_half[..., 1],
                              lod_minor, packed=packed)
        acc = ci if acc is None else acc + ci
    return acc * (1.0 / taps)
