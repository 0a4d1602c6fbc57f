"""Bilinear texture sampling (single maps, LUTs, equirect HDRI).

Counterpart of realtimeraytracer_tpu/ops/texture.py without its mip and
anisotropic samplers (ROADMAP queue A1): ``sample_bilinear``,
``pack_bilinear_neighbors``, ``sample_bilinear_packed``, ``sample_equirect``
and the texture atlas: ``sample_atlas`` on a padded (T, S, S, 4) stack with
each texture's true (h, w), ``pack_atlas_neighbors_np`` and
``sample_atlas_packed`` (one gather per fetch, the same corners and lerp).
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
