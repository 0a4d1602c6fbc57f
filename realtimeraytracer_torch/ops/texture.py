"""Bilinear texture sampling (single maps, LUTs, equirect HDRI).

Counterpart of the subset of realtimeraytracer_tpu/ops/texture.py that the
untextured frame uses: ``sample_bilinear``, ``pack_bilinear_neighbors``,
``sample_bilinear_packed`` and ``sample_equirect``.  The texture atlas, mip
and anisotropic samplers are not ported yet (ROADMAP queue A).
"""

from __future__ import annotations

import torch

from realtimeraytracer_torch.ops.vecmath import normalize

TWO_PI = 6.28318530718
PI = 3.14159265359


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
