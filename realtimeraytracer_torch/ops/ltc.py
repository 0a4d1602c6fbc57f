"""Linearly Transformed Cosines: analytic polygonal-light integration.

Counterpart of realtimeraytracer_tpu/ops/ltc.py (reference LTC.glsl and
raygen.rgen:143-157; Heitz et al., SIGGRAPH 2016), with both LUT modes:
exact bilinear (``fast=False``) and the nearest fetch from a 4x bilinearly
upsampled table (``fast=True``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from realtimeraytracer_torch.ops.texture import (
    pack_bilinear_neighbors, sample_bilinear_packed)
from realtimeraytracer_torch.ops.vecmath import cross, dot, normalize

LUT_SIZE = 64.0
LUT_SCALE = (LUT_SIZE - 1.0) / LUT_SIZE
LUT_BIAS = 0.5 / LUT_SIZE


def ltc_lut_coords(roughness: torch.Tensor, ndotv: torch.Tensor):
    """LUT (u, v) from roughness and N.V (raygen.rgen:143-145).  At N.V = 1
    the square root's derivative is infinite: its branch is taken only
    where 1 - N.V > 0 (the value is the same, sqrt(0) = 0), so a view along
    the normal carries a zero gradient instead of NaN."""
    u = roughness * LUT_SCALE + LUT_BIAS
    x = 1.0 - ndotv
    v = torch.where(x > 0.0, torch.sqrt(torch.where(x > 0.0, x, 1.0)), 0.0) * LUT_SCALE + LUT_BIAS
    return u, v


def upsample4(tbl: torch.Tensor) -> torch.Tensor:
    """Bilinear 4x upsample of a (64, 64, C) LUT -> (256, 256, C), half-pixel
    centres with edge clamping (jax.image.resize "linear" for upsampling)."""
    x = tbl.permute(2, 0, 1)[None]
    up = F.interpolate(x, scale_factor=4, mode="bilinear", align_corners=False)
    return up[0].permute(1, 2, 0).contiguous()


def sample_nearest(image: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Clamped nearest-texel fetch of (H, W, C) at normalized (u, v)."""
    h, w = image.shape[0], image.shape[1]
    xi = torch.clamp(torch.floor(u * w).to(torch.int64), 0, w - 1)
    yi = torch.clamp(torch.floor(v * h).to(torch.int64), 0, h - 1)
    return image[yi, xi]


def fetch_ltc_params(ltc1: torch.Tensor, ltc2: torch.Tensor,
                     roughness: torch.Tensor, ndotv: torch.Tensor,
                     fast: bool = False):
    """Sample both LUTs; returns ((a, b, c, d) of Minv, t2 (..., 4))."""
    u, v = ltc_lut_coords(roughness, ndotv)
    both = torch.cat([ltc1, ltc2], dim=-1)              # (64, 64, 8)
    if fast:
        t = sample_nearest(upsample4(both), u, v)
    else:
        t = sample_bilinear_packed(pack_bilinear_neighbors(both), u, v)
    t1, t2 = t[..., 0:4], t[..., 4:8]
    return (t1[..., 0], t1[..., 1], t1[..., 2], t1[..., 3]), t2


def integrate_edge_vec(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Cubic fit to the vector edge integral (LTC.glsl:2-14)."""
    x = dot(v1, v2)
    y = x.abs()
    a = 0.8543985 + (0.4965155 + 0.0145206 * y) * y
    b = 3.4175940 + (4.1616724 + y) * y
    v = a / b
    neg = 0.5 * torch.reciprocal(torch.sqrt(torch.clamp_min(1.0 - x * x, 1e-7))) - v
    theta_sintheta = torch.where(x > 0.0, v, neg)
    return cross(v1, v2) * theta_sintheta[..., None]


def ltc_evaluate(n, view, p, minv, p0, p1, p2, light_normal, two_sided, ltc2,
                 fast: bool = False) -> torch.Tensor:
    """Scalar polygon irradiance of one light triangle (LTC.glsl:16-69);
    minv is (a, b, c, d) or None for the identity (diffuse) case.  Keeps
    the reference's sidedness logic verbatim (see the JAX counterpart)."""
    t1 = normalize(view - n * dot(view, n)[..., None])
    t2v = cross(n, t1)
    if minv is None:
        r0, r1r, r2r = t1, t2v, n
    else:
        a, b, c, d = (x[..., None] for x in minv)
        r0 = a * t1 + c * n
        r1r = t2v
        r2r = b * t1 + d * n

    def xform(q):
        dq = q - p
        return normalize(torch.stack(
            [dot(r0, dq), dot(r1r, dq), dot(r2r, dq)], dim=-1))

    l0 = xform(p0)
    l1 = xform(p1)
    l2 = xform(p2)

    behind = dot(p0 - p, light_normal) < 0.0

    vsum = (integrate_edge_vec(l0, l1) + integrate_edge_vec(l1, l2)
            + integrate_edge_vec(l2, l0))
    length = torch.sqrt(torch.clamp_min(dot(vsum, vsum), 1e-20))
    z = vsum[..., 2] / length
    z = torch.where(behind, -z, z)

    u = (z * 0.5 + 0.5) * LUT_SCALE + LUT_BIAS
    v = length * LUT_SCALE + LUT_BIAS
    if fast:
        scale = sample_nearest(upsample4(ltc2), u, v)[..., 3]
    else:
        scale = sample_bilinear_packed(
            pack_bilinear_neighbors(ltc2[..., 3:4]), u, v)[..., 0]

    total = length * scale
    return torch.where((~behind) & (~two_sided), 0.0, total)
