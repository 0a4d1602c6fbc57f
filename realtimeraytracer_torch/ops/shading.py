"""BRDF math: GGX Cook-Torrance microfacet model + Lambert diffuse.

Counterpart of realtimeraytracer_tpu/ops/shading.py (reference
cook-torrance.glsl and raygen.rgen:135-139), with the wavefront's two
samplers, ``sample_ggx`` and ``cosine_hemisphere``.  Vectors are (..., 3)
float32.
"""

from __future__ import annotations

import torch

from realtimeraytracer_torch.ops.vecmath import cross, dot, mix, normalize

PI = 3.14159265359


def chi(x):
    """Positive-hemisphere indicator."""
    return torch.where(x > 0.0, 1.0, 0.0)


def ggx_distribution(n, h, alpha):
    """GGX/Trowbridge-Reitz NDF with alpha = roughness."""
    noh = dot(n, h)
    a2 = alpha * alpha
    noh2 = noh * noh
    den = torch.clamp_min(noh2 * a2 + (1.0 - noh2), 1e-3)
    return chi(noh) * a2 / (PI * den * den)


def ggx_partial_geometry(v, n, h, alpha):
    """One-direction Smith-style geometry term (cook-torrance.glsl:44-51)."""
    voh = torch.clamp(dot(v, h), 1e-3, 1.0)
    c = chi(voh / torch.clamp(dot(v, n), 1e-3, 1.0))
    voh2 = voh * voh
    tan2 = (1.0 - voh2) / voh2
    return c * 2.0 / (1.0 + torch.sqrt(1.0 + alpha * alpha * tan2))


def fresnel_schlick(cos_t, f0):
    """Schlick's approximation; f0 is (..., 3)."""
    return f0 + (1.0 - f0) * torch.pow(torch.clamp(1.0 - cos_t, 0.0, 1.0), 5.0)[..., None]


def base_color_split(albedo, metallic):
    """(diffuse_color, F0) from albedo + metallic (raygen.rgen:135-136)."""
    m = metallic[..., None]
    diffuse = (1.0 - m) * albedo
    f0 = mix(torch.full_like(albedo, 0.04), albedo, m)
    return diffuse, f0


def cook_torrance_specular(view, light, normal, roughness, f0,
                           min_ndotv=0.1, min_ndotl=0.1):
    """Cook-Torrance specular lobe D*F*G / (4 NdotV NdotL)."""
    h = normalize(view + light)
    cos_theta = torch.clamp(dot(view, h), 0.0, 1.0)
    d = ggx_distribution(normal, h, roughness)
    g = ggx_partial_geometry(view, normal, h, roughness) * ggx_partial_geometry(
        light, normal, h, roughness)
    f = fresnel_schlick(cos_theta, f0)
    ndotv = torch.clamp_min(dot(normal, view), min_ndotv)
    ndotl = torch.clamp_min(dot(normal, light), min_ndotl)
    return (d * g / (4.0 * ndotv * ndotl))[..., None] * f


def lambert_diffuse(albedo, metallic):
    """Lambert term (1-metallic)*albedo/pi (raygen.rgen:258)."""
    return (1.0 - metallic[..., None]) * albedo / PI


def sample_ggx(n, v, roughness, r1, r2):
    """GGX importance-sampled reflection direction (cook-torrance.glsl:21-42).
    Where v is parallel to n the tangent is the zero vector (normalize's
    eps clamp), as in the JAX package."""
    a = roughness * roughness
    phi = 2.0 * PI * r1
    cos_t = torch.sqrt((1.0 - r2) / (1.0 + (a * a - 1.0) * r2))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    hx = torch.cos(phi) * sin_t
    hy = torch.sin(phi) * sin_t

    t = normalize(v - n * dot(n, v)[..., None])
    b = cross(n, t)
    halfway = normalize(hx[..., None] * t + hy[..., None] * b + cos_t[..., None] * n)
    return 2.0 * dot(v, halfway)[..., None] * halfway - v


def cosine_hemisphere(n, r1, r2):
    """Cosine-weighted hemisphere sample around n, in Frisvad's branchless
    basis; n.z = -0.0 takes the +1 sign, as jnp.where does."""
    phi = 2.0 * PI * r1
    cos_t = torch.sqrt(1.0 - r2)
    sin_t = torch.sqrt(r2)
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    bvec = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sign * n[..., 0] * n[..., 0] * a, sign * bvec,
                     -sign * n[..., 0]], dim=-1)
    b = torch.stack([bvec, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    d = ((torch.cos(phi) * sin_t)[..., None] * t
         + (torch.sin(phi) * sin_t)[..., None] * b
         + cos_t[..., None] * n)
    return normalize(d)
