"""Small vector-math helpers over trailing-dim-3 tensors.

Counterpart of realtimeraytracer_tpu/ops/vecmath.py.  Shape-polymorphic over
leading batch dims; safe normalization returns 0 for the zero vector.
``look_at_angles`` is host math in float64, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis; keeps no dims."""
    return (a * b).sum(-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def length(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(dot(a, a), 0.0))


def normalize(a: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return a * torch.rsqrt(torch.clamp_min(dot(a, a), eps))[..., None]


def reflect(incident: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """GLSL reflect: i - 2*dot(n,i)*n."""
    return incident - 2.0 * dot(normal, incident)[..., None] * normal


def mix(a, b, t):
    """GLSL mix / lerp."""
    return a * (1.0 - t) + b * t


def transform_points(mat4: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a (4,4) homogeneous transform to (..., 3) points."""
    return pts @ mat4[:3, :3].T + mat4[:3, 3]


def transform_dirs(mat4: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Apply the linear part of a (4,4) transform to (..., 3) directions."""
    return dirs @ mat4[:3, :3].T


def normal_matrix(mat4: torch.Tensor) -> torch.Tensor:
    """Inverse-transpose 3x3 for transforming normals (the reference
    computes it per hit in GLSL: closesthit.rchit:73-76)."""
    return torch.linalg.inv(mat4[:3, :3]).T


def look_at_angles(position, look_at) -> tuple[float, float]:
    """Yaw/pitch (degrees) of the direction from position to look_at, in
    the reference fly camera's convention (camera.cppm:84-86: pitch =
    asin(dir.y), yaw = atan2(dir.z, dir.x))."""
    def host(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return np.asarray(v, np.float64)

    d = host(look_at) - host(position)
    d = d / np.linalg.norm(d)
    return float(np.degrees(np.arctan2(d[2], d[0]))), float(np.degrees(np.arcsin(d[1])))
