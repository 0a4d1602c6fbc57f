"""Small vector-math helpers over trailing-dim-3 tensors.

Counterpart of realtimeraytracer_tpu/ops/vecmath.py.  Shape-polymorphic over
leading batch dims; safe normalization returns 0 for the zero vector.
"""

from __future__ import annotations

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
