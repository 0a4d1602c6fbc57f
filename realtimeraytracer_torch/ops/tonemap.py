"""Tone mapping: ACES filmic + power-law gamma, analytic and LUT-based.

Counterpart of realtimeraytracer_tpu/ops/tonemap.py (reference
raygen.rgen:45-59).
"""

from __future__ import annotations

import numpy as np
import torch


def aces_film(x: torch.Tensor) -> torch.Tensor:
    """Narkowicz ACES filmic curve, clamped to [0, 1]."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def linear_to_srgb(x: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    """pow(x, 1/gamma) for x > 0, else 0 (raygen.rgen:45-49)."""
    safe = torch.where(x > 0.0, x, 1.0)
    return torch.where(x > 0.0, torch.pow(safe, 1.0 / gamma), 0.0)


def srgb_to_linear(x: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    """Inverse of linear_to_srgb (miss.rmiss:14, closesthit.rchit:104)."""
    return torch.pow(torch.clamp_min(x, 0.0), gamma)


def build_tonemap_lut(size: int = 1024, max_input: float = 8.0,
                      gamma: float = 2.2) -> np.ndarray:
    """Precompute ACES+gamma as a 1D LUT over [0, max_input]."""
    x = np.linspace(0.0, max_input, size, dtype=np.float32)
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    y = np.clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)
    return np.power(y, 1.0 / gamma).astype(np.float32)


def apply_tonemap_lut(x: torch.Tensor, lut: torch.Tensor,
                      max_input: float = 8.0) -> torch.Tensor:
    """Linearly-interpolated 1D LUT lookup."""
    n = lut.shape[0]
    pos = torch.clamp(x, 0.0, max_input) * ((n - 1) / max_input)
    i0 = torch.clamp(pos.to(torch.int64), 0, n - 2)
    frac = pos - i0.to(torch.float32)
    return lut[i0] * (1.0 - frac) + lut[i0 + 1] * frac


def tonemap(x: torch.Tensor, mode: str = "aces", gamma: float = 2.2,
            lut: torch.Tensor | None = None) -> torch.Tensor:
    """Dispatch on RenderConfig.tonemap."""
    if mode == "aces":
        return linear_to_srgb(aces_film(x), gamma)
    if mode == "lut":
        if lut is None:
            lut = torch.from_numpy(build_tonemap_lut(gamma=gamma)).to(x.device)
        return apply_tonemap_lut(x, lut)
    if mode == "none":
        return x
    raise ValueError(f"unknown tonemap mode {mode!r}")
