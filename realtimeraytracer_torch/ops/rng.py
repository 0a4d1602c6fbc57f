"""Counter-based RNG for ray jitter and light sampling.

Counterpart of realtimeraytracer_tpu/ops/rng.py: the reference's PCG-style
integer hash (raycommon.glsl:22-27).  PyTorch's uint32 arithmetic is thin,
so seeds are int64 tensors holding values in [0, 2^32) and every step masks
back to 32 bits — the form of ``hash_u32_np``, bit-equal to ``hash_u32``.
No torch.Generator is involved: the hash is the generator.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """Wrap an integer tensor to a uint32 value held in int64."""
    return x.to(torch.int64) & MASK32


def hash_u32(seed: torch.Tensor) -> torch.Tensor:
    """PCG output-permutation hash of a uint32 counter -> uint32 (int64)."""
    state = (u32(seed) * 747796405 + 2891336453) & MASK32
    shift = (state >> 28) + 4
    word = (((state >> shift) ^ state) * 277803737) & MASK32
    return ((word >> 22) ^ word) & MASK32


def uniform(seed: torch.Tensor) -> torch.Tensor:
    """Hash a uint32 counter to a float32 uniform in [0, 1)."""
    return hash_u32(seed).to(torch.float32) * (1.0 / 4294967296.0)
