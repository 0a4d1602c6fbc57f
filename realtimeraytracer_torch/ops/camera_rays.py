"""Primary-ray generation from a pinhole viewport frame.

Counterpart of realtimeraytracer_tpu/ops/camera_rays.py (``ViewportFrame``,
``block_permutation``, ``generate_rays``): the reference's
``dir = normalize(topLeft + (px+jx-0.5)*hDelta + (py+jy-0.5)*vDelta - pos)``
(raygen.rgen:86-92) over the whole image at once, with the same per-pixel
counter-hash jitter.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from realtimeraytracer_torch.ops import rng
from realtimeraytracer_torch.ops.vecmath import normalize


class ViewportFrame(NamedTuple):
    """Device-side camera frame, float32 (3,) tensors."""

    position: torch.Tensor
    top_left: torch.Tensor
    h_delta: torch.Tensor
    v_delta: torch.Tensor


@functools.lru_cache(maxsize=8)
def _block_permutation_np(width: int, height: int, block_w: int, block_h: int):
    py, px = np.mgrid[0:height, 0:width]
    blocks_x = -(-width // block_w)
    block_id = (py // block_h) * blocks_x + (px // block_w)
    within = (py % block_h) * block_w + (px % block_w)
    key = block_id.astype(np.int64) * (block_w * block_h) + within
    perm = np.argsort(key.reshape(-1), kind="stable")
    inv = np.argsort(perm, kind="stable")
    perm.flags.writeable = inv.flags.writeable = False
    return perm, inv


@functools.lru_cache(maxsize=8)
def _block_permutation_on(width: int, height: int, block_w: int, block_h: int,
                          device: torch.device):
    perm, inv = _block_permutation_np(width, height, block_w, block_h)
    # Built outside inference mode whatever the caller's mode: an inference
    # tensor cannot be saved for backward, and a gradient's gather by
    # inv_perm saves it, so the first frame of a process (rendered under
    # inference_mode) would otherwise break every later loss.
    with torch.inference_mode(False):
        return torch.tensor(perm, device=device), torch.tensor(inv, device=device)


def block_permutation(width: int, height: int, block_w: int = 16,
                      block_h: int = 8, device: str | torch.device = "cpu"):
    """Permutation turning raster-order rays into (block_h x block_w)-tile
    order, plus its inverse, as int64 index tensors.  Coherent pixel blocks
    give each 128-ray tile a tight direction cone for the cull.  Static per
    resolution and device: built once and cached, so a frame copies nothing
    from the host for it (the tensors are shared: read them, never write
    them)."""
    return _block_permutation_on(width, height, block_w, block_h, torch.device(device))


def generate_rays(frame: ViewportFrame, width: int, height: int,
                  sample_index: int = 0, jitter: bool = True):
    """One sample's primary rays: (origins, directions), each (H*W, 3)."""
    dev = frame.position.device
    py = torch.arange(height, device=dev, dtype=torch.int64)[:, None].expand(height, width)
    px = torch.arange(width, device=dev, dtype=torch.int64)[None, :].expand(height, width)
    s = int(sample_index) & rng.MASK32
    if jitter:
        base = (py * width + px) & rng.MASK32
        jx = rng.uniform(base + s)
        jy = rng.uniform(base + ((s * 322) & rng.MASK32) + 7919)
    else:
        jx = jy = torch.full((height, width), 0.5, device=dev)
    ox = px.to(torch.float32) + jx - 0.5
    oy = py.to(torch.float32) + jy - 0.5

    world = (frame.top_left + ox[..., None] * frame.h_delta
             + oy[..., None] * frame.v_delta)
    dirs = normalize(world - frame.position)
    origins = frame.position.expand(height, width, 3)
    return origins.reshape(-1, 3), dirs.reshape(-1, 3)
