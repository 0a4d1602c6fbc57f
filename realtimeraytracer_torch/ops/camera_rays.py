"""Primary-ray generation from a pinhole viewport frame.

Counterpart of realtimeraytracer_tpu/ops/camera_rays.py (``ViewportFrame``,
``block_permutation``, ``pixel_grid``, ``generate_ray_blocks``,
``blocks_to_image_scatter``, ``generate_rays``): the reference's
``dir = normalize(topLeft + (px+jx-0.5)*hDelta + (py+jy-0.5)*vDelta - pos)``
(raygen.rgen:86-92) over the whole image at once, with the same per-pixel
counter-hash jitter.  ``generate_ray_blocks`` emits the rays straight in
the traversal kernels' packed (Ts, 8, 128) tile layout, one 16x8 pixel
block a tile (the thin slice: blocks, then v9 or v7 closest).
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


def pixel_grid(width: int, height: int, device: str | torch.device = "cpu"):
    """Integer pixel coordinate grids px, py of shape (height, width),
    int64 (the port's integer type for ids and seeds)."""
    py = torch.arange(height, device=device, dtype=torch.int64)[:, None].expand(height, width)
    px = torch.arange(width, device=device, dtype=torch.int64)[None, :].expand(height, width)
    return px, py


def _jitter(px, py, width: int, sample_index: int):
    """The per-pixel counter-hash jitter (jx, jy) of raygen.rgen:84: seeds
    ``pixel + i`` and ``pixel + i*322 + 7919``, uint32 arithmetic."""
    s = int(sample_index) & rng.MASK32
    base = (py * width + px) & rng.MASK32
    return rng.uniform(base + s), rng.uniform(base + ((s * 322) & rng.MASK32) + 7919)


def generate_ray_blocks(frame: ViewportFrame, width: int, height: int,
                        sample_index: int = 0, jitter: bool = True,
                        t_min: float = 1e-3, t_max: float = 1e4,
                        block_w: int = 16, block_h: int = 8) -> torch.Tensor:
    """Primary rays directly in the traversal kernels' packed tile layout.

    Returns (Ts, 8, 128) float32 blocks, rows [o.xyz | d.xyz | t_min |
    t_max], on the frame's device; each tile is one (block_h x block_w)
    pixel block, so tiles have tight direction cones for the cull.  The
    pixel coordinates come from 4-D (by, bx, block_h, block_w) arange
    broadcasts (no division or remainder over every lane), the directions
    are normalized with rsqrt, and the jitter is generate_rays'.  Lanes
    outside the image (when width or height does not divide the block)
    get t_min=+3e38, t_max=-3e38, so traversal retires them at once."""
    lanes = block_w * block_h
    if lanes != 128:
        raise ValueError(f"the tile layout is fixed at 128 lanes, not {block_w}x{block_h}")
    bx, by = -(-width // block_w), -(-height // block_h)
    ts = bx * by
    dev = frame.position.device

    def ar(n, axis):
        shape = [1, 1, 1, 1]
        shape[axis] = n
        return torch.arange(n, device=dev, dtype=torch.int64).view(shape)

    g4 = (by, bx, block_h, block_w)
    px = (ar(bx, 1) * block_w + ar(block_w, 3)).expand(g4).reshape(ts, lanes)
    py = (ar(by, 0) * block_h + ar(block_h, 2)).expand(g4).reshape(ts, lanes)
    valid = (px < width) & (py < height)
    if jitter:
        jx, jy = _jitter(px, py, width, sample_index)
    else:
        jx = jy = 0.5
    ox = px.to(torch.float32) + jx - 0.5
    oy = py.to(torch.float32) + jy - 0.5

    d = [frame.top_left[a] + ox * frame.h_delta[a] + oy * frame.v_delta[a] - frame.position[a]
         for a in range(3)]
    inv_n = torch.rsqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    big = torch.tensor(3.0e38, dtype=torch.float32, device=dev)
    return torch.stack(
        [frame.position[0].expand(ts, lanes), frame.position[1].expand(ts, lanes),
         frame.position[2].expand(ts, lanes),
         d[0] * inv_n, d[1] * inv_n, d[2] * inv_n,
         torch.where(valid, torch.tensor(t_min, dtype=torch.float32, device=dev), big),
         torch.where(valid, torch.tensor(t_max, dtype=torch.float32, device=dev), -big)],
        dim=1)


def blocks_to_image_scatter(width: int, height: int, block_w: int = 16, block_h: int = 8,
                            device: str | torch.device = "cpu") -> torch.Tensor:
    """(H*W,) int64 index unpacking blocked outputs: image_flat =
    blocked_flat[scatter], where scatter[y*width + x] is the blocked
    position of pixel (x, y) (the (Ts, 128) layout of
    ``generate_ray_blocks``)."""
    bx = -(-width // block_w)
    py, px = np.mgrid[0:height, 0:width]
    tid = (py // block_h) * bx + (px // block_w)
    lane = (py % block_h) * block_w + (px % block_w)
    return torch.as_tensor((tid * (block_w * block_h) + lane).reshape(-1), dtype=torch.int64,
                           device=device)


def generate_rays(frame: ViewportFrame, width: int, height: int,
                  sample_index: int = 0, jitter: bool = True):
    """One sample's primary rays: (origins, directions), each (H*W, 3)."""
    dev = frame.position.device
    px, py = pixel_grid(width, height, dev)
    if jitter:
        jx, jy = _jitter(px, py, width, sample_index)
    else:
        jx = jy = torch.full((height, width), 0.5, device=dev)
    ox = px.to(torch.float32) + jx - 0.5
    oy = py.to(torch.float32) + jy - 0.5

    world = (frame.top_left + ox[..., None] * frame.h_delta
             + oy[..., None] * frame.v_delta)
    dirs = normalize(world - frame.position)
    origins = frame.position.expand(height, width, 3)
    return origins.reshape(-1, 3), dirs.reshape(-1, 3)
