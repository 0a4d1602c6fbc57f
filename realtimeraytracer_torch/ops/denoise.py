"""Edge-avoiding A-Trous wavelet denoiser and the ratio combine.

Counterpart of realtimeraytracer_tpu/ops/denoise.py (``atrous_iteration``,
``atrous_denoise``, ``ratio_combine``, ``atrous_denoise_sharded_rows``;
reference shaders/denoise.comp and combine.comp): a 5x5 kernel dilated by
step_width, edge-stopping weights exp(-|dColor|^2/c_phi) *
exp(-|dNormal|^2/(step^2 n_phi)) * exp(-|dPos|^2/p_phi), out-of-bounds taps
skipped, step_width = i+1.  This is the per-image reference stencil; the
frame denoises with the fused two-image pair of ops/denoise_kernel.py (CUDA
kernel, or its plain twin on the CPU), which shares ``shifted_taps`` and
the term order with it; the row-sharded denoise runs that pair on
halo-padded row slabs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# 5x5 Gaussian (denoise.comp:28-34).
KERNEL = (
    (1, 4, 7, 4, 1),
    (4, 16, 26, 16, 4),
    (7, 26, 41, 26, 7),
    (4, 16, 26, 16, 4),
    (1, 4, 7, 4, 1),
)


def shifted_taps(images, step: int):
    """Yield (ky, kx, taps, valid) over the 25 dilated taps: taps[i] is
    images[i] shifted so that pixel (y, x) holds (y + dy, x + dx), zero
    outside the image, and valid is the (H, W) in-bounds mask."""
    h, w = images[0].shape[0], images[0].shape[1]
    r = 2 * step
    padded = [F.pad(im.permute(2, 0, 1), (r, r, r, r)) for im in images]
    ones = F.pad(images[0].new_ones((1, h, w)), (r, r, r, r))
    for ky in range(5):
        for kx in range(5):
            y0 = r + (ky - 2) * step
            x0 = r + (kx - 2) * step
            taps = [p[:, y0:y0 + h, x0:x0 + w].permute(1, 2, 0) for p in padded]
            yield ky, kx, taps, ones[0, y0:y0 + h, x0:x0 + w]


def _sq3(a, b):
    d = a - b
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def atrous_iteration(color, normal, position, step_width: int,
                     c_phi: float, n_phi: float, p_phi: float):
    """One dilated 5x5 edge-avoiding pass over one (H, W, 3) image."""
    acc = torch.zeros_like(color)
    cum = torch.zeros(color.shape[:2] + (1,), dtype=color.dtype,
                      device=color.device)
    inv_step2 = 1.0 / float(step_width * step_width)
    for ky, kx, (c_s, n_s, p_s), valid in shifted_taps(
            (color, normal, position), step_width):
        w_c = torch.clamp_max(torch.exp(-_sq3(color, c_s) / c_phi), 1.0)
        w_n = torch.clamp_max(torch.exp(-(_sq3(normal, n_s) * inv_step2) / n_phi), 1.0)
        w_p = torch.clamp_max(torch.exp(-_sq3(position, p_s) / p_phi), 1.0)
        w = (w_c * w_n * w_p)[..., None] * float(KERNEL[ky][kx]) * valid[..., None]
        acc = acc + c_s * w
        cum = cum + w
    return acc / torch.clamp_min(cum, 1e-5)


def atrous_denoise(color, normal, position, iterations: int = 4,
                   c_phi: float = 1.0, n_phi: float = 0.001,
                   p_phi: float = 0.001):
    """Full denoise: iterations passes with step_width = 1..iterations."""
    out = color
    for i in range(iterations):
        out = atrous_iteration(out, normal, position, i + 1, c_phi, n_phi, p_phi)
    return out


def ratio_combine(analytic, shadowed, unshadowed, eps: float = 1e-3):
    """Heitz-style ratio estimator: analytic * shadowed / max(unshadowed,
    eps) (combine.comp:31-33)."""
    return analytic * (shadowed / torch.clamp_min(unshadowed, eps))


def atrous_denoise_sharded_rows(shadowed, unshadowed, normal, position, mesh,
                                iterations: int = 4, c_phi: float = 1.0,
                                n_phi: float = 0.001, p_phi: float = 0.001):
    """A-Trous denoise of both images of a ROW-SHARDED frame: each rank of
    `mesh` (parallel/mesh.py) holds its contiguous (H/n, W, 3) row slab.

    Iteration i's dilated taps reach +-2 (i + 1) rows, so each iteration
    exchanges a halo of 2 * iterations rows with the two ring neighbours
    (the filtered images change every pass; the G-buffer halos are
    exchanged once), then runs the pair iteration on the halo-padded slab
    (ops/denoise_kernel.py::atrous_pair_slab: the kernel on the card, the
    twin on the CPU) and keeps its centre rows.  A slab is padded only
    where a neighbour exists, so the kernel's own bounds test is the whole
    image's, and every pixel's arithmetic is the unsharded pair's: the
    result equals atrous_denoise_pair's rows.  No full-image gather.
    Returns this rank's (shadowed', unshadowed') rows."""
    from realtimeraytracer_torch.ops.denoise_kernel import atrous_pair_slab

    halo = 2 * iterations
    rows = shadowed.shape[0]
    if rows < halo:
        raise ValueError(
            f"row slab of {rows} rows cannot supply the {halo}-row halo (2*iterations) from a "
            "single neighbor; use fewer devices or fewer iterations")

    def padded(x, edges):
        return torch.cat([e for e in (edges[0], x, edges[1]) if e is not None])

    top = halo if mesh.rank > 0 else 0
    n_edges, p_edges = mesh.exchange_halo([normal, position], halo)
    normal_p, position_p = padded(normal, n_edges), padded(position, p_edges)
    s, u = shadowed, unshadowed
    for i in range(iterations):
        s_edges, u_edges = mesh.exchange_halo([s, u], halo)
        s, u = atrous_pair_slab(padded(s, s_edges), padded(u, u_edges), normal_p, position_p,
                                top, rows, i + 1, c_phi, n_phi, p_phi)
    return s, u
