"""Fused A-Trous denoiser: both stochastic images in one pass per iteration.

Counterpart of realtimeraytracer_tpu/ops/denoise_pallas.py::
atrous_denoise_pair.  ``atrous_denoise_pair`` launches csrc/atrous_pair.cu
once per iteration for CUDA tensors and runs the plain PyTorch twin
(``atrous_pair_iteration_plain``) for CPU tensors; there is no fallback
between the two.  Both share the normal/position weights between the two
images and use the TPU kernel's term order, so they agree with the
per-image stencil (ops/denoise.py) to a few float32 ulp.  The kernel
multiplies by the phi's reciprocals, each computed in double and rounded
to float, which is what PyTorch's CUDA division by a Python scalar does
in the twin, so on the card the two agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from realtimeraytracer_torch import kernels
from realtimeraytracer_torch.ops.denoise import KERNEL, _sq3, shifted_taps


def atrous_pair_iteration_plain(shadowed, unshadowed, normal, position,
                                step: int, c_phi: float, n_phi: float,
                                p_phi: float):
    """One iteration on both images, plain tensor ops (any device)."""
    acc_s = torch.zeros_like(shadowed)
    acc_u = torch.zeros_like(unshadowed)
    cum_s = torch.zeros(shadowed.shape[:2], dtype=shadowed.dtype,
                        device=shadowed.device)
    cum_u = torch.zeros_like(cum_s)
    inv_step2 = 1.0 / float(step * step)
    for ky, kx, (cs, cu, ns, ps), valid in shifted_taps(
            (shadowed, unshadowed, normal, position), step):
        w_cs = torch.clamp_max(torch.exp(-_sq3(shadowed, cs) / c_phi), 1.0)
        w_cu = torch.clamp_max(torch.exp(-_sq3(unshadowed, cu) / c_phi), 1.0)
        w_n = torch.clamp_max(torch.exp(-(_sq3(normal, ns) * inv_step2) / n_phi), 1.0)
        w_p = torch.clamp_max(torch.exp(-_sq3(position, ps) / p_phi), 1.0)
        wnp = (w_n * w_p) * float(KERNEL[ky][kx]) * valid
        ws = w_cs * wnp
        wu = w_cu * wnp
        acc_s = acc_s + cs * ws[..., None]
        acc_u = acc_u + cu * wu[..., None]
        cum_s = cum_s + ws
        cum_u = cum_u + wu
    return (acc_s / torch.clamp_min(cum_s, 1e-5)[..., None],
            acc_u / torch.clamp_min(cum_u, 1e-5)[..., None])


def _reciprocal(phi: float) -> float:
    """1 / phi as PyTorch's CUDA division by a Python scalar takes it:
    computed in double, rounded to float32."""
    return float(np.float32(1.0 / phi))


def _check(images) -> None:
    shape = images[0].shape
    for name, x in zip(("shadowed", "unshadowed", "normal", "position"), images):
        if x.device.type != "cuda" or x.device != images[0].device:
            raise ValueError(f"{name} must be a CUDA tensor on {images[0].device}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
        if x.ndim != 3 or x.shape[2] != 3 or x.shape != shape:
            raise ValueError(f"{name} must be (H, W, 3) like shadowed, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.requires_grad:
            raise ValueError(f"{name} requires grad; the denoise kernel has no backward")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel stages it with "
                             "16-byte copies)")


def atrous_pair_iteration_kernel(shadowed, unshadowed, normal, position,
                                 step: int, c_phi: float, n_phi: float,
                                 p_phi: float):
    """One launch of csrc/atrous_pair.cu (CUDA tensors only, 16-byte
    aligned; any step >= 1); adds one to ``atrous_denoise_pair.launches``.
    Each CTA stages its tile and the taps' rows of the four planes in
    shared memory; the result equals the twin's."""
    if step < 1:
        raise ValueError(f"step must be at least 1, got {step}")
    _check((shadowed, unshadowed, normal, position))
    h, w = shadowed.shape[0], shadowed.shape[1]
    s_out = torch.empty_like(shadowed)
    u_out = torch.empty_like(unshadowed)
    with torch.cuda.device(shadowed.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.launch("atrous_pair", shadowed.data_ptr(), unshadowed.data_ptr(),
                       normal.data_ptr(), position.data_ptr(), s_out.data_ptr(),
                       u_out.data_ptr(), h, w, step, 1.0 / float(step * step),
                       *(_reciprocal(phi) for phi in (c_phi, n_phi, p_phi)), stream)
    atrous_denoise_pair.launches += 1
    return s_out, u_out


def atrous_denoise_pair(shadowed, unshadowed, normal, position,
                        iterations: int = 4, c_phi: float = 1.0,
                        n_phi: float = 0.001, p_phi: float = 0.001):
    """Denoise both stochastic images, step_width = 1..iterations
    (application.cppm:395-434).  Returns (shadowed', unshadowed')."""
    device = shadowed.device.type
    if device == "cuda":
        step_fn = atrous_pair_iteration_kernel
    elif device == "cpu":
        step_fn = atrous_pair_iteration_plain
    else:
        raise ValueError(f"no A-Trous pair denoiser for device {shadowed.device}")
    s, u = shadowed, unshadowed
    for i in range(iterations):
        s, u = step_fn(s, u, normal, position, i + 1, c_phi, n_phi, p_phi)
    return s, u


atrous_denoise_pair.launches = 0
