"""Fused A-Trous denoiser: both stochastic images in one pass per iteration.

Counterpart of realtimeraytracer_tpu/ops/denoise_pallas.py::
atrous_denoise_pair.  ``atrous_denoise_pair`` runs each iteration as a
``torch.autograd.Function`` (``AtrousPairIteration``): its forward launches
csrc/atrous_pair.cu for CUDA tensors and runs the plain PyTorch twin
(``atrous_pair_iteration_plain``) for CPU tensors; its backward launches
csrc/atrous_pair_vjp.cu (B5b) for CUDA tensors, reading the weight sums
that the forward's kernel wrote beside its outputs, and runs the twin's
autograd (``atrous_pair_iteration_vjp_plain``) for CPU tensors.  There is
no fallback between the two.  ``atrous_pair_slab`` runs one iteration on
a halo-padded row slab, the step of the row-sharded denoise
(ops/denoise.py::atrous_denoise_sharded_rows).  Both forwards share the
normal/position weights between the two images and use the TPU kernel's
term order, so they agree with the per-image stencil (ops/denoise.py) to a
few float32 ulp.  The kernel multiplies by the phi's reciprocals, each
computed in double and rounded to float, which is what PyTorch's CUDA
division by a Python scalar does in the twin, so on the card the two agree
bit for bit.

The JAX package differentiates no Pallas kernel: under AD its dispatch
routes to the per-image XLA stencil.  The port keeps the pair under AD,
with a backward of its own (a port-only kernel).  The weights' clamp
``min(exp(.), 1)`` passes the whole gradient at a tie (exp == 1.0), as
``torch.clamp_max`` does; JAX's ``jnp.minimum`` passes half.  A tie needs
a squared difference under about 6e-8 * phi, where the term is tiny.
"""

from __future__ import annotations

import numpy as np
import torch

from realtimeraytracer_torch import kernels
from realtimeraytracer_torch.ops.denoise import KERNEL, _sq3, shifted_taps


def atrous_pair_iteration_plain(shadowed, unshadowed, normal, position,
                                step: int, c_phi: float, n_phi: float,
                                p_phi: float, weights: bool = False):
    """One iteration on both images, plain tensor ops (any device).  With
    `weights`, also each pixel's weight sums of both images, (2, H, W)
    (the kernel's W output)."""
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
    outs = (acc_s / torch.clamp_min(cum_s, 1e-5)[..., None],
            acc_u / torch.clamp_min(cum_u, 1e-5)[..., None])
    return outs + (torch.stack((cum_s, cum_u)),) if weights else outs


def _reciprocal(phi: float) -> float:
    """1 / phi as PyTorch's CUDA division by a Python scalar takes it:
    computed in double, rounded to float32."""
    return float(np.float32(1.0 / phi))


_NAMES = ("shadowed", "unshadowed", "normal", "position")


def _check(images, names=_NAMES, staged: bool = True) -> None:
    """CUDA tensors on one device, float32, (H, W, 3) alike, contiguous,
    needing no gradient; `staged` inputs (read with 16-byte copies) also
    16-byte aligned."""
    shape = images[0].shape
    for name, x in zip(names, images):
        if x.device.type != "cuda" or x.device != images[0].device:
            raise ValueError(f"{name} must be a CUDA tensor on {images[0].device}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
        if x.ndim != 3 or x.shape[2] != 3 or x.shape != shape:
            raise ValueError(f"{name} must be (H, W, 3) like shadowed, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.requires_grad:
            raise ValueError(f"{name} requires grad; differentiate through "
                             "atrous_denoise_pair, whose backward is the VJP kernel")
        if staged and x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel stages it with "
                             "16-byte copies)")


def atrous_pair_iteration_kernel(shadowed, unshadowed, normal, position,
                                 step: int, c_phi: float, n_phi: float,
                                 p_phi: float, weights: bool = False):
    """One launch of csrc/atrous_pair.cu (CUDA tensors only, 16-byte
    aligned; any step >= 1); adds one to ``atrous_denoise_pair.launches``.
    Each CTA stages its tile and the taps' rows of the four planes in
    shared memory; the result equals the twin's.  With `weights`, the
    kernel also writes each pixel's weight sums of both images, returned
    third as (2, H, W) (the backward's W)."""
    if step < 1:
        raise ValueError(f"step must be at least 1, got {step}")
    _check((shadowed, unshadowed, normal, position))
    h, w = shadowed.shape[0], shadowed.shape[1]
    s_out = torch.empty_like(shadowed)
    u_out = torch.empty_like(unshadowed)
    wsum = torch.empty((2, h, w), dtype=torch.float32, device=shadowed.device) if weights else None
    with torch.cuda.device(shadowed.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.launch("atrous_pair", shadowed.data_ptr(), unshadowed.data_ptr(),
                       normal.data_ptr(), position.data_ptr(), s_out.data_ptr(),
                       u_out.data_ptr(), None if wsum is None else wsum.data_ptr(), h, w, step,
                       1.0 / float(step * step),
                       *(_reciprocal(phi) for phi in (c_phi, n_phi, p_phi)), stream)
    atrous_denoise_pair.launches += 1
    return (s_out, u_out, wsum) if weights else (s_out, u_out)


def atrous_pair_iteration(shadowed, unshadowed, normal, position, step: int,
                          c_phi: float, n_phi: float, p_phi: float, weights: bool = False):
    """One pair iteration where the images lie: the kernel on CUDA tensors,
    the twin on CPU tensors."""
    device = shadowed.device.type
    if device == "cuda":
        return atrous_pair_iteration_kernel(shadowed, unshadowed, normal, position, step,
                                            c_phi, n_phi, p_phi, weights)
    if device == "cpu":
        return atrous_pair_iteration_plain(shadowed, unshadowed, normal, position, step,
                                           c_phi, n_phi, p_phi, weights)
    raise ValueError(f"no A-Trous pair denoiser for device {shadowed.device}")


def atrous_pair_slab(shadowed, unshadowed, normal, position, top: int, rows: int,
                     step: int, c_phi: float, n_phi: float, p_phi: float):
    """One pair iteration on a halo-padded row slab: (H', W, 3) images
    whose rows [top, top + rows) are the slab and whose other rows are the
    neighbours' (present only where a neighbour exists, so the kernel's
    bounds test is the whole image's).  Returns those `rows` of both
    filtered images, which equal the unsharded iteration's rows when each
    halo holds at least 2 step rows.  No collective."""
    s, u = atrous_pair_iteration(shadowed, unshadowed, normal, position, step,
                                 c_phi, n_phi, p_phi)
    return s[top:top + rows], u[top:top + rows]


def atrous_pair_iteration_vjp_plain(shadowed, unshadowed, normal, position,
                                    step: int, c_phi: float, n_phi: float,
                                    p_phi: float, g_shadowed, g_unshadowed,
                                    geometry_grads: bool = True):
    """The VJP of one pair iteration, plainly: recompute
    atrous_pair_iteration_plain under autograd and differentiate it (any
    device; the twin of the VJP kernel on the card).  Returns the
    gradients of (shadowed, unshadowed, normal, position) for the upstream
    gradients of the two outputs; normal's and position's are None unless
    geometry_grads."""
    with torch.enable_grad():
        ins = [x.detach().requires_grad_(i < 2 or geometry_grads)
               for i, x in enumerate((shadowed, unshadowed, normal, position))]
        outs = atrous_pair_iteration_plain(*ins, step, c_phi, n_phi, p_phi)
        grads = torch.autograd.grad(outs, ins if geometry_grads else ins[:2],
                                    (g_shadowed, g_unshadowed))
    return tuple(grads) + ((None, None) if not geometry_grads else ())


def atrous_pair_iteration_vjp_kernel(shadowed, unshadowed, normal, position,
                                     out_shadowed, out_unshadowed, weights, step: int,
                                     c_phi: float, n_phi: float, p_phi: float,
                                     g_shadowed, g_unshadowed,
                                     geometry_grads: bool = True):
    """One launch of csrc/atrous_pair_vjp.cu (CUDA tensors only): the VJP
    of the iteration whose inputs are (shadowed, unshadowed, normal,
    position) and whose outputs and weight sums were (out_shadowed,
    out_unshadowed, weights) (atrous_pair_iteration_kernel(...,
    weights=True)), for the upstream gradients g_*.  Each CTA stages its
    pixels' operands in shared memory (g / W once a pixel), then gathers
    one pixel a thread.  Returns the gradients of the four inputs,
    normal's and position's None unless geometry_grads; adds one to
    ``atrous_denoise_pair.vjp_launches``.  Its result equals
    atrous_pair_iteration_vjp_plain's up to float32 sums in another
    order."""
    if step < 1:
        raise ValueError(f"step must be at least 1, got {step}")
    ins = (shadowed, unshadowed, normal, position, out_shadowed, out_unshadowed,
           g_shadowed, g_unshadowed)
    _check(ins, _NAMES + ("out_shadowed", "out_unshadowed", "g_shadowed", "g_unshadowed"),
           staged=False)
    h, w = shadowed.shape[0], shadowed.shape[1]
    if (weights.device != shadowed.device or weights.dtype != torch.float32
            or weights.shape != (2, h, w) or not weights.is_contiguous()):
        raise ValueError(f"weights must be contiguous float32 (2, {h}, {w}) on {shadowed.device}")
    gs, gu = torch.empty_like(shadowed), torch.empty_like(unshadowed)
    gn = torch.empty_like(normal) if geometry_grads else None
    gp = torch.empty_like(position) if geometry_grads else None
    with torch.cuda.device(shadowed.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.launch("atrous_pair_vjp", *(x.data_ptr() for x in ins), weights.data_ptr(),
                       gs.data_ptr(), gu.data_ptr(),
                       None if gn is None else gn.data_ptr(),
                       None if gp is None else gp.data_ptr(), h, w, step,
                       1.0 / float(step * step),
                       *(_reciprocal(phi) for phi in (c_phi, n_phi, p_phi)), stream)
    atrous_denoise_pair.vjp_launches += 1
    return gs, gu, gn, gp


class AtrousPairIteration(torch.autograd.Function):
    """One pair iteration under autograd.  Forward: the kernel on CUDA
    tensors, the twin on CPU tensors.  Backward: the VJP kernel on CUDA
    tensors, the twin's autograd on CPU tensors; normal's and position's
    gradients only when asked for (with vertex or sphere parameters)."""

    @staticmethod
    def forward(ctx, shadowed, unshadowed, normal, position, step, c_phi, n_phi, p_phi):
        ins = tuple(x.detach() for x in (shadowed, unshadowed, normal, position))
        # On the card, when an input needs a gradient, the kernel also
        # writes the weight sums the VJP kernel reads (else its pointer is
        # null, as in every frame); the CPU backward differentiates the twin
        # and needs none.
        out = atrous_pair_iteration(*ins, step, c_phi, n_phi, p_phi,
                                    weights=shadowed.device.type == "cuda"
                                    and any(ctx.needs_input_grad[:4]))
        ctx.save_for_backward(*ins, *out)
        ctx.params = (step, c_phi, n_phi, p_phi)
        return out[:2]

    @staticmethod
    def backward(ctx, g_shadowed, g_unshadowed):
        # The saved outputs come back as the graph's tensors: detach all.
        s, u, n, p, out_s, out_u, *wsum = (x.detach() for x in ctx.saved_tensors)
        g_shadowed = torch.zeros_like(s) if g_shadowed is None else g_shadowed.contiguous()
        g_unshadowed = torch.zeros_like(u) if g_unshadowed is None else g_unshadowed.contiguous()
        geometry = ctx.needs_input_grad[2] or ctx.needs_input_grad[3]
        if s.device.type == "cuda":
            grads = atrous_pair_iteration_vjp_kernel(
                s, u, n, p, out_s, out_u, wsum[0], *ctx.params, g_shadowed, g_unshadowed,
                geometry)
        else:
            grads = atrous_pair_iteration_vjp_plain(
                s, u, n, p, *ctx.params, g_shadowed, g_unshadowed, geometry)
        return grads + (None,) * 4


def atrous_denoise_pair(shadowed, unshadowed, normal, position,
                        iterations: int = 4, c_phi: float = 1.0,
                        n_phi: float = 0.001, p_phi: float = 0.001):
    """Denoise both stochastic images, step_width = 1..iterations
    (application.cppm:395-434).  Returns (shadowed', unshadowed').
    Differentiable: each iteration is an AtrousPairIteration."""
    s, u = shadowed, unshadowed
    for i in range(iterations):
        s, u = AtrousPairIteration.apply(s, u, normal, position, i + 1, c_phi, n_phi, p_phi)
    return s, u


atrous_denoise_pair.launches = 0
atrous_denoise_pair.vjp_launches = 0
