"""Inverse rendering: differentiable losses and the gradient training step.

Counterpart of realtimeraytracer_tpu/diff/optimize.py (``OPTIMIZABLE``,
``extract_params``, ``apply_params``, ``radiance_loss``, ``pipeline_loss``,
``wavefront_loss``, ``TrainState``, ``make_train_step``, ``fit``): pixel
losses backprop through shading and intersection to material, light and
vertex parameters.  The hit search is straight-through: the BVH backends
hand their traces detached inputs (render/backends.py::stop_gradient) and
render/surface.py recomputes the continuous hit quantities from the
scene's leaves, so plain autograd works end to end; the analytic spheres
and the brute-force backend stay differentiable, as in JAX.  The full-frame
loss differentiates the fused A-Trous pair through its VJP kernel
(ops/denoise_kernel.py).

``torch.optim.Adam`` stands in for ``optax.adam`` (b1 0.9, b2 0.999, eps
1e-8 added outside the square root in both).  A step runs where the scene
lies: a scene on the card trains on the card, a CPU scene on the CPU, and
inputs on another device raise.  The training step shards the rays over
the ray mesh (parallel/mesh.py): each rank takes radiance_loss on its slab,
and the loss and the parameter gradients become their means over the ranks
(one all-reduce a step, JAX's pmean and the psum of its transpose), so
every rank's Adam step sees the same gradient and the params stay
replicated.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from realtimeraytracer_torch.config import RenderConfig
from realtimeraytracer_torch.ops.camera_rays import ViewportFrame
from realtimeraytracer_torch.parallel.mesh import RayMesh, make_ray_mesh
from realtimeraytracer_torch.render.backends import make_backend
from realtimeraytracer_torch.render.megakernel import render_components, shade_sample
from realtimeraytracer_torch.render.pipeline import denoise_and_combine
from realtimeraytracer_torch.render.wavefront import wavefront_frame
from realtimeraytracer_torch.scene.gpu_scene import TorchScene

# TorchScene leaves that are legal optimization targets.
OPTIMIZABLE = (
    "obj_color", "obj_specular", "obj_metallic",
    "lt_color", "lt_intensity",
    "sun_color", "sun_intensity", "env_color",
    "vertices", "sph_center", "sph_radius",
)


def extract_params(gpu: TorchScene, names: tuple[str, ...]) -> dict:
    for n in names:
        if n not in OPTIMIZABLE:
            raise ValueError(f"{n} is not an optimizable TorchScene leaf")
    return {n: getattr(gpu, n) for n in names}


def apply_params(gpu: TorchScene, params: dict) -> TorchScene:
    return dataclasses.replace(gpu, **params)


def _mse(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    err = img - target
    return torch.mean(err * err)


def radiance_loss(params: dict, gpu: TorchScene, cfg: RenderConfig,
                  origins, dirs, pixel_seed, target) -> torch.Tensor:
    """Mean squared error of the analytic radiance against a target.

    (The analytic LTC estimate is noise-free, so it is the natural training
    signal; the stochastic channels would add gradient variance.)"""
    g = apply_params(gpu, params)
    rad = shade_sample(g, cfg, origins, dirs, pixel_seed, make_backend(g, cfg))
    return _mse(rad.analytic, target)


def pipeline_loss(params: dict, gpu: TorchScene, cfg: RenderConfig,
                  frame: ViewportFrame, frame_index: int, target) -> torch.Tensor:
    """MSE of the FULL pipeline image (trace + A-Trous denoise x N + ratio
    combine, render/pipeline.py) against an (H, W, 3) target: gradients
    flow through the denoiser's edge-stopping weights and the ratio combine
    as well as shading and intersection."""
    g = apply_params(gpu, params)
    comp = render_components(g, frame, cfg, frame_index, make_backend(g, cfg))
    return _mse(denoise_and_combine(comp, cfg), target)


def wavefront_loss(params: dict, gpu: TorchScene, cfg: RenderConfig,
                   frame: ViewportFrame, frame_index: int, target) -> torch.Tensor:
    """MSE of the multi-bounce wavefront image (render/wavefront.py)
    against an (H, W, 3) target: gradients flow through the NEE + GGX
    estimator (bounce directions and hit ids are detached; the continuous
    shading recompute is differentiable)."""
    g = apply_params(gpu, params)
    return _mse(wavefront_frame(g, frame, cfg, frame_index, make_backend(g, cfg)), target)


class TrainState(NamedTuple):
    """Leaf tensors that require grad, by OPTIMIZABLE name, and the
    optimizer that steps them (its state is optax's opt_state)."""

    params: dict
    optimizer: torch.optim.Optimizer


def adam(params: dict, learning_rate: float) -> torch.optim.Adam:
    """optax.adam(learning_rate) over the params: b1 0.9, b2 0.999, eps
    1e-8 outside the square root."""
    return torch.optim.Adam(list(params.values()), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def train_state_from_numpy(params: dict, mu: dict, nu: dict, count: int,
                           learning_rate: float) -> TrainState:
    """A CPU TrainState carrying JAX's params and optax.adam state
    (ScaleByAdamState count, mu, nu), each as NumPy arrays by name, so one
    step of each package can be compared."""
    p = {n: torch.tensor(np.asarray(v, np.float32)).requires_grad_() for n, v in params.items()}
    opt = adam(p, learning_rate)
    for n, t in p.items():
        opt.state[t] = {"step": torch.tensor(float(count), dtype=torch.float32),
                        "exp_avg": torch.tensor(np.asarray(mu[n], np.float32)),
                        "exp_avg_sq": torch.tensor(np.asarray(nu[n], np.float32))}
    return TrainState(p, opt)


def _same_device(gpu: TorchScene, **tensors) -> None:
    for name, x in tensors.items():
        if isinstance(x, torch.Tensor) and x.device != gpu.device:
            raise ValueError(f"{name} is on {x.device} and the scene on {gpu.device}: a step "
                             "runs where the scene lies")


def _step(state: TrainState, optimizer: torch.optim.Optimizer, loss_fn,
          mesh: RayMesh | None = None):
    """One gradient step of loss_fn(params) on state, in place (PyTorch's
    optimizers step their tensors in place): returns (state, the loss as a
    0-d tensor on the scene's device).  With a mesh, loss_fn is this rank's
    share and the loss and gradients are averaged over its ranks (one
    all-reduce of them all) before the update."""
    if state.optimizer is not optimizer:
        raise ValueError("the state's optimizer is not the one the step was built with")
    optimizer.zero_grad(set_to_none=True)
    with record_function("diff.forward"):
        loss = loss_fn(state.params)
    loss.backward()
    loss = loss.detach()
    if mesh is not None and mesh.group is not None:
        params = list(state.params.values())
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        flat = mesh.all_reduce_mean(torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)]))
        at = 0
        for p in params:
            p.grad = flat[at:at + p.numel()].view_as(p)
            at += p.numel()
        loss = flat[at]
    optimizer.step()
    return state, loss


def make_train_step(cfg: RenderConfig, mesh: RayMesh, optimizer: torch.optim.Optimizer):
    """The sharded gradient step of radiance_loss: step(state, gpu,
    origins, dirs, pixel_seed, target) -> (state, loss), on the device of
    the scene (the rays and target must lie there too).  The rays (R
    divisible by the mesh size) split over the mesh, each rank taking its
    slab; the loss is the mean of the ranks' losses (the global mean, the
    slabs being equal) and the gradients are all-reduced, so the params
    stay replicated.  A one-rank mesh is the single-device step.  The state
    must carry `optimizer`, which steps its params in place."""
    if not isinstance(mesh, RayMesh):
        raise TypeError(f"mesh must be a RayMesh (parallel/mesh.py::make_ray_mesh), got "
                        f"{type(mesh).__name__}")

    def train_step(state: TrainState, gpu: TorchScene, origins, dirs, pixel_seed, target):
        _same_device(gpu, origins=origins, dirs=dirs, pixel_seed=pixel_seed, target=target,
                     **state.params)
        if mesh.group is not None and mesh.device.type != gpu.device.type:
            raise ValueError(f"the mesh is on {mesh.device} and the scene on {gpu.device}")
        a, b = mesh.slab(origins.shape[0])
        return _step(state, optimizer, lambda p: radiance_loss(
            p, gpu, cfg, origins[a:b], dirs[a:b], pixel_seed[a:b], target[a:b]), mesh)

    return train_step


def fit(
    gpu: TorchScene,
    cfg: RenderConfig,
    origins=None, dirs=None, pixel_seed=None, target=None,
    param_names: tuple[str, ...] = ("obj_color",),
    mesh=None,
    learning_rate: float = 2e-2,
    steps: int = 100,
    loss: str = "radiance",
    frame: ViewportFrame | None = None,
    frame_index: int = 0,
):
    """Inverse-rendering loop (BASELINE config 5 shape): returns (params,
    losses), the params as detached tensors by name and one float a step
    (each is one host sync).

    loss="radiance": analytic-channel MSE on explicit rays, sharded over
    the ray mesh (default make_ray_mesh() on the scene's device: every
    rank of the process group, or this process alone) with all-reduced
    gradients.
    loss="pipeline" / "wavefront": full-image MSE through the complete
    pipeline (denoise + ratio combine) or the multi-bounce path tracer;
    pass `frame` (camera ViewportFrame) and an (H, W, 3) `target`.  These
    run as one logical device, as in JAX (mesh is not read).
    Everything runs on the scene's device."""
    if mesh is not None and not isinstance(mesh, RayMesh):
        raise TypeError(f"mesh must be a RayMesh (parallel/mesh.py::make_ray_mesh), got "
                        f"{type(mesh).__name__}")
    params = {n: t.detach().clone().requires_grad_()
              for n, t in extract_params(gpu, param_names).items()}
    optimizer = adam(params, learning_rate)
    state = TrainState(params, optimizer)
    if loss == "radiance":
        if origins is None or dirs is None or pixel_seed is None or target is None:
            raise ValueError("loss='radiance' requires origins=, dirs=, pixel_seed= and target=")
        step = make_train_step(cfg, mesh or make_ray_mesh(device=gpu.device), optimizer)

        def run(st):
            return step(st, gpu, origins, dirs, pixel_seed, target)
    elif loss in ("pipeline", "wavefront"):
        loss_fn = pipeline_loss if loss == "pipeline" else wavefront_loss
        if frame is None:
            raise ValueError(f"loss={loss!r} requires frame=")
        _same_device(gpu, frame=frame.position, target=target)

        def run(st):
            return _step(st, optimizer, lambda p: loss_fn(p, gpu, cfg, frame, frame_index,
                                                          target))
    else:
        raise ValueError(f"unknown loss {loss!r}: 'radiance', 'pipeline' or 'wavefront'")

    losses = []
    for _ in range(steps):
        state, val = run(state)
        losses.append(float(val))
    return {n: p.detach() for n, p in state.params.items()}, losses
