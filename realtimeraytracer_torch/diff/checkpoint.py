"""Checkpoint / resume for inverse-rendering optimization.

Counterpart of realtimeraytracer_tpu/diff/checkpoint.py
(``save_checkpoint``, ``restore_checkpoint``, ``latest_step``): the
optimization loop's parameters and optimizer state, written with
``torch.save`` as ``{path}/step_{N}.pt``.  The JAX package's orbax
directories and npz files are not read (ROADMAP "Not to port").
"""

from __future__ import annotations

import os

import torch

from realtimeraytracer_torch.diff.optimize import TrainState
from realtimeraytracer_torch.utils import log


def _file(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step}.pt")


def save_checkpoint(path: str, state: TrainState, step: int) -> None:
    """Save a TrainState's params (by name, on the CPU) and its optimizer's
    state_dict at a step."""
    os.makedirs(path, exist_ok=True)
    torch.save({"params": {n: p.detach().cpu() for n, p in state.params.items()},
                "optimizer": state.optimizer.state_dict()}, _file(path, step))
    log.info("checkpoint saved: {}", _file(path, step))


def restore_checkpoint(path: str, like: TrainState, step: int) -> TrainState:
    """A new TrainState with the structure of `like` (parameter names,
    shapes, devices; an optimizer of like's class and settings) and the
    values saved at `step`.  A checkpoint of another structure raises:
    nothing is restored in part."""
    data = torch.load(_file(path, step), map_location="cpu", weights_only=True)
    saved = data["params"]
    if list(saved) != list(like.params):
        raise ValueError(f"checkpoint {_file(path, step)} holds params {list(saved)}; "
                         f"restore target has {list(like.params)}")
    for n, p in like.params.items():
        if tuple(saved[n].shape) != tuple(p.shape) or saved[n].dtype != p.dtype:
            raise ValueError(f"checkpoint param {n} is {saved[n].dtype} {tuple(saved[n].shape)}; "
                             f"restore target has {p.dtype} {tuple(p.shape)}")
    params = {n: saved[n].to(p.device).requires_grad_() for n, p in like.params.items()}
    optimizer = type(like.optimizer)(list(params.values()), **like.optimizer.defaults)
    optimizer.load_state_dict(data["optimizer"])
    return TrainState(params, optimizer)


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = []
    for name in os.listdir(path):
        if name.startswith("step_"):
            steps.append(int(name.split("_")[1].split(".")[0]))
    return max(steps) if steps else None
