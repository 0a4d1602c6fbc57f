"""Profiling and throughput counters.

Counterpart of realtimeraytracer_tpu/utils/profiling.py: ``RayCounter``
(rays/s), ``trace`` (a torch.profiler capture of CPU and CUDA activity,
written as a Chrome trace) and ``time_fn`` (median wall time of a call,
synchronizing the device of the tensors it returns).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass

import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._pytree import tree_leaves

from realtimeraytracer_torch.utils import log


@dataclass
class RayCounter:
    """Accumulates ray counts and wall time -> rays/s."""

    rays: int = 0
    seconds: float = 0.0
    _t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, rays: int) -> float:
        dt = time.perf_counter() - self._t0
        self.rays += rays
        self.seconds += dt
        return dt

    @property
    def rays_per_sec(self) -> float:
        return self.rays / self.seconds if self.seconds else 0.0


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the block (CPU and, where there is a card, CUDA activity)
    and write a Chrome trace, ``trace.json``, into log_dir (default: a
    directory under the temporary directory).  Yields the profiler."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "rtrt_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to {}", path)


def _sync(out) -> None:
    """Wait for the devices of every CUDA tensor in out (a tensor or a
    nested structure of them)."""
    for dev in {x.device for x in tree_leaves(out)
                if isinstance(x, torch.Tensor) and x.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def time_fn(fn, *args, iters: int = 5, warmup: int = 1, **kwargs) -> float:
    """Median wall seconds of fn(*args, **kwargs), each call ended by a
    synchronize of its result's CUDA devices (the call's host time alone
    for CPU tensors)."""
    for _ in range(warmup):
        _sync(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
