"""The f32 FMA-chain peak probe: the card's measured f32 FMA rate.

Counterpart of scripts/r4_probe.py::vpu_peak (the JAX package's TPU
probe; the script's other probes are TPU statistics and are not ported).
The kernel is csrc/fma_peak.cu: per element of a (512, 128) f32 array,
eight independent chains of 64 steps acc = fma(acc, b, 1e-9), summed, and
the TPU grid's 64 repeats as 64 slices of the launch grid: 4.295 GFLOP of
f32 FMA per call.  ``fma_peak`` times it with CUDA events; the rate sits
beside the 67 TFLOP/s f32 peak of the H100 SXM data sheet that the
traversal kernels' bounds divide by.

Run on a GPU machine:

    python -m realtimeraytracer_torch.probes [--iters 32]

It prints the card's name and power limit and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from realtimeraytracer_torch import kernels

ROWS, LANES, CHAINS, STEPS, GRID = 512, 128, 8, 64, 64
FLOP_PER_CALL = 2 * ROWS * LANES * CHAINS * STEPS * GRID
# The JAX kernel's Python-float constants, rounded to f32 as its f32
# arithmetic rounds them.
_B_SCALE = float(np.float32(0.9999999))
_ADDEND = float(np.float32(1e-9))


def fma_peak_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the kernel, for any device and shape: each
    step a*b + c in float64 rounded to f32 (the product of two f32 is exact
    in float64, so this is the FMA's single rounding but in rare
    double-rounding ties)."""
    x = x.to(torch.float32)
    b = x * _B_SCALE
    accs = [x * float(np.float32(1.0 + 1e-7 * j)) for j in range(CHAINS)]
    bd = b.double()
    for _ in range(STEPS):
        accs = [(a.double() * bd + _ADDEND).float() for a in accs]
    out = accs[0]
    for a in accs[1:]:
        out = out + a
    return out


def fma_peak_kernel(x: torch.Tensor) -> torch.Tensor:
    """Launch csrc/fma_peak.cu on x ((512, 128) f32, contiguous, on a CUDA
    device) with the TPU grid's 64 slices; adds one to
    ``fma_peak_kernel.launches``."""
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32 or tuple(x.shape) != (ROWS, LANES) or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous ({ROWS}, {LANES}) float32 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.launch("fma_peak", x.data_ptr(), out.data_ptr(), x.numel(), GRID, stream)
    fma_peak_kernel.launches += 1
    return out


fma_peak_kernel.launches = 0


def fma_peak(device: str | torch.device = "cuda", iters: int = 32):
    """(ms per call, TFLOP/s, output) of the kernel on x = ones, as the JAX
    probe feeds it: one warm-up call, then `iters` calls between two CUDA
    events.  A measurement of the card: raises for a non-CUDA device."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the FMA peak probe measures a CUDA device, got {device}")
    x = torch.ones((ROWS, LANES), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        fma_peak_kernel(x)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fma_peak_kernel(x)
        end.record()
        end.synchronize()
    ms = start.elapsed_time(end) / iters
    return ms, FLOP_PER_CALL / (ms * 1e-3) / 1e12, out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=32)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
    ms, tflops, out = fma_peak(iters=args.iters)
    ref = fma_peak_plain(torch.ones((ROWS, LANES), dtype=torch.float32, device=out.device))
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=0.0)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ms_per_call": ms,
                      "gflop_per_call": FLOP_PER_CALL / 1e9, "tflops_f32_fma": tflops,
                      "data_sheet_tflops_f32": 67.0}), flush=True)


if __name__ == "__main__":
    main()
