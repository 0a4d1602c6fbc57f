"""Where one frame's time goes on a GPU.

    python -m realtimeraytracer_torch.frame_profile [--width 1920] [--height 1080]
        [--spp 4] [--shadow-rays 3] [--tris 100000] [--backend auto]
        [--no-sort-shadows] [--scene procedural_mesh]

No JAX counterpart (the JAX package profiled with scripts/ probes on the
TPU).  Renders procedural_mesh(tris), or one of the alpha-tested
flagships (--scene textured_obj, or foliage_field compiled with
bake_instances=True; both with alpha_test=True), through the chosen route
("auto" is the hybrid route; "pallas" the v7 route) once to warm up, times three
frames with CUDA events (median), then renders one frame under
torch.profiler with CPU and CUDA activities and prints: the device's busy
time (the sum of kernel durations; one stream, so kernels do not overlap)
and idle share over that frame, the same idle share against the unprofiled median
(the profiler slows the host, which opens launch gaps), the peak device
memory of the run, the device-timeline span of each labelled range of the
frame (shade.*, v7.*, v8.*, v9.*, the alpha ladder's rounds alpha.round,
frame.denoise) beside the kernel time that starts inside it, the ladder's
host syncs, and the kernels with the most device time.  It needs a CUDA
device and fails without one.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import subprocess

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from realtimeraytracer_torch import RenderConfig, scenes
from realtimeraytracer_torch.render.alpha import wrap_backend_with_alpha
from realtimeraytracer_torch.render.pipeline import render_pipeline_gpu

RANGES = ("shade.closest", "shade.lights", "shade.sun", "v7.cull",
          "v7.closest", "v7.occluded", "v9.cull", "v9.closest", "v8.closest",
          "v8.occluded", "alpha.round", "frame.denoise")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--shadow-rays", type=int, default=3)
    ap.add_argument("--tris", type=int, default=100_000)
    ap.add_argument("--backend", default="auto",
                    help="RenderConfig.backend: auto (hybrid), pallas, quarter, hier")
    ap.add_argument("--no-sort-shadows", action="store_true",
                    help="trace area shadows in pixel-block order (cfg.sort_shadows=False)")
    ap.add_argument("--scene", default="procedural_mesh",
                    choices=("procedural_mesh", "textured_obj", "foliage_field"),
                    help="the flagships render alpha-tested; --tris is procedural_mesh's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("frame_profile needs a CUDA device")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cfg = RenderConfig(width=args.width, height=args.height, primary_rays=args.spp,
                       shadow_rays=args.shadow_rays, backend=args.backend,
                       sort_shadows=not args.no_sort_shadows,
                       alpha_test=args.scene != "procedural_mesh")
    if args.scene == "procedural_mesh":
        scene = scenes.procedural_mesh(args.tris, sun=True)
    else:
        scene = getattr(scenes, args.scene)()
    gpu = scene.compile(bake_instances=bool(scene.instances)).to("cuda")
    frame = scene.camera.viewport_frame(cfg.width, cfg.height, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    render_pipeline_gpu(gpu, frame, cfg)                        # warm-up
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    def timed_frame() -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        render_pipeline_gpu(gpu, frame, cfg)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    times = [timed_frame() for _ in range(3)]
    syncs = wrap_backend_with_alpha.syncs
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_ms = timed_frame()
    syncs = wrap_backend_with_alpha.syncs - syncs

    # Device-side events: kernels and memcpys, plus the GPU-timeline spans
    # of the record_function ranges (which carry the ranges' names).
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in device if e.name not in RANGES]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(f"card: {card}")
    print(f"frame {cfg.width}x{cfg.height}, {args.spp} spp x {args.shadow_rays} shadow rays, "
          f"backend={cfg.backend}, sort_shadows={cfg.sort_shadows}, "
          f"{args.scene}({args.tris if args.scene == 'procedural_mesh' else ''}) "
          f"({gpu.num_tris} tris, alpha_test={cfg.alpha_test}, {syncs} ladder host syncs): "
          f"{sorted(times)[1]:.2f} ms median of {[round(t, 2) for t in times]} (CUDA events); "
          f"{profiled_ms:.2f} ms under the profiler")
    median_ms = sorted(times)[1]
    print(f"device busy {busy_ms:.2f} ms in {len(kernels)} kernels; idle share "
          f"{max(0.0, 1.0 - busy_ms / profiled_ms):.4f} of the profiled frame, "
          f"{max(0.0, 1.0 - busy_ms / median_ms):.4f} of the unprofiled median")
    print(f"peak device memory {peak_gib:.3f} GiB (max_memory_allocated over one frame)")

    span = collections.defaultdict(float)
    inside = collections.defaultdict(float)
    calls = collections.Counter()
    # Kernel time starting inside each range: kernels sorted by start, with
    # prefix sums of their durations (an alpha frame has ~10^5 kernels and
    # ~10^3 ranges).
    kernels.sort(key=lambda k: k.time_range.start)
    starts = [k.time_range.start for k in kernels]
    prefix = [0.0]
    for k in kernels:
        prefix.append(prefix[-1] + k.time_range.elapsed_us())
    for e in device:
        if e.name in RANGES:
            span[e.name] += e.time_range.elapsed_us() / 1e3
            calls[e.name] += 1
            lo = bisect.bisect_left(starts, e.time_range.start)
            hi = bisect.bisect_left(starts, e.time_range.end)
            inside[e.name] += (prefix[hi] - prefix[lo]) / 1e3
    for name in RANGES:
        print(f"range {name:14s} {span[name]:10.2f} ms device span, {inside[name]:10.2f} ms "
              f"kernel time, over {calls[name]} calls")

    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    print("kernels by device time:")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"  {ms:10.3f} ms {n:6d}x  {name[:110]}")


if __name__ == "__main__":
    main()
