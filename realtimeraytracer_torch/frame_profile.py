"""Where one frame's time goes on a GPU.

    python -m realtimeraytracer_torch.frame_profile [--width 1920] [--height 1080]
        [--spp 4] [--shadow-rays 3] [--tris 100000] [--backend auto]
        [--no-sort-shadows] [--scene procedural_mesh] [--bake]
        [--wavefront] [--train-step]

No JAX counterpart (the JAX package profiled with scripts/ probes on the
TPU).  Renders procedural_mesh(tris), or one of the alpha-tested
flagships (--scene textured_obj, or foliage_field in its shared-geometry
instanced form, or with --bake its world-space copies; both with
alpha_test=True), through the chosen route
("auto" is the hybrid route; "pallas" the v7 route) once to warm up, times three
frames with CUDA events (median), then renders one frame under
torch.profiler with CPU and CUDA activities and prints: the device's busy
time (the sum of kernel durations; one stream, so kernels do not overlap)
and idle share over that frame, the same idle share against the unprofiled median
(the profiler slows the host, which opens launch gaps), the peak device
memory of the run, the device-timeline span of each labelled range of the
frame (shade.*, v7.*, v8.*, v9.*, the alpha ladder's rounds alpha.round,
frame.denoise; with --wavefront the multi-bounce frame of
render/wavefront.py, BASELINE config 4 at the defaults (4 spp, 2 bounces),
and its stages wavefront.closest, wavefront.nee_occluded, wavefront.sort
and wavefront.shade) beside the kernel time that starts inside it, the
ladder's host syncs, and the kernels with the most device time.  With
--train-step it profiles BASELINE config 5's gradient step instead
(diff/optimize.py's make_train_step: radiance_loss on 1 spp raster-order
primaries, obj_color and lt_intensity from a perturbed start, Adam) and its
range diff.forward (the backward runs on autograd's device thread, which
the ranges do not see: the step less the forward is the backward and the
update).  It needs a CUDA device and fails without one.
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
from realtimeraytracer_torch.render.wavefront import render_wavefront

RANGES = ("shade.closest", "shade.batch_occlusion", "shade.lights", "shade.sun", "v7.cull",
          "v7.closest", "v7.occluded", "v9.cull", "v9.closest", "v8.closest",
          "v8.occluded", "alpha.round", "frame.denoise", "wavefront.closest",
          "wavefront.nee_occluded", "wavefront.sort", "wavefront.shade",
          "diff.forward")


def range_times(prof, ranges=RANGES):
    """Of a profiled run: (device busy ms, the kernel events, {range:
    [device-timeline span ms, ms of kernel time starting inside it,
    calls]}).  Device events other than the ranges' own spans count as
    kernels (one stream, so they do not overlap)."""
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in device if e.name not in ranges]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    # Kernels sorted by start, with prefix sums of their durations (an
    # alpha frame has ~10^5 kernels and ~10^3 ranges).
    kernels.sort(key=lambda k: k.time_range.start)
    starts = [k.time_range.start for k in kernels]
    prefix = [0.0]
    for k in kernels:
        prefix.append(prefix[-1] + k.time_range.elapsed_us())
    out = {name: [0.0, 0.0, 0] for name in ranges}
    for e in device:
        if e.name in ranges:
            lo = bisect.bisect_left(starts, e.time_range.start)
            hi = bisect.bisect_left(starts, e.time_range.end)
            row = out[e.name]
            row[0] += e.time_range.elapsed_us() / 1e3
            row[1] += (prefix[hi] - prefix[lo]) / 1e3
            row[2] += 1
    return busy_ms, kernels, out


def _train_step(gpu, frame, cfg):
    """BASELINE config 5's step as a call render(gpu, frame, cfg) can stand
    for: the target is the analytic channel at the scene's params, the
    step starts from obj_color * 0.4 + 0.3 and lt_intensity * 0.5."""
    import dataclasses

    from realtimeraytracer_torch.diff import optimize as opt
    from realtimeraytracer_torch.ops.camera_rays import generate_rays
    from realtimeraytracer_torch.parallel.mesh import make_ray_mesh
    from realtimeraytracer_torch.render.backends import make_backend
    from realtimeraytracer_torch.render.megakernel import shade_sample

    o, d = generate_rays(frame, cfg.width, cfg.height, jitter=False)
    seed = torch.arange(o.shape[0], device=o.device)
    with torch.no_grad():
        target = shade_sample(gpu, cfg, o, d, seed, make_backend(gpu, cfg)).analytic
    wrong = dataclasses.replace(gpu, obj_color=gpu.obj_color * 0.4 + 0.3,
                                lt_intensity=gpu.lt_intensity * 0.5)
    params = {n: t.detach().clone().requires_grad_()
              for n, t in opt.extract_params(wrong, ("obj_color", "lt_intensity")).items()}
    state = opt.TrainState(params, opt.adam(params, 2e-2))
    step = opt.make_train_step(cfg, make_ray_mesh(device=gpu.device), state.optimizer)
    return lambda *_: step(state, wrong, o, d, seed, target)


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
    ap.add_argument("--bake", action="store_true",
                    help="compile an instanced scene's instances to world-space copies")
    ap.add_argument("--wavefront", action="store_true",
                    help="the multi-bounce frame (render_wavefront, max_bounces=2) instead of "
                         "the ratio frame")
    ap.add_argument("--train-step", action="store_true",
                    help="BASELINE config 5's gradient step (radiance_loss, 1 spp) instead of "
                         "a frame")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("frame_profile needs a CUDA device")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cfg = RenderConfig(width=args.width, height=args.height, primary_rays=args.spp,
                       shadow_rays=args.shadow_rays, backend=args.backend,
                       sort_shadows=not args.no_sort_shadows,
                       alpha_test=args.scene != "procedural_mesh",
                       max_bounces=2 if args.wavefront else 1)
    render = render_wavefront if args.wavefront else render_pipeline_gpu
    if args.scene == "procedural_mesh":
        scene = scenes.procedural_mesh(args.tris, sun=True)
    else:
        scene = getattr(scenes, args.scene)()
    gpu = scene.compile(bake_instances=args.bake).to("cuda")
    frame = scene.camera.viewport_frame(cfg.width, cfg.height, device="cuda")
    if args.train_step:
        render = _train_step(gpu, frame, cfg.replace(primary_rays=1, jitter=False))
    torch.cuda.reset_peak_memory_stats()
    render(gpu, frame, cfg)                                     # warm-up
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    def timed_frame() -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        render(gpu, frame, cfg)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    times = [timed_frame() for _ in range(3)]
    syncs = wrap_backend_with_alpha.syncs
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_ms = timed_frame()
    syncs = wrap_backend_with_alpha.syncs - syncs

    busy_ms, kernels, ranges = range_times(prof)
    print(f"card: {card}")
    what = (f"wavefront, max_bounces={cfg.max_bounces}"
            if args.wavefront else f"{args.shadow_rays} shadow rays, sort_shadows={cfg.sort_shadows}")
    if args.train_step:
        what += ", the config-5 training step (1 spp) in place of the frame"
    print(f"frame {cfg.width}x{cfg.height}, {args.spp} spp, {what}, backend={cfg.backend}, "
          f"{args.scene}({args.tris if args.scene == 'procedural_mesh' else ''}) "
          f"({gpu.num_tris} tris{', instanced' if gpu.instanced else ''}, "
          f"alpha_test={cfg.alpha_test}, {syncs} ladder host syncs): "
          f"{sorted(times)[1]:.2f} ms median of {[round(t, 2) for t in times]} (CUDA events); "
          f"{profiled_ms:.2f} ms under the profiler")
    median_ms = sorted(times)[1]
    print(f"device busy {busy_ms:.2f} ms in {len(kernels)} kernels; idle share "
          f"{max(0.0, 1.0 - busy_ms / profiled_ms):.4f} of the profiled frame, "
          f"{max(0.0, 1.0 - busy_ms / median_ms):.4f} of the unprofiled median")
    print(f"peak device memory {peak_gib:.3f} GiB (max_memory_allocated over one frame)")
    for name, (span, inside, calls) in ranges.items():
        print(f"range {name:22s} {span:10.2f} ms device span, {inside:10.2f} ms "
              f"kernel time, over {calls} calls")

    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    print("kernels by device time:")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"  {ms:10.3f} ms {n:6d}x  {name[:110]}")


if __name__ == "__main__":
    main()
