"""A/B of two trees of the port on one GPU: the traversal kernels' outputs
(hashed row by row) and times, and the 1080p frames.

No JAX counterpart.  Run it as a file, so that the package it measures is
the one on PYTHONPATH (a tree unpacked with ``git archive``, or this one):

    PYTHONPATH=<tree> python3 realtimeraytracer_torch/kernel_ab.py kernels <tag> [--no-foliage]
    PYTHONPATH=<tree> python3 realtimeraytracer_torch/kernel_ab.py frames <tag>
    python3 realtimeraytracer_torch/kernel_ab.py compare <log> [<log> ...]

``kernels`` traces the chip_smoke shapes (1080p primaries of
procedural_mesh(100_000, sun=True) from v7's hits: v9 closest, v8 shadow
segments, sun, incoherent closest, hinted segments, each v8 launch also
with its work counts; with the foliage, baked: masked v9, masked v8 closest
on shadow segments; instanced: v8 closest, masked closest and occluded) and
prints one line ``AB {json}``: a hash of every output row, each kernel's
median time over 10 calls (CUDA events; v9 of a tree whose v9 takes culled
keys includes its plain-torch cull), and the card.  ``frames`` renders the
reference-default opaque hybrid frame and the baked foliage alpha-tested
hybrid frame: one frame (peak memory above what was held, an image hash),
then the median of 3 by CUDA events; it prints ``FR {json}``.  ``compare``
reads those lines from logs, lists every row hash that differs between the
first two tags, and prints each tag's times side by side.  Run parent,
change, change, parent in one call to compare two trees on one card.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import statistics
import subprocess
import sys
import time

W, H = 1920, 1080


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def _median_ms(fn, reps: int = 10):
    import torch

    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), out


def kernels_ab(tag: str, foliage: bool) -> dict:
    import numpy as np
    import torch

    from realtimeraytracer_torch import kernels, scenes
    from realtimeraytracer_torch.ops.camera_rays import block_permutation, generate_rays
    from realtimeraytracer_torch.render import hier_backend as v8
    from realtimeraytracer_torch.render import quarter_backend as v9
    from realtimeraytracer_torch.render import v7_backend as v7

    dev = torch.device("cuda", 0)
    boxes = "cl_min" in inspect.signature(v9.trace_quarter_kernel).parameters
    t0 = time.perf_counter()
    kernels.build_all()
    res = {"tag": tag, "package": v8.__file__, "build_s": time.perf_counter() - t0,
           "hash": {}, "ms": {}}

    def record(name, out):
        for r in range(8):
            for side, x in (("f", out[0]), ("i", out[1])):
                res["hash"][f"{name}.{side}{r}"] = hashlib.sha256(
                    x[:, r].contiguous().cpu().numpy().tobytes()).hexdigest()[:16]

    def timed(name, fn, reps=10):
        ms, out = _median_ms(fn, reps)
        res["ms"][name] = ms
        record(name, out)
        return out

    def primaries(sc):
        frame = sc.camera.viewport_frame(W, H, device=dev)
        o, d = generate_rays(frame, W, H, sample_index=0, jitter=True)
        perm, _ = block_permutation(W, H, device=dev)
        r = o.shape[0]
        o, d = o[perm], d[perm]
        tmin, tmax = torch.full((r,), 1e-3, device=dev), torch.full((r,), 1e4, device=dev)
        return o, d, v7._pack_rays(o, d, tmin, tmax)[0]

    def v9_closest(g, rays, masked=False):
        amask = g.q_amask if masked else None
        if boxes:
            return v9.trace_quarter_kernel(rays, g.q_cl_min, g.q_cl_max, g.q_panels,
                                           g.q_group_off, "origin", amask)
        keys, id_mask = v7.cull_quarter_keys(rays, g.q_cl_min, g.q_cl_max)
        return v9.trace_quarter_kernel(rays, keys, g.q_panels, g.q_group_off, id_mask,
                                       "origin", amask)

    def secondary(g, o, d, out, seed):
        """Shadow segments toward light triangle 0, sun segments and
        incoherent closest rays from the hits of `out`; misses get [BIG, -BIG)."""
        t = out[0][:, 0].reshape(-1)
        hit = out[1][:, 0].reshape(-1) >= 0
        p = o + d * torch.where(hit, t, 0.0)[:, None] - d * 1e-3
        rng = np.random.default_rng(seed)
        ab = torch.from_numpy(rng.uniform(0, 0.5, (o.shape[0], 2)).astype(np.float32)).to(dev)
        l0, l1, l2 = g.lt_v0[0], g.lt_v1[0], g.lt_v2[0]
        delta = l0 + ab[:, :1] * (l1 - l0) + ab[:, 1:] * (l2 - l0) - p
        dist = delta.norm(dim=1)
        big = torch.full_like(dist, 3.0e38)
        lo, hi = torch.where(hit, 1e-3, big), torch.where(hit, 1e4, -big)
        seg = v7._pack_rays(p, delta / dist[:, None], lo, torch.where(hit, dist - 0.5, -big))[0]
        sun = v7._pack_rays(p, g.sun_direction.expand_as(p).contiguous(), lo, hi)[0]
        b = torch.from_numpy(rng.normal(size=(o.shape[0], 3)).astype(np.float32)).to(dev)
        b = b / b.norm(dim=1, keepdim=True)
        b = torch.where(((b * d).sum(1) > 0)[:, None], -b, b)
        return seg, sun, v7._pack_rays(p, b, lo, hi)[0]

    scene = scenes.procedural_mesh(100_000, sun=True)
    gpu = scene.compile().to(dev)
    o, d, prim = primaries(scene)
    seg, sun, bounce = secondary(gpu, o, d, v7.trace_blocks(gpu, prim, "closest", "origin"), 9)
    coeff, sup, blk, nsup = v8._hier_inputs(gpu)

    def hier(rays, mode, common, hints=None, count=False):
        return v8.trace_hier_kernel(rays, sup, blk, coeff, nsup, mode, common, hints, count)

    for name, rays, mode, common in (("v8.seg", seg, "occluded", None),
                                     ("v8.sun", sun, "occluded", "dir"),
                                     ("v8.bounce", bounce, "closest", None)):
        timed(name, lambda: hier(rays, mode, common))
        record(name + ".count", hier(rays, mode, common, count=True))
    hints = hier(seg, "occluded", None)[1][:, 3:5, 0].contiguous()
    timed("v8.seg.hinted", lambda: hier(seg, "occluded", None, hints))
    timed("v9", lambda: v9_closest(gpu, prim))
    if foliage:
        fs = scenes.foliage_field()
        fol = fs.compile(bake_instances=True).to(dev)
        fo, fd, fprim = primaries(fs)
        fseg, _, _ = secondary(fol, fo, fd, v7.trace_blocks(fol, fprim, "closest", "origin",
                                                            use_amask=True), 13)
        fc, fsup, fblk, fns = v8._hier_inputs(fol)
        timed("v8m", lambda: v8.trace_hier_kernel(fseg, fsup, fblk, fc, fns, "closest",
                                                  amask=fol.pallas_amask))
        record("v8m.count", v8.trace_hier_kernel(fseg, fsup, fblk, fc, fns, "closest", count=True,
                                                 amask=fol.pallas_amask))
        timed("v9m", lambda: v9_closest(fol, fprim, True))
        timed("v9.fol", lambda: v9_closest(fol, fprim))
        fi = fs.compile().to(dev)
        args = v8._inst_args(fi)
        for name, amask in (("v8i", None), ("v8im", fi.pallas_amask)):
            out = timed(name, lambda: v8.trace_hier_inst_kernel(fprim, *args, "closest",
                                                                amask=amask), 5)
            record(name + ".count", v8.trace_hier_inst_kernel(fprim, *args, "closest", count=True,
                                                              amask=amask))
        iseg, _, _ = secondary(fi, fo, fd, out, 17)
        timed("v8i.seg", lambda: v8.trace_hier_inst_kernel(iseg, *args, "occluded"), 5)
    res["card"] = _card()
    return res


def frames_ab(tag: str) -> dict:
    import torch

    import realtimeraytracer_torch as rt
    from realtimeraytracer_torch import kernels, scenes
    from realtimeraytracer_torch.render.pipeline import render_pipeline_gpu

    kernels.build_all()
    dev = torch.device("cuda", 0)
    res = {"tag": tag, "ms": {}, "all": {}, "peak_gib": {}, "hash": {}}

    def run(name, gpu, frame, cfg):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        img = render_pipeline_gpu(gpu, frame, cfg)
        torch.cuda.synchronize()
        res["peak_gib"][name] = (torch.cuda.max_memory_allocated() - held) / 2**30
        res["hash"][name] = hashlib.sha256(img.cpu().numpy().tobytes()).hexdigest()[:16]
        times = []
        for _ in range(3):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            render_pipeline_gpu(gpu, frame, cfg)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        res["ms"][name] = statistics.median(times)
        res["all"][name] = times

    cfg = rt.RenderConfig(width=W, height=H, primary_rays=4, shadow_rays=3, denoise_iterations=4)
    scene = scenes.procedural_mesh(100_000, sun=True)
    gpu = scene.compile().to(dev)
    run("opaque hybrid", gpu, scene.camera.viewport_frame(W, H, device=dev), cfg)
    del gpu
    fs = scenes.foliage_field()
    fol = fs.compile(bake_instances=True).to(dev)
    run("foliage baked hybrid", fol, fs.camera.viewport_frame(W, H, device=dev),
        cfg.replace(alpha_test=True))
    res["card"] = _card()
    return res


def compare(paths) -> None:
    runs = []
    for path in paths:
        with open(path, errors="replace") as f:
            runs += [json.loads(line[3:]) for line in f if line.startswith(("AB ", "FR "))]
    by_tag: dict = {}
    for r in runs:
        by_tag.setdefault(r["tag"], []).append(r)
    tags = list(by_tag)
    print("tags", tags, "card", runs[0].get("card") if runs else None)
    if len(tags) >= 2:
        a, b = by_tag[tags[0]], by_tag[tags[1]]
        for x in a:
            for y in b:
                same = [k for k in x["hash"] if k in y["hash"]]
                diff = [k for k in same if x["hash"][k] != y["hash"][k]]
                print(f"hashes compared {len(same)}, differing {len(diff)}", diff[:40])
    for name in sorted({k for r in runs for k in r["ms"]}):
        cells = [f"{t}: " + ", ".join(f"{r['ms'][name]:.3f}" for r in by_tag[t] if name in r["ms"])
                 for t in tags]
        print(f"{name:22s}", " | ".join(cells))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    k = sub.add_parser("kernels")
    k.add_argument("tag")
    k.add_argument("--no-foliage", action="store_true")
    f = sub.add_parser("frames")
    f.add_argument("tag")
    c = sub.add_parser("compare")
    c.add_argument("logs", nargs="+")
    args = ap.parse_args(argv)
    if args.what == "compare":
        compare(args.logs)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab measures on a CUDA device")
    if args.what == "kernels":
        res = kernels_ab(args.tag, not args.no_foliage)
        print("AB " + json.dumps(res), flush=True)
    else:
        print("FR " + json.dumps(frames_ab(args.tag)), flush=True)


if __name__ == "__main__":
    sys.exit(main())
