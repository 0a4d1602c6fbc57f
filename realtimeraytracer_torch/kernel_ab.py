"""A/B of two trees of the port on one GPU: the traversal kernels' outputs
(hashed row by row) and times, and the 1080p frames.

No JAX counterpart.  Run it as a file, so that the package it measures is
the one on PYTHONPATH (a tree unpacked with ``git archive``, or this one):

    PYTHONPATH=<tree> python3 realtimeraytracer_torch/kernel_ab.py kernels <tag> [--no-foliage]
    PYTHONPATH=<tree> python3 realtimeraytracer_torch/kernel_ab.py atrous <tag>
    PYTHONPATH=<tree> python3 realtimeraytracer_torch/kernel_ab.py frames <tag> [--images <dir>]
    python3 realtimeraytracer_torch/kernel_ab.py compare <log> [<log> ...]
    python3 realtimeraytracer_torch/kernel_ab.py images <dir>/<tag a> <dir>/<tag b>

``kernels`` traces the chip_smoke shapes (1080p primaries of
procedural_mesh(100_000, sun=True): v7 closest, and from its hits v7
occluded shadow segments and sun, v9 closest, v8 shadow segments, sun,
incoherent closest, hinted segments, each v8 launch also with its work
counts; the multi-segment v8 kernel (B4) on the frame's light-0 shadow
segments, S = 3, also with its work counts; the A-Trous pair's four 1080p
iterations on chip_smoke's G-buffer (B5, also with its weight-sum output
on a tree that has one) and their backward (B5b, with and without the
normal and position gradients, its error against the twin); with the
foliage, baked: masked v7 and v9, masked v8 closest on shadow segments;
instanced: v8 closest, masked closest and occluded) and
prints one line ``AB {json}``: a hash of every output row, each kernel's
median time over 10 calls (CUDA events; v7 of a tree whose kernel takes
culled keys includes its plain-torch cull), the A-Trous kernel's SASS
instruction counts, and the card.  ``frames`` renders the
reference-default opaque frame on the hybrid and the "pallas" route, the
1M-triangle hybrid frame, the alpha-tested textured_obj (base-level
textures) and baked foliage hybrid frames, and BASELINE config 4 (the
wavefront frame at 4 spp and 2 bounces on the 100k scene; skipped on a
tree without render/wavefront.py): one frame (peak memory above what was
held, an image hash), then the median of 3 by CUDA events; it prints
``FR {json}`` and, with ``--images``, saves each image as
``<dir>/<tag>/<frame>.npy``.
``atrous`` times the A-Trous pair and its backward alone (the same
``AB`` line with those keys only).
``compare`` reads those lines from logs, lists every row hash that differs
between the first two tags, and prints each tag's times side by side.
``images`` holds two tags' saved frames to the frame rule (under 0.5% of
values off by more than 2e-3) and prints their largest difference.  Run
parent, change, change, parent in one call to compare two trees on one
card.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

W, H = 1920, 1080


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def sass_functions(lib) -> dict[str, list[tuple[int, str]]]:
    """Each kernel function of a built library (`cuobjdump -sass`): name ->
    [(address, instruction), ...] in order, NOPs left out."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=120,
                         check=True).stdout
    funcs: dict[str, list[tuple[int, str]]] = {}
    cur = None
    for line in out.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if m and cur is not None and not re.match(r"(@!?U?P\w+\s+)?NOP\b", m.group(2).strip()):
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


def tap_instructions(ins: list[tuple[int, str]]) -> tuple[float, int]:
    """SASS instructions an A-Trous tap issues, and the taps the code holds
    (four MUFU.EX2 a tap, one per expf).  Counted over the innermost loops
    (a branch back to a lower address) that hold MUFU.EX2, which is where
    the taps run; a kernel without such a loop (every tap unrolled) counts
    its body up to its last EXIT (the division slow path after it is left
    out)."""
    def ex2(seq):
        return sum("MUFU.EX2" in t for _, t in seq)

    loops = []
    for i, (addr, text) in enumerate(ins):
        m = re.search(r"\bBRA\s+(?:!?U?P\w+,\s*)?(?:`\(\.L_x_\d+\)\s*)?(0x[0-9a-f]+|\d+)", text)
        if m and int(m.group(1), 16 if m.group(1).startswith("0x") else 10) < addr:
            start = int(m.group(1), 16 if m.group(1).startswith("0x") else 10)
            loops.append([x for x in ins[:i + 1] if x[0] >= start])
    inner = [lp for lp in loops if ex2(lp) and not any(
        o is not lp and lp[0][0] <= o[0][0] and o[-1][0] <= lp[-1][0] for o in loops)]
    if inner:
        taps = sum(ex2(lp) for lp in inner) // 4
        return sum(len(lp) for lp in inner) / taps, taps
    last = max(i for i, (_, t) in enumerate(ins) if re.match(r"EXIT\b", t))
    taps = ex2(ins[:last + 1]) // 4
    return (last + 1) / taps, taps


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


def light_segments(scene, gpu, s_count: int):
    """(origins, dirs_s, t_lo, t_hi_s): the area-light shadow segments that
    the reference-default 1080p frame's primary sample 0 traces toward
    light triangle 0, S per ray, recorded from the frame's fused query."""
    import torch

    import realtimeraytracer_torch as rt
    from realtimeraytracer_torch.render import hier_backend as v8
    from realtimeraytracer_torch.render.backends import make_backend
    from realtimeraytracer_torch.render.megakernel import render_components

    cfg = rt.RenderConfig(width=W, height=H, primary_rays=1, shadow_rays=s_count,
                          denoise_iterations=4)
    got = []

    def record(o, ds, lo, hs):
        got.append((o, ds, lo, hs))
        return v8.hier_occluded_multi(gpu, cfg, o, ds, lo, hs)

    backend = make_backend(gpu, cfg)._replace(occluded_multi=record)
    with torch.inference_mode():
        render_components(gpu, scene.camera.viewport_frame(W, H, device=gpu.device),
                          cfg, 0, backend)
    return got[0]


def atrous_ab(res: dict) -> dict:
    """The A-Trous pair on chip_smoke's 1080p G-buffer, into res (its "ms"
    and "hash" maps): B5's four iterations (also with its weight-sum output
    on a tree that has one) and their backward (B5b, with and without the
    normal and position gradients; its error against the twin's last
    iteration: the designs sum in other orders, so no hash), the SASS
    counts of B5's tap loops."""
    import numpy as np
    import torch

    from realtimeraytracer_torch import kernels
    from realtimeraytracer_torch.ops import denoise_kernel as dk

    dev = torch.device("cuda", 0)

    def digest(x):
        return hashlib.sha256(x.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]

    g = np.random.default_rng(11)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    pos = np.stack([xx * 2e-3, yy * 2e-3, 0.05 * np.sin(xx * 0.01)], -1) + g.normal(0, 2e-3, (H, W, 3))
    nrm = np.stack([0.05 * np.sin(yy * 0.02), np.ones_like(xx), 0.05 * np.cos(xx * 0.03)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    unsh = g.uniform(0.2, 1.0, (H, W, 3))
    shad = unsh * (g.uniform(0, 1, (H, W, 1)) > 0.3)
    dn = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev) for a in (shad, unsh, nrm, pos)]

    phis = (1.0, 0.001, 0.001)
    # A tree whose B5 writes its weight sums for B5b (else B5b recomputes them).
    with_w = "weights" in inspect.signature(dk.atrous_pair_iteration_vjp_kernel).parameters

    def denoise(weights=False):
        s_, u_ = dn[0], dn[1]
        for i in range(4):
            s_, u_ = dk.atrous_pair_iteration_kernel(s_, u_, dn[2], dn[3], i + 1, *phis,
                                                     **({"weights": True} if weights else {}))[:2]
        return s_, u_

    res["ms"]["atrous"], (s_, u_) = _median_ms(denoise)
    res["hash"]["atrous.shadowed"], res["hash"]["atrous.unshadowed"] = digest(s_), digest(u_)
    if with_w:
        res["ms"]["atrous.w"], (s_, u_) = _median_ms(lambda: denoise(weights=True))
        res["hash"]["atrous.w.shadowed"], res["hash"]["atrous.w.unshadowed"] = digest(s_), digest(u_)
    # B5b: the VJPs of the four iterations.
    gr = np.random.default_rng(29)
    g_s, g_u = (torch.from_numpy(gr.normal(size=(H, W, 3)).astype(np.float32)).to(dev)
                for _ in range(2))
    fw, s_, u_ = [], dn[0], dn[1]
    for i in range(4):
        out = dk.atrous_pair_iteration_kernel(s_, u_, dn[2], dn[3], i + 1, *phis,
                                              **({"weights": True} if with_w else {}))
        fw.append((s_, u_) + tuple(out))
        s_, u_ = out[0], out[1]

    def vjp(geom):
        for i, f in enumerate(fw):
            got = dk.atrous_pair_iteration_vjp_kernel(f[0], f[1], dn[2], dn[3], *f[2:], i + 1,
                                                      *phis, g_s, g_u, geom)
        return got

    for key, geom in (("atrous.vjp", True), ("atrous.vjp.colour", False)):
        res["ms"][key], got = _median_ms(lambda: vjp(geom))
        want = dk.atrous_pair_iteration_vjp_plain(fw[-1][0], fw[-1][1], dn[2], dn[3], 4, *phis,
                                                  g_s, g_u, geom)
        res[key + ".err"] = max(float((a - b).abs().max() / b.abs().max())
                                for a, b in zip(got, want) if b is not None)
    ins = next(v for k_, v in sass_functions(kernels.build("atrous_pair")).items() if "atrous" in k_)
    per_tap, code_taps = tap_instructions(ins)
    res["atrous_sass"] = {"instructions": len(ins), "per_tap": per_tap, "taps_in_code": code_taps,
                          "MUFU.RCP": sum("MUFU.RCP" in t for _, t in ins)}
    res["vjp_ptxas"] = [line.strip() for line in kernels.build_log.get("atrous_pair_vjp", "")
                        .splitlines() if "registers" in line or "spill" in line]
    return res


def kernels_ab(tag: str, foliage: bool) -> dict:
    import numpy as np
    import torch

    from realtimeraytracer_torch import kernels, scenes
    from realtimeraytracer_torch.ops.camera_rays import block_permutation, generate_rays
    from realtimeraytracer_torch.render import hier_backend as v8
    from realtimeraytracer_torch.render import quarter_backend as v9
    from realtimeraytracer_torch.render import v7_backend as v7

    dev = torch.device("cuda", 0)
    fused_v7 = hasattr(v7, "trace_v7_kernel")       # else a tree before v7's fused cull
    t0 = time.perf_counter()
    kernels.build_all()
    res = {"tag": tag, "package": v8.__file__, "build_s": time.perf_counter() - t0,
           "hash": {}, "ms": {}}

    def digest(x):
        return hashlib.sha256(x.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]

    def record(name, out):
        for r in range(8):
            for side, x in (("f", out[0]), ("i", out[1])):
                res["hash"][f"{name}.{side}{r}"] = digest(x[:, r])

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
        return v9.trace_quarter_kernel(rays, g.q_cl_min, g.q_cl_max, g.q_panels, g.q_group_off,
                                       "origin", g.q_amask if masked else None)

    def v7_trace(g, rays, mode, common, masked=False):
        amask = g.pallas_amask if masked else None
        if fused_v7:
            return v7.trace_v7_kernel(rays, g.pallas_cl_min, g.pallas_cl_max, g.pallas_panels,
                                      mode, common, amask)
        keys, id_mask = v7.cull_keys(rays, g.pallas_cl_min, g.pallas_cl_max)
        return v7.trace_keys_kernel(rays, keys, g.pallas_panels, id_mask, mode, common, amask)

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
    seg, sun, bounce = secondary(gpu, o, d, timed("v7", lambda: v7_trace(gpu, prim, "closest",
                                                                       "origin")), 9)
    timed("v7.seg", lambda: v7_trace(gpu, seg, "occluded", None))
    timed("v7.sun", lambda: v7_trace(gpu, sun, "occluded", "dir"))
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
    # B4, the multi-segment kernel, on the segments the reference-default
    # frame traces toward light triangle 0 (chip_smoke phase 21), S = 3.
    mrays, _ = v8.pack_rays_multi(*light_segments(scene, gpu, 3))
    timed("b4", lambda: v8.trace_hier_multi_kernel(mrays, sup, blk, coeff, nsup))
    record("b4.count", v8.trace_hier_multi_kernel(mrays, sup, blk, coeff, nsup, count=True))
    timed("v9", lambda: v9_closest(gpu, prim))
    atrous_ab(res)
    if foliage:
        fs = scenes.foliage_field()
        fol = fs.compile(bake_instances=True).to(dev)
        fo, fd, fprim = primaries(fs)
        fseg, _, _ = secondary(fol, fo, fd, timed("v7m", lambda: v7_trace(fol, fprim, "closest",
                                                                         "origin", True)), 13)
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


def frames_ab(tag: str, images: str | None = None) -> dict:
    import numpy as np
    import torch

    import realtimeraytracer_torch as rt
    from realtimeraytracer_torch import kernels, scenes
    from realtimeraytracer_torch.render.pipeline import render_pipeline_gpu

    kernels.build_all()
    dev = torch.device("cuda", 0)
    res = {"tag": tag, "ms": {}, "all": {}, "peak_gib": {}, "hash": {}}

    def run(name, gpu, frame, cfg, render=render_pipeline_gpu):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        img = render(gpu, frame, cfg)
        torch.cuda.synchronize()
        res["peak_gib"][name] = (torch.cuda.max_memory_allocated() - held) / 2**30
        res["hash"][name] = hashlib.sha256(img.cpu().numpy().tobytes()).hexdigest()[:16]
        if images:
            out = Path(images) / tag
            out.mkdir(parents=True, exist_ok=True)
            np.save(out / f"{name.replace(' ', '_')}.npy", img.cpu().numpy())
        times = []
        for _ in range(3):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            render(gpu, frame, cfg)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        res["ms"][name] = statistics.median(times)
        res["all"][name] = times

    cfg = rt.RenderConfig(width=W, height=H, primary_rays=4, shadow_rays=3, denoise_iterations=4)
    scene = scenes.procedural_mesh(100_000, sun=True)
    gpu = scene.compile().to(dev)
    run("opaque hybrid", gpu, scene.camera.viewport_frame(W, H, device=dev), cfg)
    run("opaque pallas", gpu, scene.camera.viewport_frame(W, H, device=dev),
        cfg.replace(backend="pallas"))
    try:
        from realtimeraytracer_torch.render.wavefront import render_wavefront
    except ImportError:
        res["absent"] = ["config 4 wavefront"]
    else:
        run("config 4 wavefront", gpu, scene.camera.viewport_frame(W, H, device=dev),
            cfg.replace(shadow_rays=1, max_bounces=2, denoise_iterations=0),
            render=render_wavefront)
    del gpu
    big = scenes.procedural_mesh(1_000_000, sun=True)
    gbig = big.compile(quarter_panels=False).to(dev)
    run("1M hybrid", gbig, big.camera.viewport_frame(W, H, device=dev), cfg)
    del gbig
    ts = scenes.textured_obj()
    run("textured_obj hybrid", ts.compile().to(dev), ts.camera.viewport_frame(W, H, device=dev),
        cfg.replace(alpha_test=True))
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


def images(a: str, b: str) -> None:
    """Each frame saved under both directories: equal, or the share of
    values off by more than 2e-3 (the frame rule: under 0.5%) and the
    largest difference."""
    import numpy as np

    for pa in sorted(Path(a).glob("*.npy")):
        x, y = np.load(pa), np.load(Path(b) / pa.name)
        share = float((np.abs(x - y) > 2e-3).mean())
        print(f"{pa.stem:22s} equal {bool(np.array_equal(x, y))}, max |err| "
              f"{float(np.abs(x - y).max())}, {share:.6%} of values off by > 2e-3, frame rule "
              f"{'met' if share < 5e-3 and np.isfinite(x).all() and np.isfinite(y).all() else 'FAILED'}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    k = sub.add_parser("kernels")
    k.add_argument("tag")
    k.add_argument("--no-foliage", action="store_true")
    a = sub.add_parser("atrous")
    a.add_argument("tag")
    f = sub.add_parser("frames")
    f.add_argument("tag")
    f.add_argument("--images", help="save each frame as <dir>/<tag>/<frame>.npy")
    c = sub.add_parser("compare")
    c.add_argument("logs", nargs="+")
    i = sub.add_parser("images")
    i.add_argument("a")
    i.add_argument("b")
    args = ap.parse_args(argv)
    if args.what == "compare":
        compare(args.logs)
        return
    if args.what == "images":
        images(args.a, args.b)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab measures on a CUDA device")
    if args.what == "kernels":
        res = kernels_ab(args.tag, not args.no_foliage)
        print("AB " + json.dumps(res), flush=True)
    elif args.what == "atrous":
        res = atrous_ab({"tag": args.tag, "hash": {}, "ms": {}, "card": _card()})
        print("AB " + json.dumps(res), flush=True)
    else:
        print("FR " + json.dumps(frames_ab(args.tag, args.images)), flush=True)


if __name__ == "__main__":
    sys.exit(main())
