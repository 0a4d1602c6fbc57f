#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (realtimeraytracer_torch) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on failure:
  1. environment: card name and power limit, torch and CUDA versions;
  2. build: compile every CUDA kernel from csrc/ with nvcc, one nvcc per
     source, all started together;
  3. the v7 traversal kernel against its plain PyTorch twin on the
     100k-triangle scene: closest primaries (common origin), shadow segments
     and sun segments (common direction);
  4. the A-Trous pair kernel against its plain twin at 1920x1080, 4 steps,
     and single iterations at steps 5, 6 and 8;
  5. the reference-default frame (1920x1080, 4 primary x 3 shadow rays,
     4 denoise iterations) through the "pallas" route (v7), with the
     kernels' launch counts, the frame time and v7's time beside its plain
     twin's at the frame's shapes;
  6. a 320x180 "pallas" frame rendered through the kernels and through the
     plain twins, compared;
  7. the v9 kernel against its twin on 320x180 and 1080p primaries;
  8. the v8 kernel against its twin at 1080p: occluded shadow and sun
     segments, closest on incoherent (bounce) rays, and hinted traces fed
     no hints, their own hints and garbage hints;
  9. the reference-default frame through rt.render(scene, cfg) with no
     device argument and the default backend ("auto", the hybrid route: v9
     primaries, v8 occlusion with hints), its launch counts, frame time
     and peak memory;
 10. a 320x180 hybrid frame through the kernels and through the twins;
 11. the textured, alpha-tested scenes: scenes.foliage_field() compiled
     with bake_instances=True (about 120k triangles) and
     scenes.textured_obj() (through the OBJ, MTL, PNG and HDR loaders);
 12. each masked kernel (in-kernel alpha masks) against its masked twin on
     the baked foliage at 1080p: v9 and v7 on the primaries, v8 closest on
     area-light shadow segments;
 13. the alpha closest ladder on the foliage's 1080p primaries with and
     without in-kernel masks: rounds, rays per round, time; hits agree but
     for rays that exhaust the unmasked ladder (the masked hit lies at
     least as far) and rays whose unmasked ladder stepped past an opaque
     hit just behind a transparent one (the masked hit is that nearer
     opaque hit);
 14. the reference-default alpha-tested frames: textured_obj through
     rt.render(scene, cfg) with no device and the default backend, the
     baked foliage through render_pipeline_gpu with alpha_test=True, each
     also through the "pallas" route: launches per kernel, host syncs,
     frame time, peak memory, the two routes' images compared;
 15. a 160x90 alpha-tested foliage frame through the kernels and through
     the twins;
 16. scenes.foliage_field() compiled in its shared-geometry (instanced)
     form: instances, (instance, super) pairs, pool blocks, host compile
     time, and the device bytes of the instanced scene beside the baked one;
 17. the instanced v8 kernel against its twin: closest (masked and not) on
     320x180 primaries, occluded on area-light and sun segments from their
     hits; then 1080p primaries through the instanced kernel against the
     baked scene's v9 kernel on the same rays (t and object), with times,
     launches and bounds;
 18. the instanced foliage through the entry points: rt.render(scene, cfg)
     with the reference defaults (no alpha test: no mesh of the scene has
     an opacity map; default device and backend), and the alpha-tested
     1080p frame through render_pipeline_gpu(..., alpha_test=True): launches
     per kernel (only the instanced v8 kernels and A-Trous), host syncs,
     frame time, peak memory, the image against the baked frame of 14;
 19. a 160x90 instanced alpha frame through the kernels and through the
     twins;
 20. apply_instance_transforms on the card: the moved instances traced
     against a fresh instanced compile at the moved transforms.
Each main-path frame (5, 9, 14 and 18) is driven with every kernel's launch
count set to 0 just before and read just after.  The line before the last is a
JSON object describing each kernel (times, launches, error, bound); the
last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
without the package beside it, the script fails before printing either.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(*a) -> None:
    print(*a, flush=True)


def cuda_ms(fn, reps: int):
    """(mean milliseconds per call of fn over `reps` calls after one
    warm-up, by CUDA events; the last call's result)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def once_ms(fn):
    """(milliseconds of one call of fn by CUDA events, its result): for the
    plain twins that take seconds."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def image_rule(img: np.ndarray, ref: np.ndarray, what: str) -> float:
    """No NaN, and under 0.5% of values off by more than 2e-3."""
    require(np.isfinite(img).all() and np.isfinite(ref).all(), f"{what}: non-finite")
    share = float((np.abs(img - ref) > 2e-3).mean())
    require(share < 5e-3, f"{what}: {share:.4%} of values differ by > 2e-3")
    return share


def compare_closest(k, p, what: str) -> float:
    """Kernel vs plain closest outputs: hit masks equal, t within rtol 1e-6,
    ids equal or t equal.  Returns the max |t| difference over hits."""
    tk, tp = k[0][:, 0].flatten(), p[0][:, 0].flatten()
    ik, ip = k[1][:, 0].flatten(), p[1][:, 0].flatten()
    hk, hp = ik >= 0, ip >= 0
    require(bool((hk == hp).all()), f"{what}: hit masks differ on {(hk != hp).sum().item()} rays")
    err = (tk[hk] - tp[hk]).abs()
    bad_t = err > 1e-6 * tp[hk].abs()
    require(not bool(bad_t.any()), f"{what}: t differs beyond rtol 1e-6 on {bad_t.sum().item()} rays")
    bad_id = (ik != ip) & (tk != tp)
    require(not bool(bad_id.any()), f"{what}: ids differ with unequal t on {bad_id.sum().item()} rays")
    say(f"  {what}: {int(hk.sum())} hits of {hk.numel()} lanes, "
        f"{int((ik != ip).sum())} id ties, max |dt| {err.max().item() if err.numel() else 0.0}")
    return float(err.max().item()) if err.numel() else 0.0


def compare_occluded(k, p, what: str) -> float:
    fk, fp = k[0][:, 0], p[0][:, 0]
    diff = (fk != fp).sum().item()
    require(diff == 0, f"{what}: occluded flags differ on {diff} rays")
    say(f"  {what}: {int(fk.sum().item())} occluded of {fk.numel()} lanes, flags equal")
    return float((fk - fp).abs().max().item())


# Bounds: the least time the card could take for a call, the larger of its
# operations over the f32 peak and its bytes over the memory rate (H100 SXM
# data sheet: 67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s HBM3).
PEAK_OPS = 67e12
PEAK_BYTES = 3.35e12
# f32 operations per ray-triangle pair in the traversal kernels' inner loop,
# counted from the source: three origin dots (3 mul + 3 add each), three
# direction dots (3 mul + 2 add each), |s1| > eps (2), t = -s0/s1 (2),
# u and v (2 mul + 2 add), u + v (1), five compares; a common origin hoists
# the origin dots out of the pair loop, a common direction the direction dots.
OPS_PER_PAIR = {None: 47, "origin": 29, "dir": 32}
# f32 operations per slab test of a ray against a box in the v8 kernel: per
# axis two subtractions, two multiplications, a min and a max (18), the
# near/far combine (4), four compares and max(near, 0).
SLAB_OPS = 27
# f32 operations per mesh-space transform of a ray in the instanced v8
# kernel: origin rows 3 x (3 mul + 3 add), direction rows 3 x (3 mul + 2
# add), three |d| tests (6) and three reciprocals (3).
TRANSFORM_OPS = 42


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(ops: float, moved: float) -> tuple[float, str]:
    """(bound_ms, bound_by) for a call's operations and bytes."""
    t_ops, t_bytes = ops / PEAK_OPS * 1e3, moved / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def trace_bound(outi, common, moved: int) -> tuple[tuple[float, str], int]:
    """A traversal call's (bound, pairs).  Operations: the ray-triangle
    pairs its rays tested (outi row 5: live rays only, up to the first hit
    in occluded mode) x the pair ops, plus v8's slab tests (outi row 6,
    zero in v7 and v9) x SLAB_OPS, plus the instanced v8's mesh-space
    transforms (outi row 7, zero elsewhere) x TRANSFORM_OPS.  The
    tile-shared dot products of a common origin or direction (under 1%
    more) are left out."""
    visits = int(outi[:, 1, 0].sum().item())
    pairs = int(outi[:, 5].sum().item())
    slabs = int(outi[:, 6].sum().item())
    transforms = int(outi[:, 7].sum().item())
    require(0 < pairs <= visits * 128 * 128,
            f"pair count {pairs} outside (0, {visits} visits x 128 x 128]")
    return bound(pairs * OPS_PER_PAIR[common] + slabs * SLAB_OPS + transforms * TRANSFORM_OPS,
                 moved), pairs


def atrous_bound(h: int, w: int, iterations: int) -> tuple[float, str]:
    """4 images read (48 B/px) and 2 written (24 B/px) per iteration; per
    in-bounds tap 67 f32 operations (four squared distances 32, four
    weights 17 with exp and division counted as one each, weight products
    4, accumulation 14), per pixel 8 in the normalization."""
    ops = 0
    for step in range(1, iterations + 1):
        rows = sum(max(0, h - abs(k - 2) * step) for k in range(5))
        cols = sum(max(0, w - abs(k - 2) * step) for k in range(5))
        ops += rows * cols * 67 + h * w * 8
    return bound(ops, iterations * h * w * 72)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    try:
        import realtimeraytracer_torch as rt
    except ImportError as e:
        raise SmokeFailure(f"cannot import realtimeraytracer_torch ({e}); run from the repository root") from e
    from realtimeraytracer_torch import kernels, scenes
    from realtimeraytracer_torch.ops.camera_rays import block_permutation, generate_rays
    from realtimeraytracer_torch.ops.denoise_kernel import (
        atrous_denoise_pair, atrous_pair_iteration_kernel, atrous_pair_iteration_plain)
    from realtimeraytracer_torch.ops.denoise import ratio_combine
    from realtimeraytracer_torch.ops.refit import apply_instance_transforms
    from realtimeraytracer_torch.render import hier_backend as v8
    from realtimeraytracer_torch.render import quarter_backend as v9
    from realtimeraytracer_torch.render import v7_backend as v7
    from realtimeraytracer_torch.render.alpha import hit_alpha, wrap_backend_with_alpha
    from realtimeraytracer_torch.render.backends import make_hybrid_backend
    from realtimeraytracer_torch.render.megakernel import render_components
    from realtimeraytracer_torch.render.pipeline import render_pipeline_gpu

    # Launch counters: (wrapper, attribute); a masked variant counts on its
    # wrapper's masked_launches.
    counters = {"trace_v7": (v7.trace_blocks, "launches"),
                "trace_v9": (v9.trace_blocks_quarter, "launches"),
                "trace_v8": (v8.trace_blocks_hier, "launches"),
                "atrous_pair": (atrous_denoise_pair, "launches"),
                "trace_v7_masked": (v7.trace_blocks, "masked_launches"),
                "trace_v9_masked": (v9.trace_blocks_quarter, "masked_launches"),
                "trace_v8_masked": (v8.trace_blocks_hier, "masked_launches"),
                "trace_v8_inst": (v8.trace_blocks_hier, "launches_inst"),
                "trace_v8_inst_masked": (v8.trace_blocks_hier, "masked_launches_inst")}

    def zero_counts() -> None:
        for c, attr in counters.values():
            setattr(c, attr, 0)

    def read_counts() -> dict:
        return {name: getattr(c, attr) for name, (c, attr) in counters.items()}

    def unmasked(**kw) -> dict:
        """Expected counts of an opaque frame: the masked variants unused."""
        return {**kw, "trace_v7_masked": 0, "trace_v9_masked": 0, "trace_v8_masked": 0,
                "trace_v8_inst": 0, "trace_v8_inst_masked": 0}

    # ---- 1. environment -------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip()
    say(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    libs = kernels.build_all()
    say(f"[2] built {len(libs)} kernel libraries in {time.perf_counter() - t0:.2f} s")
    for name, log in kernels.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                say(f"  {name}: {line.strip()}")

    # ---- 3. v7 kernel vs plain ------------------------------------------
    scene = scenes.procedural_mesh(100_000, sun=True)
    t0 = time.perf_counter()
    scene.compile(quarter_panels=False)
    t_plain = time.perf_counter() - t0
    t0 = time.perf_counter()
    gpu = scene.compile().to(dev)
    say(f"[3] procedural_mesh(100_000): {gpu.num_tris} tris, "
        f"{gpu.pallas_panels.shape[0]} coefficient blocks, {gpu.num_light_tris} light tris; "
        f"host compile {time.perf_counter() - t0:.2f} s with the v9 repacked panels, "
        f"{t_plain:.2f} s without (routes that run no v9 trace)")
    coeff, cl_min, cl_max = gpu.pallas_panels, gpu.pallas_cl_min, gpu.pallas_cl_max

    def primary_tiles(w, h):
        frame = scene.camera.viewport_frame(w, h, device=dev)
        o, d = generate_rays(frame, w, h, sample_index=0, jitter=True)
        perm, _ = block_permutation(w, h, device=dev)
        r = o.shape[0]
        return v7._pack_rays(o[perm], d[perm], torch.full((r,), 1e-3, device=dev),
                             torch.full((r,), 1e4, device=dev))[0]

    def shadow_tiles(prim, out, rng_seed):
        """Shadow segments from the primary hits toward a random point of
        light triangle 0, and sun segments; misses get [BIG, -BIG)."""
        o, d = prim[:, 0:3].permute(0, 2, 1).reshape(-1, 3), prim[:, 3:6].permute(0, 2, 1).reshape(-1, 3)
        t = out[0][:, 0].reshape(-1)
        hit = out[1][:, 0].reshape(-1) >= 0
        p = o + d * torch.where(hit, t, 0.0)[:, None] - d * 1e-3
        g = np.random.default_rng(rng_seed)
        ab = torch.from_numpy(g.uniform(0, 0.5, (o.shape[0], 2)).astype(np.float32)).to(dev)
        l0, l1, l2 = gpu.lt_v0[0], gpu.lt_v1[0], gpu.lt_v2[0]
        target = l0 + ab[:, :1] * (l1 - l0) + ab[:, 1:] * (l2 - l0)
        delta = target - p
        dist = delta.norm(dim=1)
        sdir = delta / dist[:, None]
        big = torch.full_like(dist, 3.0e38)
        seg = v7._pack_rays(p, sdir, torch.where(hit, 1e-3, big), torch.where(hit, dist - 0.5, -big))[0]
        sun = v7._pack_rays(p, gpu.sun_direction.expand_as(p).contiguous(),
                            torch.where(hit, 1e-3, big), torch.where(hit, 1e4, -big))[0]
        return seg, sun

    def both(rays, mode, common):
        keys, id_mask = v7.cull_keys(rays, cl_min, cl_max)
        k = v7.trace_keys_kernel(rays, keys, coeff, id_mask, mode, common)
        p = v7.trace_keys_plain(rays, keys, coeff, id_mask, mode, common)
        torch.cuda.synchronize()
        return k, p

    prim = primary_tiles(320, 180)
    k, p = both(prim, "closest", "origin")
    v7_err = compare_closest(k, p, "[3] closest common=origin 320x180")
    seg, sun = shadow_tiles(prim, k, 7)
    v7_err = max(v7_err, compare_occluded(*both(seg, "occluded", None), "[3] occluded shadow segments"))
    v7_err = max(v7_err, compare_occluded(*both(sun, "occluded", "dir"), "[3] occluded sun common=dir"))
    v7_err = max(v7_err, compare_closest(*both(seg, "closest", None), "[3] closest general (shadow rays)"))

    # ---- 4. denoise kernel vs plain at 1080p ----------------------------
    H, W = 1080, 1920
    g = np.random.default_rng(11)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    pos = np.stack([xx * 2e-3, yy * 2e-3, 0.05 * np.sin(xx * 0.01)], -1)
    pos += g.normal(0, 2e-3, pos.shape)
    nrm = np.stack([0.05 * np.sin(yy * 0.02), np.ones_like(xx), 0.05 * np.cos(xx * 0.03)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    unsh = g.uniform(0.2, 1.0, (H, W, 3))
    shad = unsh * (g.uniform(0, 1, (H, W, 1)) > 0.3)
    t32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)  # noqa: E731
    dn = [t32(a) for a in (shad, unsh, nrm, pos)]
    phis = (1.0, 0.001, 0.001)

    def denoise_with(step_fn):
        s, u = dn[0], dn[1]
        for i in range(4):
            s, u = step_fn(s, u, dn[2], dn[3], i + 1, *phis)
        return s, u

    sk, uk = denoise_with(atrous_pair_iteration_kernel)
    sp, up = denoise_with(atrous_pair_iteration_plain)
    torch.cuda.synchronize()
    dn_err = 0.0
    for a, b, what in ((sk, sp, "shadowed"), (uk, up, "unshadowed")):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=lambda m: f"[4] {what}: {m}")
        dn_err = max(dn_err, (a - b).abs().max().item())
    say(f"[4] A-Trous pair kernel vs plain at {W}x{H}, 4 iterations: max |err| {dn_err}")
    for step in (5, 6, 8):   # denoise_iterations > 4 run the kernel as well
        ks, ku = atrous_pair_iteration_kernel(*dn, step, *phis)
        ps, pu = atrous_pair_iteration_plain(*dn, step, *phis)
        for a, b, what in ((ks, ps, "shadowed"), (ku, pu, "unshadowed")):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6,
                                       msg=lambda m: f"[4] step {step} {what}: {m}")
            dn_err = max(dn_err, (a - b).abs().max().item())
    say(f"[4] A-Trous pair kernel vs plain at steps 5, 6, 8 agree; max |err| so far {dn_err}")
    dn_ms, _ = cuda_ms(lambda: denoise_with(atrous_pair_iteration_kernel), 5)
    dn_plain_ms, _ = cuda_ms(lambda: denoise_with(atrous_pair_iteration_plain), 3)
    dn_bound = atrous_bound(H, W, 4)
    say(f"[4] denoise 4 iterations, both images: kernel {dn_ms:.3f} ms, plain {dn_plain_ms:.3f} ms, "
        f"bound {dn_bound[0]:.4f} ms by {dn_bound[1]} ({card})")

    # ---- 5. the frame ---------------------------------------------------
    cfg = rt.RenderConfig(width=W, height=H, primary_rays=4, shadow_rays=3,
                          denoise_iterations=4, backend="pallas")
    torch.cuda.reset_peak_memory_stats()
    held5 = torch.cuda.memory_allocated()
    zero_counts()
    t0 = time.perf_counter()
    img_t = rt.render(scene, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts5 = read_counts()
    n_trace = counts5["trace_v7"]
    img = img_t.cpu().numpy()
    say(f"[5] render(scene, cfg, device='cuda'), backend='pallas': {wall:.2f} s wall with compile; "
        f"launches {counts5}")
    expect = cfg.primary_rays * (1 + gpu.num_light_tris * cfg.shadow_rays + 1)
    require(counts5 == unmasked(trace_v7=expect, trace_v9=0, trace_v8=0,
                                atrous_pair=cfg.denoise_iterations),
            f"pallas frame: expected {expect} v7, 0 v9, 0 v8 and 4 A-Trous launches, counted {counts5}")
    require(img.shape == (H, W, 3), f"image shape {img.shape}")
    require(bool(np.isfinite(img).all()), "frame has non-finite values")
    require(float(img.std()) > 1e-3, "frame is constant")
    say(f"[5] image mean {img.mean():.6f} std {img.std():.6f} min {img.min():.6f} max {img.max():.6f}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, of which "
        f"{held5 / 2**30:.3f} GiB were held before the frame")

    frame = scene.camera.viewport_frame(W, H, device=dev)
    render_pipeline_gpu(gpu, frame, cfg)                       # warm-up, discarded
    times = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        render_pipeline_gpu(gpu, frame, cfg)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    frame_ms = statistics.median(times)
    say(f"[5] frame time (render_pipeline_gpu, CUDA events, median of 3 after a warm-up): "
        f"{frame_ms:.2f} ms; all: {[round(x, 2) for x in times]} ({card})")

    # Kernel vs plain at the frame's shapes (1080p primaries and shadows):
    # timed, and compared once more at full size.
    prim = primary_tiles(W, H)
    keys, id_mask = v7.cull_keys(prim, cl_min, cl_max)
    cull_ms, _ = cuda_ms(lambda: v7.cull_keys(prim, cl_min, cl_max), 3)
    v7_ms, prim_k = cuda_ms(
        lambda: v7.trace_keys_kernel(prim, keys, coeff, id_mask, "closest", "origin"), 10)
    v7_plain_ms, prim_p = cuda_ms(
        lambda: v7.trace_keys_plain(prim, keys, coeff, id_mask, "closest", "origin"), 1)
    v7_visits = int(prim_k[1][:, 1, 0].sum().item())
    v7_bound, v7_pairs = trace_bound(prim_k[1], "origin",
                                     nbytes(prim, keys, coeff) + 4 * prim.shape[0] * 128 * 4)
    say(f"[5] v7 closest, 1080p primaries ({prim.shape[0]} tiles): cull {cull_ms:.3f} ms, "
        f"kernel {v7_ms:.3f} ms, plain {v7_plain_ms:.3f} ms; {v7_visits} visits, {v7_pairs} pairs "
        f"tested ({v7_pairs / (v7_visits * 16384):.4f} of visits x 128 x 128), "
        f"bound {v7_bound[0]:.4f} ms by {v7_bound[1]} ({card})")
    v7_err = max(v7_err, compare_closest(prim_k, prim_p, "[5] closest common=origin 1080p"))
    seg, sun = shadow_tiles(prim, prim_k, 8)
    for rays, common, what in ((seg, None, "shadow segments"), (sun, "dir", "sun common=dir")):
        keys_s, _ = v7.cull_keys(rays, cl_min, cl_max)
        km, k = cuda_ms(lambda: v7.trace_keys_kernel(rays, keys_s, coeff, id_mask, "occluded", common), 5)
        pm, p = cuda_ms(lambda: v7.trace_keys_plain(rays, keys_s, coeff, id_mask, "occluded", common), 1)
        say(f"[5] v7 occluded, 1080p {what} (unsorted): kernel {km:.3f} ms, plain {pm:.3f} ms ({card})")
        v7_err = max(v7_err, compare_occluded(k, p, f"[5] occluded {what} 1080p"))

    # ---- 6. small frame, kernels vs plain twins -------------------------
    cfg6 = cfg.replace(width=320, height=180, primary_rays=1)
    frame6 = scene.camera.viewport_frame(320, 180, device=dev)
    img_k = render_pipeline_gpu(gpu, frame6, cfg6).cpu().numpy()
    plain = v7.make_v7_backend(gpu, cfg6, trace=v7.trace_blocks_plain)
    phis6 = (cfg6.denoise_c_phi, cfg6.denoise_n_phi, cfg6.denoise_p_phi)
    with torch.inference_mode():
        comp = render_components(gpu, frame6, cfg6, 0, backend=plain)
        s, u = comp.shadowed, comp.unshadowed
        for i in range(cfg6.denoise_iterations):
            s, u = atrous_pair_iteration_plain(s, u, comp.normal, comp.position, i + 1, *phis6)
        img_p = ratio_combine(comp.analytic, s, u).cpu().numpy()
    share = image_rule(img_k, img_p, "[6] 320x180 frame, kernels vs plain")
    say(f"[6] 320x180 frame kernels vs plain: {share:.6%} of values differ by > 2e-3, "
        f"max |err| {np.abs(img_k - img_p).max()}")

    # ---- 7. v9 kernel vs plain ------------------------------------------
    q_coeff, q_off = gpu.q_panels, gpu.q_group_off
    require(q_coeff is not None, "the 100k scene carries no v9 repacked panels")
    say(f"[7] v9 repacked panels: {q_coeff.shape[0]} blocks")

    def v9_both(rays, common):
        qkeys, qmask = v7.cull_quarter_keys(rays, gpu.q_cl_min, gpu.q_cl_max)
        k = v9.trace_quarter_kernel(rays, qkeys, q_coeff, q_off, qmask, common)
        p = v9.trace_quarter_plain(rays, qkeys, q_coeff, q_off, qmask, common)
        torch.cuda.synchronize()
        return k, p

    v9_err = compare_closest(*v9_both(primary_tiles(320, 180), "origin"),
                             "[7] v9 closest common=origin 320x180")
    qkeys, qmask = v7.cull_quarter_keys(prim, gpu.q_cl_min, gpu.q_cl_max)
    qcull_ms, _ = cuda_ms(lambda: v7.cull_quarter_keys(prim, gpu.q_cl_min, gpu.q_cl_max), 3)
    v9_ms, v9_k = cuda_ms(
        lambda: v9.trace_quarter_kernel(prim, qkeys, q_coeff, q_off, qmask, "origin"), 10)
    v9_plain_ms, v9_p = cuda_ms(
        lambda: v9.trace_quarter_plain(prim, qkeys, q_coeff, q_off, qmask, "origin"), 1)
    v9_err = max(v9_err, compare_closest(v9_k, v9_p, "[7] v9 closest common=origin 1080p"))
    v9_visits = int(v9_k[1][:, 1, 0].sum().item()) // 4
    v9_bound, v9_pairs = trace_bound(v9_k[1], "origin", nbytes(prim, qkeys, q_coeff, q_off)
                                     + 4 * prim.shape[0] * 128 * 4)
    per_stream = (qkeys.reshape(prim.shape[0], 4, -1) != v7.INVALID).sum(dim=2).float()
    say(f"[7] candidates per tile: v7 {float((keys != v7.INVALID).sum()) / prim.shape[0]:.2f} blocks; "
        f"v9 {float(per_stream.mean()):.2f} subclusters per stream, longest stream "
        f"{float(per_stream.amax(dim=1).mean()):.2f}; visits per tile: v7 {v7_visits / prim.shape[0]:.2f}, "
        f"v9 {v9_visits / prim.shape[0]:.2f}")
    say(f"[7] v9 closest, 1080p primaries: quarter cull {qcull_ms:.3f} ms, kernel {v9_ms:.3f} ms, "
        f"plain {v9_plain_ms:.3f} ms; {v9_visits} composite visits (v7: {v7_visits}), {v9_pairs} "
        f"pairs tested ({v9_pairs / (v9_visits * 16384):.4f} of visits x 128 x 128; v7: "
        f"{v7_pairs}), bound {v9_bound[0]:.4f} ms by {v9_bound[1]} ({card})")

    # ---- 8. v8 kernel vs plain ------------------------------------------
    hcoeff, sup, blk, nsup = v8._hier_inputs(gpu)
    say(f"[8] v8 hierarchy: {nsup} superclusters over {hcoeff.shape[0]} blocks")
    h_in = nbytes(sup, blk, hcoeff)

    def v8_kernel(rays, mode, common, hints=None, count=False):
        return v8.trace_hier_kernel(rays, sup, blk, hcoeff, nsup, mode, common, hints, count)

    def v8_plain(rays, mode, common):
        return v8.trace_hier_plain(rays, sup, blk, hcoeff, nsup, mode, common)

    def bounce_tiles(prim, out, rng_seed):
        """Incoherent closest rays: from the primary hits, random directions
        on the side the primary came from; misses get [BIG, -BIG)."""
        o = prim[:, 0:3].permute(0, 2, 1).reshape(-1, 3)
        d = prim[:, 3:6].permute(0, 2, 1).reshape(-1, 3)
        t = out[0][:, 0].reshape(-1)
        hit = out[1][:, 0].reshape(-1) >= 0
        p = o + d * torch.where(hit, t, 0.0)[:, None] - d * 1e-3
        g = np.random.default_rng(rng_seed)
        b = torch.from_numpy(g.normal(size=(o.shape[0], 3)).astype(np.float32)).to(dev)
        b = b / b.norm(dim=1, keepdim=True)
        b = torch.where(((b * d).sum(1) > 0)[:, None], -b, b)
        big = torch.full_like(t, 3.0e38)
        return v7._pack_rays(p, b, torch.where(hit, 1e-3, big), torch.where(hit, 1e4, -big))[0]

    seg, sun = shadow_tiles(prim, prim_k, 9)
    bounce = bounce_tiles(prim, prim_k, 10)
    v8_err, v8_rows = 0.0, {}
    for rays, mode, common, what, reps in ((seg, "occluded", None, "occluded shadow segments", 5),
                                           (sun, "occluded", "dir", "occluded sun common=dir", 5),
                                           (bounce, "closest", None, "closest bounce rays", 3)):
        km, k = cuda_ms(lambda: v8_kernel(rays, mode, common), reps)
        pm, p = cuda_ms(lambda: v8_plain(rays, mode, common), 1)
        cmp = compare_occluded if mode == "occluded" else compare_closest
        v8_err = max(v8_err, cmp(k, p, f"[8] v8 {what} 1080p"))
        # The counting variant: the same results, plus the work counts.
        cm, kc = cuda_ms(lambda: v8_kernel(rays, mode, common, count=True), reps)
        require(torch.equal(kc[0][:, 0], k[0][:, 0]) and torch.equal(kc[1][:, 0:2], k[1][:, 0:2]),
                f"[8] v8 {what}: the counting variant's results differ")
        visits = int(k[1][:, 1, 0].sum().item())
        rows_out = 7 if mode == "occluded" else 5      # outf 0-1, outi 0-2 (+ hints 3-4)
        b, pairs = trace_bound(kc[1], common, nbytes(rays) + h_in + rows_out * rays.shape[0] * 128 * 4)
        v8_rows[what] = (km, pm, visits, b)
        say(f"[8] v8 {what}, 1080p: kernel {km:.3f} ms (counting variant {cm:.3f} ms), plain "
            f"{pm:.3f} ms; {visits} visits, {pairs} pairs tested ({pairs / (visits * 16384):.4f} of "
            f"visits x 128 x 128), {int(kc[1][:, 6].sum().item())} slab tests, "
            f"bound {b[0]:.4f} ms by {b[1]} ({card})")

    # Hints: cold, fed its own hints, fed garbage; masks equal the twin's.
    want = v8_plain(seg, "occluded", None)
    cold = v8_kernel(seg, "occluded", None)
    hints = cold[1][:, 3:5, 0].contiguous()
    fed_ms, fed = cuda_ms(lambda: v8_kernel(seg, "occluded", None, hints), 5)
    ts = seg.shape[0]
    garbage = torch.stack([torch.full((ts,), 10_000, dtype=torch.int32, device=dev),
                           torch.full((ts,), -1, dtype=torch.int32, device=dev)], dim=1)
    bad = v8_kernel(seg, "occluded", None, garbage)
    for got, what in ((cold, "cold"), (fed, "fed its own hints"), (bad, "garbage hints")):
        v8_err = max(v8_err, compare_occluded(got, want, f"[8] v8 hinted ({what})"))
    occ = want[0][:, 0] > 0.5
    cb = hcoeff.shape[0]
    has = occ.any(dim=1)
    require(bool((hints[~has] == -1).all()), "[8] a tile without occluded rays got a hint")
    require(bool(((hints[has] >= 0) & (hints[has] < cb)).all()), "[8] a hint is not a block")
    for j in range(2):
        tiles = has.nonzero()[:, 0]
        for s0 in range(0, tiles.numel(), 1024):
            tt = tiles[s0:s0 + 1024]
            _, ok = v7._intersect_pairs(seg[tt], hcoeff[hints[tt, j].long()], None)
            require(bool((ok.any(dim=2) & occ[tt]).any(dim=1).all()),
                    f"[8] hint {j} of some tile occludes none of its rays")
    fed_visits = int(fed[1][:, 1, 0].sum().item())
    say(f"[8] v8 hints hold on {int(has.sum())} tiles with occluded rays; hinted trace "
        f"{fed_ms:.3f} ms, {fed_visits} visits (cold {v8_rows['occluded shadow segments'][2]}) ({card})")

    # ---- 9. the frame through the default route --------------------------
    cfg9 = rt.RenderConfig(width=W, height=H, primary_rays=4, shadow_rays=3, denoise_iterations=4)
    require(cfg9.backend == "auto", "the default backend is not 'auto'")
    torch.cuda.reset_peak_memory_stats()
    held9 = torch.cuda.memory_allocated()
    zero_counts()
    t0 = time.perf_counter()
    img_t = rt.render(scene, cfg9)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts9 = read_counts()
    require(img_t.device.type == "cuda", f"render with no device ran on {img_t.device}")
    n_v8 = cfg9.primary_rays * (gpu.num_light_tris * cfg9.shadow_rays + 1)
    want9 = unmasked(trace_v7=0, trace_v9=cfg9.primary_rays, trace_v8=n_v8,
                     atrous_pair=cfg9.denoise_iterations)
    say(f"[9] render(scene, cfg) with no device, backend 'auto': {wall:.2f} s wall with compile; "
        f"launches {counts9}")
    require(counts9 == want9, f"hybrid frame: expected launches {want9}, counted {counts9}")
    img9 = img_t.cpu().numpy()
    require(img9.shape == (H, W, 3), f"image shape {img9.shape}")
    require(bool(np.isfinite(img9).all()), "hybrid frame has non-finite values")
    require(float(img9.std()) > 1e-3, "hybrid frame is constant")
    peak9 = torch.cuda.max_memory_allocated() / 2**30
    share9 = float((np.abs(img9 - img) > 2e-3).mean())
    say(f"[9] image mean {img9.mean():.6f} std {img9.std():.6f}; {share9:.4%} of values differ from "
        f"the pallas frame by > 2e-3; peak memory {peak9:.3f} GiB, of which {held9 / 2**30:.3f} GiB "
        f"were held before the frame")
    render_pipeline_gpu(gpu, frame, cfg9)                      # warm-up, discarded
    times9 = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        render_pipeline_gpu(gpu, frame, cfg9)
        b.record()
        b.synchronize()
        times9.append(a.elapsed_time(b))
    say(f"[9] hybrid frame time (render_pipeline_gpu, CUDA events, median of 3 after a warm-up): "
        f"{statistics.median(times9):.2f} ms; all: {[round(x, 2) for x in times9]}; pallas frame "
        f"{frame_ms:.2f} ms ({card})")

    # ---- 10. small hybrid frame, kernels vs plain twins ------------------
    cfg10 = cfg9.replace(width=320, height=180, primary_rays=2)
    img_k = render_pipeline_gpu(gpu, frame6, cfg10).cpu().numpy()
    with torch.inference_mode():
        comp = render_components(gpu, frame6, cfg10, 0,
                                 backend=make_hybrid_backend(gpu, cfg10, plain=True))
        s, u = comp.shadowed, comp.unshadowed
        for i in range(cfg10.denoise_iterations):
            s, u = atrous_pair_iteration_plain(s, u, comp.normal, comp.position, i + 1, *phis6)
        img_p = ratio_combine(comp.analytic, s, u).cpu().numpy()
    share = image_rule(img_k, img_p, "[10] 320x180 hybrid frame, kernels vs plain")
    say(f"[10] 320x180 hybrid frame kernels vs plain: {share:.6%} of values differ by > 2e-3, "
        f"max |err| {np.abs(img_k - img_p).max()}")

    # ---- 11. the textured, alpha-tested scenes ----------------------------
    t0 = time.perf_counter()
    fol_scene = scenes.foliage_field()
    fol = fol_scene.compile(bake_instances=True).to(dev)
    t_fol = time.perf_counter() - t0
    t0 = time.perf_counter()
    tobj_scene = scenes.textured_obj()
    tobj = tobj_scene.compile().to(dev)
    t_tobj = time.perf_counter() - t0
    require(fol.pallas_amask is not None and fol.q_amask is not None, "foliage: no alpha masks")
    require(fol.q_panels is not None, "foliage: no v9 repacked panels (above RESIDENT_CB?)")
    transparent = float((fol.pallas_amask != -1).float().mean())
    say(f"[11] foliage_field baked: {fol.num_tris} tris, {fol.pallas_panels.shape[0]} coefficient "
        f"blocks, {fol.q_panels.shape[0]} repacked v9 blocks, {fol.tex_atlas.shape[0]} textures "
        f"{tuple(fol.tex_atlas.shape[1:3])}, pallas_amask {tuple(fol.pallas_amask.shape)} "
        f"({transparent:.4f} of mask words hold a 0 bit), {fol.num_light_tris} light tris; "
        f"host compile {t_fol:.2f} s")
    say(f"[11] textured_obj: {tobj.num_tris} tris, {tobj.pallas_panels.shape[0]} blocks, "
        f"{tobj.tex_atlas.shape[0]} textures, {tobj.num_light_tris} light tris; "
        f"loaders + compile {t_tobj:.2f} s")

    # ---- 12. masked kernels vs their twins at 1080p -----------------------
    def scene_primaries(sc, w, h):
        frame = sc.camera.viewport_frame(w, h, device=dev)
        o, d = generate_rays(frame, w, h, sample_index=0, jitter=True)
        perm, _ = block_permutation(w, h, device=dev)
        r = o.shape[0]
        return o[perm], d[perm], torch.full((r,), 1e-3, device=dev), torch.full((r,), 1e4, device=dev)

    fo, fd, ftmin, ftmax = scene_primaries(fol_scene, W, H)
    fprim = v7._pack_rays(fo, fd, ftmin, ftmax)[0]
    out_bytes = 4 * fprim.shape[0] * 128 * 4

    qkeys, qid = v7.cull_quarter_keys(fprim, fol.q_cl_min, fol.q_cl_max)
    v9m_args = (fprim, qkeys, fol.q_panels, fol.q_group_off, qid, "origin")
    v9m_ms, v9m_k = cuda_ms(lambda: v9.trace_quarter_kernel(*v9m_args, amask=fol.q_amask), 10)
    v9m_plain_ms, v9m_p = cuda_ms(lambda: v9.trace_quarter_plain(*v9m_args, amask=fol.q_amask), 1)
    v9m_err = compare_closest(v9m_k, v9m_p, "[12] v9 masked closest common=origin 1080p")
    v9_open_ms, v9_open = cuda_ms(lambda: v9.trace_quarter_kernel(*v9m_args), 10)
    v9m_bound, v9m_pairs = trace_bound(v9m_k[1], "origin", nbytes(fprim, qkeys, fol.q_panels,
                                       fol.q_group_off, fol.q_amask) + out_bytes)
    say(f"[12] v9 masked, 1080p foliage primaries: kernel {v9m_ms:.3f} ms, plain {v9m_plain_ms:.3f} ms, "
        f"unmasked kernel on the same rays {v9_open_ms:.3f} ms, "
        f"{int((v9m_k[1][:, 0] != v9_open[1][:, 0]).sum())} hits differ from its; "
        f"{v9m_pairs} pairs, bound {v9m_bound[0]:.4f} ms by {v9m_bound[1]} ({card})")

    fkeys, fid = v7.cull_keys(fprim, fol.pallas_cl_min, fol.pallas_cl_max)
    v7m_args = (fprim, fkeys, fol.pallas_panels, fid, "closest", "origin")
    v7m_ms, v7m_k = cuda_ms(lambda: v7.trace_keys_kernel(*v7m_args, amask=fol.pallas_amask), 10)
    v7m_plain_ms, v7m_p = cuda_ms(lambda: v7.trace_keys_plain(*v7m_args, amask=fol.pallas_amask), 1)
    v7m_err = compare_closest(v7m_k, v7m_p, "[12] v7 masked closest common=origin 1080p")
    v7m_bound, v7m_pairs = trace_bound(v7m_k[1], "origin", nbytes(fprim, fkeys, fol.pallas_panels,
                                       fol.pallas_amask) + out_bytes)
    v7_open_ms, _ = cuda_ms(lambda: v7.trace_keys_kernel(*v7m_args), 10)
    say(f"[12] v7 masked, 1080p foliage primaries: kernel {v7m_ms:.3f} ms (unmasked on the same rays "
        f"{v7_open_ms:.3f} ms), plain {v7m_plain_ms:.3f} ms; "
        f"{v7m_pairs} pairs, bound {v7m_bound[0]:.4f} ms by {v7m_bound[1]} ({card})")
    require(bool(((v7m_k[1][:, 0] == v9m_k[1][:, 0]) | (v7m_k[0][:, 0] == v9m_k[0][:, 0])).all()),
            "[12] masked v7 and v9 disagree on the foliage primaries")

    # Area-light shadow segments from the masked primary hits toward light
    # triangle 0; misses get [BIG, -BIG).
    hit = v9m_k[1][:, 0].reshape(-1) >= 0
    p = fo + fd * torch.where(hit, v9m_k[0][:, 0].reshape(-1), 0.0)[:, None] - fd * 1e-3
    g = np.random.default_rng(13)
    ab = torch.from_numpy(g.uniform(0, 0.5, (p.shape[0], 2)).astype(np.float32)).to(dev)
    l0, l1, l2 = fol.lt_v0[0], fol.lt_v1[0], fol.lt_v2[0]
    delta = l0 + ab[:, :1] * (l1 - l0) + ab[:, 1:] * (l2 - l0) - p
    dist = delta.norm(dim=1)
    big = torch.full_like(dist, 3.0e38)
    fseg = v7._pack_rays(p, delta / dist[:, None], torch.where(hit, 1e-3, big),
                         torch.where(hit, dist - 0.5, -big))[0]
    fcoeff, fsup, fblk, fnsup = v8._hier_inputs(fol)
    v8m_args = (fseg, fsup, fblk, fcoeff, fnsup, "closest", None, None)
    v8m_ms, v8m_k = cuda_ms(lambda: v8.trace_hier_kernel(*v8m_args, amask=fol.pallas_amask), 5)
    v8m_plain_ms, v8m_p = cuda_ms(lambda: v8.trace_hier_plain(*v8m_args, amask=fol.pallas_amask), 1)
    v8m_err = compare_closest(v8m_k, v8m_p, "[12] v8 masked closest, 1080p shadow segments")
    v8m_c = v8.trace_hier_kernel(*v8m_args, count=True, amask=fol.pallas_amask)
    require(torch.equal(v8m_c[0][:, 0], v8m_k[0][:, 0]) and torch.equal(v8m_c[1][:, 0], v8m_k[1][:, 0]),
            "[12] v8 masked: the counting variant's results differ")
    v8m_bound, v8m_pairs = trace_bound(v8m_c[1], None, nbytes(fseg, fsup, fblk, fcoeff, fol.pallas_amask)
                                       + 5 * fseg.shape[0] * 128 * 4)
    v8_open_ms, _ = cuda_ms(lambda: v8.trace_hier_kernel(*v8m_args), 5)
    say(f"[12] v8 masked closest, 1080p foliage shadow segments: kernel {v8m_ms:.3f} ms (unmasked "
        f"on the same rays {v8_open_ms:.3f} ms), plain "
        f"{v8m_plain_ms:.3f} ms; {int(v8m_k[1][:, 1, 0].sum())} visits, {v8m_pairs} pairs, "
        f"{int(v8m_c[1][:, 6].sum())} slab tests, bound {v8m_bound[0]:.4f} ms by {v8m_bound[1]} ({card})")

    # ---- 13. the alpha closest ladder with and without in-kernel masks -----
    cfg_a = rt.RenderConfig(width=W, height=H, alpha_test=True)
    ladder = {}
    for use in (True, False):
        rec = []
        be = wrap_backend_with_alpha(make_hybrid_backend(fol, cfg_a, use_amask=use), fol, cfg_a,
                                     record=rec)

        def run_ladder():
            rec.clear()
            return be.closest(fo, fd, cfg_a.t_min, cfg_a.t_max, common="origin")

        ms, h = cuda_ms(run_ladder, 3)
        ladder[use] = (ms, h, [n for _, n in rec])
        say(f"[13] alpha closest ladder, 1080p foliage primaries, masks {'on' if use else 'off'}: "
            f"{ms:.3f} ms; rays needing each round {ladder[use][2]} "
            f"({sum(n > 0 for n in ladder[use][2])} rounds run of {cfg_a.alpha_rounds}) ({card})")
    hm, hn = ladder[True][1], ladder[False][1]
    thr = cfg_a.alpha_threshold
    exhausted = (hit_alpha(fol, hn, fo, fd) < thr) & hn.hit
    differ = ~((hm.prim_id == hn.prim_id) | (hm.t == hn.t))
    further = differ & exhausted & (hm.t >= hn.t)
    nearer = differ & (hm.t < hn.t) & (hit_alpha(fol, hm, fo, fd) >= thr)
    require(bool((differ == (further | nearer)).all()),
            f"[13] {int((differ & ~(further | nearer)).sum())} rays differ otherwise between the "
            "ladders (a mask that rejected an opaque hit would show here)")
    say(f"[13] {int(exhausted.sum())} rays exhaust the unmasked ladder; hits differ on "
        f"{int(differ.sum())} rays: {int(further.sum())} exhausted rays resolve further with masks, "
        f"on {int(nearer.sum())} the unmasked ladder stepped past the nearer opaque hit the masked "
        f"trace keeps ({int((nearer & exhausted).sum())} of them exhausted)")

    # ---- 14. the alpha-tested frames ---------------------------------------
    expect_kernels = {"auto": ("trace_v9_masked", "trace_v8_masked"),
                      "hybrid": ("trace_v9_masked", "trace_v8_masked"),
                      "pallas": ("trace_v7_masked",),
                      "instanced": ("trace_v8_inst",),
                      "instanced alpha": ("trace_v8_inst_masked",)}

    def alpha_frame(what, backend, render, timed, again=None, phase="14"):
        """Render once with every count zeroed just before and read just
        after; then time `again` (default: render) by CUDA events, median
        of `timed` runs after a discarded warm-up."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        syncs0, rounds0 = wrap_backend_with_alpha.syncs, wrap_backend_with_alpha.rounds
        zero_counts()
        t0 = time.perf_counter()
        img_t = render()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        syncs = wrap_backend_with_alpha.syncs - syncs0
        rounds = wrap_backend_with_alpha.rounds - rounds0
        peak = torch.cuda.max_memory_allocated() / 2**30
        require(img_t.device.type == "cuda", f"[{phase}] {what}: rendered on {img_t.device}")
        for name, n in counts.items():
            used = name in expect_kernels[backend] or name == "atrous_pair"
            require((n > 0) == used, f"[{phase}] {what}: {name} launched {n} times")
        require(counts["atrous_pair"] == 4, f"[{phase}] {what}: {counts['atrous_pair']} A-Trous launches")
        out = img_t.cpu().numpy()
        require(out.shape == (H, W, 3) and bool(np.isfinite(out).all()), f"[{phase}] {what}: bad image")
        require(float(out.std()) > 1e-3, f"[{phase}] {what}: constant image")
        again = again or render
        again()                                             # warm-up, discarded
        times = []
        for _ in range(timed):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            again()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        ms = statistics.median(times)
        say(f"[{phase}] {what}: {wall:.2f} s wall for the first frame; launches {counts}; host syncs "
            f"{syncs}, ladder rounds run {rounds}; peak memory {peak:.3f} GiB, of which "
            f"{held / 2**30:.3f} GiB were held before; frame {ms:.2f} ms (median of {timed}, "
            f"all {[round(x, 2) for x in times]}) ({card})")
        return out, counts, ms, syncs, peak

    cfg_t = rt.RenderConfig(width=W, height=H, primary_rays=4, shadow_rays=3, denoise_iterations=4)
    require(cfg_t.alpha_test is None and cfg_t.backend == "auto", "reference defaults changed")
    tframe = tobj_scene.camera.viewport_frame(W, H, device=dev)
    frames14 = {}
    frames14["textured_obj hybrid"] = alpha_frame(
        "textured_obj, rt.render(scene, cfg), default device and backend", "auto",
        lambda: rt.render(tobj_scene, cfg_t), 3,
        again=lambda: render_pipeline_gpu(tobj, tframe, cfg_t.replace(alpha_test=True)))
    frames14["textured_obj pallas"] = alpha_frame(
        "textured_obj, pallas route", "pallas",
        lambda: render_pipeline_gpu(tobj, tframe, cfg_t.replace(alpha_test=True, backend="pallas")), 1)
    ffr = fol_scene.camera.viewport_frame(W, H, device=dev)
    cfg_f = cfg_t.replace(alpha_test=True)
    frames14["foliage hybrid"] = alpha_frame(
        "foliage_field baked, render_pipeline_gpu, hybrid route", "auto",
        lambda: render_pipeline_gpu(fol, ffr, cfg_f), 3)
    frames14["foliage pallas"] = alpha_frame(
        "foliage_field baked, pallas route", "pallas",
        lambda: render_pipeline_gpu(fol, ffr, cfg_f.replace(backend="pallas")), 1)
    for name in ("textured_obj", "foliage"):
        hy, pa = frames14[f"{name} hybrid"][0], frames14[f"{name} pallas"][0]
        share = image_rule(hy, pa, f"[14] {name}: hybrid vs pallas route")
        say(f"[14] {name}: hybrid and pallas images differ by > 2e-3 in {share:.6%} of values, "
            f"max |err| {np.abs(hy - pa).max()}")

    # ---- 15. small alpha frame, kernels vs plain twins ---------------------
    cfg15 = cfg_f.replace(width=160, height=90, primary_rays=1)
    frame15 = fol_scene.camera.viewport_frame(160, 90, device=dev)
    img_k = render_pipeline_gpu(fol, frame15, cfg15).cpu().numpy()
    with torch.inference_mode():
        plain = wrap_backend_with_alpha(make_hybrid_backend(fol, cfg15, plain=True), fol, cfg15)
        comp = render_components(fol, frame15, cfg15, 0, backend=plain)
        s_, u_ = comp.shadowed, comp.unshadowed
        for i in range(cfg15.denoise_iterations):
            s_, u_ = atrous_pair_iteration_plain(s_, u_, comp.normal, comp.position, i + 1, *phis6)
        img_p = ratio_combine(comp.analytic, s_, u_).cpu().numpy()
    share = image_rule(img_k, img_p, "[15] 160x90 alpha frame, kernels vs plain")
    say(f"[15] 160x90 alpha-tested foliage frame kernels vs plain: {share:.6%} of values differ "
        f"by > 2e-3, max |err| {np.abs(img_k - img_p).max()}")

    # ---- 16. the instanced (shared-geometry) foliage -----------------------
    t0 = time.perf_counter()
    fol_i = fol_scene.compile().to(dev)
    t_fol_i = time.perf_counter() - t0
    require(fol_i.instanced and fol_i.pallas_amask is not None, "[16] foliage: not instanced, or no masks")
    n_pairs = int(fol_i.pair_tab[:, 3].sum())

    def scene_bytes(g) -> int:
        return sum(nbytes(getattr(g, f.name)) for f in dataclasses.fields(g)
                   if getattr(g, f.name) is not None)

    say(f"[16] foliage_field instanced: {fol_i.inst_inv.shape[0]} instances, {n_pairs} (instance, super) "
        f"pairs on {fol_i.pair_panel.shape[0]} pages, {fol_i.pallas_panels.shape[0]} pool blocks in "
        f"{fol_i.blk_panel.shape[0]} blk rows, pallas_amask {tuple(fol_i.pallas_amask.shape)}; host compile "
        f"{t_fol_i:.2f} s (baked: {t_fol:.2f} s); device bytes {scene_bytes(fol_i)} instanced, "
        f"{scene_bytes(fol)} baked")

    # ---- 17. the instanced v8 kernel vs its twin ----------------------------
    iargs = v8._inst_args(fol_i)

    def compare_instances(k, p, what):
        """Instance ids (outi row 2) equal, or else the two t equal."""
        same = (k[1][:, 2] == p[1][:, 2]) | (k[0][:, 0] == p[0][:, 0])
        require(bool(same.all()), f"{what}: instance ids differ with unequal t on {int((~same).sum())} rays")
        require(bool((k[1][:, 2][k[1][:, 0] < 0] == -1).all()), f"{what}: a miss carries an instance")

    def inst_both(rays, mode, amask=None):
        k = v8.trace_hier_inst_kernel(rays, *iargs, mode, amask=amask)
        p = v8.trace_hier_inst_plain(rays, *iargs, mode, amask)
        torch.cuda.synchronize()
        return k, p

    sprim = v7._pack_rays(*scene_primaries(fol_scene, 320, 180))[0]
    k, p = inst_both(sprim, "closest")
    vi_err = compare_closest(k, p, "[17] instanced closest, 320x180 primaries")
    compare_instances(k, p, "[17] instanced closest")
    k320 = k
    k_m, p_m = inst_both(sprim, "closest", fol_i.pallas_amask)
    vim_err = compare_closest(k_m, p_m, "[17] instanced masked closest, 320x180 primaries")
    compare_instances(k_m, p_m, "[17] instanced masked closest")
    so = sprim[:, 0:3].permute(0, 2, 1).reshape(-1, 3)
    sd = sprim[:, 3:6].permute(0, 2, 1).reshape(-1, 3)
    shit = k[1][:, 0].reshape(-1) >= 0
    sp = so + sd * torch.where(shit, k[0][:, 0].reshape(-1), 0.0)[:, None] - sd * 1e-3
    g = np.random.default_rng(17)
    ab = torch.from_numpy(g.uniform(0, 0.5, (sp.shape[0], 2)).astype(np.float32)).to(dev)
    l0, l1, l2 = fol_i.lt_v0[0], fol_i.lt_v1[0], fol_i.lt_v2[0]
    delta = l0 + ab[:, :1] * (l1 - l0) + ab[:, 1:] * (l2 - l0) - sp
    dist = delta.norm(dim=1)
    big = torch.full_like(dist, 3.0e38)
    iseg = v7._pack_rays(sp, delta / dist[:, None], torch.where(shit, 1e-3, big),
                         torch.where(shit, dist - 0.5, -big))[0]
    isun = v7._pack_rays(sp, fol_i.sun_direction.expand_as(sp).contiguous(),
                         torch.where(shit, 1e-3, big), torch.where(shit, 1e4, -big))[0]
    vi_err = max(vi_err, compare_occluded(*inst_both(iseg, "occluded"),
                                          "[17] instanced occluded, area-light segments"))
    vi_err = max(vi_err, compare_occluded(*inst_both(isun, "occluded"), "[17] instanced occluded, sun"))

    # 1080p primaries (fo, fd of phase 12): instanced kernel vs its twin,
    # timed, and against the baked scene's v9 kernel on the same rays.
    inst_rows = {}
    for masked in (False, True):
        am = fol_i.pallas_amask if masked else None
        what = "masked closest" if masked else "closest"
        km, k = cuda_ms(lambda: v8.trace_hier_inst_kernel(fprim, *iargs, "closest", amask=am), 3)
        pm, p = once_ms(lambda: v8.trace_hier_inst_plain(fprim, *iargs, "closest", am))
        err = compare_closest(k, p, f"[17] instanced {what}, 1080p primaries")
        compare_instances(k, p, f"[17] instanced {what}, 1080p")
        kc = v8.trace_hier_inst_kernel(fprim, *iargs, "closest", count=True, amask=am)
        require(torch.equal(kc[0][:, 0], k[0][:, 0]) and torch.equal(kc[1][:, 0:3], k[1][:, 0:3]),
                f"[17] instanced {what}: the counting variant's results differ")
        b, pairs = trace_bound(kc[1], None, nbytes(fprim, *iargs) + (0 if am is None else nbytes(am))
                               + 5 * fprim.shape[0] * 128 * 4)
        inst_rows[masked] = (km, pm, err, b, k)
        say(f"[17] instanced {what}, 1080p foliage primaries: kernel {km:.3f} ms, plain {pm:.3f} ms; "
            f"{int(k[1][:, 1, 0].sum())} visits, {int(k[0][:, 1, 0].sum())} pairs popped, {pairs} "
            f"ray-triangle pairs, {int(kc[1][:, 6].sum())} slab tests, {int(kc[1][:, 7].sum())} "
            f"transforms, bound {b[0]:.4f} ms by {b[1]} ({card})")
    vi_err = max(vi_err, inst_rows[False][2])
    vim_err = max(vim_err, inst_rows[True][2])
    ki = inst_rows[False][4]
    ti, tb = ki[0][:, 0].flatten(), v9_open[0][:, 0].flatten()
    ii, ib = ki[1][:, 0].flatten(), v9_open[1][:, 0].flatten()
    hi_, hb_ = ii >= 0, ib >= 0
    both = hi_ & hb_
    tol = torch.clamp(tb * 1e-4, min=1e-3)
    t_ok = (ti - tb).abs() <= tol
    obj_i = fol_i.inst_obj[ki[1][:, 2].flatten().clamp(min=0).long()]
    obj_b = fol.face_obj[ib.clamp(min=0).long()]
    mask_off = int((hi_ != hb_).sum())
    t_off = int((both & ~t_ok).sum())
    obj_off = int((both & t_ok & (obj_i != obj_b)).sum())
    n_rays = int(hi_.numel())
    say(f"[17] instanced vs baked v9 on the 1080p primaries: {int(both.sum())} both hit, hit masks differ on "
        f"{mask_off}, |dt| > max(1e-3, 1e-4 t) on {t_off}, objects differ within the t bound on {obj_off} "
        f"of {n_rays} rays")
    require(max(mask_off, t_off, obj_off) <= 1e-3 * n_rays,
            "[17] instanced and baked traces disagree on more than 0.1% of rays")

    # ---- 18. the instanced foliage frames ------------------------------------
    cfg18 = rt.RenderConfig(width=W, height=H, primary_rays=4, shadow_rays=3, denoise_iterations=4)
    frames18 = {}
    frames18["defaults"] = alpha_frame(
        "foliage_field instanced, rt.render(scene, cfg), default device and backend, reference "
        "defaults (alpha_test None: off)", "instanced", lambda: rt.render(fol_scene, cfg18), 1,
        again=lambda: render_pipeline_gpu(fol_i, ffr, cfg18), phase="18")
    frames18["alpha"] = alpha_frame(
        "foliage_field instanced, render_pipeline_gpu, alpha_test=True, default backend",
        "instanced alpha", lambda: render_pipeline_gpu(fol_i, ffr, cfg_f), 3, phase="18")
    share18 = image_rule(frames18["alpha"][0], frames14["foliage hybrid"][0],
                         "[18] instanced vs baked alpha-tested foliage frame")
    say(f"[18] instanced and baked (hybrid) alpha-tested frames differ by > 2e-3 in {share18:.6%} of "
        f"values, max |err| {np.abs(frames18['alpha'][0] - frames14['foliage hybrid'][0]).max()}; frame "
        f"{frames18['alpha'][2]:.2f} ms instanced, {frames14['foliage hybrid'][2]:.2f} ms baked ({card})")

    # ---- 19. small instanced alpha frame, kernels vs plain twins -------------
    img_k = render_pipeline_gpu(fol_i, frame15, cfg15).cpu().numpy()
    with torch.inference_mode():
        plain = wrap_backend_with_alpha(
            v8.make_hier_backend(fol_i, cfg15, trace=v8.trace_blocks_hier_plain), fol_i, cfg15)
        comp = render_components(fol_i, frame15, cfg15, 0, backend=plain)
        s_, u_ = comp.shadowed, comp.unshadowed
        for i in range(cfg15.denoise_iterations):
            s_, u_ = atrous_pair_iteration_plain(s_, u_, comp.normal, comp.position, i + 1, *phis6)
        img_p = ratio_combine(comp.analytic, s_, u_).cpu().numpy()
    share = image_rule(img_k, img_p, "[19] 160x90 instanced alpha frame, kernels vs plain")
    say(f"[19] 160x90 instanced alpha-tested foliage frame kernels vs plain: {share:.6%} of values "
        f"differ by > 2e-3, max |err| {np.abs(img_k - img_p).max()}")

    # ---- 20. apply_instance_transforms on the card ----------------------------
    shift = np.array([0.35, 0.0, -0.25], np.float32)
    moved_scene = dataclasses.replace(fol_scene, instances=[
        dataclasses.replace(inst, transform=np.asarray(inst.transform, np.float32)
                            + np.pad(shift[:, None], ((0, 1), (3, 0))))
        for inst in fol_scene.instances])
    rows = ([np.eye(4, dtype=np.float32)] * len(fol_scene.area_lights)
            + [np.asarray(m.transform, np.float32) for m in fol_scene.meshes]
            + [np.asarray(i.transform, np.float32) @ np.asarray(i.mesh.transform, np.float32)
               for i in moved_scene.instances])
    table = torch.from_numpy(np.stack(rows)).to(dev)
    refit_ms, moved = cuda_ms(lambda: apply_instance_transforms(fol_i, table), 5)
    fresh = moved_scene.compile().to(dev)
    require(bool(torch.equal(fresh.pair_tab, moved.pair_tab)), "[20] pair tables differ")
    torch.testing.assert_close(moved.inst_fwd, fresh.inst_fwd, rtol=0, atol=0)
    torch.testing.assert_close(moved.inst_inv, fresh.inst_inv, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(moved.pair_panel, fresh.pair_panel, rtol=1e-5, atol=1e-4)
    margs, fargs = v8._inst_args(moved), v8._inst_args(fresh)
    km = v8.trace_hier_inst_kernel(sprim, *margs, "closest")
    kf = v8.trace_hier_inst_kernel(sprim, *fargs, "closest")
    hm, hf = km[1][:, 0] >= 0, kf[1][:, 0] >= 0
    both = hm & hf
    t_off = int((both & ((km[0][:, 0] - kf[0][:, 0]).abs() > torch.clamp(kf[0][:, 0] * 1e-4, min=1e-3))).sum())
    inst_off = int((both & (km[0][:, 0] == kf[0][:, 0]) & (km[1][:, 2] != kf[1][:, 2])).sum())
    mask_off = int((hm != hf).sum())
    moved_px = int((km[0][:, 0] != k320[0][:, 0]).sum())
    say(f"[20] apply_instance_transforms ({table.shape[0]} rows): {refit_ms:.3f} ms ({card}); traced "
        f"against a fresh compile at the moved transforms on 320x180 primaries: hit masks differ on "
        f"{mask_off}, |dt| > max(1e-3, 1e-4 t) on {t_off}, instances differ at equal t on {inst_off} of "
        f"{int(hm.numel())} rays; the move changed t on {moved_px} rays")
    require(max(mask_off, t_off) <= 1e-3 * hm.numel() and inst_off == 0,
            "[20] the moved scene and the fresh compile disagree")
    require(moved_px > 0, "[20] the move changed no hit")

    shadow_row = v8_rows["occluded shadow segments"]
    say(json.dumps({"kernels": [
        {"name": "trace_v7", "route": "cuda", "source": "realtimeraytracer_torch/csrc/trace_v7.cu",
         "replaces": "realtimeraytracer_tpu/render/pallas_backend.py:640",
         "launches": n_trace, "max_abs_err": v7_err, "ms": v7_ms, "plain_ms": v7_plain_ms,
         "bound_ms": v7_bound[0], "bound_by": v7_bound[1], "library_ms": None},
        {"name": "trace_v9", "route": "cuda", "source": "realtimeraytracer_torch/csrc/trace_v9.cu",
         "replaces": "realtimeraytracer_tpu/render/quarter_backend.py:316",
         "launches": counts9["trace_v9"], "max_abs_err": v9_err, "ms": v9_ms, "plain_ms": v9_plain_ms,
         "bound_ms": v9_bound[0], "bound_by": v9_bound[1], "library_ms": None},
        {"name": "trace_v8", "route": "cuda", "source": "realtimeraytracer_torch/csrc/trace_v8.cu",
         "replaces": "realtimeraytracer_tpu/render/hier_backend.py:587",
         "launches": counts9["trace_v8"], "max_abs_err": v8_err, "ms": shadow_row[0],
         "plain_ms": shadow_row[1], "bound_ms": shadow_row[3][0], "bound_by": shadow_row[3][1],
         "library_ms": None},
        {"name": "atrous_pair", "route": "cuda", "source": "realtimeraytracer_torch/csrc/atrous_pair.cu",
         "replaces": "realtimeraytracer_tpu/ops/denoise_pallas.py:152",
         "launches": counts9["atrous_pair"], "max_abs_err": dn_err, "ms": dn_ms, "plain_ms": dn_plain_ms,
         "bound_ms": dn_bound[0], "bound_by": dn_bound[1], "library_ms": None},
        {"name": "trace_v7_masked", "route": "cuda", "source": "realtimeraytracer_torch/csrc/trace_v7.cu",
         "replaces": "realtimeraytracer_tpu/render/pallas_backend.py:640",
         "launches": frames14["foliage pallas"][1]["trace_v7_masked"], "max_abs_err": v7m_err,
         "ms": v7m_ms, "plain_ms": v7m_plain_ms, "bound_ms": v7m_bound[0], "bound_by": v7m_bound[1],
         "library_ms": None},
        {"name": "trace_v9_masked", "route": "cuda", "source": "realtimeraytracer_torch/csrc/trace_v9.cu",
         "replaces": "realtimeraytracer_tpu/render/quarter_backend.py:316",
         "launches": frames14["foliage hybrid"][1]["trace_v9_masked"], "max_abs_err": v9m_err,
         "ms": v9m_ms, "plain_ms": v9m_plain_ms, "bound_ms": v9m_bound[0], "bound_by": v9m_bound[1],
         "library_ms": None},
        {"name": "trace_v8_masked", "route": "cuda", "source": "realtimeraytracer_torch/csrc/trace_v8.cu",
         "replaces": "realtimeraytracer_tpu/render/hier_backend.py:587",
         "launches": frames14["foliage hybrid"][1]["trace_v8_masked"], "max_abs_err": v8m_err,
         "ms": v8m_ms, "plain_ms": v8m_plain_ms, "bound_ms": v8m_bound[0], "bound_by": v8m_bound[1],
         "library_ms": None},
        {"name": "trace_v8_inst", "route": "cuda", "source": "realtimeraytracer_torch/csrc/trace_v8.cu",
         "replaces": "realtimeraytracer_tpu/render/hier_backend.py:387",
         "launches": frames18["defaults"][1]["trace_v8_inst"], "max_abs_err": vi_err,
         "ms": inst_rows[False][0], "plain_ms": inst_rows[False][1], "bound_ms": inst_rows[False][3][0],
         "bound_by": inst_rows[False][3][1], "library_ms": None},
        {"name": "trace_v8_inst_masked", "route": "cuda", "source": "realtimeraytracer_torch/csrc/trace_v8.cu",
         "replaces": "realtimeraytracer_tpu/render/hier_backend.py:387",
         "launches": frames18["alpha"][1]["trace_v8_inst_masked"], "max_abs_err": vim_err,
         "ms": inst_rows[True][0], "plain_ms": inst_rows[True][1], "bound_ms": inst_rows[True][3][0],
         "bound_by": inst_rows[True][3][1], "library_ms": None},
    ]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
