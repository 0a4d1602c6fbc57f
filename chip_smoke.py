#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (realtimeraytracer_torch) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on failure:
  1. environment: card name and power limit, torch and CUDA versions;
  2. build: compile every CUDA kernel from csrc/ with nvcc;
  3. the v7 traversal kernel against its plain PyTorch twin on the
     100k-triangle scene: closest primaries (common origin), shadow segments
     and sun segments (common direction);
  4. the A-Trous pair kernel against its plain twin at 1920x1080, 4 steps,
     and single iterations at steps 5, 6 and 8;
  5. the reference-default frame (1920x1080, 4 primary x 3 shadow rays,
     4 denoise iterations) through realtimeraytracer_torch.render, with the
     kernels' launch counts, the frame time and each kernel's time beside
     its plain twin's at the frame's shapes;
  6. a 320x180 frame rendered through the kernels and through the plain
     twins, compared.
The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.  Without a CUDA device, or without
the package beside it, the script fails before printing either.
"""

from __future__ import annotations

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
    from realtimeraytracer_torch.render import v7_backend as v7
    from realtimeraytracer_torch.render.megakernel import render_components
    from realtimeraytracer_torch.render.pipeline import render_pipeline_gpu

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
    t0 = time.perf_counter()
    scene = scenes.procedural_mesh(100_000, sun=True)
    gpu = scene.compile().to(dev)
    say(f"[3] procedural_mesh(100_000): {gpu.num_tris} tris, "
        f"{gpu.pallas_panels.shape[0]} coefficient blocks, {gpu.num_light_tris} light tris, "
        f"compiled in {time.perf_counter() - t0:.2f} s")
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
    say(f"[4] denoise 4 iterations, both images: kernel {dn_ms:.3f} ms, plain {dn_plain_ms:.3f} ms "
        f"({card})")

    # ---- 5. the frame ---------------------------------------------------
    cfg = rt.RenderConfig(width=W, height=H, primary_rays=4, shadow_rays=3,
                          denoise_iterations=4, backend="pallas")
    v7.trace_blocks.launches = 0
    atrous_denoise_pair.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img_t = rt.render(scene, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_trace, n_dn = v7.trace_blocks.launches, atrous_denoise_pair.launches
    img = img_t.cpu().numpy()
    say(f"[5] render(scene, cfg, device='cuda'): {wall:.2f} s wall with compile; "
        f"v7 launches {n_trace}, A-Trous launches {n_dn}")
    expect = cfg.primary_rays * (1 + gpu.num_light_tris * cfg.shadow_rays + 1)
    require(n_trace == expect, f"expected {expect} v7 launches, counted {n_trace}")
    require(n_dn == cfg.denoise_iterations, f"expected 4 A-Trous launches, counted {n_dn}")
    require(img.shape == (H, W, 3), f"image shape {img.shape}")
    require(bool(np.isfinite(img).all()), "frame has non-finite values")
    require(float(img.std()) > 1e-3, "frame is constant")
    say(f"[5] image mean {img.mean():.6f} std {img.std():.6f} min {img.min():.6f} max {img.max():.6f}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

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
    say(f"[5] v7 closest, 1080p primaries ({prim.shape[0]} tiles): cull {cull_ms:.3f} ms, "
        f"kernel {v7_ms:.3f} ms, plain {v7_plain_ms:.3f} ms ({card})")
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

    say(json.dumps({"kernels": [
        {"name": "trace_v7", "route": "cuda", "source": "realtimeraytracer_torch/csrc/trace_v7.cu",
         "replaces": "realtimeraytracer_tpu/render/pallas_backend.py:640",
         "launches": n_trace, "max_abs_err": v7_err, "ms": v7_ms, "plain_ms": v7_plain_ms},
        {"name": "atrous_pair", "route": "cuda", "source": "realtimeraytracer_torch/csrc/atrous_pair.cu",
         "replaces": "realtimeraytracer_tpu/ops/denoise_pallas.py:152",
         "launches": n_dn, "max_abs_err": dn_err, "ms": dn_ms, "plain_ms": dn_plain_ms},
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
