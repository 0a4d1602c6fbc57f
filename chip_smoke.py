#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (realtimeraytracer_torch) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on failure:
  1. environment: card name and power limit, torch and CUDA versions;
  2. build: compile every CUDA kernel from csrc/ with nvcc, one nvcc per
     source, all started together, and beside them the native host library
     (native/*.cpp with $CXX or g++ and native/Makefile's flags), which
     builds the BVH of every scene compiled from phase 3 on (binned SAH),
     and the image decoder library that phase 38 reads textures with;
  3. the v7 traversal kernel, which runs its cull in-kernel, against its
     twin (the plain-torch cull, then the plain trace) on the 100k-triangle
     scene: closest primaries (common origin), shadow segments and sun
     segments (common direction), every output row against the plain
     cull's ordered visit loop;
  4. the A-Trous pair kernel against its plain twin at 1920x1080, 4 steps,
     and single iterations at steps 5 to 8; its time beside its bound and
     the issue-rate floor of its SASS instructions per tap; how far an IEEE
     quotient by a phi lies from the product with its reciprocal;
  5. the reference-default frame (1920x1080, 4 primary x 3 shadow rays,
     4 denoise iterations) through the "pallas" route (v7, no plain-torch
     cull), with the kernels' launch counts, the frame time and v7's time
     beside the plain cull's and its twin's at the frame's shapes
     (primaries, shadow segments, sun), every row against the ordered loop;
  6. a 320x180 "pallas" frame rendered through the kernels and through the
     plain twins, compared;
  7. the v9 kernel, which runs its quarter cull in-kernel, against its
     twin (the plain-torch cull, then the plain trace) on 320x180 and
     1080p primaries, every output row against the plain cull's ordered
     visit loop, its time beside the plain cull's;
  8. the v8 kernel against its twin at 1080p: occluded shadow and sun
     segments, closest on incoherent (bounce) rays, and hinted traces fed
     no hints, their own hints and garbage hints; tiles whose own hints
     retire every ray (no super popped); procedural_mesh(1_000_000), above
     32 supers, against the twin at 320x180 and timed at 1080p, with v7
     closest on its primaries (keys on 8 pages; against the twin and the
     ordered loop at 320x180, timed at 1080p) and its 1080p hybrid frame
     (v7 coherent closest, no plain-torch cull): time and peak memory;
  9. the reference-default frame through rt.render(scene, cfg) with no
     device argument and the default backend ("auto", the hybrid route: v9
     primaries, v8 occlusion with hints), its launch counts (and no
     plain-torch quarter cull: v9 culls in-kernel), frame time and peak
     memory;
 10. a 320x180 hybrid frame through the kernels and through the twins;
 11. the textured, alpha-tested scenes: scenes.foliage_field() compiled
     with bake_instances=True (about 120k triangles) and
     scenes.textured_obj() (through the OBJ, MTL, PNG and HDR loaders);
 12. each masked kernel (in-kernel alpha masks) against its masked twin on
     the baked foliage at 1080p: v9 and v7 (as in 7 and 3) on the
     primaries, v8 closest on area-light shadow segments;
 13. the alpha closest ladder on the foliage's 1080p primaries with and
     without in-kernel masks: rounds, rays per round, time; hits agree but
     for rays that exhaust the unmasked ladder (the masked hit lies at
     least as far), rays whose unmasked ladder stepped past an opaque
     hit just behind a transparent one (the masked hit is that nearer
     opaque hit), and rays whose masked ladder stepped past the unmasked
     ladder's opaque hit together with a transparent triangle of its t
     bucket (shown by testing every triangle against the ray);
 14. the reference-default alpha-tested frames: textured_obj through
     rt.render(scene, cfg) with no device and the default backend, the
     baked foliage through render_pipeline_gpu with alpha_test=True, each
     also through the "pallas" route (no plain-torch cull): launches per
     kernel, host syncs, frame time, peak memory, the two routes' images
     compared;
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
     against a fresh instanced compile at the moved transforms;
 21. the multi-segment occlusion kernel (hier_occluded_multi) on the area
     segments the frame traces toward light triangle 0: against its twin
     for S = 1, 2, 3 and 8 (320x180) and S = 8 (1080p), against three
     single v8 launches (1080p, S = 3; also hint-chained, on directions
     that straddle zero, and with every ray of every fifth tile inactive:
     those tiles visit and pop nothing), the counting variant's results
     equal to the timed one's (S = 3 and 8), its time beside the three
     single traces', visits, work counts and bound; registers, spills and
     shared memory of each S instantiation;
 22. the reference-default 1080p frame through the fused shadow query
     (v8's hier_occluded_multi wired into the default backend): launches,
     bit-equality with the default frame, both frame times, peak memory;
     a 160x90 fused frame through the kernels and through the twins;
 23. the f32 FMA peak probe (probes.fma_peak) against its twin, its rate
     beside the data sheet's 67 TFLOP/s, the FFMA count of its SASS;
 24. BASELINE config 4 through render_wavefront (1920x1080, 4 spp,
     max_bounces=2, one light sample and the sun per vertex, no denoise,
     default backend) on procedural_mesh(100_000, sun=True): launches (v9 4,
     v8 8 closest and 16 unhinted occluded, A-Trous 0), frame time, peak
     memory, live rays at each bounce, kernel time of each stage (the sorts
     among them) in one profiled frame; the unsorted frame's time and its
     image bit-equal to the sorted one; one 1-spp frame on
     procedural_mesh(1_000_000, sun=True), whose bounce 0 goes to v7;
 25. 160x90 wavefront frames (2 spp, 2 bounces) through the kernels and
     through the twins, on the hybrid and the "pallas" route;
 26. the baked foliage through render_wavefront (1080p, 1 spp, 2 bounces,
     alpha_test=True): launches (masked v9 and v8 only), host syncs, one
     timed run after the first; a 160x90 frame through the kernels and the
     twins;
 27. Application() with its defaults (1920x1080, cornell_box, fast_lut) on
     the card: run(8) with a scripted controller (moves, mouse, spin), frames
     per second, images on the card and all different, the camera moved,
     the first frame equal to render_pipeline_gpu's at frame index 0; the
     phase-9 frame with debug_traversal=True bit-equal to phase 9's image;
 28. textured_obj and the baked foliage compiled with mips: host seconds and
     device bytes of the mip leaves, the 1080p alpha-tested frames with
     mip_textures=True at aniso_taps 1 and 4 (launches, frame time, peak
     memory, beside phase 14's base-level frames), the difference from the
     base-level image;
 29. the A-Trous pair's backward (B5b, csrc/atrous_pair_vjp.cu) against its
     twin (autograd of the plain iteration) at 320x180 and 1920x1080:
     steps 1 to 12 with and without the normal and position gradients, and
     the four iterations under autograd; B5's weight-sum output (which B5b
     reads) against the twin's, its images unchanged; registers and
     spills, B5b's time for the frame's four iterations beside the bound
     of its work and of the two-pass design's (a weight-sum pass, then a
     gather), the twin's time and peak memory, B5's time without and with
     its W output;
 30. gradients through the kernels against the twins: radiance_loss on
     procedural_mesh(100_000, sun=True) at 320x180, shadow_rays=3, for
     obj_color, lt_intensity, sun_intensity, env_color and vertices, and on
     sphere_plane (compiled with a BVH) for sph_center and sph_radius: the
     losses bit-equal, the gradients within rtol 1e-4; launches;
 31. BASELINE config 5 on one card: fit(loss="radiance") on
     procedural_mesh(100_000, sun=True) at 1920x1080 (raster-order
     primaries, shadow_rays=3, obj_color and lt_intensity from a perturbed
     start), 5 steps with a falling loss and their launches; the step's
     median time, peak memory, launches and host syncs per step; a
     checkpoint saved at step 3 and restored, whose next step equals the
     uninterrupted one;
 32. one pipeline_loss gradient at the reference defaults (obj_color,
     vertices: launches, forward and backward time of a first and a second
     run, peak memory), one
     wavefront_loss gradient (1 spp, 2 bounces), and a 160x90
     pipeline_loss gradient through the kernels against the twins;
 33. ray sharding (parallel/) on a one-rank NCCL process group (127.0.0.1,
     a free port; no other backend): render_pipeline_sharded at the
     reference defaults, bit-equal to phase 9's frame with its launches,
     timed in turns with render_pipeline_gpu; wavefront_sample_sharded at
     config 4's shapes gathered over the mesh, bit-equal to trace_paths;
     atrous_pair_slab on four 1080p row slabs with 8-row halos, bit-equal
     to phase 4's four iterations; config 5's step through
     make_train_step(cfg, mesh, optimizer), loss and params bit-equal to
     the group-less step's under deterministic algorithms, its all-reduce
     logged, timed beside phase 31's step; then the group is destroyed;
 34. the native host library and the thin slice: the compiles since phase
     3 went through the native SAH builder; host compile seconds with it
     and with the NumPy LBVH (procedural_mesh 100k and 1M, the baked
     foliage, textured_obj) and textured_obj's OBJ parse through each
     tokenizer; camera ray blocks (generate_ray_blocks) on the card against
     the CPU's (directions within 2e-7); the thin slice (blocks, then
     trace_primary_blocks: v9 at 100k, v7 at the 1M rung) on each block
     order against the twins at 320x180 (every row) and timed at 1080p
     (median of 10), with rays/s, subclusters or blocks visited, pairs
     tested and the bound, the two orders' hits the same triangle or the
     same t; the reference-default hybrid frame on each order (frame rule,
     in turns); `demo render mesh100k`, its launches and PNG;
 35. alpha_split on the baked foliage and textured_obj at 1080p (hybrid):
     the frame's first light-0 shadow segments through the split and the
     classic ladder, flags equal on every segment the classic ladder
     resolved within its rounds, and each other difference held to its
     evidence (the classic ladder out of rounds, or a transparent and an
     occluding triangle in one t bucket; counts printed); the split
     through the kernels bit-equal to the split on the twins (320x180
     segments of the central 320x180 pixels); the reference-default frame
     with the split against phase 14's without it (frame rule): frame ms
     (the two in turns, median of 3 after a warm-up each), host syncs,
     ladder rounds, launches per kernel, kernel ms inside alpha.round (one
     profiled frame each), peak memory;
 36. batch_occlusion on procedural_mesh(100_000, sun=True) and the baked
     foliage at 1080p (hybrid): render_components with one occluded call
     per primary sample for all area segments bit-equal to the separate
     traces in analytic, shadowed and unshadowed, and the frames bit-equal
     to phase 9's and 14's; frame ms in turns with the separate traces
     (on the opaque frame the hint-chained ones: the area-light hints it
     gives up), launches, host syncs, peak memory;
 37. the card's name and power limit again, then the wide backend (plain
     torch, no kernel) and BASELINE config 3: the golden's 10k-triangle OBJ
     written from this script's own copy of its lines, loaded and compiled
     by the port (40 clusters); on it and on procedural_mesh(100_000,
     sun=True) the wide closest and occluded traces of the 1080p
     primaries and the frame's first area-light segments against the
     hybrid route's (hits, ids or t, flags; rays decided apart only where
     a triangle is borderline in float64), uncapped and, on the 100k scene,
     at the default cap of 64 (tiles that differ from the uncapped traces
     at most the clipped ones): cap_clipped, steps, host reads, time, peak
     memory; a starved cap (max_cluster_visits=1) detected, with the debug
     wrapper's warning; the lane traversal at 320x180 on the 100k scene
     against the hybrid route, with its steps; config 3's frames (the
     default route at the reference defaults; the wide and hybrid routes
     at the golden's sampling, under the frame rule against each other):
     launches, host syncs, times, peak memory; the reference-default
     frame with use_pallas_denoise=False against phase 9's (frame rule).
 38. the card's name and power limit again, then the host image decoders
     (utils/image_decode.py, the native library of
     realtimeraytracer_torch/native/image_decode.cpp built with the host's
     C++ compiler): every fixture of tests/data/images decoded through
     load_texture_file, both grayscale values, its digest equal to
     expected.json (the JAX package's output); textured_obj's OBJ with
     its ground and leaf maps replaced by the JPEG and TGA fixtures, and
     again by PNGs of the same decoded pixels, then by the GIF, PSD, PGM
     and RLE8 BMP fixtures, the TIFF fixtures, the WebP fixtures, and the
     arithmetic-coded, lossless, incomplete progressive and corrupt JPEG
     fixtures, each with their PNG twins: each pair of 1080p frames at the
     reference defaults through rt.render hash-equal, with their masked
     v9/v8 and B5 launches only; the C1 frame, the leaf opacity map a PGM
     of 0/1 texels (0 and 1/255, as stbi_load reads them), hash-equal to
     the frame with an all-zero map; host decode times, median of 3: the
     1024^2 JPEG, a 2048^2 RGBA Paeth PNG through the native path, a 256^2
     crop of it through the native path, a 128^2 crop (one run) through
     png.decode_png (about a minute a decode on the whole image, so the
     crop), a 1024^2 GIF, 16-bit PGM, PackBits PSD, RLE8 and 5-6-5 BMP,
     16-bit RLE TGA, LZW, Deflate and JPEG TIFF, CMYK and YCCK JPEG and
     lossless JPEG, written on the host by the tests' encoders
     (tests/_torch_image_helpers.py), and the 1024^2 WebP and
     arithmetic-coded JPEG fixtures.
Each main-path run (5, 8, 9, 14, 18, 22, 24, 26, 27, 28, 30, each step of
31 and 32, 33, 34, 35, 36, 37, 38) and the probe's timed run (23) are driven with every kernel's
launch count set to 0 just before and read just after.  The line before the last is a
JSON object describing each kernel (times, launches, error, bound); the
last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
without the package beside it, the script fails before printing either.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import re
import shutil
import socket
import statistics
import subprocess
import sys
import time
import tempfile
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

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


def median_ms(fn, reps: int):
    """(median milliseconds of `reps` calls of fn, each timed alone by CUDA
    events after one warm-up; the last result)."""
    import torch

    out = fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), out


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
# f32 operations per (tile, subcluster box) of the quarter cull that v9 runs
# in its prologue (csrc/trace_v9.cu sub_key): per axis four subtractions,
# eight multiplications, twelve min/max in the two interval products and
# two more for the axis interval (26); the near/far combine (4), three
# compares, max(entry, 0) and the finiteness test.
CULL_OPS = 87
# The multi-segment v8 kernel (csrc/trace_v8.cu, MULTI): per sample test the
# pair ops less the origin dots (47 - 18), per origin-family evaluation the
# three origin dots, per hull slab test per axis two subtractions, four
# multiplications and six min/max, then the near/far combine (4), four
# compares and max(near, 0).
MULTI_TEST_OPS = 29
FAMILY_OPS = 18
HULL_SLAB_OPS = 45


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(ops: float, moved: float) -> tuple[float, str]:
    """(bound_ms, bound_by) for a call's operations and bytes."""
    t_ops, t_bytes = ops / PEAK_OPS * 1e3, moved / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def trace_bound(outi, common, moved: int, extra_ops: float = 0.0) -> tuple[tuple[float, str], int]:
    """A traversal call's (bound, pairs).  Operations: the ray-triangle
    pairs its rays tested (outi row 5: live rays only, up to the first hit
    in occluded mode) x the pair ops, plus v8's slab tests (outi row 6,
    zero in v7 and v9) x SLAB_OPS, plus the instanced v8's mesh-space
    transforms (outi row 7, zero elsewhere) x TRANSFORM_OPS, plus
    `extra_ops` (the fused v9's in-kernel cull).  The tile-shared dot
    products of a common origin or direction (under 1%
    more) are left out."""
    visits = int(outi[:, 1, 0].sum().item())
    pairs = int(outi[:, 5].sum().item())
    slabs = int(outi[:, 6].sum().item())
    transforms = int(outi[:, 7].sum().item())
    require(0 < pairs <= visits * 128 * 128,
            f"pair count {pairs} outside (0, {visits} visits x 128 x 128]")
    return bound(pairs * OPS_PER_PAIR[common] + slabs * SLAB_OPS + transforms * TRANSFORM_OPS
                 + extra_ops, moved), pairs


def atrous_taps(h: int, w: int, iterations: int) -> int:
    """In-bounds taps of `iterations` A-Trous iterations (steps 1, 2, ...)."""
    taps = 0
    for step in range(1, iterations + 1):
        rows = sum(max(0, h - abs(k - 2) * step) for k in range(5))
        cols = sum(max(0, w - abs(k - 2) * step) for k in range(5))
        taps += rows * cols
    return taps


def atrous_bound(h: int, w: int, iterations: int) -> tuple[float, str]:
    """4 images read (48 B/px) and 2 written (24 B/px) per iteration; per
    in-bounds tap 67 f32 operations (four squared distances 32, four
    weights 17 with exp and division counted as one each, weight products
    4, accumulation 14), per pixel 8 in the normalization."""
    return bound(atrous_taps(h, w, iterations) * 67 + iterations * h * w * 8,
                 iterations * h * w * 72)


def ptxas_usage(log: str) -> dict:
    """Each entry function of an `nvcc -Xptxas -v` report: mangled name ->
    {"registers", "spill" (bytes stored plus loaded), "smem" (static
    bytes)}."""
    usage: dict = {}
    cur = None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            cur = usage.setdefault(m.group(1), {"registers": 0, "spill": 0, "smem": 0})
        elif cur is not None and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            cur["spill"] = int(m.group(1)) + int(m.group(2))
        elif cur is not None and (m := re.search(r"Used (\d+) registers", line)):
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return usage


def same_rows(k, o, what: str) -> None:
    """Every output row of a fused kernel (its cull in-kernel) equals the
    plain cull's ordered visit loop: t or flags, ids, visits (row 1) and
    pairs (row 5)."""
    import torch

    for r_ in range(8):
        require(torch.equal(k[0][:, r_], o[0][:, r_]), f"{what}: outf row {r_} differs from the "
                "plain cull's ordered loop")
        require(torch.equal(k[1][:, r_], o[1][:, r_]), f"{what}: outi row {r_} differs from the "
                "plain cull's ordered loop")
    say(f"  {what}: every row equals the plain cull's ordered loop ({int(k[1][:, 1, 0].sum())} "
        f"visits, {int(k[1][:, 5].sum())} pairs)")


@contextlib.contextmanager
def no_plain_cull(module, name: str, what: str):
    """Counts the calls of module.name (a plain-torch cull) while the body
    runs and fails if there was one: on the card the fused kernels cull in
    their prologue."""
    calls = []
    cull = getattr(module, name)
    setattr(module, name, lambda *a, **k: calls.append(1) or cull(*a, **k))
    try:
        yield
    finally:
        setattr(module, name, cull)
    require(not calls, f"{what} ran the plain-torch cull {name} {len(calls)} times")


@contextlib.contextmanager
def bvh_builder(native_module, builder: str, calls: list):
    """The scene compiles in the body build their BVHs natively ("sah",
    the default path; each call's success is appended to `calls`) or with
    the NumPy LBVH ("numpy": native_build_bvh answers None, as on a machine
    without a C++ compiler)."""
    real = native_module.native_build_bvh

    def counted(*a, **k):
        out = real(*a, **k) if builder == "sah" else None
        calls.append(out is not None)
        return out

    native_module.native_build_bvh = counted
    try:
        yield
    finally:
        native_module.native_build_bvh = real


def write_config3_obj(path: Path, num_tris: int = 10_000, seed: int = 3) -> None:
    """BASELINE config 3's procedural OBJ, the JAX golden's own lines
    (tests/test_golden.py:91-104): num_tris random triangles around
    num_tris // 64 blob centres, from the seed."""
    rng = np.random.default_rng(seed)
    n_blobs = max(1, num_tris // 64)
    centers = rng.uniform([-6, 0.3, -6], [6, 2.5, 6], (n_blobs, 3))
    base = centers[rng.integers(0, n_blobs, num_tris)]
    scale = rng.uniform(0.05, 0.3, (num_tris, 1, 1))
    tris = base[:, None, :] + rng.normal(0, 1, (num_tris, 3, 3)) * scale
    verts = tris.reshape(-1, 3)
    lines = ["o rocks"]
    lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]
    lines += [f"f {3*i+1} {3*i+2} {3*i+3}" for i in range(num_tris)]
    path.write_text("\n".join(lines) + "\n")


def config3_scene():
    """BASELINE config 3's scene (tests/test_golden.py:107-129): the OBJ
    through the port's loader, its camera and area light."""
    from realtimeraytracer_torch.scene.camera import Camera
    from realtimeraytracer_torch.scene.lights import AreaLight
    from realtimeraytracer_torch.scene.materials import Material
    from realtimeraytracer_torch.scene.obj_loader import load_obj
    from realtimeraytracer_torch.scene.scene import Scene

    with tempfile.TemporaryDirectory(prefix="rtrt_config3_") as tmp:
        path = Path(tmp) / "rocks.obj"
        write_config3_obj(path)
        mesh = load_obj(str(path), material=Material(color=(0.55, 0.5, 0.45), specular=0.3,
                                                     metallic=0.05))
    require(mesh.faces.shape[0] == 10_000, f"[37] the config-3 OBJ loaded {mesh.faces.shape[0]} faces")
    scene = Scene(camera=Camera(position=(0.0, 3.5, 12.0), look_at=(0.0, 1.0, 0.0),
                                fov_y_degrees=55.0))
    scene.add(mesh)
    light = AreaLight(color=(1.0, 0.95, 0.9), intensity=6.0)
    light.rotate("x", 90.0).scale(4.0).move(0.0, 7.0, 0.0)
    scene.add(light)
    return scene


def borderline(g_, o_, d_, lo_, hi_, rays, eps: float = 1e-4) -> list:
    """For each ray index in `rays`: whether a triangle that the ray meets
    within eps in float64 (barycentrics >= -eps, t in [lo, hi] with eps
    relative slack) decides it by a margin under eps (a barycentric within
    eps of an edge, t within eps relative of an end of [lo, hi]) or meets
    it at grazing incidence (|cos| under 2^-10, where float32's t is good
    to ~1e-4 relative): a ray that two intersection formulas may decide
    apart, or give t apart."""
    import torch

    v0, v1, v2 = (x.double() for x in (g_.bvh_tri_v0, g_.bvh_tri_v1, g_.bvh_tri_v2))
    e1, e2 = v1 - v0, v2 - v0
    nrm = torch.linalg.cross(e1, e2)
    nrm = nrm / nrm.norm(dim=-1, keepdim=True).clamp_min(1e-300)
    out = []
    for i in rays.tolist():
        o, d = o_[i].double(), d_[i].double()
        lo, hi = float(lo_[i]), float(hi_[i])
        p = torch.linalg.cross(d.expand_as(e2), e2)
        det = (e1 * p).sum(-1)
        ok = det.abs() > 1e-30
        inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
        s = o - v0
        u = (s * p).sum(-1) * inv
        q = torch.linalg.cross(s, e1)
        v = (d * q).sum(-1) * inv
        t = (e2 * q).sum(-1) * inv
        w = 1.0 - u - v
        tt = t.abs().clamp_min(1e-6)
        bary = torch.stack([u, v, w]).amin(0)
        slack = ok & (bary > -eps) & (t > lo - eps * tt) & (t < hi + eps * tt)
        near = ((bary.abs() < eps) | ((t - lo).abs() < eps * tt) | ((t - hi).abs() < eps * tt)
                | ((nrm @ d).abs() < 2.0 ** -10))
        out.append(bool((slack & near).any()))
    return out


def area_segments(g_, fr_, cfg_):
    """The area-light segments that a frame traces first (light triangle 0,
    shadow ray 0, primary sample 0), captured from one primary sample's
    render with the hint chain off (hints change no ray): (origins, dirs,
    t_lo, t_hi), the intervals per ray."""
    from realtimeraytracer_torch.ops.intersect import as_per_ray
    from realtimeraytracer_torch.render.backends import make_backend
    from realtimeraytracer_torch.render.megakernel import render_components

    seen = []
    be_ = make_backend(g_, cfg_)

    def occluded(o_, d_, lo_, hi_, common=None):
        if common is None and not seen:
            seen.append((o_, d_, lo_, hi_))
        return be_.occluded(o_, d_, lo_, hi_, common=common)

    render_components(g_, fr_, cfg_.replace(primary_rays=1), 0,
                      backend=be_._replace(occluded=occluded, occluded_hinted=None))
    require(len(seen) == 1, "the frame traced no area-light segment")
    o_, d_, lo_, hi_ = seen[0]
    r_ = o_.shape[0]
    return o_, d_, as_per_ray(lo_, r_, o_.device), as_per_ray(hi_, r_, o_.device)


def wide_and_config3(*, rt, torch, dev, card: str, W: int, H: int, scene, gpu, frame, cfg9, img9,
                     times9, zero_counts, read_counts, unmasked) -> dict:
    """Phase 37: the wide backend's traces against the hybrid route's at
    1080p on BASELINE config 3's scene and on procedural_mesh(100_000,
    sun=True); a starved cap and the debug warning; the lane traversal at
    320x180; config 3's frames; the per-image denoiser's default frame."""
    from realtimeraytracer_torch.ops.camera_rays import generate_rays
    from realtimeraytracer_torch.render import wide_backend as wideb
    from realtimeraytracer_torch.render.attic import bvh_backend as laneb
    from realtimeraytracer_torch.render.backends import make_backend
    from realtimeraytracer_torch.render.diagnostics import diagnose_traversal
    from realtimeraytracer_torch.render.pipeline import compile_for, render_pipeline_gpu
    from realtimeraytracer_torch.utils import log as rtlog

    say(card)
    t37 = time.perf_counter()
    res = {}
    tq = 2.0 ** -15          # t: the kernels clear t's low 7 mantissa bits

    def compare_hits(g_, o_, d_, lo_, hi_, got, want, what):
        """Hit masks equal and t within 2^-15 relative (the kernels' t
        quantization), ids equal or t equal.  Beyond that: a ray hit on
        the same triangle with t further apart must stay within float32's
        forward error of the plane intersection, 64 u (|o - v0| + t) /
        |cos| (u = 2^-24, in float64 from the triangle); any other ray
        decided apart must have a borderline triangle (borderline()), at
        most 256 such rays.  Returns the counts."""
        gh, wh = got.prim_id >= 0, want.prim_id >= 0
        both = gh & wh
        close = (got.t - want.t).abs() <= tq * want.t.abs()
        same = got.prim_id == want.prim_id
        cond = torch.nonzero(both & same & ~close).flatten()
        apart = torch.nonzero((gh != wh) | (both & ~same & ~close)).flatten()
        require(apart.numel() <= 256 and cond.numel() <= 4096,
                f"[37] {what}: {apart.numel()} rays decided apart, {cond.numel()} t apart")
        ratio = 0.0
        if cond.numel():
            tri = g_.vertices[g_.faces[want.prim_id[cond].long()].long()].double()   # (n, 3, 3)
            n_ = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
            n_ = n_ / n_.norm(dim=-1, keepdim=True)
            dd, oo = d_[cond].double(), o_[cond].double()
            tw = want.t[cond].double()
            bound = (tq * tw + 64 * 2.0 ** -24 * ((oo - tri[:, 0]).norm(dim=-1) + tw)
                     / (n_ * dd).sum(-1).abs())
            ratio = float(((got.t[cond].double() - tw).abs() / bound).max())
            require(ratio <= 1.0, f"[37] {what}: t apart beyond float32's forward error "
                    f"({ratio:.3f} of the bound)")
        ev = borderline(g_, o_, d_, lo_, hi_, apart)
        require(all(ev), f"[37] {what}: rays {apart[[not e for e in ev]].tolist()[:8]} decided "
                "apart with no borderline triangle")
        return {"rays": int(gh.numel()), "hits": int(wh.sum()), "apart_borderline": int(apart.numel()),
                "t_apart_within_f32_error": int(cond.numel()), "worst_t_over_bound": ratio,
                "id_ties": int((both & close & ~same).sum())}

    def compare_flags(g_, o_, d_, lo_, hi_, got, want, what):
        apart = torch.nonzero(got != want).flatten()
        require(apart.numel() <= 256, f"[37] {what}: {apart.numel()} flags differ")
        ev = borderline(g_, o_, d_, lo_, hi_, apart)
        require(all(ev), f"[37] {what}: flags of rays {apart[[not e for e in ev]].tolist()[:8]} "
                "differ with no borderline triangle")
        return {"rays": int(got.numel()), "occluded": int(want.sum()),
                "apart_borderline": int(apart.numel())}

    def timed_trace(fn, counter, reps=2):
        """(result, stats, first-call ms, host reads of that call (counted
        on `counter`), peak GiB above what was held, median ms of reps
        calls after it, None for none) of a wide or lane trace fn()."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reads0 = counter.host_reads
        first_ms, (out, stats) = once_ms(fn)
        reads = counter.host_reads - reads0
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        ms = median_ms(fn, reps)[0] if reps else None
        return out, stats, first_ms, reads, peak, ms

    # ---- (a) the config-3 scene and the wide traces at 1080p ----
    t0 = time.perf_counter()
    scene3 = config3_scene()
    cfg3 = rt.RenderConfig(width=W, height=H, tonemap="lut", shadow_ray_margin=0.1)
    gpu3 = compile_for(scene3, cfg3, dev)
    frame3 = scene3.camera.viewport_frame(W, H, device=dev)
    clusters3 = -(-gpu3.num_tris // cfg3.cluster_size)
    say(f"[37] BASELINE config 3: the 10k-triangle OBJ written, loaded and compiled in "
        f"{time.perf_counter() - t0:.2f} s: {gpu3.num_tris} tris, {gpu3.num_light_tris} light tris, "
        f"{clusters3} clusters of {cfg3.cluster_size} (cap {cfg3.max_cluster_visits})")
    require(clusters3 == 40, f"[37] config 3 has {clusters3} clusters, not 40")
    for name, g_, fr_, cfg_ in (("config3", gpu3, frame3, cfg3), ("mesh100k", gpu, frame, cfg9)):
        o_, d_ = generate_rays(fr_, W, H, jitter=False)
        so_, sd_, slo_, shi_ = area_segments(g_, fr_, cfg_)
        r_ = o_.shape[0]
        lo_p = torch.full((r_,), cfg_.t_min, device=dev)
        hi_p = torch.full((r_,), cfg_.t_max, device=dev)
        hyb = make_backend(g_, cfg_)
        h_ms, h_hit = median_ms(lambda: hyb.closest(o_, d_, cfg_.t_min, cfg_.t_max, common="origin"), 3)
        ho_ms, h_occ = median_ms(lambda: hyb.occluded(so_, sd_, slo_, shi_), 3)
        clusters = -(-g_.num_tris // cfg_.cluster_size)
        rows = {"clusters": clusters, "hybrid_closest_ms": h_ms, "hybrid_occluded_ms": ho_ms,
                "segments": int(so_.shape[0])}
        exact = {}
        for cap in sorted({min(cfg_.max_cluster_visits, clusters), clusters}):
            c_ = cfg_.replace(backend="wide", max_cluster_visits=cap)
            wd = wideb.build_wide(g_, c_.cluster_size)
            hit, st, f_ms, reads, peak, ms = timed_trace(
                lambda: wideb.wide_closest(g_, c_, o_, d_, cfg_.t_min, cfg_.t_max,
                                           return_stats=True, wd=wd), wideb.wide_closest)
            occ, sto, fo_ms, oreads, opeak, oms = timed_trace(
                lambda: wideb.wide_occluded(g_, c_, so_, sd_, slo_, shi_, return_stats=True, wd=wd),
                wideb.wide_occluded)
            key = "exact" if cap == clusters else "capped"
            row = {"cap": cap,
                   "closest": {"cap_clipped": int(st["cap_clipped"]), "steps": st["steps"],
                               "host_reads": reads, "first_ms": f_ms, "ms": ms, "peak_gib": round(peak, 3)},
                   "occluded": {"cap_clipped": int(sto["cap_clipped"]), "steps": sto["steps"],
                                "host_reads": oreads, "first_ms": fo_ms, "ms": oms,
                                "peak_gib": round(opeak, 3)}}
            require(st["cap"] == cap and sto["cap"] == cap, f"[37] {name}: stats cap {st['cap']}")
            if key == "exact":
                require(int(st["cap_clipped"]) == 0 == int(sto["cap_clipped"]),
                        f"[37] {name}: the uncapped wide traces clipped")
                row["closest"]["vs_hybrid"] = compare_hits(g_, o_, d_, lo_p, hi_p, hit, h_hit,
                                                           f"{name} wide closest")
                row["occluded"]["vs_hybrid"] = compare_flags(g_, so_, sd_, slo_, shi_, occ, h_occ,
                                                             f"{name} wide occluded")
                exact = {"hit": hit, "occ": occ}
            rows[key] = row
            rows.setdefault("_runs", []).append((key, hit, occ, st, sto))
        for key, hit, occ, st, sto in rows.pop("_runs"):
            if key != "capped":
                continue
            # Tiles (128 consecutive rays) whose result differs from the
            # uncapped trace's can only be tiles that the cap clipped.
            tile = cfg_.wide_tile
            d_hit = ((hit.prim_id != exact["hit"].prim_id) | (hit.t != exact["hit"].t))
            d_occ = occ != exact["occ"]
            n_hit = int(torch.unique(torch.nonzero(d_hit).flatten() // tile).numel())
            n_occ = int(torch.unique(torch.nonzero(d_occ).flatten() // tile).numel())
            require(n_hit <= int(st["cap_clipped"]) and n_occ <= int(sto["cap_clipped"]),
                    f"[37] {name}: {n_hit} / {n_occ} tiles differ from the uncapped traces, "
                    f"{int(st['cap_clipped'])} / {int(sto['cap_clipped'])} clipped")
            rows["capped"]["closest"]["tiles_differing_from_uncapped"] = n_hit
            rows["capped"]["occluded"]["tiles_differing_from_uncapped"] = n_occ
        res[name] = rows
        say(f"[37] {name} wide traces at {W}x{H} (primaries, raster order; the frame's first "
            f"area-light segments): " + json.dumps(rows) + f" ({card})")
        del o_, d_, so_, sd_, slo_, shi_, h_hit, h_occ, exact, hyb

    # ---- (b) a starved cap, detected; the debug wrapper's warning ----
    o3, d3 = generate_rays(frame3, W, H, jitter=False)
    starved = cfg3.replace(backend="wide", max_cluster_visits=1)
    _, st = diagnose_traversal(gpu3, starved, o3, d3, cfg3.t_min, cfg3.t_max, kind="wide")
    require(int(st["cap_clipped"]) > 0 and st["steps"] == 1,
            f"[37] the starved cap was not detected: {st}")
    lines, sink = [], rtlog._sink
    rtlog.set_sink(lines.append)
    try:
        make_backend(gpu3, starved.replace(debug_traversal=True)).closest(o3, d3, cfg3.t_min, cfg3.t_max)
        healthy = make_backend(gpu3, cfg3.replace(backend="wide", debug_traversal=True))
        healthy.closest(o3, d3, cfg3.t_min, cfg3.t_max)
    finally:
        rtlog.set_sink(sink)
    warned = [m for m in lines if "traversal cap saturated" in m]
    require(len(warned) == 1, f"[37] debug_traversal warnings {lines}")
    res["starved"] = {"cap_clipped": int(st["cap_clipped"]), "tiles": -(-o3.shape[0] // cfg3.wide_tile)}
    say(f"[37] max_cluster_visits=1 on config 3's primaries: {int(st['cap_clipped'])} of "
        f"{res['starved']['tiles']} tiles clipped; the debug wrapper logged: {warned[0]}; the "
        f"healthy cap logged nothing")
    del o3, d3

    # ---- (c) the lane traversal at 320x180 on the 100k scene ----
    cfg_s = cfg9.replace(width=320, height=180)
    frame_s = scene.camera.viewport_frame(320, 180, device=dev)
    o_s, d_s = generate_rays(frame_s, 320, 180, jitter=False)
    so_s, sd_s, slo_s, shi_s = area_segments(gpu, frame_s, cfg_s)
    hyb = make_backend(gpu, cfg_s)
    hit_h = hyb.closest(o_s, d_s, cfg_s.t_min, cfg_s.t_max, common="origin")
    occ_h = hyb.occluded(so_s, sd_s, slo_s, shi_s)
    hit_l, st_l, fl_ms, lreads, lpeak, _ = timed_trace(
        lambda: laneb.traverse_closest(gpu, cfg_s, o_s, d_s, cfg_s.t_min, cfg_s.t_max,
                                       return_stats=True), laneb.traverse_closest, reps=0)
    occ_l, st_lo, flo_ms, loreads, lopeak, _ = timed_trace(
        lambda: laneb.traverse_occluded(gpu, cfg_s, so_s, sd_s, slo_s, shi_s, return_stats=True),
        laneb.traverse_occluded, reps=0)
    require(int(st_l["cap_clipped"]) == 0 == int(st_lo["cap_clipped"]), "[37] the lane traversal clipped")
    r_s = o_s.shape[0]
    res["lane"] = {
        "closest": {"steps": st_l["steps"], "cap": st_l["cap"], "host_reads": lreads, "ms": fl_ms,
                    "peak_gib": round(lpeak, 3),
                    "vs_hybrid": compare_hits(gpu, o_s, d_s, torch.full((r_s,), cfg_s.t_min, device=dev),
                                              torch.full((r_s,), cfg_s.t_max, device=dev), hit_l, hit_h,
                                              "lane closest")},
        "occluded": {"steps": st_lo["steps"], "host_reads": loreads, "ms": flo_ms,
                     "peak_gib": round(lopeak, 3),
                     "vs_hybrid": compare_flags(gpu, so_s, sd_s, slo_s, shi_s, occ_l, occ_h,
                                                "lane occluded")}}
    say(f"[37] lane traversal at 320x180 on procedural_mesh(100_000) (one call each): "
        + json.dumps(res["lane"]) + f" ({card})")

    # ---- (d) config 3's frames ----
    def frame_run(g_, fr_, c_):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        zero_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                img_t = render_pipeline_gpu(g_, fr_, c_)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        counts = read_counts()
        syncs = sum(1 for w_ in caught if "synchroniz" in str(w_.message))
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        img = img_t.cpu().numpy()
        require(img.shape == (H, W, 3) and bool(np.isfinite(img).all()) and float(img.std()) > 1e-3,
                "[37] a config-3 frame is not a finite, varied 1080p image")
        return img, counts, syncs, peak

    cfg3g = cfg3.replace(primary_rays=1, shadow_rays=1, denoise_iterations=0, jitter=False)
    frames = {}
    for tag, c_ in (("defaults hybrid", cfg3), ("golden wide", cfg3g.replace(backend="wide")),
                    ("golden hybrid", cfg3g)):
        img, counts, syncs, peak = frame_run(gpu3, frame3, c_)
        if tag == "golden wide":
            require(not any(counts.values()), f"[37] the wide frame launched kernels: {counts}")
        else:
            want = unmasked(trace_v7=0, trace_v9=c_.primary_rays, atrous_pair=c_.denoise_iterations,
                            trace_v8=counts["trace_v8"])
            require(counts == want and counts["trace_v8"] > 0, f"[37] {tag} launches {counts}")
        frames[tag] = {"img": img, "launches": {k: v for k, v in counts.items() if v},
                       "host_syncs": syncs, "peak_gib": round(peak, 3)}
    share = image_rule(frames["golden wide"]["img"], frames["golden hybrid"]["img"],
                       "[37] config 3: the wide frame against the hybrid frame")
    renders = {"golden wide": lambda: render_pipeline_gpu(gpu3, frame3, cfg3g.replace(backend="wide")),
               "golden hybrid": lambda: render_pipeline_gpu(gpu3, frame3, cfg3g)}
    turns = {k: [] for k in renders}
    for k in ("golden wide", "golden hybrid", "golden hybrid", "golden wide", "golden wide",
              "golden hybrid"):
        turns[k].append(once_ms(renders[k])[0])
    turns = {k: (statistics.median(v[1:]), v) for k, v in turns.items()}
    frames["defaults hybrid"]["ms"] = median_ms(lambda: render_pipeline_gpu(gpu3, frame3, cfg3), 3)[0]
    for tag in ("golden wide", "golden hybrid"):
        frames[tag]["ms"], frames[tag]["ms_all"] = turns[tag]    # the first of each a warm-up
    res["config3_frames"] = {k: {kk: vv for kk, vv in v.items() if kk != "img"} for k, v in frames.items()}
    res["config3_frames"]["wide_vs_hybrid_share_over_2e-3"] = share
    say(f"[37] config 3 frames at {W}x{H} (tonemap lut, shadow_ray_margin 0.1; golden = 1 spp, 1 "
        "shadow ray, no denoise, no jitter): " + json.dumps(res["config3_frames"]) + f" ({card})")

    # ---- (e) the default frame with the per-image denoiser ----
    cfg_d = cfg9.replace(use_pallas_denoise=False)
    img_d, counts_d, syncs_d, peak_d = frame_run(gpu, frame, cfg_d)
    want_d = unmasked(trace_v7=0, trace_v9=cfg9.primary_rays, atrous_pair=0,
                      trace_v8=cfg9.primary_rays * (gpu.num_light_tris * cfg9.shadow_rays + 1))
    require(counts_d == want_d, f"[37] per-image denoise frame launches {counts_d}, expected {want_d}")
    share_d = image_rule(img_d, img9, "[37] the per-image denoiser's frame against phase 9's")
    ms_d = median_ms(lambda: render_pipeline_gpu(gpu, frame, cfg_d), 3)[0]
    res["per_image_denoise"] = {"launches": {k: v for k, v in counts_d.items() if v}, "host_syncs": syncs_d,
                                "peak_gib": round(peak_d, 3), "ms": ms_d,
                                "share_over_2e-3_vs_phase9": share_d,
                                "phase9_ms": statistics.median(times9)}
    say("[37] reference-default frame with use_pallas_denoise=False: " + json.dumps(res["per_image_denoise"])
        + f" ({card})")
    say(f"[37] phase 37 took {time.perf_counter() - t37:.1f} s")
    return res


def image_decoders(*, rt, torch, card: str, W: int, H: int, zero_counts, read_counts) -> dict:
    """Phase 38: the host image decoders on the committed fixtures (the
    corrupt JPEGs and WebP among them); 1080p frames textured by JPEG/TGA
    files, by GIF/PSD/PGM/RLE-BMP files, by LZW/Deflate/JPEG/PackBits TIFF
    files, by WebP files (lossy with alpha, lossless) and by arithmetic-
    coded, lossless, incomplete progressive and corrupt JPEGs, each
    against the same frame textured by PNGs of their pixels; the C1 frame
    (a 0/1 opacity map against an all-zero one); host decode times."""
    import hashlib

    from realtimeraytracer_torch import scenes
    from realtimeraytracer_torch.scene.obj_loader import load_obj_scene, load_texture_file
    from realtimeraytracer_torch.scene.scene import Scene
    from realtimeraytracer_torch.utils import image_decode, png

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import _torch_image_helpers as enc      # the tests' hand encoders (NumPy only)

    say(card)
    t38 = time.perf_counter()
    fx = Path(__file__).resolve().parent / "tests" / "data" / "images"
    expected = json.loads((fx / "expected.json").read_text())["digests"]
    for name, digests in expected.items():
        for grayscale in (False, True):
            got = image_decode.pixels_digest(load_texture_file(str(fx / name), grayscale))
            want = digests[str(grayscale).lower()]
            require(got == want, f"[38] {name}, grayscale={grayscale}: digest {got[:16]}, "
                                 f"expected.json {want[:16]}")
    say(f"[38] {len(expected)} fixtures decoded on the host with both grayscale values: every "
        f"digest equal to expected.json's")

    # textured_obj's maps that the fixtures replace (its MTL names them).
    roles = {"ground_kd.png": "prog420_odd.jpg", "ground_ks.png": "grey.jpg",
             "leaf_kd.png": "base422_rst.jpg", "leaf_d.png": "rle.tga"}
    new_roles = {"ground_kd.png": "frame.gif", "ground_ks.png": "gloss.pgm",
                 "leaf_kd.png": "leaf.psd", "leaf_d.png": "discs_rle8.bmp"}
    tiff_roles = {"ground_kd.png": "lzw_pred_rgb.tif", "ground_ks.png": "deflate_tiles_grey.tif",
                  "leaf_kd.png": "jpeg_ycbcr.tif", "leaf_d.png": "packbits_rgba.tif"}
    webp_roles = {"ground_kd.png": "ground_lossless.webp", "leaf_kd.png": "leaf_alpha.webp"}
    # Arithmetic-coded, lossless, incomplete progressive (block-smoothed),
    # corrupt-and-recovered JPEG.
    jpeg_roles = {"ground_kd.png": "arith420_rst.jpg", "ground_ks.png": "lossless_grey.jpg",
                  "leaf_kd.png": "prog420_cut.jpg", "leaf_d.png": "corrupt_recovered.jpg"}
    disc = enc.disc_pattern(64)
    cfg = rt.RenderConfig(width=W, height=H, primary_rays=4, shadow_rays=3, denoise_iterations=4)
    frames = {}
    with tempfile.TemporaryDirectory(prefix="rtrt_images_") as d:
        base = scenes.textured_obj(str(Path(d) / "png"))

        def variant(tag, files):
            vd = Path(d) / tag.replace("/", "_").replace(" ", "_")
            vd.mkdir()
            mtl = (Path(d) / "png" / "scene.mtl").read_text()
            for name in ("scene.obj", "pillar_pm.png", *(m for m in roles if m not in files)):
                shutil.copy(Path(d) / "png" / name, vd / name)
            for map_name, (fname, data) in files.items():
                (vd / fname).write_bytes(data)
                mtl = mtl.replace(map_name, fname)
            (vd / "scene.mtl").write_text(mtl)
            sc = Scene(camera=base.camera, hdri=base.hdri, env_color=base.env_color,
                       area_lights=list(base.area_lights), sun=base.sun)
            load_obj_scene(sc, str(vd / "scene.obj"))
            require(len(sc.textures) == 5, f"[38] {tag}: {len(sc.textures)} textures loaded")
            return sc

        def twins(fixture_roles):
            return {m: (m.replace(".png", "_fx.png"), png.encode_png(image_decode.decode_image(b)[0]))
                    for m, (_, b) in fixture_roles.items()}

        old_bytes = {m: (f, (fx / f).read_bytes()) for m, f in roles.items()}
        new_bytes = {m: (f, (fx / f).read_bytes()) for m, f in new_roles.items()}
        tiff_bytes = {m: (f, (fx / f).read_bytes()) for m, f in tiff_roles.items()}
        webp_bytes = {m: (f, (fx / f).read_bytes()) for m, f in webp_roles.items()}
        jpeg_bytes = {m: (f, (fx / f).read_bytes()) for m, f in jpeg_roles.items()}
        scenes38 = {
            "JPEG/TGA maps": variant("fixtures", old_bytes),
            "PNG maps": variant("repng", twins(old_bytes)),
            "GIF/PSD/PGM/RLE-BMP maps": variant("newfmt", new_bytes),
            "their PNG maps": variant("newfmt_png", twins(new_bytes)),
            "TIFF maps": variant("tiff", tiff_bytes),
            "the TIFFs' PNG maps": variant("tiff_png", twins(tiff_bytes)),
            "WebP maps": variant("webp", webp_bytes),
            "the WebPs' PNG maps": variant("webp_png", twins(webp_bytes)),
            "rarer JPEG maps": variant("jpeg_variants", jpeg_bytes),
            "the rarer JPEGs' PNG maps": variant("jpeg_variants_png", twins(jpeg_bytes)),
            # C1: 0/1 texels read 0 and 1/255 (stbi_load), below alpha_threshold
            # like 0; the JAX package's rule kept them 0 and 1.0, opaque leaves.
            "C1 0/1 opacity PGM": variant("c1", {"leaf_d.png": (
                "leaf_d01.pgm", enc.encode_pnm(disc.astype(int), b"P5"))}),
            "all-zero opacity PGM": variant("zero", {"leaf_d.png": (
                "leaf_d00.pgm", enc.encode_pnm(np.zeros((64, 64), int), b"P5"))}),
        }
        for tag, sc in scenes38.items():
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            img_t = rt.render(sc, cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            require(img_t.device.type == "cuda", f"[38] {tag}: rendered on {img_t.device}")
            for name, n in counts.items():
                used = name in ("trace_v9_masked", "trace_v8_masked", "atrous_pair")
                require((n > 0) == used, f"[38] {tag}: {name} launched {n} times")
            require(counts["atrous_pair"] == cfg.denoise_iterations,
                    f"[38] {tag}: {counts['atrous_pair']} A-Trous launches")
            out = img_t.cpu().numpy()
            require(out.shape == (H, W, 3) and bool(np.isfinite(out).all()), f"[38] {tag}: bad image")
            require(float(out.std()) > 1e-3, f"[38] {tag}: constant image")
            frames[tag] = {"sha256": hashlib.sha256(out.tobytes()).hexdigest(),
                           "wall_s": round(wall, 3),
                           "launches": {k: v for k, v in counts.items() if v}}
    for a, b, what in (("JPEG/TGA maps", "PNG maps", "JPEG/TGA"),
                       ("GIF/PSD/PGM/RLE-BMP maps", "their PNG maps", "GIF/PSD/PGM/RLE-BMP"),
                       ("TIFF maps", "the TIFFs' PNG maps", "LZW/Deflate/JPEG/PackBits TIFF"),
                       ("WebP maps", "the WebPs' PNG maps", "WebP (lossy with alpha, lossless)"),
                       ("rarer JPEG maps", "the rarer JPEGs' PNG maps",
                        "arithmetic, lossless, incomplete progressive, corrupt JPEG"),
                       ("C1 0/1 opacity PGM", "all-zero opacity PGM", "C1 (0/1 opacity)")):
        ha, hb = frames[a]["sha256"], frames[b]["sha256"]
        require(ha == hb, f"[38] the {what} frame differs from its twin: {ha[:16]} against {hb[:16]}")
    require(frames["C1 0/1 opacity PGM"]["sha256"] != frames["PNG maps"]["sha256"],
            "[38] the C1 frame equals the frame with textured_obj's own cut-outs")
    say(f"[38] textured_obj at 1080p, reference defaults, rt.render: the JPEG/TGA-textured frame, "
        f"the GIF/PSD/PGM/RLE-BMP-textured frame, the TIFF-textured frame, the WebP-textured frame and "
        f"the frame textured by arithmetic-coded, lossless, incomplete progressive and corrupt JPEGs "
        f"are each hash-equal to the "
        f"frame with PNG maps of the same pixels; the C1 frame (0/1 opacity PGM) is hash-equal to the "
        f"all-zero one; "
        + json.dumps(frames))

    def med3(fn, n=3):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times), times

    jpeg = (fx / "smooth1024.jpg").read_bytes()
    yy, xx = np.mgrid[0:2048, 0:2048]
    noise = np.random.default_rng(38).integers(0, 16, (2048, 2048, 4))
    rgba = ((yy % 200)[..., None] + noise + np.stack([xx % 7, xx % 11, yy % 5, xx % 3], -1)).astype(np.uint8)
    paeth = png.encode_png(rgba, filters=[4])
    crop = png.encode_png(rgba[:256, :256], filters=[4])
    crop128 = png.encode_png(rgba[:128, :128], filters=[4])     # the Python decoder's timing
    require(np.array_equal(image_decode.decode_image(paeth)[0], rgba), "[38] the 2048^2 PNG decodes wrong")
    require(np.array_equal(png.decode_png(crop), image_decode.decode_image(crop)[0]),
            "[38] the crop's native and Python decodes differ")
    # One 1024^2 GIF, PGM, PSD, RLE and 16-bit BMP and 16-bit TGA, written on the host.
    rng = np.random.default_rng(381)
    y1, x1 = np.mgrid[0:1024, 0:1024]
    blocks = (x1 // 16 + y1 // 16) % 16
    pal = rng.integers(0, 256, (16, 3))
    rgb = np.stack([blocks * 16, (blocks * 7) % 256, 255 - blocks * 16], -1).astype(np.uint8)
    t_enc = time.perf_counter()
    new_files = {
        "gif_1024": (enc.encode_gif([dict(indices=blocks, min_size=4)], (1024, 1024), pal), "P"),
        "pgm16_1024": (enc.encode_pnm(x1 + y1 * 31 % 1000, b"P5", 1000), "I"),
        "psd_packbits_1024": (enc.encode_psd([rgb[..., k] for k in range(3)], 3, compression=1), "RGB"),
        "bmp_rle8_1024": (enc.make_bmp(None, 8, 40, False, pal, 1, size=(1024, 1024),
                                       data=enc.encode_bmp_rle(blocks, False, rng, max_run=64)), "P"),
        "bmp_565_1024": (enc.make_bmp((x1 * 64 + y1).astype(np.uint16), 16, 40, False, compression=3,
                                      masks=(0xF800, 0x7E0, 0x1F)), "RGB"),
        "tga16_rle_1024": (enc.make_tga(np.stack([blocks * 9, blocks], -1), 10, 16, rng=rng,
                                        max_packet=128), "RGBA"),
    }
    t_enc = time.perf_counter() - t_enc
    for key, (data, mode) in new_files.items():
        px, got_mode = image_decode.decode_image(data)
        require(px.shape[:2] == (1024, 1024) and got_mode == mode, f"[38] {key}: {px.shape} {got_mode}")
    require(np.array_equal(image_decode.decode_image(new_files["gif_1024"][0])[0][..., :3],
                           pal.astype(np.uint8)[blocks]), "[38] the 1024^2 GIF decodes wrong")
    # One 1024^2 LZW + predictor RGB TIFF in strips, Deflate grey TIFF in
    # tiles, JPEG-compressed YCbCr TIFF in tiles (a 256^2 crop repeated:
    # equal strips and tiles are encoded once), CMYK and YCCK JPEG.
    smooth = np.stack([128 + 100 * np.sin(x1 / 97 + y1 / 131), 128 + 100 * np.cos(x1 / 151 - y1 / 83),
                       128 + 90 * np.sin((x1 + y1) / 211)], -1).astype(np.uint8)
    repeated = np.tile(smooth[:256, :256], (4, 4, 1))
    cmyk_planes = [smooth[..., k] for k in (0, 1, 2, 0)]
    t_enc_tiff = time.perf_counter()
    new_files.update({
        "tiff_lzw_pred_strips_1024": (enc.make_tiff(repeated, 8, 2, compression=5, predictor=2,
                                                    rows_per_strip=256), "RGB"),
        "tiff_deflate_tiles_1024": (enc.make_tiff(repeated[..., 1], 8, 1, compression=8, tile=(256, 256)),
                                    "L"),
        "tiff_jpeg_ycbcr_tiles_1024": (enc.make_tiff(repeated, 8, 6, compression=7, subsampling=(2, 2),
                                                     tile=(256, 256)), "RGB"),
        "jpeg_cmyk_1024": (enc.encode_jpeg(cmyk_planes, [(1, 1)] * 4, adobe=0), "CMYK"),
        "jpeg_ycck_1024": (enc.encode_jpeg(cmyk_planes, [(2, 2), (1, 1), (1, 1), (2, 2)], adobe=2), "CMYK"),
    })
    t_enc += time.perf_counter() - t_enc_tiff
    for key, (data, mode) in new_files.items():
        if key.startswith(("tiff", "jpeg")):
            px, got_mode = image_decode.decode_image(data)
            require(px.shape[:2] == (1024, 1024) and got_mode == mode, f"[38] {key}: {px.shape} {got_mode}")
    require(np.array_equal(image_decode.decode_image(new_files["tiff_lzw_pred_strips_1024"][0])[0], repeated),
            "[38] the 1024^2 LZW TIFF decodes wrong")
    require(np.array_equal(image_decode.decode_image(new_files["tiff_deflate_tiles_1024"][0])[0][..., 0],
                           repeated[..., 1]), "[38] the 1024^2 Deflate TIFF decodes wrong")
    # The 1024^2 WebP fixtures: lossy with alpha (ALPH), lossy, lossless.
    webp_1024 = {"webp_lossy_alpha_1024": ("smooth1024_alpha.webp", "RGBA"),
                 "webp_lossy_1024": ("smooth1024.webp", "RGB"),
                 "webp_lossless_1024": ("ramp1024_lossless.webp", "RGB")}
    for key, (name, mode) in webp_1024.items():
        data = (fx / name).read_bytes()
        px, got_mode = image_decode.decode_image(data)
        require(px.shape[:2] == (1024, 1024) and got_mode == mode, f"[38] {key}: {px.shape} {got_mode}")
        new_files[key] = (data, mode)
    # The 1024^2 arithmetic-coded fixture (4:2:0, its digest checked above)
    # and a 1024^2 lossless RGB file (predictor 6, a restart every 32 rows)
    # written here: it decodes to its source exactly.
    arith = (fx / "smooth1024_arith.jpg").read_bytes()
    px, got_mode = image_decode.decode_image(arith)
    require(px.shape == (1024, 1024, 3) and got_mode == "RGB", f"[38] jpeg_arith_1024: {px.shape} {got_mode}")
    new_files["jpeg_arith_1024"] = (arith, "RGB")
    big = enc.smooth1024()
    t_enc_lossless = time.perf_counter()
    lossless = enc.encode_lossless_jpeg([big[..., k] for k in range(3)], 6, restart_rows=32)
    t_enc += time.perf_counter() - t_enc_lossless
    require(np.array_equal(image_decode.decode_image(lossless)[0], big), "[38] the 1024^2 lossless JPEG decodes wrong")
    new_files["jpeg_lossless_1024"] = (lossless, "RGB")
    y1k, x1k = np.mgrid[0:1024, 0:1024]
    require(np.array_equal(image_decode.decode_image(new_files["webp_lossless_1024"][0])[0],
                           np.stack([(x1k + y1k) & 255, (2 * x1k) & 255, (3 * y1k) & 255], -1)),
            "[38] the 1024^2 lossless WebP decodes wrong")
    times = {"jpeg_1024_native": med3(lambda: image_decode.decode_image(jpeg)),
             "png_paeth_2048_native": med3(lambda: image_decode.decode_image(paeth)),
             "png_paeth_256_native": med3(lambda: image_decode.decode_image(crop)),
             "png_paeth_128_python": med3(lambda: png.decode_png(crop128), 1)}
    for key, (data, _) in new_files.items():
        times[key + "_native"] = med3(lambda data=data: image_decode.decode_image(data))
    res = {k: {"ms": v[0], "ms_all": v[1]} for k, v in times.items()}
    res["bytes"] = {"jpeg_1024": len(jpeg), "png_paeth_2048": len(paeth), "png_paeth_256": len(crop),
                    "png_paeth_128": len(crop128),
                    **{k: len(v[0]) for k, v in new_files.items()}}
    res["encode_s"] = t_enc
    say(f"[38] host decode ms, median of 3 (one run of the Python PNG decoder; host side, the card machine's "
        f"CPU; {card}): " + json.dumps(res))
    say(f"[38] phase 38 took {time.perf_counter() - t38:.1f} s")
    return {"frames": frames, "decode": res}


def main() -> int:
    import torch
    import torch.distributed as tdist

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    try:
        import realtimeraytracer_torch as rt
    except ImportError as e:
        raise SmokeFailure(f"cannot import realtimeraytracer_torch ({e}); run from the repository root") from e
    from realtimeraytracer_torch import demo, kernels, probes, scenes
    from realtimeraytracer_torch.ops.camera_rays import (block_permutation, generate_ray_blocks,
                                                         generate_rays)
    from realtimeraytracer_torch.diff import checkpoint, optimize as opt
    from realtimeraytracer_torch.ops.denoise_kernel import (
        atrous_denoise_pair, atrous_pair_iteration_kernel, atrous_pair_iteration_plain,
        atrous_pair_iteration_vjp_kernel, atrous_pair_iteration_vjp_plain, atrous_pair_slab)
    from realtimeraytracer_torch.ops.denoise import ratio_combine
    from realtimeraytracer_torch.ops.intersect import HitRecord, ray_triangle
    from realtimeraytracer_torch.ops.refit import apply_instance_transforms
    from realtimeraytracer_torch.parallel.mesh import initialize_multihost, make_ray_mesh
    from realtimeraytracer_torch.parallel.sharded import (render_pipeline_sharded,
                                                          wavefront_sample_sharded)
    from realtimeraytracer_torch.render import hier_backend as v8
    from realtimeraytracer_torch.render import quarter_backend as v9
    from realtimeraytracer_torch.render import v7_backend as v7
    from realtimeraytracer_torch.render.alpha import (hit_alpha, occlusion_ladder, step_past,
                                                      wrap_backend_with_alpha)
    from realtimeraytracer_torch.render.backends import (make_backend, make_hybrid_backend,
                                                         trace_primary_blocks)
    from realtimeraytracer_torch.render.megakernel import render_components, shade_sample
    from realtimeraytracer_torch.render.pipeline import compile_for, render_pipeline_gpu
    from realtimeraytracer_torch.render.wavefront import render_wavefront, trace_paths
    from realtimeraytracer_torch.app.application import Application
    from realtimeraytracer_torch.frame_profile import range_times
    from realtimeraytracer_torch.kernel_ab import sass_functions, tap_instructions
    from realtimeraytracer_torch.scene import obj_loader
    from realtimeraytracer_torch.utils import image_decode, native
    from realtimeraytracer_torch.utils.image_io import read_png

    # Launch counters: (wrapper, attribute); a masked variant counts on its
    # wrapper's masked_launches.
    counters = {"trace_v7": (v7.trace_blocks, "launches"),
                "trace_v9": (v9.trace_blocks_quarter, "launches"),
                "trace_v8": (v8.trace_blocks_hier, "launches"),
                "atrous_pair": (atrous_denoise_pair, "launches"),
                "atrous_pair_vjp": (atrous_denoise_pair, "vjp_launches"),
                "trace_v7_masked": (v7.trace_blocks, "masked_launches"),
                "trace_v9_masked": (v9.trace_blocks_quarter, "masked_launches"),
                "trace_v8_masked": (v8.trace_blocks_hier, "masked_launches"),
                "trace_v8_inst": (v8.trace_blocks_hier, "launches_inst"),
                "trace_v8_inst_masked": (v8.trace_blocks_hier, "masked_launches_inst"),
                "trace_v8_multi": (v8.trace_blocks_hier, "launches_multi"),
                "fma_peak": (probes.fma_peak_kernel, "launches")}

    def zero_counts() -> None:
        for c, attr in counters.values():
            setattr(c, attr, 0)

    def read_counts() -> dict:
        return {name: getattr(c, attr) for name, (c, attr) in counters.items()}

    def unmasked(**kw) -> dict:
        """Expected counts of an opaque frame: the masked, instanced and
        multi-segment variants, the A-Trous backward and the probe unused
        unless kw names them."""
        return {"trace_v7_masked": 0, "trace_v9_masked": 0, "trace_v8_masked": 0,
                "trace_v8_inst": 0, "trace_v8_inst_masked": 0, "trace_v8_multi": 0,
                "atrous_pair_vjp": 0, "fma_peak": 0, **kw}

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
    # The native host library (g++, native/) beside the nvcc builds: the
    # scene compiles from phase 3 on build their BVHs with it.
    def build_native():
        t_ = time.perf_counter()
        lib_ = native.load_library()
        return lib_, time.perf_counter() - t_

    def build_image_decoder():                 # phase 38's host decoders
        t_ = time.perf_counter()
        image_decode.load_library()
        return time.perf_counter() - t_

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        native_job = pool.submit(build_native)
        image_job = pool.submit(build_image_decoder)
        libs = kernels.build_all()
        native_lib, native_s = native_job.result()
        image_s = image_job.result()
    require(native_lib is not None, f"no C++ compiler ({native._compiler()}): the native host "
            "library cannot be built")
    say(f"[2] built {len(libs)} kernel libraries in {time.perf_counter() - t0:.2f} s; the native "
        f"host library {native.library_path(native._compiler()).name} in {native_s:.2f} s with "
        f"{' '.join(native._compiler())} {' '.join(native.CXX_FLAGS)}; the image decoder "
        f"{image_decode.library_path(native._compiler()).name} in {image_s:.2f} s with "
        f"{' '.join(image_decode.CXX_FLAGS)}")
    for name, log in kernels.build_log.items():
        entry = ""
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '.*?_cu_[0-9a-f]+\d+(\w+?kernel)(I\w*?E)?(?=E)", line)
            if m:     # the kernel and its template arguments, as mangled
                entry = m.group(1) + (m.group(2) or "")
            elif "registers" in line or "smem" in line or "spill" in line:
                say(f"  {name} {entry}: {line.strip()}")

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

    def v7_fused(rays, mode, common, amask=None, g=gpu):
        return v7.trace_v7_kernel(rays, g.pallas_cl_min, g.pallas_cl_max, g.pallas_panels, mode,
                                  common, amask)

    def v7_twin(rays, mode, common, amask=None, g=gpu, ordered=True):
        """The fused v7's twin: the plain cull, then the plain trace (t, ids,
        flags) and, with `ordered`, the ordered visit loop (every row; else
        None)."""
        keys_, id_ = v7.cull_keys(rays, g.pallas_cl_min, g.pallas_cl_max)
        p_ = v7.trace_keys_plain(rays, keys_, g.pallas_panels, id_, mode, common, amask)
        if not ordered:
            return p_, None
        return p_, v7.trace_keys_ordered(rays, keys_, g.pallas_panels, id_, mode, common, amask)

    def both(rays, mode, common, what):
        k_ = v7_fused(rays, mode, common)
        p_, o_ = v7_twin(rays, mode, common)
        torch.cuda.synchronize()
        same_rows(k_, o_, what)
        return k_, p_

    prim = primary_tiles(320, 180)
    k, p = both(prim, "closest", "origin", "[3] v7 closest 320x180")
    v7_err = compare_closest(k, p, "[3] closest common=origin 320x180")
    seg, sun = shadow_tiles(prim, k, 7)
    v7_err = max(v7_err, compare_occluded(*both(seg, "occluded", None, "[3] v7 occluded segments"),
                                          "[3] occluded shadow segments"))
    v7_err = max(v7_err, compare_occluded(*both(sun, "occluded", "dir", "[3] v7 occluded sun"),
                                          "[3] occluded sun common=dir"))
    v7_err = max(v7_err, compare_closest(*both(seg, "closest", None, "[3] v7 closest general"),
                                         "[3] closest general (shadow rays)"))

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
    for step in (5, 6, 7, 8):   # denoise_iterations > 4 run the kernel as well
        ks, ku = atrous_pair_iteration_kernel(*dn, step, *phis)
        ps, pu = atrous_pair_iteration_plain(*dn, step, *phis)
        for a, b, what in ((ks, ps, "shadowed"), (ku, pu, "unshadowed")):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6,
                                       msg=lambda m: f"[4] step {step} {what}: {m}")
            dn_err = max(dn_err, (a - b).abs().max().item())
    say(f"[4] A-Trous pair kernel vs plain at steps 5, 6, 7, 8 agree; max |err| so far {dn_err}")
    # The kernel multiplies by the phi's reciprocals (computed in double,
    # rounded to float), as the twin's division by a Python scalar does on
    # the card; the IEEE quotient of the design before differs from that
    # product by this many ulp on the taps of step 1 (squared normal and
    # position distances).
    from realtimeraytracer_torch.ops.denoise import _sq3, shifted_taps
    ulp = 0
    for _, _, (ns, ps), _ in shifted_taps((dn[2], dn[3]), 1):
        for x, phi in ((_sq3(dn[2], ns), phis[1]), (_sq3(dn[3], ps), phis[2])):
            quot = -x / torch.tensor(phi, dtype=torch.float32, device=dev)
            prod = -x * torch.tensor(np.float32(1.0 / phi), dtype=torch.float32, device=dev)
            ulp = max(ulp, int((quot.view(torch.int32) - prod.view(torch.int32)).abs().max()))
    say(f"[4] x / phi (IEEE) against x * (1 / phi) on step 1's taps: at most {ulp} ulp apart")
    dn_bits = all(torch.equal(a, b) for a, b in ((sk, sp), (uk, up)))
    dn_ms, _ = cuda_ms(lambda: denoise_with(atrous_pair_iteration_kernel), 5)
    dn_plain_ms, _ = cuda_ms(lambda: denoise_with(atrous_pair_iteration_plain), 3)
    dn_bound = atrous_bound(H, W, 4)
    # The issue-rate floor: the SASS instructions the kernel's tap loops
    # issue per tap x the in-bounds taps, one warp instruction per
    # scheduler and clock (132 SMs x 4 schedulers at the card's greatest SM
    # clock).
    ins = next(v for k_, v in sass_functions(kernels.build("atrous_pair")).items() if "atrous" in k_)
    per_tap, code_taps = tap_instructions(ins)
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    dn_floor = per_tap * atrous_taps(H, W, 4) / 32 / (132 * 4 * float(clk) * 1e6) * 1e3
    say(f"[4] denoise 4 iterations, both images: kernel {dn_ms:.3f} ms, plain {dn_plain_ms:.3f} ms, "
        f"bound {dn_bound[0]:.4f} ms by {dn_bound[1]}; SASS {len(ins)} instructions, its tap loops "
        f"{per_tap:.1f} a tap ({code_taps} taps in the code); issue-rate floor {dn_floor:.4f} ms at "
        f"{clk} MHz; kernel bit-equal to the twin: {dn_bits} ({card})")

    # ---- 5. the frame ---------------------------------------------------
    cfg = rt.RenderConfig(width=W, height=H, primary_rays=4, shadow_rays=3,
                          denoise_iterations=4, backend="pallas")
    torch.cuda.reset_peak_memory_stats()
    held5 = torch.cuda.memory_allocated()
    zero_counts()
    t0 = time.perf_counter()
    with no_plain_cull(v7, "cull_keys", "[5] the pallas frame"):
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
    with no_plain_cull(v7, "cull_keys", "[5] the timed pallas frames"):
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
    # timed, and compared once more at full size, every row against the
    # plain cull's ordered loop.
    prim = primary_tiles(W, H)
    keys, id_mask = v7.cull_keys(prim, cl_min, cl_max)
    cull_ms, _ = cuda_ms(lambda: v7.cull_keys(prim, cl_min, cl_max), 3)
    v7_ms, prim_k = cuda_ms(lambda: v7_fused(prim, "closest", "origin"), 10)
    v7_plain_ms, (prim_p, _) = cuda_ms(lambda: v7_twin(prim, "closest", "origin", ordered=False), 1)
    same_rows(prim_k, v7_twin(prim, "closest", "origin")[1], "[5] v7 closest 1080p")
    v7_visits = int(prim_k[1][:, 1, 0].sum().item())
    v7_cull_ops = CULL_OPS * prim.shape[0] * cl_min.shape[0]
    v7_bound, v7_pairs = trace_bound(prim_k[1], "origin", nbytes(prim, cl_min, cl_max, coeff)
                                     + 4 * prim.shape[0] * 128 * 4, extra_ops=v7_cull_ops)
    say(f"[5] v7 closest with its cull in-kernel, 1080p primaries ({prim.shape[0]} tiles): kernel "
        f"{v7_ms:.3f} ms; the plain-torch cull alone {cull_ms:.3f} ms on the same rays; plain cull + "
        f"twin {v7_plain_ms:.3f} ms; {v7_visits} visits, {v7_pairs} pairs tested "
        f"({v7_pairs / (v7_visits * 16384):.4f} of visits x 128 x 128), {v7_cull_ops} cull operations, "
        f"bound {v7_bound[0]:.4f} ms by {v7_bound[1]} ({card})")
    v7_err = max(v7_err, compare_closest(prim_k, prim_p, "[5] closest common=origin 1080p"))
    seg, sun = shadow_tiles(prim, prim_k, 8)
    v7_occ = {}
    for rays, common, what in ((seg, None, "shadow segments"), (sun, "dir", "sun common=dir")):
        km, k = cuda_ms(lambda: v7_fused(rays, "occluded", common), 5)
        pm, (p, _) = cuda_ms(lambda: v7_twin(rays, "occluded", common, ordered=False), 1)
        same_rows(k, v7_twin(rays, "occluded", common)[1], f"[5] v7 occluded {what} 1080p")
        b, pairs = trace_bound(k[1], common, nbytes(rays, cl_min, cl_max, coeff)
                               + 4 * rays.shape[0] * 128 * 4, extra_ops=v7_cull_ops)
        v7_occ[what] = (km, pm, b)
        say(f"[5] v7 occluded, 1080p {what} (unsorted), cull in-kernel: kernel {km:.3f} ms, plain cull + "
            f"twin {pm:.3f} ms; {int(k[1][:, 1, 0].sum())} visits, {pairs} pairs, bound {b[0]:.4f} ms "
            f"by {b[1]} ({card})")
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

    def v9_twin(rays, common, amask=None, g=gpu, ordered=True):
        """The fused kernel's twin: the plain quarter cull, then the plain
        trace (t, ids) and, with `ordered`, the ordered visit loop (every
        row; else None)."""
        qkeys, qmask = v7.cull_quarter_keys(rays, g.q_cl_min, g.q_cl_max)
        p = v9.trace_quarter_plain(rays, qkeys, g.q_panels, g.q_group_off, qmask, common, amask)
        if not ordered:
            return p, None
        return p, v9.trace_quarter_ordered(rays, qkeys, g.q_panels, g.q_group_off, qmask, common,
                                           amask)

    def v9_fused(rays, common, amask=None, g=gpu):
        return v9.trace_quarter_kernel(rays, g.q_cl_min, g.q_cl_max, g.q_panels, g.q_group_off,
                                       common, amask)

    k = v9_fused(primary_tiles(320, 180), "origin")
    p, o = v9_twin(primary_tiles(320, 180), "origin")
    v9_err = compare_closest(k, p, "[7] v9 closest common=origin 320x180")
    same_rows(k, o, "[7] v9 320x180")
    qkeys, qmask = v7.cull_quarter_keys(prim, gpu.q_cl_min, gpu.q_cl_max)
    qcull_ms, _ = cuda_ms(lambda: v7.cull_quarter_keys(prim, gpu.q_cl_min, gpu.q_cl_max), 3)
    v9_ms, v9_k = cuda_ms(lambda: v9_fused(prim, "origin"), 10)
    v9_plain_ms, (v9_p, _) = cuda_ms(lambda: v9_twin(prim, "origin", ordered=False), 1)
    _, v9_o = v9_twin(prim, "origin")
    v9_err = max(v9_err, compare_closest(v9_k, v9_p, "[7] v9 closest common=origin 1080p"))
    same_rows(v9_k, v9_o, "[7] v9 1080p")
    v9_visits = int(v9_k[1][:, 1, 0].sum().item()) // 4
    cull_ops = CULL_OPS * prim.shape[0] * gpu.q_cl_min.shape[0]
    v9_bound, v9_pairs = trace_bound(v9_k[1], "origin", nbytes(prim, gpu.q_cl_min, gpu.q_cl_max,
                                     q_coeff, q_off) + 3 * prim.shape[0] * 128 * 4, extra_ops=cull_ops)
    per_stream = (qkeys.reshape(prim.shape[0], 4, -1) != v7.INVALID).sum(dim=2).float()
    say(f"[7] candidates per tile: v7 {float((keys != v7.INVALID).sum()) / prim.shape[0]:.2f} blocks; "
        f"v9 {float(per_stream.mean()):.2f} subclusters per stream, longest stream "
        f"{float(per_stream.amax(dim=1).mean()):.2f} (greatest {int(per_stream.amax())}); visits per "
        f"tile: v7 {v7_visits / prim.shape[0]:.2f}, v9 {v9_visits / prim.shape[0]:.2f}")
    say(f"[7] v9 closest with its quarter cull in-kernel, 1080p primaries: kernel {v9_ms:.3f} ms; the "
        f"plain-torch quarter cull alone {qcull_ms:.3f} ms on the same rays; plain cull + twin "
        f"{v9_plain_ms:.3f} ms; {v9_visits} composite visits (v7: {v7_visits}), {v9_pairs} pairs tested "
        f"({v9_pairs / (v9_visits * 16384):.4f} of visits x 128 x 128; v7: {v7_pairs}), {cull_ops} cull "
        f"operations, bound {v9_bound[0]:.4f} ms by {v9_bound[1]} ({card})")

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

    # Tiles whose own hints retire every ray: the occluded segment rays
    # regrouped by their first-occluder block, so that most tiles' rays
    # share one or two occluder blocks.  Fed its own hints, such a tile
    # retires every live ray in the hint visits and pops no super.
    first = cold[1][:, 0].reshape(-1)
    occ_r = (first >= 0).nonzero()[:, 0]
    per_ray = seg.permute(0, 2, 1).reshape(-1, 8)[occ_r[torch.argsort(first[occ_r], stable=True)]]
    rt_tiles = v7._pack_rays(per_ray[:, 0:3], per_ray[:, 3:6], per_ray[:, 6], per_ray[:, 7])[0]
    want_r = v8_plain(rt_tiles, "occluded", None)
    cold_r = v8_kernel(rt_tiles, "occluded", None)
    hints_r = cold_r[1][:, 3:5, 0].contiguous()
    fed_r = v8_kernel(rt_tiles, "occluded", None, hints_r)
    for got, what in ((cold_r, "cold"), (fed_r, "fed its own hints")):
        v8_err = max(v8_err, compare_occluded(got, want_r, f"[8] v8 regrouped occluded segments ({what})"))
    live_r = rt_tiles[:, 6] <= rt_tiles[:, 7]
    b_r = cold_r[1][:, 0]
    covered = ((b_r == hints_r[:, 0:1]) | (b_r == hints_r[:, 1:2]) | ~live_r).all(dim=1)
    require(float(covered.float().mean()) > 0.5, "[8] regrouped segments: few tiles covered by their hints")
    require(bool((fed_r[0][:, 1, 0][covered] == 0).all()),
            "[8] a tile whose hints retire every ray popped a super")
    require(bool((fed_r[1][:, 1, 0][covered] == 2).all()),
            "[8] a tile whose hints retire every ray visited more than its two hint blocks")
    say(f"[8] v8 hints that retire every ray: {int(covered.sum())} of {rt_tiles.shape[0]} regrouped tiles "
        f"pop no super and visit only their 2 hint blocks; flags equal the twin's")

    # A non-instanced scene above 32 supers (the L1 keys span more warps):
    # procedural_mesh(1_000_000), the 1M rung, where v7 takes coherent
    # closest and v8 gets no hints.
    t0 = time.perf_counter()
    big = scenes.procedural_mesh(1_000_000, sun=True)
    gbig = big.compile(quarter_panels=False).to(dev)
    t_big = time.perf_counter() - t0
    bcoeff, bsup, bblk, bnsup = v8._hier_inputs(gbig)
    require(bnsup > 32, f"[8] procedural_mesh(1_000_000) has {bnsup} supers")
    say(f"[8] procedural_mesh(1_000_000): {gbig.num_tris} tris, {bcoeff.shape[0]} blocks in {bnsup} "
        f"supers; host compile {t_big:.2f} s")

    def big_tiles(w, h):
        fr = big.camera.viewport_frame(w, h, device=dev)
        o_, d_ = generate_rays(fr, w, h, sample_index=0, jitter=True)
        perm_, _ = block_permutation(w, h, device=dev)
        n_ = o_.shape[0]
        o_, d_ = o_[perm_], d_[perm_]
        bp = v7._pack_rays(o_, d_, torch.full((n_,), 1e-3, device=dev), torch.full((n_,), 1e4, device=dev))[0]
        k_ = v8.trace_hier_kernel(bp, bsup, bblk, bcoeff, bnsup, "closest", None)
        hit_ = k_[1][:, 0].reshape(-1) >= 0
        p_ = o_ + d_ * torch.where(hit_, k_[0][:, 0].reshape(-1), 0.0)[:, None] - d_ * 1e-3
        delta = (gbig.lt_v0[0] + gbig.lt_v1[0] + gbig.lt_v2[0]) / 3.0 - p_
        dist = delta.norm(dim=1)
        big_ = torch.full_like(dist, 3.0e38)
        bs = v7._pack_rays(p_, delta / dist[:, None], torch.where(hit_, 1e-3, big_),
                           torch.where(hit_, dist - 0.5, -big_))[0]
        return bp, k_, bs

    bp, bk, bs = big_tiles(320, 180)
    v8_err = max(v8_err, compare_closest(bk, v8.trace_hier_plain(bp, bsup, bblk, bcoeff, bnsup, "closest"),
                                         "[8] v8 closest, 1M triangles, 320x180 primaries"))
    v8_err = max(v8_err, compare_occluded(
        v8.trace_hier_kernel(bs, bsup, bblk, bcoeff, bnsup, "occluded", None),
        v8.trace_hier_plain(bs, bsup, bblk, bcoeff, bnsup, "occluded"),
        "[8] v8 occluded, 1M triangles, 320x180 segments to light 0"))
    # v7 there, which takes the hybrid route's coherent closest traces above
    # 1,024 blocks: keys on 8 pages (13 id bits), against the plain cull +
    # twin and every row against the ordered loop at 320x180.
    kb7 = v7_fused(bp, "closest", "origin", g=gbig)
    pb7, ob7 = v7_twin(bp, "closest", "origin", g=gbig)
    v7_err = max(v7_err, compare_closest(kb7, pb7, "[8] v7 closest, 1M triangles, 320x180 primaries"))
    same_rows(kb7, ob7, "[8] v7 1M 320x180")
    bp, bk, bs = big_tiles(W, H)
    big_closest_ms, _ = cuda_ms(lambda: v8.trace_hier_kernel(bp, bsup, bblk, bcoeff, bnsup, "closest", None), 3)
    big_occ_ms, bo_ = cuda_ms(lambda: v8.trace_hier_kernel(bs, bsup, bblk, bcoeff, bnsup, "occluded", None), 3)
    say(f"[8] v8 at 1M triangles, 1080p: closest primaries {big_closest_ms:.3f} ms "
        f"({int(bk[1][:, 1, 0].sum())} visits, {int(bk[0][:, 1, 0].sum())} supers popped), occluded "
        f"segments to light 0 {big_occ_ms:.3f} ms ({int(bo_[1][:, 1, 0].sum())} visits) ({card})")
    big_v7_ms, kb7 = cuda_ms(lambda: v7_fused(bp, "closest", "origin", g=gbig), 3)
    big_cull_ms, (bkeys, _) = once_ms(lambda: v7.cull_keys(bp, gbig.pallas_cl_min, gbig.pallas_cl_max))
    require(bool(((kb7[1][:, 0] == bk[1][:, 0]) | (kb7[0][:, 0] == bk[0][:, 0])).all()),
            "[8] v7 and v8 disagree on the 1M primaries (ids differ with unequal t)")
    cand = (bkeys.reshape(bp.shape[0], -1) != v7.INVALID).sum(dim=1)
    say(f"[8] v7 at 1M triangles, 1080p primaries, cull in-kernel: {big_v7_ms:.3f} ms, "
        f"{int(kb7[1][:, 1, 0].sum())} visits; the plain-torch cull alone {big_cull_ms:.3f} ms and "
        f"{nbytes(bkeys)} bytes of keys; candidates per tile mean {float(cand.float().mean()):.1f}, "
        f"greatest {int(cand.amax())} (the rank sort up to 512, the bitonic network above, on "
        f"{int((cand > 512).sum())} tiles) ({card})")
    del bkeys, kb7, pb7, ob7

    # The hybrid frame at the 1M rung (v7 coherent closest, v8 occlusion).
    cfg8 = rt.RenderConfig(width=W, height=H, primary_rays=4, shadow_rays=3, denoise_iterations=4)
    frame8 = big.camera.viewport_frame(W, H, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held8 = torch.cuda.memory_allocated()
    zero_counts()
    with no_plain_cull(v7, "cull_keys", "[8] the 1M hybrid frame"):
        img8 = render_pipeline_gpu(gbig, frame8, cfg8)
        torch.cuda.synchronize()
    counts8 = read_counts()
    peak8 = (torch.cuda.max_memory_allocated() - held8) / 2**30
    require(counts8 == unmasked(trace_v7=cfg8.primary_rays, trace_v9=0,
                                trace_v8=cfg8.primary_rays * (gbig.num_light_tris * cfg8.shadow_rays + 1),
                                atrous_pair=cfg8.denoise_iterations),
            f"[8] 1M hybrid frame launches {counts8}")
    img8 = img8.cpu().numpy()
    require(bool(np.isfinite(img8).all()) and float(img8.std()) > 1e-3, "[8] 1M hybrid frame: bad image")
    ms8, _ = median_ms(lambda: render_pipeline_gpu(gbig, frame8, cfg8), 3)
    say(f"[8] the 1M hybrid frame (render_pipeline_gpu, reference defaults): {ms8:.2f} ms (median of 3 "
        f"after a warm-up), peak memory {peak8:.3f} GiB above the {held8 / 2**30:.3f} GiB held; "
        f"launches {counts8} ({card})")
    del big, gbig, bcoeff, bsup, bblk, bp, bk, bs, bo_, img8

    # ---- 9. the frame through the default route --------------------------
    cfg9 = rt.RenderConfig(width=W, height=H, primary_rays=4, shadow_rays=3, denoise_iterations=4)
    require(cfg9.backend == "auto", "the default backend is not 'auto'")
    torch.cuda.reset_peak_memory_stats()
    held9 = torch.cuda.memory_allocated()
    zero_counts()
    t0 = time.perf_counter()
    with no_plain_cull(v9, "cull_quarter_keys", "[9] the hybrid frame"):
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

    fcull_ms, _ = cuda_ms(lambda: v7.cull_quarter_keys(fprim, fol.q_cl_min, fol.q_cl_max), 3)
    v9m_ms, v9m_k = cuda_ms(lambda: v9_fused(fprim, "origin", fol.q_amask, fol), 10)
    v9m_plain_ms, (v9m_p, _) = cuda_ms(
        lambda: v9_twin(fprim, "origin", fol.q_amask, fol, ordered=False), 1)
    v9m_err = compare_closest(v9m_k, v9m_p, "[12] v9 masked closest common=origin 1080p")
    same_rows(v9m_k, v9_twin(fprim, "origin", fol.q_amask, fol)[1], "[12] v9 masked 1080p")
    v9_open_ms, v9_open = cuda_ms(lambda: v9_fused(fprim, "origin", None, fol), 10)
    fcull_ops = CULL_OPS * fprim.shape[0] * fol.q_cl_min.shape[0]
    v9m_bound, v9m_pairs = trace_bound(v9m_k[1], "origin", nbytes(fprim, fol.q_cl_min, fol.q_cl_max,
                                       fol.q_panels, fol.q_group_off, fol.q_amask) + out_bytes,
                                       extra_ops=fcull_ops)
    say(f"[12] v9 masked with its cull in-kernel, 1080p foliage primaries: kernel {v9m_ms:.3f} ms, the "
        f"plain-torch quarter cull alone {fcull_ms:.3f} ms, plain cull + twin {v9m_plain_ms:.3f} ms, "
        f"unmasked kernel on the same rays {v9_open_ms:.3f} ms, "
        f"{int((v9m_k[1][:, 0] != v9_open[1][:, 0]).sum())} hits differ from its; "
        f"{v9m_pairs} pairs, bound {v9m_bound[0]:.4f} ms by {v9m_bound[1]} ({card})")

    fv7_cull_ms, _ = cuda_ms(lambda: v7.cull_keys(fprim, fol.pallas_cl_min, fol.pallas_cl_max), 3)
    v7m_ms, v7m_k = cuda_ms(lambda: v7_fused(fprim, "closest", "origin", fol.pallas_amask, fol), 10)
    v7m_plain_ms, (v7m_p, _) = cuda_ms(
        lambda: v7_twin(fprim, "closest", "origin", fol.pallas_amask, fol, ordered=False), 1)
    v7m_err = compare_closest(v7m_k, v7m_p, "[12] v7 masked closest common=origin 1080p")
    same_rows(v7m_k, v7_twin(fprim, "closest", "origin", fol.pallas_amask, fol)[1],
              "[12] v7 masked 1080p")
    fv7_cull_ops = CULL_OPS * fprim.shape[0] * fol.pallas_cl_min.shape[0]
    v7m_bound, v7m_pairs = trace_bound(v7m_k[1], "origin", nbytes(fprim, fol.pallas_cl_min,
                                       fol.pallas_cl_max, fol.pallas_panels, fol.pallas_amask)
                                       + out_bytes, extra_ops=fv7_cull_ops)
    v7_open_ms, _ = cuda_ms(lambda: v7_fused(fprim, "closest", "origin", None, fol), 10)
    say(f"[12] v7 masked with its cull in-kernel, 1080p foliage primaries: kernel {v7m_ms:.3f} ms "
        f"(unmasked on the same rays {v7_open_ms:.3f} ms), the plain-torch cull alone "
        f"{fv7_cull_ms:.3f} ms, plain cull + twin {v7m_plain_ms:.3f} ms; "
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
    # The kernels return t with its low 7 mantissa bits cleared, and which
    # of two triangles in one such bucket wins depends on the tile's visit
    # order, so the two ladders may take different ones; a ladder that
    # rejects the transparent one steps past the bucket (step_past), and
    # the opaque one with it.  Where the masked ladder passed the unmasked
    # ladder's opaque hit, it is held to have met such a triangle: one the
    # ray meets (Moller-Trumbore over every triangle) within a bucket below
    # and a step above the opaque hit's t, transparent at its hit, its mask
    # bit set.  No mask rejected an opaque hit there.
    tied = torch.zeros_like(differ)
    for i in torch.nonzero(differ & ~(further | nearer) & (hm.t > hn.t)
                           & (hit_alpha(fol, hn, fo, fd) >= thr)).flatten()[:64].tolist():
        n_ = fol.num_tris
        o_, d_ = fo[i].expand(n_, 3), fd[i].expand(n_, 3)
        t_, u_, v_, ok_ = ray_triangle(o_, d_, fol.bvh_tri_v0, fol.bvh_tri_v1, fol.bvh_tri_v2)
        bucket_ = hn.t[i] * 2.0 ** -16
        mates = torch.nonzero(ok_ & (t_ >= hn.t[i] - bucket_) & (t_ < step_past(hn.t[i]))
                              & (torch.arange(n_, device=dev) != hn.prim_id[i])).flatten()
        if mates.numel() == 0:
            continue
        rec_ = HitRecord(t=t_[mates], prim_id=mates.to(hn.prim_id.dtype), u=u_[mates], v=v_[mates])
        a_ = hit_alpha(fol, rec_, o_[mates], d_[mates])
        w_ = fol.pallas_amask[mates // 128, :, mates % 128]
        mask_ok = v7._mask_ok(torch.ones_like(mates, dtype=torch.bool)[None], u_[mates][None],
                              v_[mates][None], w_.T[None])[0]
        tied[i] = bool(((a_ < thr) & mask_ok).any())
    odd = torch.nonzero(differ & ~(further | nearer | tied)).flatten()[:8]
    require(odd.numel() == 0,
            f"[13] {int((differ & ~(further | nearer)).sum())} rays differ otherwise between the "
            "ladders (a mask that rejected an opaque hit would show here): ray, (t, prim, alpha) "
            "masked, unmasked, unmasked exhausted: " + "; ".join(
                f"{int(i)}, ({float(hm.t[i])!r}, {int(hm.prim_id[i])}, "
                f"{float(hit_alpha(fol, hm, fo, fd)[i])!r}), ({float(hn.t[i])!r}, {int(hn.prim_id[i])}, "
                f"{float(hit_alpha(fol, hn, fo, fd)[i])!r}), {bool(exhausted[i])}" for i in odd))
    say(f"[13] {int(exhausted.sum())} rays exhaust the unmasked ladder; hits differ on "
        f"{int(differ.sum())} rays: {int(further.sum())} exhausted rays resolve further with masks, "
        f"on {int(nearer.sum())} the unmasked ladder stepped past the nearer opaque hit the masked "
        f"trace keeps ({int((nearer & exhausted).sum())} of them exhausted), on {int(tied.sum())} the "
        f"masked ladder stepped past the unmasked ladder's opaque hit with a transparent triangle "
        f"of its t bucket")

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
        return out, counts, ms, syncs, peak - held / 2**30

    cfg_t = rt.RenderConfig(width=W, height=H, primary_rays=4, shadow_rays=3, denoise_iterations=4)
    require(cfg_t.alpha_test is None and cfg_t.backend == "auto", "reference defaults changed")
    tframe = tobj_scene.camera.viewport_frame(W, H, device=dev)
    frames14 = {}
    frames14["textured_obj hybrid"] = alpha_frame(
        "textured_obj, rt.render(scene, cfg), default device and backend", "auto",
        lambda: rt.render(tobj_scene, cfg_t), 3,
        again=lambda: render_pipeline_gpu(tobj, tframe, cfg_t.replace(alpha_test=True)))
    with no_plain_cull(v7, "cull_keys", "[14] the textured_obj pallas frames"):
        frames14["textured_obj pallas"] = alpha_frame(
            "textured_obj, pallas route", "pallas",
            lambda: render_pipeline_gpu(tobj, tframe, cfg_t.replace(alpha_test=True, backend="pallas")),
            1)
    ffr = fol_scene.camera.viewport_frame(W, H, device=dev)
    cfg_f = cfg_t.replace(alpha_test=True)
    frames14["foliage hybrid"] = alpha_frame(
        "foliage_field baked, render_pipeline_gpu, hybrid route", "auto",
        lambda: render_pipeline_gpu(fol, ffr, cfg_f), 3)
    with no_plain_cull(v7, "cull_keys", "[14] the foliage pallas frames"):
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

    # ---- 21. the multi-segment occlusion kernel (B4) ---------------------------
    def frame_segments(w, h, shadow_rays):
        """The area-light shadow segments the megakernel traces for primary
        sample 0 of a w x h frame of the 100k scene: one (origins, dirs_s,
        t_lo, t_hi_s) per light triangle, recorded by a fused query that
        resolves them with the kernel."""
        got = []

        def record(o, ds, lo, hs):
            got.append((o, ds, lo, hs))
            return v8.hier_occluded_multi(gpu, cfg9, o, ds, lo, hs)

        cfg_s = cfg9.replace(width=w, height=h, primary_rays=1, shadow_rays=shadow_rays)
        be = make_backend(gpu, cfg_s)._replace(occluded_multi=record)
        with torch.inference_mode():
            render_components(gpu, scene.camera.viewport_frame(w, h, device=dev), cfg_s, 0, be)
        require(len(got) == gpu.num_light_tris, f"[21] {len(got)} fused queries recorded")
        return got

    def multi_kernel(o, ds, lo, hs, count=False):
        rays, _ = v8.pack_rays_multi(o, ds, lo, hs)
        return v8.trace_hier_multi_kernel(rays, sup, blk, hcoeff, nsup, count)

    def singles(o, ds, lo, hs, hinted=False, count=False):
        """One v8 occluded launch per sample on the same segments; hinted:
        chained as the frame chains them, each fed the previous one's
        hints."""
        outs, hints = [], None
        for d, hi in zip(ds, hs):
            out = v8_kernel(v7._pack_rays(o, d, lo, hi)[0], "occluded", None, hints, count)
            hints = out[1][:, 3:5, 0].contiguous() if hinted else None
            outs.append(out)
        return outs

    def same_flags(k, outs, what):
        for s, out in enumerate(outs):
            diff = int((k[0][:, s] != out[0][:, 0]).sum())
            require(diff == 0, f"{what}: sample {s} flags differ on {diff} rays")
        say(f"  {what}: {sum(int(out[0][:, 0].sum()) for out in outs)} occluded of "
            f"{len(outs) * outs[0][0][:, 0].numel()} sample lanes, flags equal")

    # (a) against the twin on the segments of a 320x180 frame, S = 8 and its
    # first 1, 2 and 3 samples.
    o8, ds8, lo8, hs8 = frame_segments(320, 180, 8)[0]
    multi_err = 0.0
    for n_s in (1, 2, 3, 8):
        rays, _ = v8.pack_rays_multi(o8, ds8[:n_s], lo8, hs8[:n_s])
        k = v8.trace_hier_multi_kernel(rays, sup, blk, hcoeff, nsup)
        p = v8.trace_hier_multi_plain(rays, sup, blk, hcoeff, nsup)
        diff = int((k[0][:, :n_s] != p[0][:, :n_s]).sum())
        require(diff == 0, f"[21] B4 vs its twin, 320x180, S = {n_s}: flags differ on {diff} lanes")
        multi_err = max(multi_err, float((k[0] - p[0]).abs().max()))
        say(f"  [21] B4 vs its twin, 320x180 light-0 segments, S = {n_s}: "
            f"{int(k[0][:, :n_s].sum())} occluded of {n_s * rays.shape[0] * 128} sample lanes, flags equal")

    # (b) against three single v8 launches at 1080p, S = 3.
    o, ds, lo, hs = frame_segments(W, H, 3)[0]
    inactive = float((lo > 1e30).float().mean())
    k3 = multi_kernel(o, ds, lo, hs)
    same_flags(k3, singles(o, ds, lo, hs), "[21] B4 vs three single v8 launches, 1080p, S = 3")
    same_flags(k3, singles(o, ds, lo, hs, hinted=True), "[21] B4 vs three hint-chained v8 launches")
    rays3, _ = v8.pack_rays_multi(o, ds, lo, hs)
    b4_plain_ms, p3 = once_ms(lambda: v8.trace_hier_multi_plain(rays3, sup, blk, hcoeff, nsup))
    require(torch.equal(k3[0][:, :3], p3[0][:, :3]), "[21] B4 vs its twin at 1080p: flags differ")
    # (c) a direction set whose x and z components straddle zero per ray.
    g = np.random.default_rng(21)
    active = lo < 1e30
    ds_x, hs_x = [], []
    for _ in range(3):
        dx = torch.from_numpy(np.stack([g.uniform(-0.4, 0.4, o.shape[0]), np.ones(o.shape[0]),
                                        g.uniform(-0.4, 0.4, o.shape[0])], 1).astype(np.float32)).to(dev)
        ds_x.append(dx / dx.norm(dim=1, keepdim=True))
        hx = torch.from_numpy(g.uniform(2.0, 12.0, o.shape[0]).astype(np.float32)).to(dev)
        hs_x.append(torch.where(active, hx, -3.0e38))
    kx = multi_kernel(o, ds_x, lo, hs_x)
    same_flags(kx, singles(o, ds_x, lo, hs_x), "[21] B4 vs three single launches, straddling directions")
    # (d) every ray of every fifth tile inactive: those tiles visit and pop
    # nothing, and the other tiles' flags stay the singles'.
    dead = (torch.arange(o.shape[0], device=dev) // 128) % 5 == 0
    lo_d = torch.where(dead, 3.0e38, lo)
    hs_d = [torch.where(dead, -3.0e38, h) for h in hs]
    kd = multi_kernel(o, ds, lo_d, hs_d)
    same_flags(kd, singles(o, ds, lo_d, hs_d), "[21] B4 vs three single launches, every fifth tile inactive")
    dead_t = dead.reshape(-1, 128)[:, 0]
    require(not kd[0][dead_t].any() and not kd[1][dead_t, 0:2].any(),
            "[21] B4: a tile with no active ray visited or popped")
    say(f"  [21] {int(dead_t.sum())} all-inactive tiles: no visit, no pop; the other tiles "
        f"{int(kd[1][~dead_t, 0, 0].sum())} visits")
    # (e) S = 8 at 1080p against the twin, the counting variant beside it.
    o8f, ds8f, lo8f, hs8f = frame_segments(W, H, 8)[0]
    rays8, _ = v8.pack_rays_multi(o8f, ds8f, lo8f, hs8f)
    k8 = v8.trace_hier_multi_kernel(rays8, sup, blk, hcoeff, nsup)
    p8 = v8.trace_hier_multi_plain(rays8, sup, blk, hcoeff, nsup)
    c8 = v8.trace_hier_multi_kernel(rays8, sup, blk, hcoeff, nsup, count=True)
    diff8 = int((k8[0] != p8[0]).sum())
    require(diff8 == 0, f"[21] B4 vs its twin, 1080p, S = 8: flags differ on {diff8} lanes")
    require(torch.equal(c8[0], k8[0]) and torch.equal(c8[1][:, 0:2], k8[1][:, 0:2]),
            "[21] B4, S = 8: the counting variant's results differ")
    say(f"  [21] B4 vs its twin, 1080p light-0 segments, S = 8: {int(k8[0].sum())} occluded of "
        f"{8 * rays8.shape[0] * 128} sample lanes, flags equal; counting variant equal")
    multi_err = max(multi_err, float((k8[0] - p8[0]).abs().max()))
    del p8, c8

    b4_ms, _ = median_ms(lambda: multi_kernel(o, ds, lo, hs), 10)
    one_ms, one = median_ms(lambda: singles(o, ds, lo, hs), 10)
    chain_ms, chain = median_ms(lambda: singles(o, ds, lo, hs, hinted=True), 10)
    b4c = multi_kernel(o, ds, lo, hs, count=True)
    require(torch.equal(b4c[0], k3[0]) and torch.equal(b4c[1][:, 0:2], k3[1][:, 0:2]),
            "[21] B4: the counting variant's results differ")
    hslabs, tests, fams, slabs = (int(b4c[1][:, r].sum()) for r in (4, 5, 6, 7))
    require(tests > 0 and fams > 0, "[21] B4 counted no work")
    b4_bound = bound(MULTI_TEST_OPS * tests + FAMILY_OPS * fams + HULL_SLAB_OPS * hslabs
                     + SLAB_OPS * slabs, nbytes(rays3) + h_in + (3 + 2) * rays3.shape[0] * 128 * 4)
    one_c = singles(o, ds, lo, hs, count=True)
    b4_visits = int(k3[1][:, 0, 0].sum())
    one_visits = [int(x[1][:, 1, 0].sum()) for x in one]
    chain_visits = [int(x[1][:, 1, 0].sum()) for x in chain]
    say(f"[21] 1080p light-0 segments, S = 3, {inactive:.4f} of the rays inactive: B4 {b4_ms:.3f} ms "
        f"(median of 10), three single v8 traces {one_ms:.3f} ms unhinted, {chain_ms:.3f} ms "
        f"hint-chained, B4's twin {b4_plain_ms:.3f} ms ({card})")
    say(f"[21] visits (tile sums): B4 {b4_visits}, singles unhinted {one_visits}, hint-chained "
        f"{chain_visits}; B4 sample tests {tests}, origin-family evaluations {fams}, hull slab tests "
        f"{hslabs}, per-sample slab tests {slabs}; the singles' pairs tested "
        f"{[int(x[1][:, 5].sum()) for x in one_c]}, slab tests {[int(x[1][:, 6].sum()) for x in one_c]}; "
        f"B4 bound {b4_bound[0]:.4f} ms by {b4_bound[1]}, {b4_bound[0] / b4_ms:.1%} of it")
    # Registers, spills and shared memory of each S instantiation (timed and
    # counting), from this process's ptxas report (phase 2's build).
    usage = ptxas_usage(kernels.build_log.get("trace_v8", ""))
    multi_usage = {(int(m.group(1)), m.group(2) == "1"): u for e, u in usage.items()
                   if (m := re.search(r"trace_v8_multi_kernelILi(\d+)ELb([01])E", e))}
    if kernels.build_log.get("trace_v8"):
        require(len(multi_usage) == 16, f"[21] {len(multi_usage)} B4 instantiations in the ptxas report")
        for s_ in range(1, 9):
            t_, c_ = multi_usage[(s_, False)], multi_usage[(s_, True)]
            say(f"  [21] B4 S = {s_}: {t_['registers']} registers, {t_['spill']} bytes spilled, "
                f"{t_['smem']} + {v8.multi_dynamic_smem(s_, nsup)} bytes shared (static + dynamic); "
                f"counting: {c_['registers']} registers, {c_['spill']} bytes spilled, {c_['smem']} static")
        require(all(u["spill"] == 0 for u in multi_usage.values()), "[21] a B4 instantiation spills")
    else:
        say("  [21] trace_v8 was not built in this process: no ptxas report")

    # ---- 22. the reference-default frame through the fused path --------------
    def fused(cfg_f, trace=v8.trace_blocks_hier_multi, plain=False):
        be = make_hybrid_backend(gpu, cfg_f, plain=True) if plain else make_backend(gpu, cfg_f)
        return be._replace(occluded_multi=lambda o_, ds_, lo_, hs_: v8.hier_occluded_multi(
            gpu, cfg_f, o_, ds_, lo_, hs_, trace=trace))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held22 = torch.cuda.memory_allocated()
    zero_counts()
    img22 = render_pipeline_gpu(gpu, frame, cfg9, backend=fused(cfg9))
    torch.cuda.synchronize()
    counts22 = read_counts()
    peak22 = torch.cuda.max_memory_allocated() / 2**30
    want22 = unmasked(trace_v7=0, trace_v9=cfg9.primary_rays, trace_v8=cfg9.primary_rays,
                      trace_v8_multi=cfg9.primary_rays * gpu.num_light_tris,
                      atrous_pair=cfg9.denoise_iterations)
    say(f"[22] the reference-default frame with v8's fused shadow query: launches {counts22}")
    require(counts22 == want22, f"[22] fused frame: expected launches {want22}, counted {counts22}")
    img22 = img22.cpu().numpy()
    img_def = render_pipeline_gpu(gpu, frame, cfg9).cpu().numpy()
    n_diff = int((img22 != img_def).sum())
    require(n_diff == 0, f"[22] the fused frame differs from the default frame in {n_diff} values")
    say(f"[22] fused frame bit-equal to the default frame on the same compiled scene; bit-equal to "
        f"phase 9's rt.render image: {bool(np.array_equal(img22, img9))}; peak memory {peak22:.3f} "
        f"GiB, of which {held22 / 2**30:.3f} GiB were held before")
    times22 = {"default": [], "fused": []}
    be22 = {"default": None, "fused": fused(cfg9)}
    for name in times22:
        render_pipeline_gpu(gpu, frame, cfg9, backend=be22[name])       # warm-up, discarded
    for _ in range(3):
        for name in times22:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            render_pipeline_gpu(gpu, frame, cfg9, backend=be22[name])
            b.record()
            b.synchronize()
            times22[name].append(a.elapsed_time(b))
    frame22 = {k: statistics.median(v) for k, v in times22.items()}
    say(f"[22] frame time, CUDA events, median of 3 after a warm-up, in turns: default "
        f"{frame22['default']:.2f} ms {[round(x, 2) for x in times22['default']]}, fused "
        f"{frame22['fused']:.2f} ms {[round(x, 2) for x in times22['fused']]} ({card})")
    cfg22 = cfg9.replace(width=160, height=90)
    frame22s = scene.camera.viewport_frame(160, 90, device=dev)
    img_k = render_pipeline_gpu(gpu, frame22s, cfg22, backend=fused(cfg22)).cpu().numpy()
    with torch.inference_mode():
        comp = render_components(gpu, frame22s, cfg22, 0, backend=fused(
            cfg22, trace=v8.trace_blocks_hier_multi_plain, plain=True))
        s_, u_ = comp.shadowed, comp.unshadowed
        for i in range(cfg22.denoise_iterations):
            s_, u_ = atrous_pair_iteration_plain(s_, u_, comp.normal, comp.position, i + 1, *phis6)
        img_p = ratio_combine(comp.analytic, s_, u_).cpu().numpy()
    share = image_rule(img_k, img_p, "[22] 160x90 fused frame, kernels vs plain")
    say(f"[22] 160x90 fused frame kernels vs plain: {share:.6%} of values differ by > 2e-3, "
        f"max |err| {np.abs(img_k - img_p).max()}")

    # ---- 23. the f32 FMA peak probe (B6) ----------------------------------------
    zero_counts()
    fma_ms, fma_tflops, fma_out = probes.fma_peak(dev, iters=32)
    counts23 = read_counts()
    require(counts23 == {name: (33 if name == "fma_peak" else 0) for name in counts23},
            f"[23] the probe's launches: {counts23}")
    ones = torch.ones((probes.ROWS, probes.LANES), dtype=torch.float32, device=dev)
    fma_plain_ms, fma_ref = once_ms(lambda: probes.fma_peak_plain(ones))
    torch.testing.assert_close(fma_out, fma_ref, rtol=1e-6, atol=0.0, msg=lambda m: f"[23] probe: {m}")
    xr = torch.from_numpy(g.uniform(0.5, 1.5, (probes.ROWS, probes.LANES)).astype(np.float32)).to(dev)
    fk, fp = probes.fma_peak_kernel(xr), probes.fma_peak_plain(xr)
    torch.testing.assert_close(fk, fp, rtol=1e-6, atol=0.0, msg=lambda m: f"[23] probe, random x: {m}")
    fma_err = max(float((fma_out - fma_ref).abs().max()), float((fk - fp).abs().max()))
    fma_bound = bound(probes.FLOP_PER_CALL, 2 * ones.numel() * 4)
    sass = subprocess.run([shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(kernels.build("fma_peak"))], capture_output=True, text=True, timeout=120)
    require(sass.returncode == 0, f"[23] cuobjdump failed: {sass.stderr.strip()}")
    ffma = sum(1 for line in sass.stdout.splitlines() if re.search(r"\bFFMA\b", line))
    require(ffma >= probes.CHAINS * probes.STEPS, f"[23] {ffma} FFMA in the probe's SASS, "
            f"not the {probes.CHAINS * probes.STEPS} of its chains")
    say(f"[23] FMA peak probe: {fma_ms:.5f} ms per call (mean of 32 after a warm-up), "
        f"{fma_tflops:.3f} TFLOP/s f32 FMA against the data sheet's 67 TFLOP/s; {ffma} FFMA per "
        f"thread in the SASS; twin {fma_plain_ms:.3f} ms, max |err| {fma_err}; bound "
        f"{fma_bound[0]:.5f} ms by {fma_bound[1]} ({card})")

    # ---- 24. BASELINE config 4: the wavefront path tracer ------------------------
    @contextlib.contextmanager
    def v8_calls():
        """Counts the v8 traces of the backends built while the body runs,
        by (mode, hinted): each v8 backend's trace function is wrapped where
        the routes build it (make_hier_backend, looked up at each build)."""
        calls = collections.Counter()
        make = v8.make_hier_backend

        def counting_make(gpu_, cfg_, trace=v8.trace_blocks_hier, **kw):
            def counted(*a, **k):
                calls[(a[2] if len(a) > 2 else k["mode"], k.get("hints") is not None)] += 1
                return trace(*a, **k)
            return make(gpu_, cfg_, trace=counted, **kw)

        v8.make_hier_backend = counting_make
        try:
            yield calls
        finally:
            v8.make_hier_backend = make

    cfg24 = rt.RenderConfig(width=W, height=H, primary_rays=4, shadow_rays=1, max_bounces=2,
                            denoise_iterations=0)
    require(cfg24.backend == "auto" and cfg24.jitter and cfg24.sort_bounces,
            "[24] config 4's defaults changed")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held24 = torch.cuda.memory_allocated()
    zero_counts()
    t0 = time.perf_counter()
    with v8_calls() as modes24, no_plain_cull(v9, "cull_quarter_keys", "[24] the wavefront frame"):
        img24_t = render_wavefront(gpu, frame, cfg24)
        torch.cuda.synchronize()
    wall24 = time.perf_counter() - t0
    counts24 = read_counts()
    peak24 = (torch.cuda.max_memory_allocated() - held24) / 2**30
    spp24 = cfg24.primary_rays
    want24 = unmasked(trace_v7=0, trace_v9=spp24, trace_v8=6 * spp24, atrous_pair=0)
    say(f"[24] render_wavefront, BASELINE config 4 (1920x1080, 4 spp, max_bounces=2, default "
        f"backend) on procedural_mesh(100_000, sun=True): {wall24:.2f} s wall for the first frame; "
        f"launches {counts24}; v8 calls by (mode, hinted) {dict(modes24)}")
    require(counts24 == want24, f"[24] expected launches {want24}, counted {counts24}")
    require(dict(modes24) == {("closest", False): 2 * spp24, ("occluded", False): 4 * spp24},
            f"[24] v8: expected 8 closest and 16 unhinted occluded calls, counted {dict(modes24)}")
    require(img24_t.device.type == "cuda", f"[24] rendered on {img24_t.device}")
    img24 = img24_t.cpu().numpy()
    require(img24.shape == (H, W, 3) and bool(np.isfinite(img24).all()), "[24] bad image")
    require(float(img24.std()) > 1e-3, "[24] constant image")
    # Live rays at each bounce: the closest queries' lanes with a non-empty
    # interval (a backend that counts them; the image must not change).
    live24 = []
    be24 = make_backend(gpu, cfg24)

    def counting_closest(o_, d_, lo_, hi_, common=None):
        live24.append(int((lo_ < 1e30).sum()))
        return be24.closest(o_, d_, lo_, hi_, common=common)

    img24_live = render_wavefront(gpu, frame, cfg24, backend=be24._replace(closest=counting_closest))
    require(np.array_equal(img24_live.cpu().numpy(), img24), "[24] the counting backend changed the image")
    per_bounce = [live24[b::cfg24.max_bounces + 1] for b in range(cfg24.max_bounces + 1)]
    ms24, _ = median_ms(lambda: render_wavefront(gpu, frame, cfg24), 3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof24:
        render_wavefront(gpu, frame, cfg24)
        torch.cuda.synchronize()
    busy24, _, ranges24 = range_times(prof24)
    stages24 = {k.split(".", 1)[1]: round(v[1], 3) for k, v in ranges24.items()
                if k.startswith("wavefront.")}
    say(f"[24] frame time {ms24:.2f} ms (CUDA events, median of 3 after a warm-up); peak memory "
        f"{peak24:.3f} GiB above the {held24 / 2**30:.3f} GiB held; live rays per bounce (each "
        f"sample) {per_bounce} of {W * H}; kernel ms inside each stage of one profiled frame "
        f"{stages24} (the sorts: {ranges24['wavefront.sort'][2]} calls, "
        f"{ranges24['wavefront.sort'][1]:.3f} ms); device busy {busy24:.2f} ms, idle share "
        f"{max(0.0, 1.0 - busy24 / ms24):.4f} of the unprofiled median ({card})")
    cfg24u = cfg24.replace(sort_bounces=False)
    ms24u, img24u = median_ms(lambda: render_wavefront(gpu, frame, cfg24u), 3)
    n_diff = int((img24u.cpu().numpy() != img24).sum())
    require(n_diff == 0, f"[24] the unsorted frame differs from the sorted one in {n_diff} values")
    say(f"[24] sort_bounces=False: {ms24u:.2f} ms (median of 3 after a warm-up), image bit-equal to "
        f"the sorted frame's; sorted {ms24:.2f} ms ({card})")
    # The 1M rung: bounce 0 above RESIDENT_CB goes to v7.
    big24 = scenes.procedural_mesh(1_000_000, sun=True)
    t0 = time.perf_counter()
    gbig24 = big24.compile().to(dev)
    t_big24 = time.perf_counter() - t0
    frame24b = big24.camera.viewport_frame(W, H, device=dev)
    cfg24b = cfg24.replace(primary_rays=1)
    render_wavefront(gbig24, frame24b, cfg24b)                  # warm-up, discarded
    zero_counts()
    with no_plain_cull(v7, "cull_keys", "[24] the 1M wavefront frame"):
        ms24b, img24b = once_ms(lambda: render_wavefront(gbig24, frame24b, cfg24b))
    counts24b = read_counts()
    require(counts24b == unmasked(trace_v7=1, trace_v9=0, trace_v8=6, atrous_pair=0),
            f"[24] 1M wavefront frame launches {counts24b}")
    img24b = img24b.cpu().numpy()
    require(bool(np.isfinite(img24b).all()) and float(img24b.std()) > 1e-3, "[24] 1M frame: bad image")
    say(f"[24] config 4 at 1 spp on procedural_mesh(1_000_000, sun=True) ({gbig24.num_tris} tris, "
        f"{gbig24.pallas_panels.shape[0]} blocks, host compile {t_big24:.2f} s): {ms24b:.2f} ms, one "
        f"run after a warm-up; launches {counts24b} ({card})")
    del big24, gbig24, img24b

    # ---- 25. small wavefront frames, kernels vs plain twins ----------------------
    cfg25 = cfg24.replace(width=160, height=90, primary_rays=2)
    frame25 = scene.camera.viewport_frame(160, 90, device=dev)
    for route in ("auto", "pallas"):
        c25 = cfg25.replace(backend=route)
        with no_plain_cull(v7, "cull_keys", f"[25] the 160x90 {route} wavefront frame"):
            img_k = render_wavefront(gpu, frame25, c25).cpu().numpy()
        plain = (make_hybrid_backend(gpu, c25, plain=True) if route == "auto"
                 else v7.make_v7_backend(gpu, c25, trace=v7.trace_blocks_plain))
        img_p = render_wavefront(gpu, frame25, c25, backend=plain).cpu().numpy()
        share = image_rule(img_k, img_p, f"[25] 160x90 {route} wavefront frame, kernels vs plain")
        require(float(img_k.std()) > 1e-3, f"[25] {route}: constant image")
        say(f"[25] 160x90 wavefront frame, 2 spp, 2 bounces, route {route}: kernels vs plain "
            f"{share:.6%} of values differ by > 2e-3, max |err| {np.abs(img_k - img_p).max()}")

    # ---- 26. the alpha-tested baked foliage through the wavefront ---------------
    cfg26 = cfg24.replace(primary_rays=1, alpha_test=True)
    syncs0, rounds0 = wrap_backend_with_alpha.syncs, wrap_backend_with_alpha.rounds
    zero_counts()
    t0 = time.perf_counter()
    with v8_calls() as modes26:
        img26 = render_wavefront(fol, ffr, cfg26)
        torch.cuda.synchronize()
    wall26 = time.perf_counter() - t0
    counts26 = read_counts()
    syncs26 = wrap_backend_with_alpha.syncs - syncs0
    rounds26 = wrap_backend_with_alpha.rounds - rounds0
    for name_, n_ in counts26.items():
        used = name_ in ("trace_v9_masked", "trace_v8_masked")
        require((n_ > 0) == used, f"[26] foliage wavefront: {name_} launched {n_} times")
    require(set(modes26) == {("closest", False)}, f"[26] v8 calls {dict(modes26)}: the ladder "
            "traces closest hits only")
    img26 = img26.cpu().numpy()
    require(img26.shape == (H, W, 3) and bool(np.isfinite(img26).all()), "[26] bad image")
    require(float(img26.std()) > 1e-3, "[26] constant image")
    ms26, _ = once_ms(lambda: render_wavefront(fol, ffr, cfg26))
    say(f"[26] foliage_field baked, render_wavefront, 1080p, 1 spp, 2 bounces, alpha_test=True: "
        f"{wall26:.2f} s wall for the first frame, {ms26:.2f} ms one run after it; launches "
        f"{counts26}; host syncs {syncs26}, ladder rounds run {rounds26} ({card})")
    cfg26s = cfg26.replace(width=160, height=90)
    frame26 = fol_scene.camera.viewport_frame(160, 90, device=dev)
    img_k = render_wavefront(fol, frame26, cfg26s).cpu().numpy()
    plain = wrap_backend_with_alpha(make_hybrid_backend(fol, cfg26s, plain=True), fol, cfg26s)
    img_p = render_wavefront(fol, frame26, cfg26s, backend=plain).cpu().numpy()
    share = image_rule(img_k, img_p, "[26] 160x90 alpha-tested foliage wavefront, kernels vs plain")
    say(f"[26] 160x90 alpha-tested foliage wavefront frame kernels vs plain: {share:.6%} of values "
        f"differ by > 2e-3, max |err| {np.abs(img_k - img_p).max()}")

    # ---- 27. the application loop on the card -----------------------------------
    app = Application()
    require(app.device.type == "cuda" and app.config.fast_lut
            and (app.config.width, app.config.height) == (W, H), "[27] Application defaults changed")
    t0 = time.perf_counter()
    app.compile_scene()
    t_app = time.perf_counter() - t0
    cam = app.scene.camera
    pos0, yaw0 = cam.position, cam.yaw
    gpu27 = compile_for(app.scene, app.config, dev)
    want27 = render_pipeline_gpu(gpu27, cam.viewport_frame(W, H, device=dev), app.config, 0)
    first27 = app.render_frame()
    require(torch.equal(first27, want27), "[27] the Application's first frame differs from "
            "render_pipeline_gpu's at frame index 0")
    images27 = []

    def controller(a, i):
        a.process_input(forward=1.0 if i % 2 == 0 else 0.0, strafe=0.5 if i % 3 == 0 else 0.0,
                        mouse_dx=3.0, mouse_dy=-1.5)
        if i == 4:
            a.toggle_spin()

    zero_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fps27 = app.run(8, controller=controller, on_frame=lambda i, img: images27.append(img))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    counts27 = read_counts()
    # Where torch saw a synchronizing call (the warning's caller); the
    # loop's own waits are torch.cuda.synchronize, called by application.py.
    flagged = collections.Counter(f"{w_.filename}:{w_.lineno}" for w_ in caught
                                  if "synchroniz" in str(w_.message))
    implicit = {k: n for k, n in flagged.items()
                if not re.search(r"(/application\.py|/torch/cuda/__init__\.py):\d+$", k)}
    require(len(images27) == 8 and all(im.device.type == "cuda" for im in images27),
            "[27] the loop's images are not all on the card")
    require(all(not torch.equal(a_, b_) for a_, b_ in zip(images27, images27[1:])),
            "[27] two consecutive frames are equal")
    require(cam.position != pos0 and cam.yaw != yaw0, "[27] the camera did not move")
    require(counts27 == unmasked(trace_v7=0, trace_v9=0, trace_v8=0, atrous_pair=4 * 9),
            f"[27] Application loop launches {counts27}")
    require(not implicit, f"[27] the frames synchronized with the host: {implicit}")
    say(f"[27] Application() on the card: cornell_box ({gpu27.num_tris} tris, brute force), "
        f"{W}x{H}, fast_lut=True; compile {t_app:.2f} s; run(8) with a scripted controller: "
        f"{fps27:.3f} frames per second (one warm-up frame, one device wait after it and one at the "
        f"end); launches {counts27}; synchronizing calls flagged by torch.cuda.set_sync_debug_mode "
        f"in the loop: {dict(flagged) or 'none'}; camera moved {pos0} -> {cam.position}, yaw {yaw0:.2f} -> "
        f"{cam.yaw:.2f}; first frame bit-equal to render_pipeline_gpu's ({card})")
    img27 = render_pipeline_gpu(gpu, frame, cfg9.replace(debug_traversal=True)).cpu().numpy()
    require(np.array_equal(img27, img9), "[27] debug_traversal=True changed phase 9's frame")
    say("[27] the phase-9 frame with debug_traversal=True is bit-equal to phase 9's image")
    del app, gpu27, images27

    # ---- 28. mip-mapped and anisotropic textures on the card ---------------------
    mip28 = {}
    for name, sc, g0, base_key, bake, fr in (
            ("textured_obj", tobj_scene, tobj, "textured_obj hybrid", False, tframe),
            ("foliage_field baked", fol_scene, fol, "foliage hybrid", True, ffr)):
        t0 = time.perf_counter()
        gm = sc.compile(bake_instances=bake, mip_textures=True).to(dev)
        torch.cuda.synchronize()
        t_mip = time.perf_counter() - t0
        require(gm.has_mips, f"[28] {name}: no mip chain")
        mip_bytes = nbytes(gm.tex_mip_atlas, gm.tex_mip_atlas_packed, gm.face_uv_density)
        base_img, _, base_ms, _, base_peak = frames14[base_key]   # peak above what was held
        say(f"[28] {name} compiled with mips: host {t_mip:.2f} s (phase 11 compiled it without "
            f"mips); mip leaves {mip_bytes} device bytes ({gm.mip_levels} levels of "
            f"{tuple(gm.tex_mip_atlas.shape)}); scene {scene_bytes(gm)} device bytes, without mips "
            f"{scene_bytes(g0)}")
        for taps in (1, 4):
            c28 = cfg_f.replace(mip_textures=True, aniso_taps=taps)
            out, counts, ms, syncs, peak = alpha_frame(
                f"{name}, mip_textures=True, aniso_taps={taps}", "auto",
                lambda: render_pipeline_gpu(gm, fr, c28), 3, phase="28")
            diff = np.abs(out - base_img)
            mip28[(name, taps)] = (ms, peak, float(diff.mean()), float(diff.max()))
            say(f"[28] {name}, aniso_taps={taps}: frame {ms:.2f} ms against {base_ms:.2f} ms at base "
                f"level (phase 14); peak memory above what was held {peak:.3f} GiB against "
                f"{base_peak:.3f} GiB; "
                f"difference from the base-level image: mean {diff.mean():.6f}, largest "
                f"{diff.max():.6f} ({card})")
        del gm

    # ---- 29. the A-Trous pair's backward (B5b) against its twin ------------------
    vjp_use = ptxas_usage(kernels.build_log.get("atrous_pair_vjp", ""))
    for fn_, u_ in vjp_use.items():
        say(f"[29] {fn_}: {u_['registers']} registers, {u_['spill']} spill bytes, "
            f"{u_['smem']} bytes static shared memory")
    require(vjp_use and all(u_["spill"] == 0 for u_ in vjp_use.values()),
            f"[29] the VJP kernels spill (or no ptxas report): {vjp_use}")

    def vjp_close(k_, t_, what):
        """|kernel - twin| <= 1e-5 |twin| + 1e-6 max|twin|, per gradient:
        the sums run in another order (both lie within about 5e-7 max|g|
        of a float64 twin).  Returns the largest error over max|twin|."""
        nonlocal vjp_abs
        worst = 0.0
        for name_, a_, b_ in zip(("shadowed", "unshadowed", "normal", "position"), k_, t_):
            if b_ is None:
                require(a_ is None, f"{what}: the kernel gave a {name_} gradient nobody asked for")
                continue
            sc = float(b_.abs().max())
            torch.testing.assert_close(a_, b_, rtol=1e-5, atol=1e-6 * sc,
                                       msg=lambda m: f"{what} {name_}: {m}")
            vjp_abs = max(vjp_abs, float((a_ - b_).abs().max()))
            worst = max(worst, float((a_ - b_).abs().max()) / sc)
        return worst

    vjp_err = vjp_abs = 0.0
    rng29 = np.random.default_rng(29)
    for (h_, w_) in ((180, 320), (H, W)):
        if h_ == H:
            ins29 = dn
        else:
            ins29 = [x[:h_, :w_].contiguous() for x in dn]
        g_s, g_u = (torch.from_numpy(rng29.normal(size=(h_, w_, 3)).astype(np.float32)).to(dev)
                    for _ in range(2))
        for step in range(1, 13):
            o_s, o_u, ws_ = atrous_pair_iteration_kernel(*ins29, step, *phis, weights=True)
            for geom in (True, False):
                k_ = atrous_pair_iteration_vjp_kernel(*ins29, o_s, o_u, ws_, step, *phis, g_s, g_u,
                                                      geom)
                t_ = atrous_pair_iteration_vjp_plain(*ins29, step, *phis, g_s, g_u, geom)
                vjp_err = max(vjp_err, vjp_close(k_, t_, f"[29] {w_}x{h_} step {step} geometry {geom}"))
        # The four chained iterations of the frame's denoise, under autograd.
        xs = [x.clone().requires_grad_() for x in ins29]
        fwd0, vjp0 = atrous_denoise_pair.launches, atrous_denoise_pair.vjp_launches
        torch.autograd.backward(atrous_denoise_pair(*xs, 4, *phis), (g_s, g_u))
        require(atrous_denoise_pair.launches - fwd0 == 4 and atrous_denoise_pair.vjp_launches - vjp0 == 4,
                "[29] atrous_denoise_pair under autograd did not launch 4 forwards and 4 VJPs")
        ys = [x.clone().requires_grad_() for x in ins29]
        s_, u_ = ys[0], ys[1]
        for i in range(4):
            s_, u_ = atrous_pair_iteration_plain(s_, u_, ys[2], ys[3], i + 1, *phis)
        torch.autograd.backward((s_, u_), (g_s, g_u))
        for name_, x_, y_ in zip(("shadowed", "unshadowed", "normal", "position"), xs, ys):
            sc = float(y_.grad.abs().max())
            torch.testing.assert_close(x_.grad, y_.grad, rtol=1e-5, atol=1e-5 * sc,
                                       msg=lambda m: f"[29] {w_}x{h_} 4 iterations {name_}: {m}")
        say(f"[29] B5b vs its twin at {w_}x{h_}: steps 1-12, with and without normal/position "
            f"gradients, and the 4-iteration chain under autograd agree; largest |err| / max|twin| "
            f"so far {vjp_err:.3e}")
    # At 1080p: the four iterations' VJPs of the frame's denoise (steps
    # 1-4), on the forward's outputs and weight sums.  B5's W output: the
    # images bit-equal to those without it, the sums to the twin's.
    outs29 = []
    s_, u_ = dn[0], dn[1]
    for i in range(4):
        outs29.append((s_, u_) + atrous_pair_iteration_kernel(s_, u_, dn[2], dn[3], i + 1, *phis,
                                                              weights=True))
        s_, u_ = outs29[-1][2], outs29[-1][3]
        _, _, w_plain = atrous_pair_iteration_plain(*outs29[-1][:2], dn[2], dn[3], i + 1, *phis,
                                                    weights=True)
        torch.testing.assert_close(outs29[-1][4], w_plain, rtol=1e-6, atol=0,
                                   msg=lambda m: f"[29] B5's W output, step {i + 1}: {m}")
    require(torch.equal(s_, sk) and torch.equal(u_, uk),
            "[29] B5 with its W output changed the denoised images (phase 4)")

    def vjp4(fn, geom):
        for i, (si, ui, so, uo, wo) in enumerate(outs29):
            if fn is atrous_pair_iteration_vjp_kernel:
                fn(si, ui, dn[2], dn[3], so, uo, wo, i + 1, *phis, g_s, g_u, geom)
            else:
                fn(si, ui, dn[2], dn[3], i + 1, *phis, g_s, g_u, geom)

    def denoise_w():
        s_, u_ = dn[0], dn[1]
        for i in range(4):
            s_, u_, _ = atrous_pair_iteration_kernel(s_, u_, dn[2], dn[3], i + 1, *phis,
                                                     weights=True)
        return s_, u_

    zero_counts()
    vjp_ms, _ = cuda_ms(lambda: vjp4(atrous_pair_iteration_vjp_kernel, True), 10)
    vjp_ms_colour, _ = cuda_ms(lambda: vjp4(atrous_pair_iteration_vjp_kernel, False), 10)
    vjp_plain_ms, _ = cuda_ms(lambda: vjp4(atrous_pair_iteration_vjp_plain, True), 2)
    # B5 without and with its W output, in turns.
    b5_ms = {"without W": [], "with W": []}
    for key in ("without W", "with W", "with W", "without W"):
        b5_ms[key].append(cuda_ms(lambda: denoise_with(atrous_pair_iteration_kernel)
                                  if key == "without W" else denoise_w(), 10)[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held29 = torch.cuda.memory_allocated()
    atrous_pair_iteration_vjp_plain(*dn, 1, *phis, g_s, g_u, True)
    torch.cuda.synchronize()
    twin_peak29 = (torch.cuda.max_memory_allocated() - held29) / 2**30
    taps4 = atrous_taps(H, W, 4)
    # The bound of the work of the two-pass design before this one (a
    # weight-sum pass, then a gather), per in-bounds tap: the weight pass 55
    # (the forward's 53 of distances, weights and products, two sums); the
    # gather 53 for the weights, per image 37, 21 for the normal and
    # position terms; eight (H, W, 3) images read, four written.
    old_bound = bound(taps4 * (55 + 53 + 2 * 37 + 21), 4 * H * W * 12 * (8 + 4))
    # The work this design does (csrc/atrous_pair_vjp.cu), per in-bounds tap
    # with a fused multiply-add as two operations and an exp as one: four
    # differences 12, four squared norms 20, the exponents 9, two exps and
    # kernel weights 4, per image the weight term 18 and the accumulation
    # 13, the normal and position terms 13; per pixel eight (H, W, 3) images
    # and the two weight sums read, four (two) images written.
    vjp_bound = bound(taps4 * 118, 4 * H * W * (12 * 8 + 8 + 12 * 4))
    vjp_bound_colour = bound(taps4 * 105, 4 * H * W * (12 * 8 + 8 + 12 * 2))
    b5_no_w, b5_w = statistics.mean(b5_ms["without W"]), statistics.mean(b5_ms["with W"])
    say(f"[29] B5b at {W}x{H}, the 4 iterations of the frame's denoise (steps 1-4): {vjp_ms:.3f} ms "
        f"with normal/position gradients (bound of this design's work {vjp_bound[0]:.4f} ms by "
        f"{vjp_bound[1]}; of the two-pass design's {old_bound[0]:.4f} ms by {old_bound[1]}), "
        f"{vjp_ms_colour:.3f} ms without (bound {vjp_bound_colour[0]:.4f} ms by "
        f"{vjp_bound_colour[1]}); the twin (autograd of the plain iteration) {vjp_plain_ms:.3f} ms, "
        f"its peak memory {twin_peak29:.3f} GiB for one iteration; B5's 4 iterations without its W "
        f"output {b5_no_w:.3f} ms {[round(x, 4) for x in b5_ms['without W']]}, with it {b5_w:.3f} "
        f"ms {[round(x, 4) for x in b5_ms['with W']]} (in turns: without, with, with, without) "
        f"({card})")

    # ---- 30. gradients through the kernels against the twins ----------------------
    @contextlib.contextmanager
    def twin_route():
        """The losses' backend (opt.make_backend) as the kernels' plain twins
        on the card, and the denoiser's iterations as the plain twin's
        autograd."""
        from realtimeraytracer_torch.render import pipeline as pipeline_mod

        make, pair = opt.make_backend, pipeline_mod.atrous_denoise_pair

        def plain_pair(s_, u_, n_, p_, iterations, *ph):
            for i in range(iterations):
                s_, u_ = atrous_pair_iteration_plain(s_, u_, n_, p_, i + 1, *ph)
            return s_, u_

        opt.make_backend = lambda g_, c_: make_hybrid_backend(g_, c_, plain=True)
        pipeline_mod.atrous_denoise_pair = plain_pair
        try:
            yield
        finally:
            opt.make_backend, pipeline_mod.atrous_denoise_pair = make, pair

    def loss_grads(loss_fn, names, g_, *args):
        params = {n_: getattr(g_, n_).detach().clone().requires_grad_() for n_ in names}
        val = loss_fn(params, g_, *args)
        val.backward()
        return float(val.detach()), {n_: p_.grad for n_, p_ in params.items()}

    def grads_close(k_, t_, what):
        """Gradients through the kernels against the twins': index_add_ on
        the card accumulates with atomics in another order each run, so
        rtol 1e-4 with atol 1e-5 x the leaf's largest entry."""
        worst = 0.0
        for n_, a_ in k_.items():
            b_ = t_[n_]
            require(bool(torch.isfinite(a_).all()), f"{what}: non-finite {n_} gradient")
            sc = float(b_.abs().max())
            require(sc > 0, f"{what}: the {n_} gradient is zero")
            torch.testing.assert_close(a_, b_, rtol=1e-4, atol=1e-5 * sc,
                                       msg=lambda m: f"{what} {n_}: {m}")
            worst = max(worst, float((a_ - b_).abs().max()) / sc)
        return worst

    cfg30 = rt.RenderConfig(width=320, height=180, primary_rays=1, shadow_rays=3, jitter=False)
    o30, d30 = generate_rays(frame6, 320, 180, jitter=False)
    seed30 = torch.arange(o30.shape[0], device=dev)
    target30 = torch.full_like(o30, 0.1)
    names30 = ("obj_color", "lt_intensity", "sun_intensity", "env_color", "vertices")
    zero_counts()
    loss_k, gk = loss_grads(opt.radiance_loss, names30, gpu, cfg30, o30, d30, seed30, target30)
    torch.cuda.synchronize()
    counts30 = read_counts()
    want30 = unmasked(trace_v7=0, trace_v9=1, trace_v8=gpu.num_light_tris * 3 + 1, atrous_pair=0,
                      atrous_pair_vjp=0)
    require(counts30 == want30, f"[30] radiance_loss gradient launches {counts30}, expected {want30}")
    with twin_route():
        loss_p, gp_ = loss_grads(opt.radiance_loss, names30, gpu, cfg30, o30, d30, seed30, target30)
    require(loss_k == loss_p, f"[30] radiance_loss through the kernels {loss_k!r}, twins {loss_p!r}")
    grad_err = grads_close(gk, gp_, "[30] radiance_loss on procedural_mesh(100_000)")
    say(f"[30] radiance_loss gradient at 320x180, shadow_rays=3, {names30}: kernels vs twins, loss "
        f"bit-equal ({loss_k!r}), largest |err| / max|grad| {grad_err:.3e}; launches {counts30} (no "
        f"kernel took a gradient-carrying input: each wrapper refuses one)")
    sph_scene = scenes.sphere_plane()
    # Its 2 triangles get a BVH of one-triangle leaves (and v7 panels, which
    # v9 reads in place of the SAH-repacked ones) so that the hybrid route's
    # kernels trace them.
    sph = sph_scene.compile(bvh_leaf_size=1, bvh_threshold=0, quarter_panels=False).to(dev)
    require(sph.has_bvh and sph.num_spheres > 0, "[30] sphere_plane compiled without a BVH or spheres")
    fr30 = sph_scene.camera.viewport_frame(320, 180, device=dev)
    o30s, d30s = generate_rays(fr30, 320, 180, jitter=False)
    zero_counts()
    loss_k, gk = loss_grads(opt.radiance_loss, ("sph_center", "sph_radius"), sph, cfg30, o30s, d30s,
                            seed30, target30)
    counts30s = read_counts()
    require(counts30s["trace_v9"] == 1 and counts30s["trace_v8"] > 0,
            f"[30] sphere_plane through the hybrid route: launches {counts30s}")
    with twin_route():
        loss_p, gp_ = loss_grads(opt.radiance_loss, ("sph_center", "sph_radius"), sph, cfg30, o30s,
                                 d30s, seed30, target30)
    require(loss_k == loss_p, f"[30] sphere_plane loss through the kernels {loss_k!r}, twins {loss_p!r}")
    grad_err = max(grad_err, grads_close(gk, gp_, "[30] radiance_loss on sphere_plane"))
    say(f"[30] sphere_plane (compiled with a BVH) sph_center, sph_radius: kernels vs twins, loss "
        f"bit-equal, largest |err| / max|grad| so far {grad_err:.3e}; launches {counts30s}")

    # ---- 31. BASELINE config 5 on one card ----------------------------------------
    cfg31 = rt.RenderConfig(width=W, height=H, primary_rays=1, shadow_rays=3, jitter=False)
    o31, d31 = generate_rays(frame, W, H, jitter=False)
    seed31 = torch.arange(o31.shape[0], device=dev)
    with torch.no_grad():
        target31 = shade_sample(gpu, cfg31, o31, d31, seed31, make_backend(gpu, cfg31)).analytic
    wrong = dataclasses.replace(gpu, obj_color=gpu.obj_color * 0.4 + 0.3,
                                lt_intensity=gpu.lt_intensity * 0.5)
    names31 = ("obj_color", "lt_intensity")
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    fit_params, losses31 = opt.fit(wrong, cfg31, o31, d31, seed31, target31, param_names=names31,
                                   steps=5)
    fit_s = time.perf_counter() - t0
    counts31 = read_counts()
    want31fit = unmasked(trace_v7=0, trace_v9=5, trace_v8=5 * (gpu.num_light_tris * 3 + 1),
                         atrous_pair=0, atrous_pair_vjp=0)
    require(counts31 == want31fit, f"[31] fit's launches {counts31}, expected {want31fit}")
    require(all(np.isfinite(losses31)) and losses31[-1] < losses31[0],
            f"[31] fit(loss='radiance') losses {losses31} do not fall")
    require(all(p_.device == dev for p_ in fit_params.values()), "[31] fit returned params off the card")
    say(f"[31] BASELINE config 5: fit(loss='radiance') on procedural_mesh(100_000, sun=True) at "
        f"{W}x{H}, shadow_rays=3, params {names31}, 5 steps: losses {losses31}; {fit_s:.2f} s wall "
        f"with the first step; launches {counts31}")

    def fresh_state():
        p_ = {n_: t_.detach().clone().requires_grad_()
              for n_, t_ in opt.extract_params(wrong, names31).items()}
        return opt.TrainState(p_, opt.adam(p_, 2e-2))

    state31 = fresh_state()
    mesh31 = make_ray_mesh()
    step31 = opt.make_train_step(cfg31, mesh31, state31.optimizer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held31 = torch.cuda.memory_allocated()
    step_ms, step_counts, step_syncs = [], [], []
    for i in range(5):
        zero_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                state31, loss31 = step31(state31, wrong, o31, d31, seed31, target31)
                b.record()
                loss_val = float(loss31)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
        step_counts.append(read_counts())
        step_syncs.append(collections.Counter(f"{w_.filename}:{w_.lineno}" for w_ in caught
                                              if "synchroniz" in str(w_.message)))
        require(np.isfinite(loss_val), f"[31] step {i}: loss {loss_val}")
    peak31 = (torch.cuda.max_memory_allocated() - held31) / 2**30
    want31 = unmasked(trace_v7=0, trace_v9=1, trace_v8=gpu.num_light_tris * 3 + 1, atrous_pair=0,
                      atrous_pair_vjp=0)
    require(all(c_ == want31 for c_ in step_counts), f"[31] launches per step {step_counts}")
    say(f"[31] config 5 step (make_train_step, the step fit runs): median {statistics.median(step_ms[1:]):.2f} "
        f"ms of steps 2-5 (CUDA events; all {[round(x, 2) for x in step_ms]}); peak memory "
        f"{peak31:.3f} GiB above the {held31 / 2**30:.3f} GiB held (the scene and the phases' "
        f"tensors); launches per step {step_counts[-1]}; host syncs per step (set_sync_debug_mode, "
        f"float(loss) among them): {[sum(c_.values()) for c_ in step_syncs]}, at "
        f"{dict(step_syncs[-1])} ({card})")
    # Checkpoint round trip: save at step 3, restore, and step both.
    state_a = fresh_state()
    step_a = opt.make_train_step(cfg31, mesh31, state_a.optimizer)
    for _ in range(3):
        state_a, _ = step_a(state_a, wrong, o31, d31, seed31, target31)
    ckpt_dir = str(Path(__file__).resolve().parent / "build" / "smoke_checkpoint")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    checkpoint.save_checkpoint(ckpt_dir, state_a, 3)
    require(checkpoint.latest_step(ckpt_dir) == 3, "[31] latest_step is not 3")
    state_b = checkpoint.restore_checkpoint(ckpt_dir, state_a, 3)
    require(all(p_.device == dev for p_ in state_b.params.values()), "[31] restored params off the card")
    state_a, loss_a = step_a(state_a, wrong, o31, d31, seed31, target31)
    state_b, loss_b = opt.make_train_step(cfg31, mesh31, state_b.optimizer)(
        state_b, wrong, o31, d31, seed31, target31)
    require(float(loss_a) == float(loss_b), f"[31] the restored step's loss {float(loss_b)!r} differs "
            f"from the uninterrupted {float(loss_a)!r}")
    for n_ in names31:
        torch.testing.assert_close(state_b.params[n_], state_a.params[n_], rtol=1e-5, atol=1e-7,
                                   msg=lambda m: f"[31] restored step, {n_}: {m}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    say("[31] checkpoint saved at step 3 and restored: the next step's loss equals the uninterrupted "
        "one's bit for bit, its params within rtol 1e-5 (the gradient's atomics)")

    # ---- 32. the full-frame gradients at 1080p -------------------------------------
    def timed_grad(what, loss_fn, names, g_, *args):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        params = {n_: getattr(g_, n_).detach().clone().requires_grad_() for n_ in names}
        zero_counts()
        a, m_, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        a.record()
        val = loss_fn(params, g_, *args)
        m_.record()
        val.backward()
        b.record()
        b.synchronize()
        counts = read_counts()
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        for n_, p_ in params.items():
            require(bool(torch.isfinite(p_.grad).all()) and float(p_.grad.abs().sum()) > 0,
                    f"[32] {what}: the {n_} gradient is non-finite or zero")
        first = (a.elapsed_time(m_), m_.elapsed_time(b))
        del params, val
        # Once more, the caching allocator now holding the first run's blocks.
        params = {n_: getattr(g_, n_).detach().clone().requires_grad_() for n_ in names}
        a.record()
        val = loss_fn(params, g_, *args)
        m_.record()
        val.backward()
        b.record()
        b.synchronize()
        say(f"[32] {what}: loss {float(val.detach())!r}; forward {first[0]:.2f} ms, backward "
            f"{first[1]:.2f} ms (CUDA events, first run), {a.elapsed_time(m_):.2f} and "
            f"{m_.elapsed_time(b):.2f} ms (second run); peak memory {peak:.3f} GiB above the "
            f"{held / 2**30:.3f} GiB held; launches {counts} (first run) ({card})")
        return counts

    target32 = torch.from_numpy(img9).to(dev)
    g32 = dataclasses.replace(gpu, obj_color=gpu.obj_color * 0.8)
    counts32 = timed_grad("pipeline_loss gradient at the reference defaults (1920x1080, 4 spp x 3, "
                          "4 denoise iterations; obj_color and vertices)", opt.pipeline_loss,
                          ("obj_color", "vertices"), g32, cfg9, frame, 0, target32)
    n_v8_32 = cfg9.primary_rays * (gpu.num_light_tris * cfg9.shadow_rays + 1)
    want32 = unmasked(trace_v7=0, trace_v9=cfg9.primary_rays, trace_v8=n_v8_32, atrous_pair=4,
                      atrous_pair_vjp=4)
    require(counts32 == want32, f"[32] pipeline_loss launches {counts32}, expected {want32}")
    counts32w = timed_grad("wavefront_loss gradient (1920x1080, 1 spp, max_bounces=2; obj_color and "
                           "vertices)", opt.wavefront_loss, ("obj_color", "vertices"), g32,
                           cfg24.replace(primary_rays=1), frame, 0, target32)
    require(counts32w == unmasked(trace_v7=0, trace_v9=1, trace_v8=6, atrous_pair=0, atrous_pair_vjp=0),
            f"[32] wavefront_loss launches {counts32w}")
    cfg32s = cfg9.replace(width=160, height=90)
    frame32s = scene.camera.viewport_frame(160, 90, device=dev)
    target32s = torch.zeros((90, 160, 3), device=dev)
    loss_k, gk = loss_grads(opt.pipeline_loss, ("obj_color", "vertices"), g32, cfg32s, frame32s, 0,
                            target32s)
    with twin_route():
        loss_p, gp_ = loss_grads(opt.pipeline_loss, ("obj_color", "vertices"), g32, cfg32s, frame32s,
                                 0, target32s)
    require(abs(loss_k - loss_p) <= 1e-6 * abs(loss_p), f"[32] 160x90 pipeline_loss through the kernels "
            f"{loss_k!r}, twins {loss_p!r}")
    grad_err = max(grad_err, grads_close(gk, gp_, "[32] 160x90 pipeline_loss"))
    say(f"[32] 160x90 pipeline_loss gradient (reference defaults otherwise) through the kernels and "
        f"through the twins: losses {loss_k!r} and {loss_p!r}; largest |err| / max|grad| so far "
        f"{grad_err:.3e}")

    # ---- 33. ray sharding (A7) over a one-rank NCCL process group ----------------
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port33 = sock.getsockname()[1]
    sock.close()
    initialize_multihost(backend="nccl", init_method=f"tcp://127.0.0.1:{port33}", world_size=1,
                         rank=0)
    try:
        backend33 = tdist.get_backend() if tdist.is_initialized() else None
        require(backend33 == "nccl", f"[33] no NCCL process group (backend {backend33})")
        mesh33 = make_ray_mesh()
        require(mesh33.group is not None and mesh33.size == 1 and mesh33.device == dev,
                f"[33] make_ray_mesh() under the group: {mesh33}")
        # (a) The reference-default frame: v9, v8 and B5 as in phase 9.
        zero_counts()
        img33 = render_pipeline_sharded(gpu, frame, cfg9, mesh33)
        torch.cuda.synchronize()
        counts33 = read_counts()
        require(counts33 == want9, f"[33] sharded frame launches {counts33}, expected {want9}")
        require(np.array_equal(img33.cpu().numpy(), img9),
                "[33] render_pipeline_sharded's frame differs from phase 9's")
        frame_ms33 = {"render_pipeline_gpu": [], "render_pipeline_sharded": []}
        for key in ("render_pipeline_gpu", "render_pipeline_sharded", "render_pipeline_sharded",
                    "render_pipeline_gpu"):
            fn33 = render_pipeline_gpu if key == "render_pipeline_gpu" else (
                lambda g_, f_, c_: render_pipeline_sharded(g_, f_, c_, mesh33))
            frame_ms33[key].append(median_ms(lambda: fn33(gpu, frame, cfg9), 3)[0])
        say(f"[33] render_pipeline_sharded on a one-rank NCCL mesh, reference defaults: launches "
            f"{counts33}, the image bit-equal to phase 9's; frame ms (median of 3 each, in turns) "
            f"{frame_ms33}; phase 9's {statistics.median(times9):.2f} ms ({card})")
        # (b) One wavefront sample at config 4's shapes, gathered over the mesh.
        cfg33 = cfg24.replace(primary_rays=1)
        o33, d33 = generate_rays(frame, W, H, sample_index=0, jitter=True)
        py33 = torch.arange(H, device=dev)[:, None]
        px33 = torch.arange(W, device=dev)[None, :]
        seed33 = (px33 * 733 + py33 * 1933).reshape(-1)
        with torch.inference_mode():
            zero_counts()
            wf33 = mesh33.all_gather_rows(
                wavefront_sample_sharded(gpu, cfg33, o33, d33, seed33, mesh33))
            torch.cuda.synchronize()
            counts33w = read_counts()
            wf_ref = trace_paths(gpu, cfg33, o33, d33, seed33)
        require(counts33w == unmasked(trace_v7=0, trace_v9=1, trace_v8=6, atrous_pair=0),
                f"[33] wavefront sample launches {counts33w}")
        require(torch.equal(wf33, wf_ref), "[33] wavefront_sample_sharded differs from trace_paths")
        say(f"[33] wavefront_sample_sharded at config 4's shapes (1920x1080, 2 bounces), gathered "
            f"over the mesh: bit-equal to trace_paths; launches {counts33w}")
        # (c) The slab function on four 1080p row slabs with 8-row halos.
        zero_counts()
        s33, u33 = dn[0], dn[1]
        rows33 = H // 4
        for i in range(4):
            parts = []
            for r in range(4):
                a_, b_ = max(r * rows33 - 8, 0), min((r + 1) * rows33 + 8, H)
                parts.append(atrous_pair_slab(
                    *(x[a_:b_].contiguous() for x in (s33, u33, dn[2], dn[3])), r * rows33 - a_,
                    rows33, i + 1, *phis))
            s33, u33 = torch.cat([p_[0] for p_ in parts]), torch.cat([p_[1] for p_ in parts])
        torch.cuda.synchronize()
        counts33s = read_counts()
        require(counts33s["atrous_pair"] == 16, f"[33] slab launches {counts33s}")
        require(torch.equal(s33, sk) and torch.equal(u33, uk),
                "[33] the four-slab denoise differs from the unsharded pair kernel (phase 4)")
        say(f"[33] atrous_pair_slab on four {W}x{rows33} row slabs (8-row halos), 4 iterations: "
            f"16 B5 launches, bit-equal to the unsharded kernel's 4 iterations")
        # (d) Config 5's step through make_train_step(cfg, mesh, optimizer):
        # under deterministic algorithms (the gradient's index_add_ sorted,
        # not atomic), against the group-less mesh of phase 31.
        def step33(mesh_, steps):
            st_ = fresh_state()
            fn_ = opt.make_train_step(cfg31, mesh_, st_.optimizer)
            ms_, loss_ = [], None
            for _ in range(steps):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                st_, loss_ = fn_(st_, wrong, o31, d31, seed31, target31)
                b.record()
                b.synchronize()
                ms_.append(a.elapsed_time(b))
            return st_, float(loss_), ms_

        with warnings.catch_warnings(record=True) as caught33:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                st_1, loss_1, _ = step33(mesh31, 1)
                zero_counts()
                mesh33.log.clear()
                st_n, loss_n, _ = step33(mesh33, 1)
                counts33d = read_counts()
            finally:
                torch.use_deterministic_algorithms(False)
        nondet = sorted({str(w_.message)[:120] for w_ in caught33 if "determinis" in str(w_.message)})
        require(counts33d == want31, f"[33] sharded step launches {counts33d}, expected {want31}")
        log33 = list(mesh33.log)
        require([e_["kind"] for e_ in log33] == ["all_reduce"], f"[33] the step's collectives {log33}")
        require(loss_n == loss_1, f"[33] sharded step loss {loss_n!r}, unsharded {loss_1!r}")
        for n_ in names31:
            require(torch.equal(st_n.params[n_], st_1.params[n_]),
                    f"[33] sharded step {n_} differs from the unsharded step's "
                    f"(nondeterministic ops warned: {nondet})")
        _, _, ms_n = step33(mesh33, 5)
        _, _, ms_1 = step33(mesh31, 5)
        say(f"[33] config 5's step through make_train_step(cfg, mesh, optimizer) on the one-rank "
            f"NCCL mesh: loss and params bit-equal to the group-less step's (deterministic "
            f"algorithms; warned: {nondet}); its collectives {log33}; launches {counts33d}; "
            f"median of steps 2-5 {statistics.median(ms_n[1:]):.2f} ms sharded, "
            f"{statistics.median(ms_1[1:]):.2f} ms group-less; phase 31's "
            f"{statistics.median(step_ms[1:]):.2f} ms ({card})")
    finally:
        tdist.destroy_process_group()

    # ---- 34. the native host library and the thin slice ------------------------
    # (a) The default compile went through the native SAH builder; host
    # compile seconds with it and with the NumPy LBVH (both through the
    # port, scene generation excluded); textured_obj's OBJ through each
    # tokenizer.
    require(native._lib is not None, "[34] the native host library is not loaded")

    def compiled(make, builder, **kw):
        """(host seconds, TorchScene on the host) of make().compile(**kw)
        with the BVH builder `builder`."""
        sc_, calls_ = make(), []
        with bvh_builder(native, builder, calls_):
            t_ = time.perf_counter()
            g_ = sc_.compile(**kw)
            sec_ = time.perf_counter() - t_
        require(bool(calls_) and all(calls_) if builder == "sah" else not any(calls_),
                f"[34] compile with the {builder} builder: native builds {calls_}")
        return sec_, g_

    compile34, keep34 = {}, {}
    for what, make, kw in (
            ("procedural_mesh(100_000)", lambda: scenes.procedural_mesh(100_000), {}),
            ("procedural_mesh(1_000_000)", lambda: scenes.procedural_mesh(1_000_000), {}),
            ("foliage_field() baked", scenes.foliage_field, {"bake_instances": True}),
            ("textured_obj", scenes.textured_obj, {})):
        for builder in ("sah", "numpy"):
            sec_, g_ = compiled(make, builder, **kw)
            compile34[what, builder] = sec_
            if what.startswith("procedural_mesh"):
                keep34[what, builder] = g_.to(dev)
            del g_
    with tempfile.TemporaryDirectory() as d34:
        scenes.textured_obj(d34)                  # writes the OBJ, MTL and texture files
        obj34 = str(Path(d34) / "scene.obj")
        parsed = {}
        parse34 = {}
        for allow in (True, False, True, False):
            t0 = time.perf_counter()
            parsed[allow] = obj_loader.parse_obj(obj34, allow_native=allow)
            parse34.setdefault(allow, []).append((time.perf_counter() - t0) * 1e3)
    for k_ in range(3):
        require(np.array_equal(parsed[True][k_], parsed[False][k_]),
                "[34] the two tokenizers disagree on textured_obj")
    require([(s_.name, s_.material, [tuple(map(tuple, t_)) for t_ in s_.faces])
             for s_ in parsed[True][3]] == [(s_.name, s_.material, s_.faces) for s_ in parsed[False][3]],
            "[34] the two tokenizers' shapes differ on textured_obj")
    say(f"[34] the native host library ({native.library_path(native._compiler()).name}, built in "
        f"{native_s:.2f} s in phase 2) carried every compile since phase 3; host compile seconds, "
        f"native SAH / NumPy LBVH: " + "; ".join(
            f"{w_} {compile34[w_, 'sah']:.2f} / {compile34[w_, 'numpy']:.2f}"
            for w_ in dict.fromkeys(k_[0] for k_ in compile34))
        + f"; textured_obj's OBJ parse (ms, twice each) native {[round(x, 2) for x in parse34[True]]}, "
        f"Python {[round(x, 2) for x in parse34[False]]}, the same arrays and shapes")

    # (b) The thin slice: camera ray blocks on the card, then v9 (v7 above
    # RESIDENT_CB blocks), on each block order.
    def slice_blocks(sc_, w_, h_):
        return generate_ray_blocks(sc_.camera.viewport_frame(w_, h_, device=dev), w_, h_,
                                   sample_index=0, jitter=True)

    blocks34 = slice_blocks(scene, W, H)
    blocks_cpu = generate_ray_blocks(scene.camera.viewport_frame(W, H), W, H, sample_index=0,
                                     jitter=True)
    bdiff = float((blocks34.cpu()[:, 3:6] - blocks_cpu[:, 3:6]).abs().max())
    require(blocks34.shape == (-(-W // 16) * -(-H // 8), 8, 128) and bdiff <= 2e-7
            and torch.equal(blocks34.cpu()[:, :3], blocks_cpu[:, :3])
            and torch.equal(blocks34.cpu()[:, 6:], blocks_cpu[:, 6:]),
            f"[34] ray blocks on the card against the CPU's: directions {bdiff}")
    big34 = scenes.procedural_mesh(1_000_000)
    slice34, hits34 = {}, {}
    for rung, sc_, kernel_ in (("100k", scene, "trace_v9"), ("1M", big34, "trace_v7")):
        small_ = slice_blocks(sc_, 320, 180)
        big_ = blocks34 if rung == "100k" else slice_blocks(sc_, W, H)
        for order in ("sah", "numpy"):
            g_ = keep34[f"procedural_mesh({'100_000' if rung == '100k' else '1_000_000'})", order]
            tag = f"{rung} {'SAH' if order == 'sah' else 'LBVH'}"
            k_ = trace_primary_blocks(g_, small_)
            if kernel_ == "trace_v9":
                p_, o_ = v9_twin(small_, "origin", g=g_)
            else:
                p_, o_ = v7_twin(small_, "closest", "origin", g=g_)
            err_ = compare_closest(k_, p_, f"[34] {kernel_} {tag}, 320x180 ray blocks")
            if kernel_ == "trace_v9":
                v9_err = max(v9_err, err_)
            else:
                v7_err = max(v7_err, err_)
            same_rows(k_, o_, f"[34] {kernel_} {tag} 320x180")
            zero_counts()
            trace_primary_blocks(g_, big_)
            torch.cuda.synchronize()
            c_ = read_counts()
            require(c_ == unmasked(trace_v7=int(kernel_ == "trace_v7"), trace_v9=int(kernel_ == "trace_v9"),
                                   trace_v8=0, atrous_pair=0), f"[34] thin slice {tag} launches {c_}")
            ms_, out_ = median_ms(lambda: trace_primary_blocks(g_, big_), 10)
            ts_ = big_.shape[0]
            if kernel_ == "trace_v9":
                moved_ = nbytes(big_, g_.q_cl_min, g_.q_cl_max, g_.q_panels, g_.q_group_off) + 3 * ts_ * 512
                cull_ = CULL_OPS * ts_ * g_.q_cl_min.shape[0]
            else:
                moved_ = nbytes(big_, g_.pallas_cl_min, g_.pallas_cl_max, g_.pallas_panels) + 4 * ts_ * 512
                cull_ = CULL_OPS * ts_ * g_.pallas_cl_min.shape[0]
            b_, pairs_ = trace_bound(out_[1], "origin", moved_, extra_ops=cull_)
            slice34[tag] = dict(kernel=kernel_, ms=ms_, rays_per_s=W * H / ms_ * 1e3,
                                visited=int(out_[1][:, 1, 0].sum()), pairs=pairs_, bound_ms=b_[0],
                                bound_by=b_[1], launches=c_[kernel_])
            ids_ = out_[1][:, 0].reshape(-1)
            hits34[tag] = (ids_ >= 0, out_[0][:, 0].reshape(-1),
                           g_.faces[ids_.clamp(min=0)].where((ids_ >= 0)[:, None], -1))
            say(f"[34] thin slice {tag} (generate_ray_blocks, then {kernel_}), 1080p: {ms_:.3f} ms "
                f"(median of 10 after a warm-up), {slice34[tag]['rays_per_s']:.4e} rays/s, "
                f"{slice34[tag]['visited']} {'subclusters' if kernel_ == 'trace_v9' else 'blocks'} "
                f"visited, {pairs_} pairs tested, bound {b_[0]:.4f} ms by {b_[1]}; launches {c_} ({card})")
        # The same hits on both orders: the same triangle (its vertex ids)
        # or the same t.
        (hs, ts_s, fs), (hl, ts_l, fl) = hits34[f"{rung} SAH"], hits34[f"{rung} LBVH"]
        require(bool((hs == hl).all()), f"[34] {rung}: hit masks differ on {int((hs != hl).sum())} rays")
        other = hs & (fs != fl).any(dim=1)
        require(bool((ts_s[other] == ts_l[other]).all()),
                f"[34] {rung}: another triangle at another t on {int((ts_s[other] != ts_l[other]).sum())} rays")
        say(f"[34] {rung}: both orders hit the same rays ({int(hs.sum())}), the same triangle or the "
            f"same t ({int(other.sum())} ties on another triangle)")
    del big34

    # (c) The reference-default hybrid frame on both orders, in turns.
    gpu_l = keep34["procedural_mesh(100_000)", "numpy"]
    frames34, times34 = {}, {"SAH": [], "LBVH": []}
    for tag, g_ in (("SAH", gpu), ("LBVH", gpu_l)):
        zero_counts()
        frames34[tag] = render_pipeline_gpu(g_, frame, cfg9)
        torch.cuda.synchronize()
        c_ = read_counts()
        require(c_ == want9, f"[34] {tag} hybrid frame launches {c_}, expected {want9}")
        frames34[tag] = frames34[tag].cpu().numpy()
    share34 = image_rule(frames34["SAH"], frames34["LBVH"], "[34] the hybrid frame, SAH against LBVH")
    require(np.array_equal(frames34["SAH"], img9), "[34] the SAH frame differs from phase 9's")
    for tag in ("SAH", "LBVH", "LBVH", "SAH"):
        g_ = gpu if tag == "SAH" else gpu_l
        times34[tag].append(median_ms(lambda: render_pipeline_gpu(g_, frame, cfg9), 3)[0])
    say(f"[34] reference-default hybrid frame, SAH against LBVH: {share34:.4%} of values differ by "
        f"> 2e-3 (max |err| {float(np.abs(frames34['SAH'] - frames34['LBVH']).max())}); frame ms "
        f"(median of 3 each, in turns SAH, LBVH, LBVH, SAH) {times34}; launches {want9} each ({card})")
    keep34.clear()
    del gpu_l, frames34

    # (d) The demo CLI's render of mesh100k through its entry point.
    png34 = Path(__file__).resolve().parent / "build" / "demo_mesh100k.png"
    png34.parent.mkdir(parents=True, exist_ok=True)
    _, cfg34 = demo.SCENES["mesh100k"]()
    zero_counts()
    t0 = time.perf_counter()
    img34 = demo.cmd_render("mesh100k", str(png34))
    torch.cuda.synchronize()
    wall34 = time.perf_counter() - t0
    c_ = read_counts()
    require(img34.device == dev and c_["trace_v9"] == cfg34.primary_rays and c_["trace_v8"] > 0
            and c_["atrous_pair"] == cfg34.denoise_iterations and c_["trace_v7"] == 0
            and c_ == unmasked(trace_v7=0, trace_v9=c_["trace_v9"], trace_v8=c_["trace_v8"],
                               atrous_pair=c_["atrous_pair"]),
            f"[34] demo render mesh100k launches {c_}")
    png = read_png(str(png34))
    require(png.shape == (cfg34.height, cfg34.width, 3) and float(img34.std()) > 1e-3,
            f"[34] demo render mesh100k wrote {png.shape}")
    say(f"[34] python -m realtimeraytracer_torch.demo render mesh100k {png34.name}: "
        f"{cfg34.width}x{cfg34.height}, {wall34:.2f} s wall with the compile; launches {c_}; "
        f"image mean {float(img34.mean()):.6f} ({card})")
    say("[34] " + json.dumps({"thin_slice": slice34, "host_compile_s": {
        f"{w_} {b_}": v_ for (w_, b_), v_ in compile34.items()},
        "obj_parse_ms": {"native": parse34[True], "python": parse34[False]},
        "hybrid_frame_ms": times34, "native_build_s": native_s, "card": card}))

    # ---- 35. alpha_split: two-phase alpha occlusion at 1080p ---------------
    expect_kernels["split"] = ("trace_v9_masked", "trace_v8_masked", "trace_v8")

    def first_area_segments(g_, fr_, cfg_):
        """The area-light segments a frame traces first (light triangle 0,
        shadow ray 0, primary sample 0): the first occluded call without a
        common origin or direction, captured from one primary sample."""
        seen = []
        be_ = make_backend(g_, cfg_)

        def occluded(o_, d_, lo_, hi_, common=None):
            if common is None and not seen:
                seen.append((o_, d_, lo_, hi_))
            return be_.occluded(o_, d_, lo_, hi_, common=common)

        render_components(g_, fr_, cfg_.replace(primary_rays=1), 0,
                          backend=be_._replace(occluded=occluded))
        require(len(seen) == 1, "[35] the frame traced no area-light segment")
        return seen[0]

    def bucket_evidence(g_, o_, d_, lo_, hi_, thr) -> bool:
        """Whether the segment meets, in range, a transparent triangle that
        the masks accept and an occluding one (opacity at its hit at least
        thr) within one step_past of each other: one t bucket, whose winner
        depends on the visit order (ROADMAP queue C, 't buckets')."""
        n_ = g_.num_tris
        oo, dd = o_.expand(n_, 3), d_.expand(n_, 3)
        t_, u_, v_, ok_ = ray_triangle(oo, dd, g_.bvh_tri_v0, g_.bvh_tri_v1, g_.bvh_tri_v2)
        cand = torch.nonzero(ok_ & (t_ >= lo_) & (t_ < hi_)).flatten()
        if cand.numel() < 2:
            return False
        rec_ = HitRecord(t=t_[cand], prim_id=cand.to(torch.int32), u=u_[cand], v=v_[cand])
        a_ = hit_alpha(g_, rec_, oo[cand], dd[cand])
        w_ = g_.pallas_amask[cand // 128, :, cand % 128]
        mask_ok = v7._mask_ok(torch.ones_like(cand, dtype=torch.bool)[None], u_[cand][None],
                              v_[cand][None], w_.T[None])[0]
        tt, to = t_[cand][(a_ < thr) & mask_ok], t_[cand][a_ >= thr]
        if not tt.numel() or not to.numel():
            return False
        far = torch.maximum(tt[:, None], to[None, :])
        return bool(((tt[:, None] - to[None, :]).abs() <= step_past(far) - far).any())

    def in_turns(renders: dict, rounds: int = 3) -> dict:
        """{name: (median ms, all ms)} of each render by CUDA events, in
        turns: one warm-up each, then `rounds` rounds of one frame each."""
        for fn in renders.values():
            fn()
        times = {k: [] for k in renders}
        for _ in range(rounds):
            for k, fn in renders.items():
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                b.synchronize()
                times[k].append(a.elapsed_time(b))
        return {k: (statistics.median(v), v) for k, v in times.items()}

    res35 = {}
    crop = block_permutation(W, H, device=dev)[0]             # raster pixel of each lane
    crop = torch.nonzero(((crop // W - H // 2).abs() < 90) & ((crop % W - W // 2).abs() < 160)).flatten()
    for name, g_, fr_, cfg_ in (("foliage", fol, ffr, cfg_f),
                                ("textured_obj", tobj, tframe, cfg_t.replace(alpha_test=True))):
        require(g_.has_alpha_split, f"[35] {name}: the compile built no opaque/alpha split")
        cfg_s = cfg_.replace(alpha_split=True)
        o35, d35, lo35, hi35 = first_area_segments(g_, fr_, cfg_)
        thr = cfg_.alpha_threshold
        # (a) The occlusion query: the split against the classic ladder.
        hyb = make_hybrid_backend(g_, cfg_)
        classic_ms, (occ_c, unres_c) = cuda_ms(
            lambda: occlusion_ladder(hyb, g_, cfg_, o35, d35, lo35, hi35), 3)
        split_be = wrap_backend_with_alpha(make_hybrid_backend(g_, cfg_s), g_, cfg_s)
        split_ms, occ_s = cuda_ms(lambda: split_be.occluded(o35, d35, lo35, hi35), 3)
        differ = occ_c != occ_s
        exhausted = differ & unres_c
        rest = torch.nonzero(differ & ~unres_c).flatten()
        require(rest.numel() <= 256, f"[35] {name}: {rest.numel()} segments differ from the classic "
                "ladder that resolved within its rounds")
        tied = [i for i in rest.tolist()
                if bucket_evidence(g_, o35[i], d35[i], lo35[i], hi35[i], thr)]
        odd = sorted(set(rest.tolist()) - set(tied))
        require(not odd, f"[35] {name}: {len(odd)} segments differ with no evidence (segment, "
                "classic, split): " + "; ".join(f"{i}, {bool(occ_c[i])}, {bool(occ_s[i])}"
                                                  for i in odd[:8]))
        live = int((lo35 < hi35).sum())
        say(f"[35] {name}, the frame's first light-0 segments ({live} live of {o35.shape[0]}): "
            f"classic ladder {int(occ_c.sum())} occluded, {int(unres_c.sum())} out of rounds; split "
            f"{int(occ_s.sum())} occluded; flags differ on {int(differ.sum())}: "
            f"{int(exhausted.sum())} where the classic ladder ran out of rounds, {len(tied)} with a "
            f"transparent and an occluding triangle in one t bucket, 0 otherwise; query "
            f"{classic_ms:.3f} ms classic, {split_ms:.3f} ms split ({card})")
        # (b) The split on the card against the same split on the twins, on
        # the segments of the frame's central 320x180 pixels.
        args_c = (o35[crop], d35[crop], lo35[crop], hi35[crop])
        k_ = split_be.occluded(*args_c)
        with torch.inference_mode():
            p_ = wrap_backend_with_alpha(make_hybrid_backend(g_, cfg_s, plain=True), g_, cfg_s,
                                         plain=True).occluded(*args_c)
        require(torch.equal(k_, p_), f"[35] {name}: the split's flags differ from its twins' on "
                f"{int((k_ != p_).sum())} of the 320x180 crop's segments")
        require(int((args_c[2] < args_c[3]).sum()) >= 1000 and bool(k_.any()),
                f"[35] {name}: the crop's segments are inactive or none is occluded")
        say(f"[35] {name}: the split through the kernels equals its twins on the segments of the "
            f"central 320x180 pixels ({int((args_c[2] < args_c[3]).sum())} live, {int(k_.sum())} "
            f"occluded)")
        # (c) The full frame with the split (launches, syncs, peak) and
        # phase 14's without it (the same configuration), then both timed
        # in turns; one profiled frame of each.
        rows = {"split": alpha_frame(f"{name} hybrid, alpha_split=True", "split",
                                     lambda: render_pipeline_gpu(g_, fr_, cfg_s), 1, phase="35"),
                "classic": frames14[f"{name} hybrid"]}
        turns = in_turns({"classic": lambda: render_pipeline_gpu(g_, fr_, cfg_),
                          "split": lambda: render_pipeline_gpu(g_, fr_, cfg_s)})
        for tag, c_ in (("split", cfg_s), ("classic", cfg_)):
            out_, counts_, _, syncs_, peak_ = rows[tag]
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof_:
                render_pipeline_gpu(g_, fr_, c_)
                torch.cuda.synchronize()
            _, _, ranges_ = range_times(prof_)
            rows[tag] = (out_, counts_, turns[tag], syncs_, peak_, ranges_["alpha.round"])
        share = image_rule(rows["split"][0], rows["classic"][0], f"[35] {name}: split vs classic")
        res35[name] = {tag: {"frame_ms": r_[2][0], "frame_ms_all": r_[2][1], "host_syncs": r_[3],
                             "peak_gib": round(r_[4], 3),
                             "launches": {k: v for k, v in r_[1].items() if v},
                             "alpha_round_kernel_ms": round(r_[5][1], 3),
                             "alpha_round_calls": r_[5][2]} for tag, r_ in rows.items()}
        say(f"[35] {name}: split and classic frames differ by > 2e-3 in {share:.6%} of values; "
            + json.dumps(res35[name]) + f" ({card})")
    del hyb, split_be

    # ---- 36. batch_occlusion: one trace for all of a sample's segments ----
    res36 = {}
    for name, g_, fr_, cfg_ in (("opaque", gpu, frame, cfg9), ("foliage", fol, ffr, cfg_f)):
        cfg_b = cfg_.replace(batch_occlusion=True, batch_occlusion_min_rays=0)
        comps = {b_: render_components(g_, fr_, c_, 0) for b_, c_ in ((True, cfg_b), (False, cfg_))}
        for part in ("analytic", "shadowed", "unshadowed"):
            require(torch.equal(getattr(comps[True], part), getattr(comps[False], part)),
                    f"[36] {name}: batched {part} differs from the separate traces'")
        del comps
        if name == "opaque":
            rows36 = {}
            for tag, c_ in (("separate", cfg_), ("batched", cfg_b)):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held_ = torch.cuda.memory_allocated()
                zero_counts()
                img_ = render_pipeline_gpu(g_, fr_, c_)
                torch.cuda.synchronize()
                rows36[tag] = [read_counts(), torch.cuda.max_memory_allocated() / 2**30
                               - held_ / 2**30, img_.cpu().numpy(), []]
            want36 = unmasked(trace_v7=0, trace_v9=cfg_.primary_rays, trace_v8=2 * cfg_.primary_rays,
                              atrous_pair=cfg_.denoise_iterations)
            require(rows36["batched"][0] == want36,
                    f"[36] opaque batched frame launches {rows36['batched'][0]}, expected {want36}")
            require(rows36["separate"][0] == want9, "[36] the separate frame's launches moved")
            require(np.array_equal(rows36["batched"][2], img9) and np.array_equal(rows36["separate"][2], img9),
                    "[36] the opaque frames differ from phase 9's")
            for tag in ("separate", "batched", "batched", "separate"):
                c_ = cfg_b if tag == "batched" else cfg_
                rows36[tag][3].append(median_ms(lambda: render_pipeline_gpu(g_, fr_, c_), 3)[0])
            res36[name] = {tag: {"frame_ms": r_[3], "peak_gib": round(r_[1], 3),
                                 "launches": {k: v for k, v in r_[0].items() if v}}
                           for tag, r_ in rows36.items()}
        else:
            out_, counts_, _, syncs_, peak_ = alpha_frame(
                "foliage hybrid, batch_occlusion=True", "auto",
                lambda: render_pipeline_gpu(g_, fr_, cfg_b), 1, phase="36")
            require(np.array_equal(out_, frames14["foliage hybrid"][0]),
                    "[36] foliage: the batched frame differs from phase 14's")
            turns = in_turns({"separate": lambda: render_pipeline_gpu(g_, fr_, cfg_),
                              "batched": lambda: render_pipeline_gpu(g_, fr_, cfg_b)})
            sep = res35["foliage"]["classic"]
            res36[name] = {"batched": {"frame_ms": turns["batched"][0],
                                       "frame_ms_all": turns["batched"][1], "host_syncs": syncs_,
                                       "peak_gib": round(peak_, 3),
                                       "launches": {k: v for k, v in counts_.items() if v}},
                           "separate": {"frame_ms": turns["separate"][0],
                                        "frame_ms_all": turns["separate"][1],
                                        **{k: sep[k] for k in ("host_syncs", "peak_gib", "launches")}}}
        say(f"[36] {name}: batched components bit-equal to the separate traces' (analytic, shadowed, "
            f"unshadowed), frames bit-equal; " + json.dumps(res36[name]) + f" ({card})")
    say(f"[36] opaque frame, the area-light hint chain given up by batch_occlusion: "
        f"{res36['opaque']['batched']['frame_ms']} ms batched (no area-light hints) against "
        f"{res36['opaque']['separate']['frame_ms']} ms separate (hint-chained), in turns ({card})")

    # ---- 37. the wide backend, the lane traversal, BASELINE config 3 ----
    wide_and_config3(rt=rt, torch=torch, dev=dev, card=card, W=W, H=H, scene=scene, gpu=gpu,
                     frame=frame, cfg9=cfg9, img9=img9, times9=times9, zero_counts=zero_counts,
                     read_counts=read_counts, unmasked=unmasked)

    # ---- 38. the host image decoders, frames textured by every format ----
    image_decoders(rt=rt, torch=torch, card=card, W=W, H=H, zero_counts=zero_counts,
                   read_counts=read_counts)

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
        {"name": "atrous_pair_vjp", "route": "cuda",
         "source": "realtimeraytracer_torch/csrc/atrous_pair_vjp.cu",
         "replaces": "realtimeraytracer_tpu/ops/denoise.py:46",
         "launches": counts32["atrous_pair_vjp"], "max_abs_err": vjp_abs, "ms": vjp_ms,
         "plain_ms": vjp_plain_ms, "bound_ms": vjp_bound[0], "bound_by": vjp_bound[1],
         "library_ms": None},
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
        {"name": "trace_v8_multi", "route": "cuda", "source": "realtimeraytracer_torch/csrc/trace_v8.cu",
         "replaces": "realtimeraytracer_tpu/render/hier_backend.py:985",
         "launches": counts22["trace_v8_multi"], "max_abs_err": multi_err, "ms": b4_ms,
         "plain_ms": b4_plain_ms, "bound_ms": b4_bound[0], "bound_by": b4_bound[1], "library_ms": None},
        {"name": "fma_peak", "route": "cuda", "source": "realtimeraytracer_torch/csrc/fma_peak.cu",
         "replaces": "scripts/r4_probe.py:58",
         "launches": counts23["fma_peak"], "max_abs_err": fma_err, "ms": fma_ms,
         "plain_ms": fma_plain_ms, "bound_ms": fma_bound[0], "bound_by": fma_bound[1], "library_ms": None},
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
