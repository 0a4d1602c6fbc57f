"""Wavefront multi-bounce path tracer.

Counterpart of realtimeraytracer_tpu/render/wavefront.py (``PathState``,
``_sample_one_light``, ``trace_paths``, ``render_wavefront``; its
``_coherence_key`` is render/megakernel.py's ``coherence_key``): the
reference's legacy recursive GGX reflection, phong.rchit:255-288, done as
a ladder of bounces.  The ray state is a flat structure of arrays
{origin, dir, throughput, radiance, alive}; every bounce traces all lanes
at once with masks instead of recursion: closest hit, emission, next-event
estimation at every vertex (one area-light sample and the sun), then a GGX
or cosine continuation ray.

Dead lanes trace the empty interval [BIG_T, -BIG_T), which every backend
treats as a miss (the kernels drop such lanes from their live lists, as
they do pad lanes, and the alpha ladder never re-traces them).  From the
first bounce on, the rays are sorted by ``coherence_key`` before the trace
(``cfg.sort_bounces``); the path state and its seed travel with the ray, so
the order changes only which rays share a tile, never a result.  Routing is
make_backend's: bounce 0 is coherent (common origin: v9, or v7 above
RESIDENT_CB blocks), later bounces and all occlusion go to v8.

The frame runs on the device of the compiled scene and the frame; nothing
moves between devices on its own.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from realtimeraytracer_torch.config import RenderConfig, check_supported
from realtimeraytracer_torch.ops import rng
from realtimeraytracer_torch.ops.camera_rays import ViewportFrame, generate_rays
from realtimeraytracer_torch.ops.intersect import BIG_T
from realtimeraytracer_torch.ops.shading import (
    base_color_split, cook_torrance_specular, cosine_hemisphere, lambert_diffuse, sample_ggx)
from realtimeraytracer_torch.ops.texture import sample_equirect
from realtimeraytracer_torch.ops.tonemap import srgb_to_linear, tonemap
from realtimeraytracer_torch.ops.vecmath import cross, dot, normalize
from realtimeraytracer_torch.render.backends import TraceBackend, make_backend
from realtimeraytracer_torch.render.megakernel import coherence_key
from realtimeraytracer_torch.render.surface import resolve_surface, rows
from realtimeraytracer_torch.scene.gpu_scene import TorchScene


class PathState(NamedTuple):
    origins: torch.Tensor     # (R, 3)
    dirs: torch.Tensor        # (R, 3)
    throughput: torch.Tensor  # (R, 3)
    radiance: torch.Tensor    # (R, 3)
    alive: torch.Tensor       # (R,) bool


def _interval(live: torch.Tensor, t_lo, t_hi):
    """Per-ray [t_lo, t_hi) on live lanes, the empty [BIG_T, -BIG_T) on the
    others."""
    return torch.where(live, t_lo, BIG_T), torch.where(live, t_hi, -BIG_T)


def _sample_one_light(gpu: TorchScene, cfg: RenderConfig, backend: TraceBackend,
                      p, n, view, albedo, rough, metal, seed, live=None):
    """Next-event estimation: one uniform sample on one uniformly chosen
    light triangle, plus the directional sun.  seed: (R,) uint32 values in
    int64.  live: lanes whose contribution is used; the others trace empty
    intervals."""
    R = p.shape[0]
    if live is None:
        live = torch.ones(R, dtype=torch.bool, device=p.device)
    lt = gpu.num_light_tris
    lam = lambert_diffuse(albedo, metal)
    _, f0 = base_color_split(albedo, metal)

    # One light triangle per ray (an unsigned modulo of the hash).
    li = rng.hash_u32(seed + 7777) % lt
    p0, p1, p2 = rows(gpu.lt_v0, li), rows(gpu.lt_v1, li), rows(gpu.lt_v2, li)
    lcol = rows(gpu.lt_color, li)
    lint = rows(gpu.lt_intensity, li)[:, None]
    valid_l = gpu.lt_valid[li]
    two = gpu.lt_two_sided[li]

    r1 = rng.uniform(seed + 31)
    r2 = rng.uniform(seed + 131)
    over = r1 + r2 > 1.0
    r1 = torch.where(over, 1.0 - r1, r1)
    r2 = torch.where(over, 1.0 - r2, r2)
    lpos = p0 + r1[:, None] * (p1 - p0) + r2[:, None] * (p2 - p0)

    nl = cross(p2 - p1, p0 - p1)
    area = torch.sqrt(torch.clamp_min(dot(nl, nl), 1e-20)) * 0.5
    nlu = normalize(nl)
    front = dot(nlu, p - p0) >= 0.0
    active = valid_l & (two | front)

    delta = lpos - p
    dist = torch.sqrt(torch.clamp_min(dot(delta, delta), 1e-20))
    ldir = delta / dist[:, None]
    so = p + n * cfg.shadow_origin_offset
    with record_function("wavefront.nee_occluded"):
        occ = backend.occluded(so, ldir, *_interval(live, cfg.t_min,
                                                    dist - cfg.shadow_ray_margin))

    ndotl = torch.clamp_min(dot(n, ldir), 0.0)
    cos_on_light = torch.abs(dot(nlu, -ldir))
    # Solid-angle conversion of the area pdf 1 / (area * light triangles).
    pdf_sa = (dist * dist) / torch.clamp_min(area * lt * cos_on_light, 1e-8)
    spec = cook_torrance_specular(view, ldir, n, rough, f0, min_ndotv=1e-3, min_ndotl=1e-3)
    radiance = lcol * lint * cfg.sampled_gain
    contrib = (spec + lam) * radiance * (ndotl / torch.clamp_min(pdf_sa, 1e-8))[:, None]
    contrib = torch.where((active & ~occ & (ndotl > 0))[:, None], contrib, 0.0)

    # The sun (a delta light).
    sun_dir = gpu.sun_direction.expand(R, 3)
    sun_nl = dot(n, gpu.sun_direction[None, :])
    with record_function("wavefront.nee_occluded"):
        sun_occ = backend.occluded(so, sun_dir, *_interval(live, cfg.t_min, cfg.t_max),
                                   common="dir")
    sun_spec = cook_torrance_specular(view, sun_dir, n, rough, f0, min_ndotv=1e-3, min_ndotl=1e-3)
    sun_c = ((sun_spec + lam) * gpu.sun_color[None, :] * gpu.sun_intensity
             * cfg.sun_gain * torch.clamp_min(sun_nl, 0.0)[:, None])
    return contrib + torch.where(
        ((sun_nl > 0) & ~sun_occ)[:, None] & (gpu.sun_intensity > 0), sun_c, 0.0)


def trace_paths(gpu: TorchScene, cfg: RenderConfig, origins: torch.Tensor,
                dirs: torch.Tensor, pixel_seed: torch.Tensor,
                backend: TraceBackend | None = None,
                sample_index: int = 0) -> torch.Tensor:
    """Trace one sample of full paths; returns each ray's linear radiance
    (R, 3), in the input order.  pixel_seed: (R,) uint32 values in int64."""
    if backend is None:
        backend = make_backend(gpu, cfg)
    R = origins.shape[0]
    state = PathState(origins=origins, dirs=dirs,
                      throughput=torch.ones_like(origins),
                      radiance=torch.zeros_like(origins),
                      alive=torch.ones(R, dtype=torch.bool, device=origins.device))
    # The logical pixel of each lane: sorting permutes the whole path
    # state, its seed included, and the result is scattered back by it.
    pix = torch.arange(R, device=origins.device)
    seeds = pixel_seed
    sorted_ = False

    for bounce in range(cfg.max_bounces + 1):
        if cfg.sort_bounces and bounce >= 1:
            with record_function("wavefront.sort"):
                order = torch.argsort(coherence_key(state.origins, state.dirs, state.alive),
                                      stable=True)
                state = PathState(*(x[order] for x in state))
                pix = pix[order]
                seeds = seeds[order]
                sorted_ = True
        bseed = (seeds + bounce * 9176 + sample_index * 15485863) & rng.MASK32
        # Bounce 0 keeps the pinhole's common origin.
        with record_function("wavefront.closest"):
            hit = backend.closest(state.origins, state.dirs,
                                  *_interval(state.alive, cfg.t_min, cfg.t_max),
                                  common="origin" if bounce == 0 else None)
        with record_function("wavefront.shade"):
            surf = resolve_surface(gpu, hit, state.origins, state.dirs)
            env = srgb_to_linear(sample_equirect(gpu.hdri, state.dirs)) * gpu.env_color
            emit = (torch.where(surf.missed[:, None], env, 0.0)
                    + torch.where(surf.hit_light[:, None], surf.light_color, 0.0))
            radiance = state.radiance + torch.where(state.alive[:, None],
                                                    state.throughput * emit, 0.0)
            still = state.alive & surf.valid
        if bounce == cfg.max_bounces:
            state = state._replace(radiance=radiance)
            break

        view = -state.dirs
        nee = _sample_one_light(gpu, cfg, backend, surf.position, surf.normal, view,
                                surf.albedo, surf.roughness, surf.metallic, bseed, live=still)
        with record_function("wavefront.shade"):
            radiance = radiance + torch.where(still[:, None], state.throughput * nee, 0.0)

            # Continuation: the specular (GGX) or the diffuse (cosine) lobe.
            _, f0 = base_color_split(surf.albedo, surf.metallic)
            p_spec = torch.clamp(surf.metallic + (1.0 - surf.roughness) * 0.5, 0.05, 0.95)
            u_lobe = rng.uniform(bseed + 555)
            r1 = rng.uniform(bseed + 667)
            r2 = rng.uniform(bseed + 787)
            d_spec = sample_ggx(surf.normal, view, torch.clamp_min(surf.roughness, 0.03), r1, r2)
            d_diff = cosine_hemisphere(surf.normal, r1, r2)
            choose_spec = u_lobe < p_spec
            new_dir = normalize(torch.where(choose_spec[:, None], d_spec, d_diff))
            going_up = dot(surf.normal, new_dir) > 1e-4
            # The reference's throughput model (phong.rchit:255-288): F0 on
            # specular bounces, the albedo on diffuse ones.
            weight = torch.where(
                choose_spec[:, None],
                f0 / torch.clamp_min(p_spec, 1e-3)[:, None],
                surf.albedo * (1.0 - surf.metallic[:, None])
                / torch.clamp_min(1.0 - p_spec, 1e-3)[:, None])
            state = PathState(
                origins=surf.position + surf.normal * cfg.shadow_origin_offset,
                dirs=new_dir,
                throughput=state.throughput * torch.where(still[:, None], weight, 1.0),
                radiance=radiance,
                alive=still & going_up)
    if not sorted_:
        return state.radiance
    out = torch.empty_like(state.radiance)
    out[pix] = state.radiance
    return out


def wavefront_frame(gpu: TorchScene, frame: ViewportFrame, cfg: RenderConfig,
                    frame_index: int = 0,
                    backend: TraceBackend | None = None) -> torch.Tensor:
    """render_wavefront's body, differentiable: gradients reach the
    scene's leaves through the NEE and GGX estimator (bounce directions
    and hit ids are detached, the continuous shading recompute is not), as
    diff/optimize.py's wavefront_loss takes them."""
    check_supported(cfg)
    if frame.position.device != gpu.device:
        raise ValueError(f"the frame is on {frame.position.device} and the scene on "
                         f"{gpu.device}: build the frame on the scene's device")
    h, w = cfg.height, cfg.width
    dev = gpu.device
    py = torch.arange(h, dtype=torch.int64, device=dev)[:, None]
    px = torch.arange(w, dtype=torch.int64, device=dev)[None, :]
    pixel_seed = ((px * 733 + py * 1933 + int(frame_index)) & rng.MASK32).reshape(-1)
    if backend is None:
        backend = make_backend(gpu, cfg)
    acc = torch.zeros((h * w, 3), dtype=torch.float32, device=dev)
    for s in range(cfg.primary_rays):
        o, d = generate_rays(frame, w, h, sample_index=s, jitter=cfg.jitter)
        acc = acc + trace_paths(gpu, cfg, o, d, pixel_seed, backend, s)
    return tonemap(acc / cfg.primary_rays, cfg.tonemap, cfg.gamma).reshape(h, w, 3)


def render_wavefront(gpu: TorchScene, frame: ViewportFrame, cfg: RenderConfig,
                     frame_index: int = 0,
                     backend: TraceBackend | None = None) -> torch.Tensor:
    """Multi-bounce render of a compiled scene: the tonemapped (H, W, 3)
    float32 image on the scene's device, under inference mode.  The frame
    must lie on that device too."""
    with torch.inference_mode():
        return wavefront_frame(gpu, frame, cfg, frame_index, backend)
