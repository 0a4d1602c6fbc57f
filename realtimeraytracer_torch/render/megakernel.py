"""The single-pass frame renderer: primaries, surface, lights, sun.

Counterpart of realtimeraytracer_tpu/render/megakernel.py
(``_shadow_sort_key`` as ``coherence_key``, ``shade_sample``,
``render_components``, ``render``), the re-design of the reference's ray-generation shader
(raygen.rgen:71-364).  Per pixel it traces jittered primary rays and
produces three radiance estimates — analytic direct light via LTC,
stochastic unshadowed and stochastic shadowed — plus a normal/position
G-buffer, which render/pipeline.py denoises and ratio-combines.

The whole image is one ray batch; per-ray control flow is masks.  The
shadow-hint chain of the JAX version is carried: with a backend that has
``occluded_hinted`` (v8 on the "hier" and "hybrid" routes), each light's
occlusion traces and the sun's warm-start from the previous trace's hints,
across samples and primary samples.  The alpha-tested backend
(render/alpha.py) has no hinted occlusion, so on alpha scenes the chain is
off, as in the JAX package.  The per-light shadow-ray sort is
carried for per-tile culls (v7) and skipped for per-ray culls (v8).  So is
the fused shadow branch: with a backend that has ``occluded_multi`` and
more than one shadow ray, each light triangle's samples are all drawn
first and their occlusion resolved by one call, ahead of the hint chain
(the sun keeps its hints).  No ``make_backend`` route supplies one, as in
the JAX package; a caller wires v8's with
``backend._replace(occluded_multi=...)``.

``cfg.batch_occlusion`` traces all of a primary sample's light x sample
area-shadow segments in one ``backend.occluded`` call, as the JAX package
does: on per-ray-culling backends ("hier", "hybrid"), with at least one
shadow ray, more than one segment, at least ``batch_occlusion_min_rays``
rays and at most 8 light triangles (above 8 it warns once and traces per
light, as JAX's scan path does).  Every light's samples are drawn with the
per-light loop's seeds and inactive lanes get [BIG, -BIG), so the flags
are the per-segment traces' and the frame is bit-equal.  The batched
segments leave the area-light hint chain (the sun keeps its hints); on
alpha scenes the one call is one occlusion ladder instead of lights x
samples ladders.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from realtimeraytracer_torch.config import RenderConfig
from realtimeraytracer_torch.ops import rng
from realtimeraytracer_torch.ops.camera_rays import (
    ViewportFrame, block_permutation, generate_rays)
from realtimeraytracer_torch.ops.intersect import BIG_T
from realtimeraytracer_torch.ops.ltc import fetch_ltc_params, ltc_evaluate
from realtimeraytracer_torch.ops.shading import (
    base_color_split, cook_torrance_specular, lambert_diffuse)
from realtimeraytracer_torch.ops.texture import sample_equirect
from realtimeraytracer_torch.ops.tonemap import srgb_to_linear, tonemap
from realtimeraytracer_torch.ops.vecmath import cross, dot, normalize
from realtimeraytracer_torch.render.backends import TraceBackend, make_backend
from realtimeraytracer_torch.render.surface import resolve_surface
from realtimeraytracer_torch.scene.gpu_scene import TorchScene
from realtimeraytracer_torch.utils import log

# Light triangles above which batch_occlusion is ignored (JAX: the
# unrolled light loop; a lax.scan above it).
BATCH_MAX_LIGHTS = 8
_batch_warned = False


def _warn_batch_ignored() -> None:
    """JAX's warning for batch_occlusion above BATCH_MAX_LIGHTS light
    triangles, once per process."""
    global _batch_warned
    if not _batch_warned:
        _batch_warned = True
        log.warn("batch_occlusion is ignored for scenes with more than {} light triangles; "
                 "shadow segments trace per light as usual", BATCH_MAX_LIGHTS)


def _spread(v: torch.Tensor) -> torch.Tensor:
    v = (v | (v << 8)) & 0x0100FF
    v = (v | (v << 4)) & 0x010C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def coherence_key(origin, direction, active):
    """Ray coherence key (uint32 in int64): the direction's octant in the
    high 3 bits, then a 15-bit 3D Morton code of the origin over the active
    rays' bounds; inactive lanes get 0xFFFFFFFF and sort last.  Sorted
    tiles have thin ray shafts, which is what a per-tile cull pays for.
    The JAX package's ``_shadow_sort_key`` (direction = toward the light)
    and the wavefront's ``_coherence_key`` (bounce rays) are this one
    function."""
    lo = torch.where(active[:, None], origin, 1e9).amin(dim=0)
    hi = torch.where(active[:, None], origin, -1e9).amax(dim=0)
    ext = torch.clamp_min(hi - lo, 1e-6)
    q = torch.clamp((origin - lo) / ext * 31.0, 0, 31).to(torch.int64)
    m = (_spread(q[:, 0]) << 2) | (_spread(q[:, 1]) << 1) | _spread(q[:, 2])
    oct_ = ((direction[:, 0] > 0).to(torch.int64)
            + 2 * (direction[:, 1] > 0).to(torch.int64)
            + 4 * (direction[:, 2] > 0).to(torch.int64))
    key = (oct_ << 28) | (m & 0x0FFFFFFF)
    return torch.where(active, key, 0xFFFFFFFF)


class SampleRadiance(NamedTuple):
    """Per-ray output of one primary-sample shade."""

    analytic: torch.Tensor    # (R, 3)
    shadowed: torch.Tensor    # (R, 3)
    unshadowed: torch.Tensor  # (R, 3)
    normal: torch.Tensor      # (R, 3), zero on miss/light hits
    position: torch.Tensor    # (R, 3)


def shade_sample(gpu: TorchScene, cfg: RenderConfig, origins, dirs,
                 pixel_seed, backend: TraceBackend,
                 sample_index: int = 0,
                 lod_scale: torch.Tensor | None = None,
                 hint_state: dict | None = None) -> SampleRadiance:
    """Shade one primary sample of every pixel.  pixel_seed: (R,) uint32
    values in int64 (px*733 + py*1933 + frame).  lod_scale: the pixel
    footprint per unit distance (render_components computes it when
    cfg.mip_textures is set); textures are then sampled from the mip chain.
    hint_state: the shadow-hint chain (key ("lt", i) per light triangle,
    "sun"), updated in place; None when the backend has no hinted
    occlusion."""
    R = origins.shape[0]
    # Primaries share the pinhole origin: common="origin".
    with record_function("shade.closest"):
        hit = backend.closest(origins, dirs, cfg.t_min, cfg.t_max, common="origin")
    surf = resolve_surface(gpu, hit, origins, dirs,
                           lod_scale=lod_scale if cfg.mip_textures else None,
                           aniso_taps=cfg.aniso_taps)

    # Miss: equirect HDRI environment (miss.rmiss:21-26).
    env = srgb_to_linear(sample_equirect(gpu.hdri, dirs)) * gpu.env_color
    base = (torch.where(surf.missed[:, None], env, 0.0)
            + torch.where(surf.hit_light[:, None], surf.light_color, 0.0))

    # Surface shading set-up (raygen.rgen:124-157).
    p = surf.position
    n = surf.normal
    view = normalize(origins - p)
    m_diffuse, m_specular = base_color_split(surf.albedo, surf.metallic)
    ndotv = torch.clamp(dot(n, view), 0.0, 1.0)
    minv, t2 = fetch_ltc_params(gpu.ltc1, gpu.ltc2, surf.roughness, ndotv,
                                fast=cfg.fast_lut)
    fresnel = m_specular * t2[..., 0:1] + (1.0 - m_specular) * t2[..., 1:2]
    shadow_origin = p + n * cfg.shadow_origin_offset
    lam = lambert_diffuse(surf.albedo, surf.metallic)

    num_s = cfg.shadow_rays
    use_sort = (cfg.sort_shadows and R >= cfg.sort_shadows_min_rays
                and not backend.perray_cull)
    analytic = torch.zeros_like(origins)
    shadowed = torch.zeros_like(origins)
    unshadowed = torch.zeros_like(origins)

    def light_geom(i):
        """Light triangle i's corners, unit normal, 1/pdf and the lanes it
        lights (front side or two-sided, on a valid surface)."""
        p0, p1, p2 = gpu.lt_v0[i], gpu.lt_v1[i], gpu.lt_v2[i]
        nl = cross(p2 - p1, p0 - p1)
        area = torch.sqrt(torch.clamp_min(dot(nl, nl), 0.0)) * 0.5
        inv_pdf = area * cfg.light_pdf_scale             # 1/pdf
        nlu = normalize(nl)
        front = dot(nlu[None, :], p - p0[None, :]) >= 0.0
        active = (gpu.lt_valid[i] & (gpu.lt_two_sided[i] | front)) & surf.valid
        return p0, p1, p2, nlu, inv_pdf, active

    def light_samples(i, p0, p1, p2, ps, seeds):
        """Barycentric light samples (raygen.rgen:213-219), [(dist, dir)]
        per shadow ray; seeds are decorrelated per sample, light triangle
        and primary sample."""
        samples = []
        for s in range(num_s):
            seed = (seeds + s + i * 7919 + sample_index * 15485863) & rng.MASK32
            r1 = rng.uniform(seed)
            r2 = rng.uniform(seed + 100)
            over = r1 + r2 > 1.0
            r1 = torch.where(over, 1.0 - r1, r1)
            r2 = torch.where(over, 1.0 - r2, r2)
            lpos = (p0[None, :] + r1[:, None] * (p1 - p0)[None, :]
                    + r2[:, None] * (p2 - p0)[None, :])
            delta = lpos - ps
            dist = torch.sqrt(torch.clamp_min((delta * delta).sum(-1), 1e-20))
            samples.append((dist, delta / dist[..., None]))
        return samples

    # Batched occlusion: every light's samples drawn first (the loop's
    # seeds; per-ray-culling backends skip the sort, so the rays are in
    # pixel order), all segments in one occluded call, each light's slices
    # handed to the loop below in place of its traces.
    lt_count = gpu.num_light_tris
    geoms = [light_geom(i) for i in range(lt_count)]
    batched = None
    if cfg.batch_occlusion and lt_count > BATCH_MAX_LIGHTS:
        _warn_batch_ignored()
    elif (cfg.batch_occlusion and backend.perray_cull and num_s >= 1
          and lt_count * num_s > 1 and R >= cfg.batch_occlusion_min_rays):
        with record_function("shade.batch_occlusion"):
            batched, seg_dir, seg_lo, seg_hi = [], [], [], []
            for i in range(lt_count):
                p0, p1, p2, _, _, active = geoms[i]
                samples = light_samples(i, p0, p1, p2, p, pixel_seed)
                batched.append(samples)
                for dist, sdir in samples:
                    seg_dir.append(sdir)
                    seg_lo.append(torch.where(active, cfg.t_min, BIG_T))
                    seg_hi.append(torch.where(active, dist - cfg.shadow_ray_margin, -BIG_T))
            nseg = len(seg_dir)
            occ_cat = backend.occluded(shadow_origin.repeat(nseg, 1), torch.cat(seg_dir),
                                       torch.cat(seg_lo), torch.cat(seg_hi))
            del seg_dir, seg_lo, seg_hi
            occ_cat = occ_cat.reshape(lt_count, num_s, R)

    # Per light triangle (raygen.rgen:164-285).
    with record_function("shade.lights"):
        for i in range(lt_count):
            p0, p1, p2, nlu, inv_pdf, active = geoms[i]
            lcolor, lintensity = gpu.lt_color[i], gpu.lt_intensity[i]
            ltwo = gpu.lt_two_sided[i]
            active_f = active.to(torch.float32)[:, None]

            # Shadow-ray reordering (coherence_key): one stable argsort per
            # light triangle; all samples trace and shade in sorted order and
            # the per-ray seed travels with the ray, so results equal the
            # unsorted path.
            if use_sort:
                centroid = (p0 + p1 + p2) * (1.0 / 3.0)
                key = coherence_key(shadow_origin, centroid[None, :] - p, active)
                order = torch.argsort(key, stable=True)
                inv_order = torch.argsort(order, stable=True)
                packed = torch.cat([p, n, view, lam, m_specular,
                                    surf.roughness[:, None]], dim=1)[order]
                ps, ns, views = packed[:, 0:3], packed[:, 3:6], packed[:, 6:9]
                lams, m_specs = packed[:, 9:12], packed[:, 12:15]
                roughs = packed[:, 15]
                seeds, actives = pixel_seed[order], active[order]
                sos = ps + ns * cfg.shadow_origin_offset
            else:
                ps, ns, views, lams = p, n, view, lam
                m_specs, roughs = m_specular, surf.roughness
                seeds, actives, sos = pixel_seed, active, shadow_origin

            # All samples are drawn before any is traced.
            if batched is not None:
                samples, batched[i] = batched[i], None
            else:
                samples = light_samples(i, p0, p1, p2, ps, seeds)

            # Forward shadow segments with the margin at the light end;
            # inactive lanes get the empty interval [BIG, -BIG).  The batched
            # call above, or a backend's fused shadow query, resolves all of
            # a light's samples at once.
            t_lo = torch.where(actives, cfg.t_min, BIG_T)
            t_his = [torch.where(actives, dist - cfg.shadow_ray_margin, -BIG_T)
                     for dist, _ in samples]
            occ_multi = None
            if batched is not None:
                occ_multi = occ_cat[i]
            elif backend.occluded_multi is not None and num_s > 1:
                occ_multi = backend.occluded_multi(sos, [d for _, d in samples], t_lo, t_his)

            shadowed_sum = torch.zeros_like(ps)
            unshadowed_sum = torch.zeros_like(ps)
            for s in range(num_s):
                dist, sdir = samples[s]
                if occ_multi is not None:
                    occ = occ_multi[s]
                # Shadow-hint chain: a light's samples share their tiles'
                # dominant occluders, so each trace visits the previous
                # one's first (per-ray-culling backends, which skip the
                # sort, so the ray layout is the same across traces).
                elif hint_state is not None and not use_sort:
                    occ, hint_state[("lt", i)] = backend.occluded_hinted(
                        sos, sdir, t_lo, t_his[s], hints=hint_state.get(("lt", i)))
                else:
                    occ = backend.occluded(sos, sdir, t_lo, t_his[s])
                lit = torch.where(occ, 0.0, 1.0)[:, None]

                ndotl = torch.clamp_min((ns * sdir).sum(-1), 0.1)
                spec = cook_torrance_specular(views, sdir, ns, roughs, m_specs)
                brdf = spec + lams
                atten = 1.0 / torch.clamp_min(dist * dist, 1e-20)
                radiance = (lcolor[None, :] * lintensity
                            * (ndotl * atten)[:, None] * cfg.sampled_gain)
                contrib = brdf * radiance * inv_pdf
                shadowed_sum = shadowed_sum + lit * contrib
                unshadowed_sum = unshadowed_sum + contrib
                # cfg.serialize_shadow_samples: the JAX package fences here so
                # that XLA does not overlap the alpha ladders of several
                # samples and run out of memory.  Eager PyTorch runs the
                # samples one after the other, so there is nothing to fence.
            if use_sort:
                both = torch.cat([shadowed_sum, unshadowed_sum], dim=1)[inv_order]
                shadowed_sum, unshadowed_sum = both[:, 0:3], both[:, 3:6]
            shadowed_s = shadowed_sum * (1.0 / max(num_s, 1))
            unshadowed_s = unshadowed_sum * (1.0 / max(num_s, 1))

            # Analytic LTC (raygen.rgen:277-283); None = identity Minv.
            two_b = ltwo.expand(R)
            diffuse = ltc_evaluate(n, view, p, None, p0, p1, p2, nlu, two_b,
                                   gpu.ltc2, fast=cfg.fast_lut)
            specular = ltc_evaluate(n, view, p, minv, p0, p1, p2, nlu, two_b,
                                    gpu.ltc2, fast=cfg.fast_lut)
            analytic_c = (lcolor[None, :] * lintensity
                          * (specular[:, None] * fresnel + m_diffuse * diffuse[:, None])
                          * cfg.analytic_gain)
            analytic = analytic + analytic_c * active_f
            shadowed = shadowed + shadowed_s * active_f
            unshadowed = unshadowed + unshadowed_s * active_f

    # Directional sun (raygen.rgen:288-338); lanes facing away get empty
    # segments.
    with record_function("shade.sun"):
        sun_dir = gpu.sun_direction.expand(R, 3)
        sun_ndotl_raw = dot(n, gpu.sun_direction[None, :])
        sun_active = surf.valid & (sun_ndotl_raw > 0.0) & (gpu.sun_intensity > 0.0)
        sun_args = (shadow_origin, sun_dir,
                    torch.where(sun_active, cfg.t_min, BIG_T),
                    torch.where(sun_active, cfg.t_max, -BIG_T))
        if hint_state is not None:
            sun_occ, hint_state["sun"] = backend.occluded_hinted(
                *sun_args, hints=hint_state.get("sun"), common="dir")
        else:
            sun_occ = backend.occluded(*sun_args, common="dir")
        sun_lit = torch.where(sun_occ, 0.0, 1.0)[:, None]
        sun_ndotl = torch.clamp_min(sun_ndotl_raw, 1e-4)
        # Parity quirk: NdotV clamped from below at 5.0 (raygen.rgen:322).
        sun_spec = cook_torrance_specular(view, sun_dir, n, surf.roughness,
                                          m_specular, min_ndotv=5.0, min_ndotl=1e-4)
        sun_brdf = sun_spec + lam
        sun_l = (gpu.sun_color[None, :] * gpu.sun_intensity * sun_ndotl[:, None]
                 * cfg.sun_gain)
        sun_af = sun_active.to(torch.float32)[:, None]
        analytic = analytic + sun_brdf * sun_l * sun_af
        shadowed = shadowed + sun_lit * sun_brdf * sun_l * sun_af
        unshadowed = unshadowed + sun_brdf * sun_l * sun_af

    g_mask = surf.valid.to(torch.float32)[:, None]
    return SampleRadiance(
        analytic=analytic + base,
        shadowed=shadowed + base,
        unshadowed=unshadowed + base,
        normal=n * g_mask,
        position=p * g_mask,
    )


class RenderComponents(NamedTuple):
    """Tonemapped per-pixel component images (H, W, 3) + G-buffer."""

    analytic: torch.Tensor
    shadowed: torch.Tensor
    unshadowed: torch.Tensor
    normal: torch.Tensor
    position: torch.Tensor


def render_components(gpu: TorchScene, frame: ViewportFrame, cfg: RenderConfig,
                      frame_index: int = 0,
                      backend: TraceBackend | None = None,
                      rows: tuple[int, int] | None = None) -> RenderComponents:
    """primary_rays jittered samples per pixel, averaged (raygen.rgen main,
    without the denoise/combine passes).  rows: trace only the pixel rows
    [start, stop) of the frame (a rank's slab, parallel/sharded.py), whose
    rays and seeds are the frame's; the components are then (stop - start,
    W, 3)."""
    if backend is None:
        backend = make_backend(gpu, cfg)
    h, w = cfg.height, cfg.width
    r0, r1 = rows if rows is not None else (0, h)
    dev = gpu.device
    py = torch.arange(h, dtype=torch.int64, device=dev)[:, None]
    px = torch.arange(w, dtype=torch.int64, device=dev)[None, :]
    pixel_seed = ((px * 733 + py * 1933 + int(frame_index)) & rng.MASK32).reshape(-1)
    pixel_seed = pixel_seed[r0 * w:r1 * w]

    # Coherent 2-D pixel blocks for the tile cull; undone before reshaping.
    if cfg.ray_order == "block":
        perm, inv_perm = block_permutation(w, r1 - r0, device=dev)
        pixel_seed = pixel_seed[perm]
    else:
        perm = inv_perm = None

    # Pixel angular footprint for the mip LOD: the world pixel step on the
    # viewport plane over the centre ray's distance to that plane.
    lod_scale = None
    if cfg.mip_textures:
        center = (frame.top_left + (w * 0.5) * frame.h_delta
                  + (h * 0.5) * frame.v_delta - frame.position)
        lod_scale = (torch.linalg.vector_norm(frame.h_delta)
                     / torch.clamp_min(torch.linalg.vector_norm(center), 1e-6))

    acc = None
    # Shadow-hint chain (see shade_sample), threaded through the samples.
    hint_state = {} if backend.occluded_hinted is not None else None
    for s in range(cfg.primary_rays):
        o, d = generate_rays(frame, w, h, sample_index=s, jitter=cfg.jitter)
        o, d = o[r0 * w:r1 * w], d[r0 * w:r1 * w]
        if perm is not None:
            o, d = o[perm], d[perm]
        out = shade_sample(gpu, cfg, o, d, pixel_seed, backend, sample_index=s,
                           lod_scale=lod_scale, hint_state=hint_state)
        acc = out if acc is None else SampleRadiance(*(a + b for a, b in zip(acc, out)))
    if inv_perm is not None:
        acc = SampleRadiance(*(x[inv_perm] for x in acc))

    inv = 1.0 / cfg.primary_rays

    def tm(x):
        return tonemap(x * inv, cfg.tonemap, cfg.gamma).reshape(r1 - r0, w, 3)

    return RenderComponents(
        analytic=tm(acc.analytic),
        shadowed=tm(acc.shadowed),
        unshadowed=tm(acc.unshadowed),
        normal=normalize(acc.normal * inv).reshape(r1 - r0, w, 3),
        position=(acc.position * inv).reshape(r1 - r0, w, 3),
    )


def render(scene, cfg: RenderConfig | None = None, frame_index: int = 0,
           device: str | torch.device = "cuda") -> torch.Tensor:
    """One-call render of a Scene on `device` (the GPU unless the caller
    passes device="cpu"): compile, trace, denoise, ratio-combine.  Returns
    the (H, W, 3) float32 image in [0, 1]."""
    from realtimeraytracer_torch.render.pipeline import render_pipeline

    return render_pipeline(scene, cfg, frame_index=frame_index, device=device)
