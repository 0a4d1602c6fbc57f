"""Render configuration.

Counterpart of realtimeraytracer_tpu/config.py: the same fields, defaults
and backend strings, so one set of knobs drives both packages.  The port
renders the ratio-estimator frame with the "hybrid" route (v9 and v8
traversal, CUDA kernels), "pallas" (v7), "quarter" (v9 closest, v7
occlusion), "hier" (v8), "wide" (plain torch cluster culling under the
``max_cluster_visits`` cap, with its ``cluster_size`` and ``wide_tile``)
or "brute", alpha-tested or not (with the opaque/alpha split of
``alpha_split`` or the classic ladder), with one occlusion trace for all
of a sample's area-light segments (``batch_occlusion``) or one per
segment, with mip-mapped and anisotropic textures or not, denoised by the
pair denoiser or, with ``use_pallas_denoise=False``, the per-image
stencil, and the wavefront multi-bounce frame (render/wavefront.py:
max_bounces, sort_bounces).  ``max_traversal_steps`` caps the attic's
lane traversal (render/attic/), which the traversal diagnostics run.  The
attic packet backend's two fields raise when set (``check_supported``):
with ``dtype`` other than float32 they are the only JAX options the port
refuses (ROADMAP queue A).  ``tile_rays`` is accepted and read by no code,
as in the JAX package, whose only reader is a docstring (ROADMAP queue C).
"""

from __future__ import annotations

import dataclasses

# Fields of the JAX RenderConfig that no code of this port reads, and why
# (ROADMAP.md queue A, 'Not to port').  check_supported raises when one is
# set away from its default, so that no setting is dropped silently.
_PACKET = ("it belongs to the JAX package's attic packet backend, which its "
           "make_backend refuses and nothing of that package runs")
UNPORTED_FIELDS = {
    "packet_size": _PACKET,
    "traversal_unroll": _PACKET,
}


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All render-time knobs (see the JAX package's RenderConfig for the
    reference-source notes on each)."""

    width: int = 1920
    height: int = 1080

    primary_rays: int = 4
    jitter: bool = True
    shadow_rays: int = 3
    # Path depth of the wavefront frame (render/wavefront.py); the
    # ratio-estimator frame of render_pipeline traces one surface and
    # ignores it, as in the JAX package.
    max_bounces: int = 1

    t_min: float = 1e-3
    t_max: float = 1e4
    shadow_ray_margin: float = 0.5
    shadow_origin_offset: float = 0.01

    denoise_iterations: int = 4
    denoise_c_phi: float = 1.0
    denoise_n_phi: float = 0.001
    denoise_p_phi: float = 0.001

    # An XLA scheduling fence between the alpha ladder's shadow samples in
    # the JAX package.  PyTorch runs the samples eagerly, one after the
    # other, so there is nothing to fence: the port reads the field and
    # every value renders the same frame.
    serialize_shadow_samples: bool | None = None

    tonemap: str = "aces"
    gamma: float = 2.2

    fast_lut: bool = False

    light_pdf_scale: float = 0.7
    analytic_gain: float = 5.0
    sampled_gain: float = 10.0
    sun_gain: float = 20.0

    use_bvh: bool = True
    bvh_leaf_size: int = 4
    max_traversal_steps: int = 16384
    alpha_test: bool | None = None
    alpha_rounds: int = 4
    alpha_threshold: float = 0.9
    # Two-phase alpha occlusion (render/alpha.py): the raw occluded trace
    # on the opaque triangles, then the ladder on the alpha-mapped ones
    # for the rays still unresolved.  Per-ray-culling routes only, on
    # scenes whose compile built the split (not instanced).
    alpha_split: bool = False

    # "auto" resolves to "hybrid" (v9 coherent closest, v8 occlusion and
    # incoherent closest) when the scene has a BVH and use_bvh is set, else
    # "brute".
    backend: str = "auto"
    packet_size: int = 64
    traversal_unroll: int = 8
    cluster_size: int = 256
    wide_tile: int = 128
    max_cluster_visits: int = 64
    ray_order: str = "block"
    # Traversal diagnostics (render/diagnostics.py): the "wide" backend
    # traces with its cap statistics and warns when the cap clips; the
    # exact backends pass through unchanged.
    debug_traversal: bool = False

    # Read by no code of either package (ROADMAP queue C).
    tile_rays: int = 8192
    # Sort the wavefront's bounce rays by coherence_key before each trace;
    # the image is the same either way (each ray's seed travels with it).
    sort_bounces: bool = True

    sort_shadows: bool = True
    sort_shadows_min_rays: int = 65536

    # One occlusion trace for all of a primary sample's light x sample
    # area-shadow segments (render/megakernel.py), on per-ray-culling
    # routes, at least batch_occlusion_min_rays rays and at most 8 light
    # triangles; the segments leave the hint chain.
    batch_occlusion: bool = False
    batch_occlusion_min_rays: int = 65536

    # None and True denoise with the pair denoiser (the CUDA kernel on CUDA
    # tensors, its plain twin on CPU tensors); False with the per-image
    # stencil (ops/denoise.py::atrous_denoise), the JAX package's XLA one.
    use_pallas_denoise: bool | None = None

    # Trilinear textures from the mip chain at the footprint's LOD, and
    # with aniso_taps > 1 that many taps along its major axis (not on
    # instanced scenes).  render_pipeline compiles the chain only when set.
    mip_textures: bool = False
    aniso_taps: int = 1

    dtype: str = "float32"

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


def check_supported(cfg: RenderConfig) -> None:
    """Raise for settings whose code paths are not ported yet, so that a
    frame never renders silently without them."""
    defaults = {f.name: f.default for f in dataclasses.fields(RenderConfig)}
    for name, home in UNPORTED_FIELDS.items():
        value = getattr(cfg, name)
        if value != defaults[name]:
            raise NotImplementedError(
                f"RenderConfig.{name}={value!r} has no code path in the "
                f"port: {home}")
    if cfg.dtype != "float32":
        raise ValueError(f"only float32 rendering exists, got {cfg.dtype!r}")
