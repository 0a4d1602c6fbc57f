"""Sharded rendering: a frame's rays and pixel rows split over the ray mesh.

Counterpart of realtimeraytracer_tpu/parallel/sharded.py (``sharded_shade``,
``wavefront_sample_sharded``, ``render_components_sharded``,
``render_pipeline_sharded``).  Each rank of the mesh (parallel/mesh.py)
shades a contiguous slab of the frame's rays against its replicated copy
of the scene, through its own backend (render/backends.py::make_backend).
The functions that return ray slabs return this rank's slab, where JAX
returns a global array sharded over the mesh; ``mesh.all_gather_rows``
joins them.  The frame denoises its row slabs with the halo exchange
(ops/denoise.py::atrous_denoise_sharded_rows) and ratio-combines each
slab; its one full-size collective is the final gather of image rows,
which returns the (H, W, 3) image on every rank.

A slab is rows of the frame: the port shards whole pixel rows (H divides
over the ranks), where JAX needs only H x W to divide, because the
denoise and the tile cull's pixel blocks (render_components' ray order)
work on rows.  Within a rank the frame is render_components' own on the
slab's rows (pixel blocks, the shadow-hint chain, the mip footprint),
so a one-rank mesh renders render_pipeline_gpu's frame bit for bit.
"""

from __future__ import annotations

import torch

from realtimeraytracer_torch.config import RenderConfig, check_supported
from realtimeraytracer_torch.ops.camera_rays import ViewportFrame
from realtimeraytracer_torch.ops.denoise import atrous_denoise_sharded_rows, ratio_combine
from realtimeraytracer_torch.parallel.mesh import RayMesh
from realtimeraytracer_torch.render.backends import make_backend
from realtimeraytracer_torch.render.megakernel import (
    RenderComponents, SampleRadiance, render_components, shade_sample)
from realtimeraytracer_torch.render.pipeline import denoise_and_combine
from realtimeraytracer_torch.render.wavefront import trace_paths
from realtimeraytracer_torch.scene.gpu_scene import TorchScene


def sharded_shade(gpu: TorchScene, cfg: RenderConfig, origins: torch.Tensor,
                  dirs: torch.Tensor, pixel_seed: torch.Tensor, mesh: RayMesh,
                  sample_index: int = 0) -> SampleRadiance:
    """One primary sample of the (R, 3) rays (R divisible by the mesh
    size), scene replicated: this rank's slab of R / n rays."""
    a, b = mesh.slab(origins.shape[0])
    return shade_sample(gpu, cfg, origins[a:b], dirs[a:b], pixel_seed[a:b],
                        make_backend(gpu, cfg), sample_index=sample_index)


def wavefront_sample_sharded(gpu: TorchScene, cfg: RenderConfig, origins: torch.Tensor,
                             dirs: torch.Tensor, pixel_seed: torch.Tensor, mesh: RayMesh,
                             sample_index: int = 0) -> torch.Tensor:
    """One multi-bounce wavefront sample (render/wavefront.py::trace_paths)
    of the (R, 3) rays, R divisible by the mesh size: this rank's (R / n,
    3) linear radiance.  Each rank runs the whole bounce loop on its rays,
    its coherence sorts included: a sort is a permutation of the slab's
    paths, which are independent and carry their seeds, so the rank count
    never changes a result."""
    a, b = mesh.slab(origins.shape[0])
    return trace_paths(gpu, cfg, origins[a:b], dirs[a:b], pixel_seed[a:b],
                       make_backend(gpu, cfg), sample_index)


def render_components_sharded(gpu: TorchScene, frame: ViewportFrame, cfg: RenderConfig,
                              mesh: RayMesh, frame_index: int = 0) -> RenderComponents:
    """render_components on this rank's pixel rows: the frame's pixel
    seeds (px 733 + py 1933 + frame_index) and rays, sliced to the slab;
    each component (H / n, W, 3).  H must divide over the mesh."""
    h, n = cfg.height, mesh.size
    if h % n:
        raise ValueError(f"{h} rows not divisible by {n} ranks; pick a resolution that tiles "
                         "over the mesh (the port shards whole pixel rows)")
    return render_components(gpu, frame, cfg, frame_index, rows=mesh.slab(h, "rows"))


def render_pipeline_sharded(gpu: TorchScene, frame: ViewportFrame, cfg: RenderConfig,
                            mesh: RayMesh, frame_index: int = 0) -> torch.Tensor:
    """The frame over the mesh: sharded trace, then the ROW-SHARDED
    denoise (a 2 * iterations-row halo exchange per A-Trous iteration) and
    ratio combine on each rank's slab, then one gather of the image rows.
    Returns the (H, W, 3) image on every rank, under inference mode.  One
    rank denoises and combines its whole frame (render/pipeline.py::
    denoise_and_combine), as JAX's one-device mesh does."""
    check_supported(cfg)
    it, n = cfg.denoise_iterations, mesh.size
    if n > 1 and it > 0 and (cfg.height % n or cfg.height // n < 2 * it):
        raise ValueError(
            f"height {cfg.height} must divide over {n} devices with >= {2 * it} rows per "
            "device (the halo comes from a single ring neighbor)")
    with torch.inference_mode():
        comp = render_components_sharded(gpu, frame, cfg, mesh, frame_index)
        if n == 1:
            return denoise_and_combine(comp, cfg)
        s, u = comp.shadowed, comp.unshadowed
        if it > 0:
            s, u = atrous_denoise_sharded_rows(s, u, comp.normal, comp.position, mesh, it,
                                               cfg.denoise_c_phi, cfg.denoise_n_phi,
                                               cfg.denoise_p_phi)
        return mesh.all_gather_rows(ratio_combine(comp.analytic, s, u))
