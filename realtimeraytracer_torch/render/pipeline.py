"""Full frame pipeline: trace -> A-Trous denoise x N -> ratio combine.

Counterpart of realtimeraytracer_tpu/render/pipeline.py
(``denoise_and_combine``, ``render_pipeline_gpu``, ``render_pipeline``;
reference app/application.cppm:352-480).  PyTorch runs eagerly, so there is
no jit: the frame is a sequence of kernel launches on the scene's device.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from realtimeraytracer_torch.config import RenderConfig, check_supported
from realtimeraytracer_torch.ops.camera_rays import ViewportFrame
from realtimeraytracer_torch.ops.denoise import atrous_denoise, ratio_combine
from realtimeraytracer_torch.ops.denoise_kernel import atrous_denoise_pair
from realtimeraytracer_torch.render.backends import TraceBackend
from realtimeraytracer_torch.render.megakernel import (
    RenderComponents, render_components)
from realtimeraytracer_torch.scene.gpu_scene import TorchScene


def denoise_and_combine(comp: RenderComponents, cfg: RenderConfig) -> torch.Tensor:
    """Denoise the stochastic pair, then ratio-combine with the analytic.

    By default (cfg.use_pallas_denoise None or True) the fused pair
    denoiser (ops/denoise_kernel.py): the CUDA kernel on CUDA tensors, at
    any iteration count, and its plain twin on CPU tensors.
    Differentiable: under a gradient each iteration's backward is the VJP
    kernel (its twin's autograd on CPU tensors), where the JAX package
    switches to its per-image XLA stencil.  use_pallas_denoise=False
    selects that stencil by name, as in the JAX package: plain torch
    (ops/denoise.py::atrous_denoise) on each stochastic image."""
    it = cfg.denoise_iterations
    if it <= 0:
        return ratio_combine(comp.analytic, comp.shadowed, comp.unshadowed)
    phis = (cfg.denoise_c_phi, cfg.denoise_n_phi, cfg.denoise_p_phi)
    with record_function("frame.denoise"):
        if cfg.use_pallas_denoise is False:
            shadowed, unshadowed = (atrous_denoise(x, comp.normal, comp.position, it, *phis)
                                    for x in (comp.shadowed, comp.unshadowed))
        else:
            shadowed, unshadowed = atrous_denoise_pair(
                comp.shadowed, comp.unshadowed, comp.normal, comp.position, it, *phis)
    return ratio_combine(comp.analytic, shadowed, unshadowed)


def render_pipeline_gpu(gpu: TorchScene, frame: ViewportFrame, cfg: RenderConfig,
                        frame_index: int = 0,
                        backend: TraceBackend | None = None) -> torch.Tensor:
    """Render a compiled scene: (H, W, 3) float32 image on the scene's
    device, under inference mode (the losses of diff/optimize.py call
    render_components and denoise_and_combine themselves)."""
    check_supported(cfg)
    with torch.inference_mode():
        comp = render_components(gpu, frame, cfg, frame_index, backend)
        return denoise_and_combine(comp, cfg)


def require_device(device: str | torch.device) -> torch.device:
    """The device an entry point renders on; a CUDA device that is not
    there raises (an entry point never renders on the CPU instead)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"render on {device} needs a CUDA device and none is available; "
            "pass device='cpu' to render with the plain PyTorch twins")
    return device


def compile_for(scene, cfg: RenderConfig, device: torch.device) -> TorchScene:
    """Compile a Scene for cfg's frame and move it to `device`.  Only the
    v9 kernel reads the SAH-repacked panels, and only the mip path the mip
    chain; frames that need neither skip their host build."""
    v9 = cfg.backend in ("quarter", "hybrid") or (cfg.backend == "auto" and cfg.use_bvh)
    return scene.compile(bvh_leaf_size=cfg.bvh_leaf_size, quarter_panels=v9,
                         mip_textures=cfg.mip_textures).to(device)


def render_pipeline(scene, cfg: RenderConfig | None = None,
                    frame_index: int = 0,
                    device: str | torch.device = "cuda") -> torch.Tensor:
    """Host entry: compile the Scene, move it to `device`, build the camera
    frame and render.  Returns an (H, W, 3) float32 image in [0, 1].

    Runs on the GPU unless the caller passes device="cpu"; without a CUDA
    device the default raises, it never renders on the CPU instead.
    cfg.alpha_test=None resolves to whether some mesh's material has an
    opacity map, as in the JAX package (which looks at scene.meshes only,
    so the instances of an instanced scene do not count)."""
    from realtimeraytracer_torch.scene.scene import Scene

    device = require_device(device)
    cfg = cfg or RenderConfig()
    if not isinstance(scene, Scene):
        raise TypeError(
            "render_pipeline(scene) expects a Scene; for compiled scenes use "
            "render_pipeline_gpu(gpu, frame, cfg)")
    if cfg.alpha_test is None:
        cfg = cfg.replace(alpha_test=any(
            m.material.opacity_map is not None for m in scene.meshes))
    check_supported(cfg)
    gpu = compile_for(scene, cfg, device)
    frame = scene.camera.viewport_frame(cfg.width, cfg.height, device=device)
    return render_pipeline_gpu(gpu, frame, cfg, frame_index)
