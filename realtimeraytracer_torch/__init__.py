"""realtimeraytracer_torch — the ray tracer on PyTorch and CUDA.

A port of ``realtimeraytracer_tpu`` (JAX on a TPU), which stays in the
repository as its reference.  This package imports torch and NumPy, never
jax.  It renders the reference's ratio-estimator frame, on textured,
alpha-tested and shared-geometry instanced scenes too (the instanced form
traces through the v8 kernel's instanced level, and moves with
ops/refit.apply_instance_transforms): jittered primaries, closest hit under the alpha
re-trace ladder, surface with texture maps, LTC analytic light,
stochastic area-light shadows, sun, HDRI miss, tonemap, A-Trous denoising
of both stochastic images and the ratio combine.  Hand-written CUDA
kernels for Hopper carry it on a GPU (csrc/): the v9 quarter-composited
traversal and the v8 per-ray hierarchy of the default hybrid route, the
v7 block traversal of the "pallas" route (each with an in-kernel alpha
mask variant; v8 also with its instanced instantiation, which carries
every trace of an instanced scene), the fused two-image A-Trous
iteration and its backward.  Pixel losses differentiate through shading
and intersection to material, light and geometry parameters (diff/:
the losses, the training step, ``fit``, checkpoints).  A frame, a
wavefront sample or a training step splits its rays over the ranks of a
torch.distributed process group (parallel/: gloo on the CPU, NCCL on the
GPU).  ``render`` runs on the GPU unless the caller passes ``device="cpu"``.

Public API:
    Scene, Camera, Material, Sphere, TriangleMesh, AreaLight, DirectionalLight
    render(scene, cfg, device="cuda") — forward render to an (H, W, 3) image
    render_pipeline(...)              — the same, by its pipeline name
    RenderConfig                      — all knobs (resolution, spp, ...)
"""

from realtimeraytracer_torch.config import RenderConfig
from realtimeraytracer_torch.scene.camera import Camera
from realtimeraytracer_torch.scene.materials import Material
from realtimeraytracer_torch.scene.geometry import Sphere, TriangleMesh
from realtimeraytracer_torch.scene.lights import AreaLight, DirectionalLight
from realtimeraytracer_torch.scene.scene import Scene
from realtimeraytracer_torch.render.megakernel import render
from realtimeraytracer_torch.render.pipeline import render_pipeline

__all__ = [
    "RenderConfig",
    "Camera",
    "Material",
    "Sphere",
    "TriangleMesh",
    "AreaLight",
    "DirectionalLight",
    "Scene",
    "render",
    "render_pipeline",
]

__version__ = "0.1.0"
