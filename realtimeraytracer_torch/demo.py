"""Demo CLI: render the example scene ladder / run the app frame loop /
inverse-rendering optimization, on the GPU.

Usage:
  python -m realtimeraytracer_torch.demo render [cornell|sphere|mesh10k|mesh100k|textured|sky|instanced] out.png
  python -m realtimeraytracer_torch.demo wavefront cornell out.png   # multi-bounce
  python -m realtimeraytracer_torch.demo app                          # timed frame loop
  python -m realtimeraytracer_torch.demo fit                          # albedo recovery

Counterpart of scripts/demo.py, with the same commands, scene table and
configurations.  Every command runs on the card; each ``cmd_*`` function
takes ``device`` (``"cpu"`` runs the kernels' plain twins) and returns
what it logs.  PNGs are written by the port's own codec (utils/png.py).
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

import realtimeraytracer_torch as rt
from realtimeraytracer_torch import scenes
from realtimeraytracer_torch.utils import log
from realtimeraytracer_torch.utils.image_io import write_png

SCENES = {
    "cornell": lambda: (scenes.cornell_box(),
                        rt.RenderConfig(width=512, height=512, primary_rays=2,
                                        shadow_rays=3, shadow_ray_margin=0.02)),
    "sphere": lambda: (scenes.sphere_plane(),
                       rt.RenderConfig(width=512, height=384, primary_rays=2,
                                       shadow_rays=1, shadow_ray_margin=0.01)),
    "mesh10k": lambda: (scenes.procedural_mesh(10_000),
                        rt.RenderConfig(width=960, height=540, primary_rays=2,
                                        shadow_rays=2, tonemap="lut")),
    "mesh100k": lambda: (scenes.procedural_mesh(100_000),
                         rt.RenderConfig(width=1920, height=1080, primary_rays=2,
                                         shadow_rays=2)),
    # Flagship textured-PBR scene: OBJ+MTL with color/specular/metallic/
    # opacity maps, alpha-cutout foliage, HDRI sky, 2 area lights + sun
    # (create_scene.cppm:75-136, application.cppm:226-250 parity).
    "textured": lambda: (scenes.textured_obj(),
                         rt.RenderConfig(width=1920, height=1080,
                                         primary_rays=2, shadow_rays=3,
                                         shadow_ray_margin=0.05,
                                         mip_textures=True)),
    # HDRI sky on primary-ray miss (miss.rmiss parity).
    "sky": lambda: (scenes.sky_sphere(),
                    rt.RenderConfig(width=960, height=540, primary_rays=2,
                                    shadow_rays=1, shadow_ray_margin=0.01)),
    # 100 shared-geometry instances of one 10k-tri mesh (1M effective
    # tris at one mesh's memory; the v8 kernel's instanced level).
    "instanced": lambda: (_instanced_scene(),
                          rt.RenderConfig(width=960, height=540,
                                          primary_rays=2, shadow_rays=2,
                                          backend="hier")),
}


def _instanced_scene():
    from realtimeraytracer_torch.scene.camera import Camera
    from realtimeraytracer_torch.scene.geometry import TriangleMesh, make_grid_plane
    from realtimeraytracer_torch.scene.lights import AreaLight
    from realtimeraytracer_torch.scene.materials import Material
    from realtimeraytracer_torch.scene.scene import Scene

    r = np.random.default_rng(0)
    n = 10_000
    base = r.uniform(-1, 1, (n, 1, 3))
    tris = (base + r.normal(0, 0.1, (n, 3, 3))).astype(np.float32)
    blob = TriangleMesh(
        vertices=tris.reshape(-1, 3),
        faces=np.arange(3 * n, dtype=np.int32).reshape(n, 3),
        material=Material(color=(0.6, 0.3, 0.2), specular=0.3))
    s = Scene(camera=Camera(position=(0, 8, 25), look_at=(0, 0.5, 0),
                            fov_y_degrees=55))
    light = AreaLight(intensity=6.0)
    light.rotate("x", 90).scale(4.0).move(0, 10, 0)
    s.add(light, make_grid_plane(size=60.0))
    ts = []
    for i in range(100):
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = ((i % 10) * 4 - 18, 1.0, (i // 10) * 4 - 18)
        ts.append(t)
    s.add_instances(blob, ts)
    return s


def cmd_render(name: str, out: str, device: str | torch.device = "cuda",
               size: tuple[int, int] | None = None) -> torch.Tensor:
    """Render SCENES[name] (at `size` = (width, height) if given) through
    rt.render and write it to `out`; returns the image."""
    scene, cfg = SCENES[name]()
    if size is not None:
        cfg = cfg.replace(width=size[0], height=size[1])
    img = rt.render(scene, cfg, device=device)
    write_png(out, img)
    log.info("wrote {} ({}x{}, mean {:.4f})", out, cfg.width, cfg.height, float(img.mean()))
    return img


def cmd_wavefront(name: str, out: str, device: str | torch.device = "cuda") -> torch.Tensor:
    """The multi-bounce render (2 bounces) of SCENES[name] to `out`."""
    from realtimeraytracer_torch.render.pipeline import compile_for, require_device
    from realtimeraytracer_torch.render.wavefront import render_wavefront

    device = require_device(device)
    scene, cfg = SCENES[name]()
    cfg = cfg.replace(max_bounces=2)
    gpu = compile_for(scene, cfg, device)
    frame = scene.camera.viewport_frame(cfg.width, cfg.height, device=device)
    img = render_wavefront(gpu, frame, cfg)
    write_png(out, img)
    log.info("wrote {} (wavefront, {} bounces)", out, cfg.max_bounces)
    return img


def cmd_app(device: str | torch.device = "cuda") -> float:
    """The application frame loop on cornell_box, spinning; returns frames
    per second."""
    from realtimeraytracer_torch.app.application import Application

    app = Application("Real Time RayTracer", 512, 512,
                      config=rt.RenderConfig(primary_rays=1, shadow_rays=2,
                                             denoise_iterations=2,
                                             shadow_ray_margin=0.02),
                      scene=scenes.cornell_box(), device=device)
    app.toggle_spin()
    fps = app.run(num_frames=8)
    log.info("frame loop done: {:.2f} fps", fps)
    return fps


def cmd_fit(device: str | torch.device = "cuda", size: int = 48,
            steps: int = 50) -> tuple[list[float], float]:
    """Recover cornell_box's albedos from a rendered target by radiance
    loss; returns (losses, mean |albedo error|)."""
    from realtimeraytracer_torch.diff.optimize import fit
    from realtimeraytracer_torch.ops.camera_rays import generate_rays
    from realtimeraytracer_torch.render.backends import make_backend
    from realtimeraytracer_torch.render.megakernel import shade_sample
    from realtimeraytracer_torch.render.pipeline import require_device

    device = require_device(device)
    scene = scenes.cornell_box()
    cfg = rt.RenderConfig(width=size, height=size, primary_rays=1, jitter=False,
                          shadow_rays=1, denoise_iterations=0, use_bvh=False,
                          shadow_ray_margin=0.02)
    gpu = scene.compile().to(device)
    frame = scene.camera.viewport_frame(cfg.width, cfg.height, device=device)
    o, d = generate_rays(frame, cfg.width, cfg.height, jitter=False)
    seed = torch.arange(o.shape[0], device=device)
    with torch.no_grad():
        target = shade_sample(gpu, cfg, o, d, seed, make_backend(gpu, cfg)).analytic

    wrong = dataclasses.replace(gpu, obj_color=gpu.obj_color * 0.4 + 0.3)
    params, losses = fit(wrong, cfg, o, d, seed, target,
                         param_names=("obj_color",), steps=steps)
    log.info("fit: loss {:.5f} -> {:.6f}", losses[0], losses[-1])
    err = float((params["obj_color"] - gpu.obj_color).abs().mean())
    log.info("albedo mean abs error after recovery: {:.4f}", err)
    return losses, err


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return
    cmd, args = argv[0], argv[1:]
    if cmd == "render":
        cmd_render(args[0] if args else "cornell", args[1] if len(args) > 1 else "out.png")
    elif cmd == "wavefront":
        cmd_wavefront(args[0] if args else "cornell", args[1] if len(args) > 1 else "out.png")
    elif cmd == "app":
        cmd_app()
    elif cmd == "fit":
        cmd_fit()
    else:
        print(__doc__)


if __name__ == "__main__":
    main()
