"""Application: scene set-up and the headless frame loop.

Counterpart of realtimeraytracer_tpu/app/application.py (the reference's
src/app/application.cppm:50-502 and src/main.cpp): construct it with a
title and a resolution, point it at a Scene, then ``run`` a frame loop.
Where the reference pumps GLFW events and presents to a swapchain, frames
are tensors handed to a callback, and a scripted controller stands in for
WASD, the mouse and the 'T' auto-spin toggle (window.cppm:68-133).

Frames run on the card unless the application is built with
device="cpu"; without a CUDA device the default raises.  PyTorch queues
each frame's kernels and returns, so consecutive frames overlap the host's
work for the next frame with the device's work for the last: the loop
waits for the device once after its warm-up frame and once at its end,
never per frame (``on_frame`` receives the image on the device).
"""

from __future__ import annotations

import time
from typing import Callable, Iterator

import numpy as np
import torch

from realtimeraytracer_torch.config import RenderConfig
from realtimeraytracer_torch.render.pipeline import (
    compile_for, render_pipeline_gpu, require_device)
from realtimeraytracer_torch.scene.gpu_scene import TorchScene
from realtimeraytracer_torch.scene.scene import Scene
from realtimeraytracer_torch.utils import log


class Application:
    """Owns the scene, its camera, the compiled scene and the frame
    counter."""

    # Reference interaction constants (application.cppm:497-501).
    CAM_SPEED = 10.5
    MOUSE_SENSITIVITY = 0.5
    NUM_DENOISING_ITERATIONS = 4
    DENOISING_STRENGTH = 1

    def __init__(self, title: str = "Real Time RayTracer",
                 width: int = 1920, height: int = 1080,
                 config: RenderConfig | None = None,
                 scene: Scene | None = None,
                 device: str | torch.device = "cuda"):
        self.device = require_device(device)
        self.title = title
        # Interactive default: the one-gather LTC fetch (cfg.fast_lut).
        self.config = (config or RenderConfig(fast_lut=True)).replace(
            width=width, height=height)
        if scene is None:
            from realtimeraytracer_torch import scenes

            scene = scenes.cornell_box()
        self.scene = scene
        self.frame_index = 0
        self._gpu: TorchScene | None = None
        self._spin = False
        log.info("{}: {}x{} on {}", title, width, height, self.device)

    # -- set-up ------------------------------------------------------------
    def compile_scene(self) -> None:
        """Scene -> TorchScene on the application's device (the one-time
        set-up of Application::run, application.cppm:99-330)."""
        t0 = time.perf_counter()
        self._gpu = compile_for(self.scene, self.config, self.device)
        log.info("scene compiled in {:.2f}s: {} tris", time.perf_counter() - t0,
                 self._gpu.num_tris)

    # -- interaction (scripted input) --------------------------------------
    def toggle_spin(self) -> None:
        """The 'T' auto-spin toggle (window.cppm:99-104)."""
        self._spin = not self._spin

    def process_input(self, forward=0.0, strafe=0.0, mouse_dx=0.0,
                      mouse_dy=0.0, dt=1.0 / 60.0) -> None:
        cam = self.scene.camera
        if mouse_dx or mouse_dy:
            cam.process_mouse(mouse_dx, mouse_dy, self.MOUSE_SENSITIVITY)
        if forward or strafe:
            cam.move(forward=forward, strafe=strafe, dt=dt)

    # -- frame loop ----------------------------------------------------------
    def render_frame(self) -> torch.Tensor:
        """Queue the next frame; returns its (H, W, 3) image on the device."""
        if self._gpu is None:
            self.compile_scene()
        if self._spin:
            self.scene.camera.rotate_y(0.5)
        cfg = self.config
        frame = self.scene.camera.viewport_frame(cfg.width, cfg.height, device=self.device)
        img = render_pipeline_gpu(self._gpu, frame, cfg, self.frame_index)
        self.frame_index += 1
        return img

    def _wait(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, num_frames: int = 16,
            controller: Callable[["Application", int], None] | None = None,
            on_frame: Callable[[int, torch.Tensor], None] | None = None) -> float:
        """Run the frame loop after one warm-up frame; returns the frames
        per second.  controller(app, i) plays glfwPollEvents + processInput;
        on_frame(i, image) plays present, with the image on the device."""
        if self._gpu is None:
            self.compile_scene()
        self.render_frame()                 # warm-up, excluded from timing
        self._wait()
        t0 = time.perf_counter()
        for i in range(num_frames):
            if controller is not None:
                controller(self, i)
            img = self.render_frame()
            if on_frame is not None:
                on_frame(i, img)
        self._wait()
        dt = time.perf_counter() - t0
        fps = num_frames / dt
        log.info("{} frames in {:.2f}s = {:.1f} fps", num_frames, dt, fps)
        return fps

    def frames(self, n: int) -> Iterator[np.ndarray]:
        """The next n frames as host arrays."""
        for _ in range(n):
            yield self.render_frame().cpu().numpy()
