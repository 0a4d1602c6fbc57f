"""Pinhole camera and its viewport frame.

Counterpart of realtimeraytracer_tpu/scene/camera.py: the same host NumPy
camera (reference scene/camera.cppm) with its fly controls (mouse-look with
the +-89 degree pitch clamp, planar moves, the auto-spin rotate_y of
window.cppm:68-133), all in float64 as in the JAX package;
``viewport_frame`` returns the frame as float32 tensors on the requested
device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from realtimeraytracer_torch.ops.camera_rays import ViewportFrame


@dataclasses.dataclass
class Camera:
    position: tuple[float, float, float] = (0.0, 0.0, 0.0)
    look_at: tuple[float, float, float] = (0.0, 0.0, -1.0)
    up: tuple[float, float, float] = (0.0, 1.0, 0.0)
    fov_y_degrees: float = 60.0

    # Interaction constants (application.cppm:497-501).
    move_speed: float = 10.5
    mouse_sensitivity: float = 0.5

    def __post_init__(self):
        d = np.asarray(self.look_at, np.float64) - np.asarray(self.position, np.float64)
        n = np.linalg.norm(d)
        d = d / (n if n > 0 else 1.0)
        self.pitch = math.degrees(math.asin(float(np.clip(d[1], -1.0, 1.0))))
        self.yaw = math.degrees(math.atan2(float(d[2]), float(d[0])))

    @property
    def forward(self) -> np.ndarray:
        yr, pr = math.radians(self.yaw), math.radians(self.pitch)
        return np.array(
            [math.cos(pr) * math.cos(yr), math.sin(pr), math.cos(pr) * math.sin(yr)],
            np.float64,
        )

    @property
    def right(self) -> np.ndarray:
        u = np.cross(np.asarray(self.up, np.float64), -self.forward)
        return u / np.linalg.norm(u)

    def process_mouse(self, dx: float, dy: float, sensitivity: float = 0.1) -> None:
        """Mouse-look: yaw += dx*s, pitch += dy*s, clamped to +-89 degrees
        (camera.cppm:136-148)."""
        self.yaw += dx * sensitivity
        self.pitch = float(np.clip(self.pitch + dy * sensitivity, -89.0, 89.0))

    def move(self, forward: float = 0.0, strafe: float = 0.0, dt: float = 1.0 / 60.0) -> None:
        """WASD-style planar movement (window.cppm:68-110)."""
        p = np.asarray(self.position, np.float64)
        p = p + self.forward * (forward * self.move_speed * dt)
        p = p + self.right * (strafe * self.move_speed * dt)
        self.position = tuple(p.tolist())

    def rotate_y(self, degrees: float) -> None:
        """The auto-spin toggle's step (window.cppm:99-104, camera.cppm:149-154)."""
        self.yaw += degrees

    def viewport_frame_np(self, width: int, height: int) -> tuple[np.ndarray, ...]:
        """(position, top_left, h_delta, v_delta) as float32 NumPy arrays
        (camera.cppm:98-134 derivation, computed in float64)."""
        aspect = width / height
        half_h = math.tan(math.radians(self.fov_y_degrees) * 0.5)
        half_w = aspect * half_h

        w = -self.forward
        u = np.cross(np.asarray(self.up, np.float64), w)
        u /= np.linalg.norm(u)
        v = np.cross(w, u)

        pos = np.asarray(self.position, np.float64)
        h_delta = (2.0 * half_w / width) * u
        v_delta = -(2.0 * half_h / height) * v
        top_left = pos - half_w * u + half_h * v - w
        return tuple(np.asarray(x, np.float32)
                     for x in (pos, top_left, h_delta, v_delta))

    def viewport_frame(self, width: int, height: int,
                       device: str | torch.device = "cpu") -> ViewportFrame:
        """The pinhole viewport frame as float32 tensors on `device`: one
        (4, 3) upload that does not wait for the device's queued work, so a
        frame loop can queue the next frame while the last one runs."""
        rows = torch.from_numpy(np.stack(self.viewport_frame_np(width, height)))
        return ViewportFrame(*rows.to(device, non_blocking=True))
