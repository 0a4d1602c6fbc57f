"""Light descriptions: textured-geometry area lights and a directional sun.

Copy of realtimeraytracer_tpu/scene/lights.py (host NumPy, unchanged): the JAX
package cannot be imported without jax, so the port carries its own.

Parity: scene::AreaLight (scene/area_light.cppm:18-135) — an emitter with
color, intensity, two-sidedness, arbitrary triangle geometry (default the
unit "square" quad, :79-82) and a transform; and the hard-coded directional
sun the reference bakes into ray generation (raygen.rgen:288-292: dir
(-1,1,-0.5) normalized, color (1,1,0.5), intensity 0.2) which here is proper
scene data.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from realtimeraytracer_torch.scene.geometry import Transformable, TriangleMesh, make_quad_mesh


@dataclasses.dataclass
class AreaLight(Transformable):
    color: tuple[float, float, float] = (1.0, 1.0, 1.0)
    intensity: float = 1.0
    two_sided: bool = False
    mesh: TriangleMesh | None = None   # default: unit quad ("square")
    name: str = ""

    def __post_init__(self):
        if self.mesh is None:
            self.mesh = make_quad_mesh(name="light_square")


@dataclasses.dataclass
class DirectionalLight:
    direction: tuple[float, float, float] = (-1.0, 1.0, -0.5)  # toward the light
    color: tuple[float, float, float] = (1.0, 1.0, 0.5)
    intensity: float = 0.2

    def normalized_direction(self) -> np.ndarray:
        d = np.asarray(self.direction, np.float32)
        return d / np.linalg.norm(d)
