"""Host-side material description.

Copy of realtimeraytracer_tpu/scene/materials.py (host NumPy, unchanged): the JAX
package cannot be imported without jax, so the port carries its own.

Parity with the reference's constant-or-texture material model
(scene/object.cppm:48-57; GPUObjectInfo mirror at raycommon.glsl:29-51):
each of color / specular / metallic / opacity is either a constant or a
texture map; roughness is derived as ``1 - specular`` at shade time
(closesthit.rchit:106), and color maps are sRGB-decoded (:104).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Material:
    color: tuple[float, float, float] = (0.8, 0.8, 0.8)
    specular: float = 0.5            # roughness = 1 - specular
    metallic: float = 0.0

    # Texture references: either an index into Scene.textures (int) or a
    # file path (str, resolved at scene compile) or None for constant.
    color_map: int | str | None = None
    specular_map: int | str | None = None
    metallic_map: int | str | None = None
    opacity_map: int | str | None = None

    name: str = ""
