"""Image output helpers (PNG/NPY): the headless stand-in for the swapchain.

Counterpart of realtimeraytracer_tpu/utils/image_io.py (``to_uint8``,
``write_png``, ``write_npy``).  PNGs are written by the port's own codec
(utils/png.py) instead of Pillow, which the GPU machine does not have;
``read_png`` is the codec's 8-bit reader, ``read_image`` reads every
format of the native decoder (utils/image_decode.py).
"""

from __future__ import annotations

import numpy as np

from realtimeraytracer_torch.utils.image_decode import decode_image
from realtimeraytracer_torch.utils.png import decode_png, encode_png


def _numpy(image) -> np.ndarray:
    if hasattr(image, "detach"):                 # a torch tensor
        image = image.detach().cpu().numpy()
    return np.asarray(image)


def to_uint8(image) -> np.ndarray:
    """Clamp a float [0,1] image to uint8."""
    return (np.clip(_numpy(image), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, image) -> None:
    """Write a float [0,1] (H, W), (H, W, 3) or (H, W, 4) image as an
    8-bit PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(to_uint8(image)))


def read_png(path: str) -> np.ndarray:
    """(H, W, C) uint8 pixels of an 8-bit grey, RGB or RGBA PNG."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def read_image(path: str) -> np.ndarray:
    """(H, W, C) uint8 pixels of a JPEG, PNG, TGA, BMP, GIF, PNM, PSD,
    TIFF or WebP file: C is 1 (grey), 2 (grey + alpha), 3 (RGB) or 4
    (RGBA; palettes and CMYK expanded)."""
    with open(path, "rb") as f:
        return decode_image(f.read())[0]


def write_npy(path: str, image) -> None:
    np.save(path, _numpy(image))
