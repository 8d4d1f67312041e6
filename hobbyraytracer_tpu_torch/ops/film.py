"""Film: tonemap, quantization and PNG output (reference film.cpp;
counterpart of hobbyraytracer_tpu/ops/film.py)."""
from __future__ import annotations

import numpy as np
import torch


def tonemap(colour: torch.Tensor) -> torch.Tensor:
    """NaN scrub + Narkowicz ACES + clamp + gamma 2 (film.cpp:32-52).
    NaN -> 0 as in the reference; +inf -> 1e4 and -inf -> 0, the JAX
    package's documented fix (the reference turns +inf into NaN)."""
    c = torch.nan_to_num(colour, nan=0.0, posinf=1e4, neginf=0.0)
    a, b, cc, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    c = (c * (a * c + b)) / (c * (cc * c + d) + e)
    c = torch.clamp(c, 0.0, 1.0)
    return torch.sqrt(c)


def quantize(colour: np.ndarray) -> np.ndarray:
    """uint8(256 * clamp(c, 0, 0.9999)) (film.cpp:25-30). Host-side."""
    c = np.clip(np.asarray(colour, np.float32), 0.0, 0.9999)
    return (256.0 * c).astype(np.uint8)


def output_film(pixels_u8: np.ndarray, output_name: str) -> int:
    """Write the framebuffer as PNG. pixels_u8: (H, W, 3) uint8, row 0 =
    top. The reference's TGA and BMP outputs are ROADMAP Queue 1 item 16.
    Returns nonzero on success (stb convention)."""
    from ..io import images
    if not output_name.endswith(".png"):
        raise NotImplementedError(
            f"output {output_name!r}: only .png is ported yet (TGA/BMP: "
            "ROADMAP Queue 1 item 16)")
    return images.write_png(output_name, pixels_u8)
