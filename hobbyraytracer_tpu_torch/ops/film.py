"""Film: tonemap, quantization and PNG/TGA/BMP output (reference film.cpp;
counterpart of hobbyraytracer_tpu/ops/film.py)."""
from __future__ import annotations

import numpy as np
import torch


def tonemap(colour: torch.Tensor, grad_eps: float = 0.0) -> torch.Tensor:
    """NaN scrub + Narkowicz ACES + clamp + gamma 2 (film.cpp:32-52).
    NaN -> 0 as in the reference; +inf -> 1e4 and -inf -> 0, the JAX
    package's documented fix (the reference turns +inf into NaN).

    grad_eps: sqrt(c + grad_eps). The derivative of sqrt is infinite at 0,
    which would make a loss gradient NaN at black pixels; the fit passes a
    tiny epsilon (far below quantization). The clamp to [0, 1] is a
    maximum and a minimum, whose derivative at a tie is the reference's
    (jnp.clip's) 1/2: a black pixel sits on the tie."""
    c = torch.nan_to_num(colour, nan=0.0, posinf=1e4, neginf=0.0)
    a, b, cc, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    c = (c * (a * c + b)) / (c * (cc * c + d) + e)
    c = torch.minimum(torch.maximum(c, c.new_zeros(())), c.new_ones(()))
    return torch.sqrt(c + grad_eps) if grad_eps else torch.sqrt(c)


def quantize(colour: np.ndarray) -> np.ndarray:
    """uint8(256 * clamp(c, 0, 0.9999)) (film.cpp:25-30). Host-side."""
    c = np.clip(np.asarray(colour, np.float32), 0.0, 0.9999)
    return (256.0 * c).astype(np.uint8)


def output_film(pixels_u8: np.ndarray, output_name: str) -> int:
    """Write the framebuffer by extension: .png / .tga / else BMP
    (film.cpp:59-79, with its "File type not supported, generating
    bitmap!" line for an unknown extension). pixels_u8: (H, W, 3) uint8,
    row 0 = top. Returns nonzero on success (stb convention)."""
    from ..io import images
    name = output_name
    if name.endswith(".png"):
        return images.write_png(name, pixels_u8)
    if name.endswith(".tga"):
        return images.write_tga(name, pixels_u8)
    if not name.endswith(".bmp"):
        print("File type not supported, generating bitmap!")
    print(">>> " + name)
    return images.write_bmp(name, pixels_u8)
