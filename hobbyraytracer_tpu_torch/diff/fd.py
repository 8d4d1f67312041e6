"""Finite-difference check of gradients (counterpart of
hobbyraytracer_tpu/diff/fd.py): the pixel gradient against central
differences for albedo, roughness, IOR or vertex positions."""
from __future__ import annotations

import numpy as np
import torch


def fd_check(f, x0: torch.Tensor, eps: float = 1e-3, n_probe: int = 4,
             seed: int = 0):
    """The autograd gradient of the scalar f(x) at x0 against central
    differences at n_probe coordinates drawn by seed -> (autograd values,
    finite-difference values) at those coordinates, numpy."""
    x = x0.detach().clone().requires_grad_(True)
    (g,) = torch.autograd.grad(f(x), x)
    flat_g = g.detach().cpu().numpy().reshape(-1)
    flat_x = x0.detach().cpu().numpy().reshape(-1)
    rs = np.random.RandomState(seed)
    idxs = rs.choice(flat_x.size, size=min(n_probe, flat_x.size),
                     replace=False)

    def at(flat):
        with torch.no_grad():
            return float(f(torch.as_tensor(flat.reshape(x0.shape),
                                           device=x0.device)))

    fd = []
    for i in idxs:
        xp = flat_x.copy()
        xp[i] += eps
        xm = flat_x.copy()
        xm[i] -= eps
        fd.append((at(xp) - at(xm)) / (2 * eps))
    return flat_g[idxs], np.asarray(fd)
