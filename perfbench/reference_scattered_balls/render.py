"""The wavefront render of this reference: the shared reference's
(`perfbench.reference.render`: the lane schedule, the draws of each
iteration, Russian roulette, the capped retirement and the film) over this
package's trace, with one more draw an iteration where the scene has a
dielectric: the choice uniforms of the (DIELECTRIC_CHOICE, it) stream, one
a lane, as the program draws them for its dielectric lobe.
"""
from __future__ import annotations

import types

from perfbench.reference import render as shared
from perfbench.reference import rng

from . import trace

DIELECTRIC_CHOICE = 4   # the purpose tag of the dielectric's choice stream

# the shared reference's iteration, its module name `tr` bound to this
# package's trace instead of the shared one
_shared_step = types.FunctionType(shared.Pool.step.__code__,
                                  {**vars(shared), "tr": trace}, "step")


class Pool(shared.Pool):
    """The shared Pool; each iteration first draws the dielectric's choice
    uniforms into the scene (`DeviceScene.choice`)."""

    def step(self) -> None:
        sc = self.sc
        if trace.MAT_DIELECTRIC in sc.present:
            sc.choice = rng.uniforms(
                [rng.stream(self.key, DIELECTRIC_CHOICE, self.it)],
                self.pool, sc.device, sc.dtype)[0]
        _shared_step(self)


def render(sc: trace.DeviceScene, width: int, height: int, samples: int,
           seed: int, max_depth: int = 50, pool: int = 196_608,
           rr: bool = True):
    """The tonemapped (H, W, 3) image of a render of `samples` samples a
    pixel from `seed` (its completion read every 8 iterations)."""
    p = Pool(sc, width, height, samples, seed, max_depth, pool, rr)
    while not (p.it % 8 == 0 and p.done()):
        p.step()
    return p.image()
