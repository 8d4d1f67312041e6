"""The work of the sphere find (the pooled spheres of a scene, whichever
route finds them: the dense scan or kernel K4) counted from its inputs and
outputs only, and so the least time the card needs for it
(counts.least_time).

Bytes: each ray given to the find read once and each hit record written
once, at K1's sizes (counts.RAY_BYTES, counts.HIT_BYTES). Operations: one
ray-sphere test a ray and its hit record. Nothing of the route's own
layout is charged (not the spheres a ray is tested against, not the
clusters visited), so the dense scan and K4 read on one yardstick.
"""
from __future__ import annotations

from . import counts

# the half-b quadratic: oc 3, a 5, half_b 5, c 7, disc 3, sqrt 1, 1 / a 1,
# the two roots 6; the record: p = o + t d 6, the normal (p - c) / r 6 and
# its facing dot product 5
OPS_PER_RAY = 48


def sphere_find_work(segments: int, lanes: int) -> tuple:
    """(bytes, operations) of the find over `segments` segments of a pool
    of `lanes` lanes."""
    rays = segments * lanes
    return (rays * (counts.RAY_BYTES + counts.HIT_BYTES),
            rays * OPS_PER_RAY)
