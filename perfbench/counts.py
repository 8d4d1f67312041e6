"""The work of kernel K1 (the mesh find, `traverse_kernel`) counted from its
inputs and outputs only, and the least time the card needs for it.

Bytes: each ray given to the find read once (8 float32: origin,
direction, valid, pad) and each hit record written once (8 float32 and an
int32 id). Operations: one Moller-Trumbore test and the normal's
interpolation for each ray that hits; the count takes every ray as a hit,
an upper bound (the bytes bind by far even so). Nothing of the find's own
layout (clusters, leaves visited) is charged, so the count does not change
with another find.
"""
from __future__ import annotations

RAY_BYTES = 32
HIT_BYTES = 36
# Moller-Trumbore: 9 (p) + 5 (det) + 1 (1/det) + 3 (s) + 6 (u) + 9 (q)
# + 6 (v) + 6 (t) + 1 (u + v) = 46; the normal w0 n0 + u n1 + v n2: 2 + 15
OPS_PER_HIT = 63


def k1_work(launches: int, lanes: int) -> tuple:
    """(bytes, operations) of `launches` launches of `lanes` rays each."""
    rays = launches * lanes
    return rays * (RAY_BYTES + HIT_BYTES), rays * OPS_PER_HIT


def least_time(n_bytes: float, n_ops: float, peaks: dict) -> tuple:
    """(seconds, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the float32 operations over the peak rate."""
    t_bytes = n_bytes / peaks["bytes_per_s"]
    t_ops = n_ops / peaks["f32_flops_per_s"]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
