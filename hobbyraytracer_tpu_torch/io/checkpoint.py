"""Render checkpoint/resume (counterpart of hobbyraytracer_tpu/io/checkpoint.py,
whose .npz format this module reads and writes unchanged).

The wavefront integrator's `PoolState` is the whole render state: the
framebuffer's radiance sums, every in-flight path (ray, throughput, partial
radiance, work item, depth, sample-chunk fields), the work-queue counter,
the retired samples and the iteration that indexes every random stream.
Saving it and resuming reproduces the uninterrupted render bit for bit
(integrator/wavefront.py says where the device's sums allow it).

Work-item ids encode the (pixel, sample-chunk) geometry, so a checkpoint
is only meaningful for the render invocation that wrote it: v4 records
that geometry (width, height, samples, sample_chunk, n_workers) and
`load_state(expect=...)` refuses a mismatched resume. A multi-worker render
(parallel/shard.py) writes a stacked state: every field with a leading
worker axis, `retired` and `it` of shape (n,).

The file is a plain .npz of the fields plus a schema version, written
atomically (a temporary file, then os.replace), so a kill mid-write leaves
the previous checkpoint whole. Files written by the JAX package load here
and the other way round: `it`, a host int in the port, is an int32 array
in the file.
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np
import torch

from ..integrator.wavefront import PoolState

# v3: planar (3, W*H) fb without scratch rows; sample-chunk fields
# `sub`/`defer`; `retired` counts samples. v4: adds the render geometry,
# checked on resume; v3 files still load (without the check).
_VERSION = 4
_MIN_VERSION = 3
_FIELDS = ("fb", "o", "d", "thr", "rad", "item", "depth", "sub", "defer",
           "counter", "retired", "it")
# metadata keys checked on resume when present in both file and expect
META_KEYS = ("width", "height", "samples", "sample_chunk", "n_workers")


def render_meta(width: int, height: int, samples: int, sample_chunk: int,
                n_workers: int = 1) -> dict:
    """The invocation geometry a checkpoint is only valid for."""
    return {"width": int(width), "height": int(height),
            "samples": int(samples), "sample_chunk": int(sample_chunk),
            "n_workers": int(n_workers)}


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value, np.int32)   # `it`: an int, or a list of ints


def save_state(path: str, state: PoolState,
               meta: Optional[dict] = None) -> None:
    """Atomically write the pool state to `path` (.npz), fetching it from
    its device."""
    arrays = {f: _host(getattr(state, f)) for f in _FIELDS}
    arrays["__version__"] = np.int32(_VERSION)
    if meta:
        for k in META_KEYS:
            if k in meta:
                arrays["__meta_" + k] = np.int64(meta[k])
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_state(path: str, expect: Optional[dict] = None,
               device="cuda") -> PoolState:
    """Load a pool state written by save_state (of either package) onto
    `device`. `it` comes back a host int, or a list of ints for a stacked
    state.

    expect: a render_meta() dict for the current invocation. A key recorded
    in the checkpoint that differs raises ValueError: resuming with other
    samples or sample_chunk would map work items to the wrong pixels, and a
    single-worker state cannot drive a multi-worker mesh or the reverse."""
    with np.load(path) as z:
        version = int(z["__version__"])
        if not _MIN_VERSION <= version <= _VERSION:
            raise ValueError(
                f"checkpoint {path}: version {version} not in "
                f"[{_MIN_VERSION}, {_VERSION}]")
        if expect is not None:
            bad = []
            for k in META_KEYS:
                fk = "__meta_" + k
                if fk in z and k in expect and int(z[fk]) != int(expect[k]):
                    bad.append(f"{k}: checkpoint={int(z[fk])} "
                               f"current={int(expect[k])}")
            if bad:
                hint = ""
                if any(b.startswith("n_workers") for b in bad):
                    hint = (" (a checkpoint written on N devices resumes "
                            "only on an N-device mesh)")
                raise ValueError(
                    f"checkpoint {path} was written by a different render "
                    f"invocation{hint}: " + "; ".join(bad))
        fields = {f: torch.from_numpy(np.array(z[f])).to(device)
                  for f in _FIELDS if f != "it"}
        it = z["it"]
        fields["it"] = int(it) if it.ndim == 0 else [int(v) for v in it]
    return PoolState(**fields)
