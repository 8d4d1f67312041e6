"""The planted faults of the timed path, each a function (program, j) ->
the output of job j with the fault in it: here those of the built-in job
kinds, and in a kind file (`kinds/<job>.py`) its own `FAULTS`. The tests
drive whole runs with them (tests/test_perfbench_reference.py), and
`calibrate.py --fault-seeds` reads them at a cell's own size.

Renders:
- half_the_samples: half of the samples left out, the mean over the rest;
- answer_altered: a 32 x 32 tile of the image (all of a tiny one) altered;
- framebuffer_unchanged: every segment leaves the framebuffer as it found
  it (a segment that left the whole state unchanged would never end the
  render).
Fits:
- step_unchanged: Adam's step a no-op;
- half_the_batch: the loss over the first half of the image's rows;
- answer_altered: the fitted albedo + 1e-3.
"""
from __future__ import annotations

import torch

from . import jobs, manifest


def _half_the_samples(p, j):
    from hobbyraytracer_tpu_torch.core.rng import Sampler
    t = p.t
    return p.wavefront.render_image(
        p.scene, p.camera, t["width"], t["height"], t["spp"] // 2,
        Sampler(jobs.job_seed(p.seed, "job", j), p.device),
        max_depth=t["max_depth"], pool=t["pool"], rr=t["rr"])


def _render_altered(p, j):
    img = jobs.RenderJobs.run(p, j).clone()
    img[:32, :32] += 0.05
    return img


def _framebuffer_unchanged(p, j):
    wf = p.wavefront
    segment = wf._segment

    def still(state, *args, **kwargs):
        fb = state.fb.clone()
        out = segment(state, *args, **kwargs)
        state.fb.copy_(fb)
        return out

    wf._segment = still
    try:
        return jobs.RenderJobs.run(p, j)
    finally:
        wf._segment = segment


def _half_the_batch(p, j):
    fit_mod = p.fit_mod
    loss_of = fit_mod._loss_from_image
    fit_mod._loss_from_image = lambda img, target, *a: loss_of(
        img[: img.shape[0] // 2], target[: target.shape[0] // 2], *a)
    try:
        return jobs.FitJobs.run(p, j)
    finally:
        fit_mod._loss_from_image = loss_of


def _step_unchanged(p, j):
    step = torch.optim.Adam.step
    torch.optim.Adam.step = lambda self, closure=None: None
    try:
        return jobs.FitJobs.run(p, j)
    finally:
        torch.optim.Adam.step = step


def _fit_altered(p, j):
    losses, params = jobs.FitJobs.run(p, j)
    params["albedo"] = params["albedo"] + 1e-3
    return losses, params


FAULTS = {
    "render": {"half_the_samples": _half_the_samples,
               "answer_altered": _render_altered,
               "framebuffer_unchanged": _framebuffer_unchanged},
    "fit": {"step_unchanged": _step_unchanged,
            "half_the_batch": _half_the_batch,
            "answer_altered": _fit_altered},
}


def planted(cell) -> dict:
    """The planted faults of the cell's job kind: a built-in kind's, or the
    `FAULTS` of its file `kinds/<job>.py`."""
    job = cell.traffic["job"]
    return FAULTS.get(job) or manifest.kind(job, cell.bench).FAULTS


def broken(cell, fault: str):
    """The class of the cell's jobs with `fault` planted in its run."""
    cls, plant = jobs.kind(cell), planted(cell)[fault]

    class Broken(cls):
        def run(self, j):
            return plant(self, j)

    return Broken
