"""The general traffic generator: the kinds of job a traffic mix can name,
each driven through the program's own entry point, and the check of a
finished job against the plain reference that the cell's configuration
names (manifest.reference).

- "render": `integrator.wavefront.render_image` at the mix's film, spp,
  depth, pool and Russian roulette, on the route the program chooses (the
  CUDA graph route on a card). Its work is W*H*spp primary rays. The check
  renders the same job with the reference and counts the share of the
  image's values that differ by more than one 8-bit output step.
- "fit": `diff.fit.fit_materials` with the CLI's arguments, from the
  materials perturbed as the CLI perturbs them, towards a target rendered
  once in set-up from the authored scene. Its work is its Adam steps. The
  check runs the same fit with the reference and compares every step's
  loss and the fitted materials.

Any other "job" is a new kind: a file `kinds/<job>.py` (see manifest.py)
whose class `JOBS` has the interface of `Jobs` (the constructor, `kind`,
`work`, `run`, `reference`, `as_output`, `compare`), as a subclass of
`RenderJobs` or `FitJobs` or of `Jobs`; `kind(cell)` finds it.

Job j of a run draws from the seed `job_seed(seed, "job", j)`; the same
seed gives the same jobs.
"""
from __future__ import annotations

import hashlib

import torch

from . import manifest

PIXEL_STEP = 1.0 / 256.0   # one step of the 8-bit output (film.cpp:25-30)


def job_seed(seed: int, purpose: str, j: int = 0) -> int:
    """A 32-bit seed for job j (or the target, or the check's draw) from
    the run's seed, any whole number."""
    h = hashlib.sha256(f"{int(seed)}:{purpose}:{j}".encode()).digest()
    return int.from_bytes(h[:4], "little")


class Jobs:
    """The jobs of one cell, of one kind, run by the program under test:
    `run(j)` runs job j (j = -1: the warm-up) and returns its output,
    `work()` counts one job's units, `reference(j, dtype)` computes job j
    with the plain reference package `ref` (the shared `reference/` where
    none is given) in `dtype`, `as_output` cuts such a result to what `run`
    returns, and `compare(out, ref)` gives {name of a number compared: its
    gap} (the cell's limits name them)."""

    kind = ""

    def __init__(self, scene_path: str, traffic: dict, device, seed: int,
                 ref=None):
        self.t = traffic
        self.scene_path, self.device, self.seed = scene_path, device, seed
        self.ref = ref or manifest.reference_package()

    @staticmethod
    def as_output(ref):
        """The reference's result of a job as `run` would return it."""
        return ref


class RenderJobs(Jobs):
    """Renders of one scene at one film (the program under test)."""

    kind = "render"

    def __init__(self, scene_path: str, traffic: dict, device, seed: int,
                 ref=None):
        super().__init__(scene_path, traffic, device, seed, ref)
        from hobbyraytracer_tpu_torch.integrator import wavefront
        from hobbyraytracer_tpu_torch.scene import (build_scene,
                                                    load_scene_desc)
        self.wavefront = wavefront
        job = build_scene(load_scene_desc(scene_path))
        self.scene = job.scene.to(device)
        self.camera = job.camera.to(device)

    def work(self) -> int:
        """Primary rays of one render."""
        return self.t["width"] * self.t["height"] * self.t["spp"]

    def run(self, j: int):
        from hobbyraytracer_tpu_torch.core.rng import Sampler
        t = self.t
        return self.wavefront.render_image(
            self.scene, self.camera, t["width"], t["height"], t["spp"],
            Sampler(job_seed(self.seed, "job", j), self.device),
            max_depth=t["max_depth"], pool=t["pool"], rr=t["rr"])

    def reference(self, j: int, dtype=torch.float32):
        """The reference's image of job j, computed in `dtype`."""
        t, ref = self.t, self.ref
        sc = ref.trace.DeviceScene(ref.scene.load(self.scene_path),
                                   self.device, dtype)
        return ref.render.render(sc, t["width"], t["height"], t["spp"],
                                 job_seed(self.seed, "job", j),
                                 t["max_depth"], t["pool"], t["rr"])

    @staticmethod
    def compare(out, ref) -> dict:
        """{pixels_off_pct: % of the image's values more than one output
        step away from the reference's}."""
        gap = (out.float() - ref.float()).abs()
        off = ~(gap <= PIXEL_STEP)     # NaN counts as off
        return {"pixels_off_pct": 100.0 * off.float().mean().item()}


class FitJobs(Jobs):
    """Material fits of one scene (the program under test)."""

    kind = "fit"

    def __init__(self, scene_path: str, traffic: dict, device, seed: int,
                 ref=None):
        super().__init__(scene_path, traffic, device, seed, ref)
        from hobbyraytracer_tpu_torch.core.rng import Sampler
        from hobbyraytracer_tpu_torch.diff import fit as fit_mod
        from hobbyraytracer_tpu_torch.scene import (build_scene,
                                                    load_scene_desc, ir)
        t = traffic
        self.fit_mod, self.Sampler = fit_mod, Sampler
        job = build_scene(load_scene_desc(scene_path))
        scene = job.scene.to(device)
        self.camera = job.camera.to(device)
        with torch.no_grad():
            self.target = fit_mod.render_linear(
                scene, self.camera, t["width"], t["height"],
                Sampler(job_seed(seed, "target"), device), t["spp"],
                t["max_depth"])
        m = scene.materials
        p = t["perturb"]
        self.start = ir.replace(scene, materials=ir.replace(
            m, albedo=torch.clamp(m.albedo * p["albedo_scale"]
                                  + p["albedo_shift"], 0.0, 1.0),
            roughness=torch.clamp(m.roughness + p["roughness_shift"],
                                  0.0, 1.0)))

    def work(self) -> int:
        """Adam steps of one fit."""
        return self.t["steps"]

    def run(self, j: int):
        t = self.t
        res = self.fit_mod.fit_materials(
            self.start, self.camera, self.target, t["width"], t["height"],
            steps=t["steps"], lr=t["lr"], n_samples=t["spp"],
            max_depth=t["max_depth"],
            sampler=self.Sampler(job_seed(self.seed, "job", j), self.device),
            verbose=False, correlated=True)
        return ([float(x) for x in res.losses],
                {f: p.detach() for f, p in res.params["materials"].items()})

    def reference(self, j: int, dtype=torch.float32):
        """The reference's (losses, fitted materials, start materials) of
        job j, computed in `dtype`."""
        t, ref = self.t, self.ref
        sc = ref.trace.DeviceScene(ref.scene.load(self.scene_path),
                                   self.device, dtype)
        with torch.no_grad():
            target = ref.fit.render_linear(
                sc, sc.mats, t["width"], t["height"],
                job_seed(self.seed, "target"), t["spp"], t["max_depth"])
        losses, params = ref.fit.fit(
            sc, target, t["width"], t["height"], job_seed(self.seed, "job", j),
            t["steps"], t["lr"], t["spp"], t["max_depth"])
        return losses, params, ref.fit.perturb(sc.mats)

    @staticmethod
    def as_output(ref):
        """(losses, fitted materials), as `run` returns them."""
        return ref[:2]

    @staticmethod
    def compare(out, ref) -> dict:
        """{loss_gap: the largest relative gap of a step's loss;
        param_gap: the worst material field's distance from the
        reference's fitted value, over how far the reference moved it (at
        least a thousandth of the farthest-moved field's move)}."""
        losses, params = out
        r_losses, r_params, start = ref
        loss_gaps = [abs(a - b) / abs(b) if b else float(a != b)
                     for a, b in zip(losses, r_losses)]
        if len(losses) != len(r_losses):
            loss_gaps.append(float("inf"))
        moved = {f: (r_params[f].float() - start[f].float()).norm().item()
                 for f in r_params}
        floor = max(max(moved.values()) * 1e-3, 1e-30)
        param_gaps = [(params[f].float() - r_params[f].float()).norm().item()
                      / max(moved[f], floor) for f in r_params]
        return {"loss_gap": worst(loss_gaps), "param_gap": worst(param_gaps)}


def worst(gaps: list) -> float:
    """The largest gap; infinite when one is NaN."""
    return float("inf") if any(g != g for g in gaps) else max(gaps)


KINDS = {"render": RenderJobs, "fit": FitJobs}   # the built-in kinds


def kind(cell: manifest.Cell) -> type:
    """The class of the cell's jobs: a built-in kind, or the `JOBS` of
    `kinds/<job>.py` in the cell's bench folder."""
    job = cell.traffic["job"]
    return KINDS.get(job) or manifest.kind(job, cell.bench).JOBS
