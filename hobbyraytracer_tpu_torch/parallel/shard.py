"""Rendering and fitting over several workers (counterpart of
hobbyraytracer_tpu/parallel/shard.py).

A mesh is the ordered list of this process's worker devices, for example
[cuda:0, cuda:1], or [cuda:0, cuda:0] (two workers on one card) or
[cpu] * 8 (the counterpart of the reference's eight virtual CPU devices).
Rays are independent and the scene is small, so the work is split the way
the reference splits it over its mesh:

- render_wavefront_sharded: worker i drains one contiguous slice of the
  wavefront's work items with a pool of its own and its own random
  streams (sampler.fold_in(i), the reference's fold_in(key, i)); the
  framebuffers are summed at the end in worker order on worker 0's device.
  Checkpoints stack the workers' states (a leading worker axis on every
  field), as the reference's do.
- render_sharded (the batch integrator) and sharded_render_loss (the fit):
  worker i renders one contiguous slice of the pixels with the whole
  image's draws sliced to them (core/rng.py span), so the image, and the
  fit's loss and gradients up to their sums' order, equal the
  single-worker ones. The fit's parameters reach each worker by a
  differentiable .to(device), and each worker's loss over its slice,
  divided by the worker count, is summed on worker 0's device: autograd
  brings every worker's gradient back to the leaves (the reference's psum).

The workers of one process run one after another from one host thread, so
several workers on one card do not run faster than one. Across processes
(init_multihost: torch.distributed, one process group, left again by
shutdown_multihost), global worker g =
rank * len(mesh) + i; the framebuffer, the batch image and the fit's
gradients and loss are summed over the processes (all_reduce) once at the
end of a render or a backward, as DDP does. The backend is the caller's:
"nccl" when each process has a card of its own, "gloo" on the CPU and for
several processes on one card (NCCL refuses two ranks on one GPU).
Checkpoints of a render across processes are refused.

The reference's GSPMD batch path pinned mesh scenes to its XLA find and
warned about it (_warn_batch_xla_find); here every worker runs its kernels
itself, so there is nothing to warn about.
"""
from __future__ import annotations

import copy
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from ..core.types import Rays
from ..diff import fit as fit_mod
from ..integrator import path as path_mod
from ..integrator import wavefront as wf
from ..ops import film as film_ops


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: str = "gloo") -> None:
    """Join the process group of a render or fit across processes: rank
    `process_id` of `num_processes`, meeting at `coordinator` (host:port).
    A no-op for one process."""
    if num_processes is None or num_processes <= 1:
        return
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def shutdown_multihost() -> None:
    """Leave the process group that init_multihost joined, if any: every
    process of a group must, or one of them may abort at exit while the
    group's threads are still up. A no-op without a group."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _process():
    """(rank, world size) of this process; (0, 1) without a process
    group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over the processes, in place (through the host for gloo)."""
    if dist.get_backend() == "gloo" and t.device.type != "cpu":
        host = t.cpu()
        dist.all_reduce(host)
        t.copy_(host)
    else:
        dist.all_reduce(t)
    return t


def make_mesh(n_devices: Optional[int] = None,
              device="cuda") -> list:
    """A mesh of workers. device "cuda": the first n_devices visible cards
    (all of them by default); any other device ("cpu", "cuda:0"): that
    device n_devices times (once by default)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        n = torch.cuda.device_count() if n_devices is None else n_devices
        return [torch.device("cuda", i) for i in range(n)]
    return [device] * (n_devices or 1)


def parse_mesh(spec: str) -> list:
    """The CLI's --device: comma-separated workers ("cuda:0,cuda:0",
    "cpu,cpu"), or one device; "cuda" alone is every visible card."""
    names = [s.strip() for s in spec.split(",") if s.strip()]
    if names == ["cuda"]:
        return make_mesh()
    return [torch.device(n) for n in names]


def _moved(module: nn.Module, device) -> nn.Module:
    """A copy of `module` with every buffer on `device`, by a
    differentiable .to (a buffer already there is shared). The module and
    its submodules are copied, never moved in place."""
    new = copy.copy(module)
    new._buffers = {k: None if v is None else v.to(device)
                    for k, v in module._buffers.items()}
    new._modules = {k: None if m is None else _moved(m, device)
                    for k, m in module._modules.items()}
    return new


def replicate_scene(scene: nn.Module, mesh: Sequence) -> list:
    """The scene (or camera) for each worker of the mesh, on its device:
    workers on one device share one copy."""
    copies = {}
    out = []
    for dev in mesh:
        dev = torch.device(dev)
        if dev not in copies:
            copies[dev] = _moved(scene, dev)
        out.append(copies[dev])
    return out


def _sampler_on(sampler, device):
    """`sampler` drawing on `device`."""
    s = copy.copy(sampler)
    s.device = torch.device(device)
    return s


def _slices(n_rows: int, mesh: Sequence):
    """This process's workers' contiguous row slices of n_rows rows split
    over every worker of every process (ceil(n_rows / workers) each, the
    last ones shorter or empty): [(global worker, start, stop)]."""
    rank, world = _process()
    local = len(mesh)
    per = -(-n_rows // (local * world))
    out = []
    for i in range(local):
        g = rank * local + i
        start = min(g * per, n_rows)
        out.append((g, start, min(start + per, n_rows)))
    return out


def shard_rays(rays: Rays, mesh: Sequence) -> list:
    """A ray wavefront split along its batch axis over the mesh: this
    process's workers' slices, each on its worker's device."""
    return [Rays(o=rays.o[a:b].to(dev), d=rays.d[a:b].to(dev))
            for dev, (_, a, b) in zip(mesh, _slices(rays.o.shape[0], mesh))]


def render_sharded(scene, camera, width: int, height: int, samples: int,
                   sampler, mesh: Sequence,
                   max_depth: int = path_mod.MAX_DEPTH,
                   sample_chunk: int = 0) -> torch.Tensor:
    """The batch integrator's render (integrator/path.py:render_image) with
    the pixels split over the mesh's workers: the tonemapped (H, W, 3)
    image on worker 0's device, equal to the single-worker render's.
    On a card each worker's radiance_sum runs a BatchRun of its own: its
    graphs (their span draws fixed at its pixel offset), capture stream
    and memory pool are its own, also for two workers on one card; the
    processes' sum (all_reduce) follows the replays, outside any graph."""
    scenes = replicate_scene(scene, mesh)
    cameras = replicate_scene(camera, mesh)
    dev0 = torch.device(mesh[0])
    wh = width * height
    total = torch.zeros((wh, 3), dtype=torch.float32, device=dev0)
    for i, (_, a, b) in enumerate(_slices(wh, mesh)):
        if a == b:
            continue
        part = path_mod.radiance_sum(
            scenes[i], cameras[i], width, height, samples,
            _sampler_on(sampler, mesh[i]), max_depth, sample_chunk,
            pix0=a, n_pix=b - a)
        total[a:b] = part.to(dev0)
    if _process()[1] > 1:
        _all_reduce_(total)
    return film_ops.tonemap(total / float(samples)).reshape(height, width, 3)


def _stack(states: list, device) -> wf.PoolState:
    """The workers' states as one stacked state on `device` (a copy)."""
    fields = {f: torch.stack([getattr(s, f).to(device) for s in states])
              for f in ("fb", "counter", "retired") + wf._LANE_FIELDS}
    return wf.PoolState(**fields, it=[s.it for s in states])


def _unstack(state: wf.PoolState, i: int, device) -> wf.PoolState:
    """Worker i's state of a stacked one, a copy on `device`."""
    fields = {f: getattr(state, f)[i].to(device, copy=True)
              for f in ("fb", "counter", "retired") + wf._LANE_FIELDS}
    return wf.PoolState(**fields, it=int(state.it[i]))


def render_wavefront_sharded(
        scene, camera, width: int, height: int, samples: int, sampler,
        mesh: Sequence, max_depth: int = path_mod.MAX_DEPTH, pool: int = 0,
        steps_per_call: int = 8,
        progress_cb: Optional[Callable[[int, int], None]] = None,
        checkpoint_cb: Optional[Callable[[wf.PoolState], None]] = None,
        state: Optional[wf.PoolState] = None, rr: bool = True,
        sample_chunk: int = wf.SAMPLE_CHUNK,
        pool_sort: Optional[int] = None) -> torch.Tensor:
    """The wavefront render with the work items split over the mesh's
    workers -> the tonemapped (H, W, 3) image on worker 0's device.

    Worker g (of every process's workers) drains items [g * per, g * per +
    its count) with a pool of `pool // workers` lanes (default
    wavefront.DEFAULT_POOL // workers) and sampler.fold_in(g). The drain
    runs in blocks of `steps_per_call` iterations a worker, the workers'
    blocks issued one after another, and after each:
    - progress_cb(retired samples of all workers, total samples);
    - checkpoint_cb(stacked state): every field with a leading worker
      axis, `it` a list (io/checkpoint.py writes it as is).
    state resumes such a stacked state; its worker count must be the
    mesh's. The random streams are not the single-worker render's, so it
    agrees with that one statistically, not bit for bit."""
    rank, world = _process()
    n = len(mesh) * world
    if world > 1 and (state is not None or checkpoint_cb is not None):
        raise ValueError("checkpoints of a render across processes are not "
                         "supported: render on one process to checkpoint")
    wh = width * height
    _, n_chunks, _ = wf._chunk_geometry(samples, sample_chunk)
    total = wh * n_chunks
    total_samples = wh * samples
    per = -(-total // n)
    pool_per = min(max(pool // n, 1) if pool else wf.DEFAULT_POOL // n or 1,
                   per)
    slices = _slices(total, mesh)
    items = [range(a, b) for _, a, b in slices]
    need = [wf._samples_of(r, wh, samples, sample_chunk) for r in items]
    samplers = [_sampler_on(sampler.fold_in(g), dev)
                for dev, (g, _, _) in zip(mesh, slices)]
    scenes = replicate_scene(scene, mesh)
    cameras = replicate_scene(camera, mesh)
    dev0 = torch.device(mesh[0])
    if state is None:
        states = [wf.init_state(width, height, pool_per, dev) for dev in mesh]
    else:
        if state.retired.ndim != 1:
            raise ValueError(
                "checkpoint is a single-device render state; this render "
                f"runs on a {n}-device mesh: resume it with one device or "
                "restart")
        if state.retired.shape[0] != n:
            raise ValueError(
                f"checkpoint has {state.retired.shape[0]} worker states, "
                f"the mesh has {n} devices: resume on the same mesh size")
        states = [_unstack(state, i, dev) for i, dev in enumerate(mesh)]

    def retired_all(done):
        t = torch.tensor([sum(done)], dtype=torch.int64)
        return int(_all_reduce_(t)) if world > 1 else int(t)

    done = [0] * len(states) if state is None else [
        int(s.retired) for s in states]
    retired = retired_all(done)
    while retired < total_samples:
        blocks = {}
        for i, s in enumerate(states):
            if done[i] < need[i]:
                blocks[i] = wf._issue_block(
                    s, scenes[i], cameras[i], width, height, samples,
                    samplers[i], items[i], steps_per_call, max_depth,
                    sample_chunk, rr, pool_sort)
        for i, counts in blocks.items():
            done[i] = wf._close_block(states[i], counts, need[i])
        retired = retired_all(done)
        if progress_cb is not None:
            progress_cb(retired, total_samples)
        if checkpoint_cb is not None:
            checkpoint_cb(_stack(states, dev0))
    fb = states[0].fb.clone()
    for s in states[1:]:
        fb += s.fb.to(dev0)
    if world > 1:
        _all_reduce_(fb)
    return wf.film_image(fb, width, height, samples)


def _leaves(params: dict) -> list:
    return list(params["materials"].values()) + list(params.get("verts", []))


def sharded_render_loss(params, rebuild, camera, width: int, height: int,
                        sampler, n_samples: int, target, mesh: Sequence,
                        max_depth: int = 6,
                        mesh_backend: str = "kernel_replay") -> torch.Tensor:
    """The fit's loss (diff/fit.py:render_loss, tonemapped) with the pixels
    split over the mesh: each worker renders its contiguous slice through
    render_linear_slice on its device (the kernel find included), its mean
    over the slice divided by the worker count is its share, and the shares
    are summed in worker order on worker 0's device. Gradients flow back to
    `params` through the differentiable .to(device). Across processes the
    result is this process's share (make_sharded_fit_step sums the shares
    and the gradients). target: (W*H, 3) linear radiance; W*H must divide
    over the workers."""
    _, world = _process()
    n = len(mesh) * world
    wh = width * height
    if wh % n:
        raise ValueError(f"{wh} pixels do not divide over {n} devices")
    scene = rebuild(params)
    scenes = replicate_scene(scene, mesh)
    cameras = replicate_scene(camera, mesh)
    dev0 = torch.device(mesh[0])
    loss = None
    for i, (_, a, b) in enumerate(_slices(wh, mesh)):
        dev = mesh[i]
        img = fit_mod.render_linear_slice(
            scenes[i], cameras[i], width, height, _sampler_on(sampler, dev),
            n_samples, a, b - a, max_depth, mesh_backend)
        share = (fit_mod._loss_from_image(img, target[a:b].to(dev)) / n
                 ).to(dev0)
        loss = share if loss is None else loss + share
    return loss


def make_sharded_fit_step(rebuild, camera, width: int, height: int,
                          n_samples: int, target, mesh: Sequence, opt,
                          max_depth: int = 6,
                          mesh_backend: str = "kernel_replay"):
    """One data-parallel fit step, built once and called a step: the
    sharded loss and its backward, the gradients (and the loss) summed over
    the processes, then `opt` (a torch optimizer over the leaves of the
    params) and the physical-range projection of diff/fit.py, the same
    trajectory as fit_materials. -> step(params, sampler) -> the loss of
    the parameters the step started from (a float); params change in
    place."""
    _, world = _process()

    def step(params, sampler) -> float:
        opt.zero_grad(set_to_none=True)
        loss = sharded_render_loss(params, rebuild, camera, width, height,
                                   sampler, n_samples, target, mesh,
                                   max_depth, mesh_backend)
        loss.backward()
        loss = loss.detach()
        for p in _leaves(params):
            # optax updates a parameter with no gradient as one with a
            # zero gradient; torch's optimizers would skip it
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            if world > 1:
                _all_reduce_(p.grad)
        if world > 1:
            _all_reduce_(loss)
        opt.step()
        fit_mod.project_materials(params)
        return float(loss)

    return step


def sharded_fit_step(params, rebuild, camera, width: int, height: int,
                     sampler, n_samples: int, target, mesh: Sequence, opt,
                     max_depth: int = 6,
                     mesh_backend: str = "kernel_replay") -> float:
    """One step of make_sharded_fit_step's, built for this call (a fit loop
    should build the step once)."""
    return make_sharded_fit_step(rebuild, camera, width, height, n_samples,
                                 target, mesh, opt, max_depth,
                                 mesh_backend)(params, sampler)
