"""Inverse rendering: the differentiable material / vertex fit (counterpart
of hobbyraytracer_tpu/diff/fit.py).

The scene's tables are the parameter vector. `select_params` takes the
differentiable ones out of a SceneIR (the material table's floats, and the
mesh vertices for a vertex fit) as leaf tensors that require grad, and
gives back `rebuild`, which puts them into a copy of the scene that shares
every other buffer (scene/ir.py:replace). `render_loss` renders that scene
with the differentiable integrator (integrator/path.py:trace_diff) and
`fit_materials` runs torch.optim.Adam on top (optax.adam's defaults:
betas 0.9 / 0.999, eps 1e-8). The gradients flow through each path's
shading chain; the discrete decisions are replayed without gradients.

On a CUDA device `fit_materials` runs its steps as the JAX package runs
its jitted step: the forward, the backward, Adam's update and
`project_materials` of a step are one CUDA graph (kernels/build.py:
GraphReplay), replayed every step; `fit_route` says when a step runs
eagerly instead. The graph outlives its fit (`FIT_GRAPHS`): a later fit of
the same scene and camera objects, their buffers and flags as they were,
at the same sizes replays it from its first step, its draws under its own
key, which the graph reads from a key slot (core/rng.py:KeySlot).

Mesh finds take "kernel_replay": the fused kernel (K1 / K2 on the card)
finds the winning triangle without gradients and the winner is replayed
from the live vertices. A vertex fit's `rebuild` refreshes the kernel's
tables from the live vertices (scene/ir.py:refresh_kernel_tables), so the
find follows the moving geometry.

`render_linear_slice` renders one worker's pixels of the sharded fit
(parallel/shard.py) with the whole image's draws sliced to them.

A traced fit (tracing.py: a profiler recording, or tracing.recording(),
when fit_materials starts) records the spans hrt.fit (its attribute
`graph`: "hit", "capture" or "eager") and hrt.fit.step and times each
step's forward, backward and Adam update by events that the step's CUDA
graph captures.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import tracing
from ..core.rng import KeySlot, Sampler
from ..integrator import path as path_mod
from ..kernels import build as kbuild
from ..ops import film
from ..ops import intersect as isect
from ..ops.camera import get_rays
from ..scene import ir as scene_ir

# material-table floats that are fit targets
MAT_FIELDS = ("albedo", "roughness", "strength", "ior", "metallness")


def project_materials(params: dict) -> dict:
    """Clamp the fitted material parameters to their physical ranges, in
    place and without gradients (after an optimizer step): albedo and
    roughness to [0, 1], ior to [1, 3], strength to >= 0."""
    m = params.get("materials")
    if m is not None:
        with torch.no_grad():
            m["albedo"].clamp_(0.0, 1.0)
            m["roughness"].clamp_(0.0, 1.0)
            m["ior"].clamp_(1.0, 3.0)
            m["strength"].clamp_(min=0.0)
    return params


def select_params(scene: scene_ir.SceneIR, fit_vertices: bool = False):
    """-> (params, rebuild). params: {"materials": {field: (M, ...)},
    "verts": [(V, 3) for each mesh instance]} ("verts" only for a vertex
    fit), leaf tensors that require grad, copies of the scene's buffers.
    rebuild(params) -> the scene with those tensors in place of its own
    (and, for a vertex fit, each mesh's kernel tables refreshed from
    them)."""
    leaves = [t.detach().clone().requires_grad_(True)
              for t in _start_values(scene, fit_vertices)]
    params = {"materials": dict(zip(MAT_FIELDS, leaves))}
    if fit_vertices:
        params["verts"] = leaves[len(MAT_FIELDS):]

    def rebuild(p) -> scene_ir.SceneIR:
        mats = scene_ir.replace(scene.materials, **p["materials"])
        if not fit_vertices:
            return scene_ir.replace(scene, materials=mats)
        verts = iter(p["verts"])
        instances = []
        for inst in scene.instances:
            if inst.kind == "mesh":
                mesh = scene_ir.refresh_kernel_tables(
                    scene_ir.replace(inst.mesh, verts=next(verts)))
                inst = scene_ir.replace(inst, mesh=mesh)
            instances.append(inst)
        return scene_ir.replace(scene, materials=mats,
                                instances=nn.ModuleList(instances))

    return params, rebuild


def _start_values(scene: scene_ir.SceneIR, fit_vertices: bool) -> list:
    """The scene's tensors that a fit's leaves start from, in the leaves'
    order (_leaves): the material fields of MAT_FIELDS, then each mesh
    instance's vertices for a vertex fit."""
    out = [getattr(scene.materials, f) for f in MAT_FIELDS]
    if fit_vertices:
        out += [inst.mesh.verts for inst in scene.instances
                if inst.kind == "mesh"]
    return out


def _leaves(params: dict) -> list:
    return list(params["materials"].values()) + list(params.get("verts", []))


def render_linear(scene: scene_ir.SceneIR, camera, width: int, height: int,
                  sampler, n_samples: int, max_depth: int = 6,
                  mesh_backend: str = "kernel_replay") -> torch.Tensor:
    """Linear radiance (W*H, 3), before the tonemap, averaged over
    n_samples jittered samples of the differentiable integrator; sample s
    draws from sampler.fold_in(s), as integrator/path.py:sample_radiance.
    Each sample runs under torch.utils.checkpoint, so the backward pass
    holds one sample's bounce chain at a time, whatever n_samples."""
    return render_linear_slice(scene, camera, width, height, sampler,
                               n_samples, 0, width * height, max_depth,
                               mesh_backend)


def render_linear_slice(scene: scene_ir.SceneIR, camera, width: int,
                        height: int, sampler, n_samples: int, pix0: int,
                        n_pix: int, max_depth: int = 6,
                        mesh_backend: str = "kernel_replay") -> torch.Tensor:
    """render_linear for the n_pix pixels from flat index pix0 on -> (n_pix,
    3). Every draw is the whole image's draw sliced to these pixels
    (core/rng.py span), so the result equals render_linear(...)[pix0:pix0 +
    n_pix] bit for bit: one worker's share of the sharded fit
    (parallel/shard.py:sharded_render_loss)."""
    wh = width * height
    x, y = path_mod.pixel_grid(width, height, sampler.device, pix0, n_pix)
    span = None if n_pix == wh else (pix0, wh)

    def one_sample(s):
        ku, kv, kt = sampler.fold_in(s).split(3)
        ju = ku.key_uniform(x.shape, span)
        jv = kv.key_uniform(y.shape, span)
        rays = get_rays(camera, (x + ju) / (width - 1),
                        (y + jv) / (height - 1), kt, 0, span)
        return path_mod.trace_diff(scene, rays, kt, max_depth,
                                   mesh_backend=mesh_backend, rng_span=span)

    acc = torch.zeros((n_pix, 3), dtype=torch.float32,
                      device=sampler.device)
    for s in range(n_samples):
        # no generator state to stash: see integrator/path.py:trace_diff
        acc = acc + checkpoint(one_sample, s, use_reentrant=False,
                               preserve_rng_state=False)
    return acc / float(n_samples)


def _loss_from_image(img, target, tonemapped: bool = True):
    """Mean squared error between (W*H, 3) linear radiance images, in
    tonemapped space unless told otherwise."""
    if tonemapped:
        img = film.tonemap(img, grad_eps=1e-6)
        target = film.tonemap(target, grad_eps=1e-6)
    return ((img - target) ** 2).mean()


def render_loss(params, rebuild, camera, width, height, sampler, n_samples,
                target, max_depth: int = 6, tonemapped: bool = True,
                mesh_backend: str = "kernel_replay"):
    """The image loss of the scene rebuilt from params against `target`
    ((W*H, 3) linear radiance): a scalar tensor with gradients to params."""
    img = render_linear(rebuild(params), camera, width, height, sampler,
                        n_samples, max_depth, mesh_backend=mesh_backend)
    return _loss_from_image(img, target, tonemapped)


class FitResult(NamedTuple):
    scene: scene_ir.SceneIR
    losses: np.ndarray
    params: dict


def fit_route(scene: scene_ir.SceneIR, device, boundary: bool = False,
              correlated: bool = True, workers: int = 1) -> bool:
    """Does a fit replay its steps from a CUDA graph? Where graphs are on
    (kernels/build.py:graphs_on), unless a step reads the host or draws
    from other keys than the last: boundary=True (the edge-sampled terms
    run the batch integrator and the lockstep find, which read the host),
    correlated=False (step i draws from sampler.fold_in(i): a replay would
    draw step 1's numbers again), a scene whose finds read the host
    (scene/ir.py:finds_read_host) and more than one worker
    (parallel/shard.py's sharded step). Those run eagerly. The route
    follows from the configuration alone, never from a failure."""
    return (kbuild.graphs_on(device) and not boundary and correlated
            and workers == 1 and not scene_ir.finds_read_host(scene))


def _run_step(step, graph):
    """One fit step: step() eagerly (graph None) or by the fit's graph ->
    the loss, a 0-d tensor (after a replay the graph's own, valid until the
    next step)."""
    if graph is None:
        return step()
    with torch.cuda.device(graph.device):
        return graph(step)


@dataclass(eq=False)
class _Fit:
    """What a fit's steps run on: the parameter leaves (`params` and
    `rebuild`, as select_params gives them; `leaves` in _leaves's order)
    with their gradients, Adam over them, the target, `step(k)` (one step
    drawing from k -> its loss) and the graph that replays it (None:
    eager). `sampler` draws the steps of a correlated fit. A kept fit
    (FitGraphs) also holds its cache key, the scene and camera that the
    key names, the tensors whose addresses the key holds (`held`, kept
    alive so that no other tensor takes an address the graph reads), its
    key slot and the phase marks of its traced capture (tracing.py)."""
    params: dict
    rebuild: Callable
    leaves: list
    opt: torch.optim.Adam
    target: torch.Tensor
    step: Callable
    graph: Optional[kbuild.GraphReplay]
    sampler: Sampler
    scene: scene_ir.SceneIR
    camera: object
    fit_vertices: bool
    key: Optional[tuple] = None
    held: list = field(default_factory=list)
    slot: Optional[KeySlot] = None
    marks: list = field(default_factory=list)

    def reset(self, target, key) -> None:
        """Make this kept fit a fresh one of its scene to `target` under
        the host key `key`, in place: the leaves at the scene's values,
        the gradients and Adam's moments and step count at 0, the target
        and the slot's words written. A replayed first step then does an
        eager first step's arithmetic (Adam is capturable on the card on
        both routes)."""
        with torch.no_grad():
            for leaf, start in zip(self.leaves, _start_values(
                    self.scene, self.fit_vertices)):
                leaf.copy_(start)
                leaf.grad.zero_()
            for state in self.opt.state.values():
                for v in state.values():   # exp_avg, exp_avg_sq, step
                    v.zero_()
            self.target.copy_(target)
        self.slot.fill(key)


class FitGraphs:
    """The fits kept with their step graphs across fits, in one process
    (FIT_GRAPHS): at most one for each (device, traced) pair, since a
    traced graph holds timing events that an untraced one lacks. A fit
    takes the kept fit of its cache key out (`take`) and gives it back
    when it has run all its steps (`give`); a fit that raises never gives
    it back, so no half-run state is kept. `hits` counts the fits that
    replayed a kept graph, `captures` the fits on the graph route that
    captured one of their own. A kept fit holds its graph's memory pool
    and its scene and camera until a miss replaces it or `clear` drops
    it."""

    def __init__(self):
        self.kept = {}
        self.hits = 0
        self.captures = 0

    def clear(self) -> None:
        """Drop every kept fit, with its graph, buffers, scene and camera
        (the counts stay): the next fit captures again."""
        self.kept.clear()

    def take(self, key: tuple) -> Optional[_Fit]:
        """The kept fit of `key`, taken out, or None. A kept fit of another
        key on the same (device, traced) pair is dropped (a miss replaces
        it), so its graph's memory is free before the new capture."""
        fit = self.kept.pop(key[:2], None)
        return fit if fit is not None and fit.key == key else None

    def give(self, fit: _Fit) -> None:
        self.kept[fit.key[:2]] = fit


FIT_GRAPHS = FitGraphs()


def _new_fit(scene, camera, target, width, height, lr, n_samples,
             max_depth, sampler, fit_vertices, boundary, boundary_samples,
             shadow_light, graph, key=None, held=()) -> _Fit:
    """A fit's state and step at the scene's values (see _Fit). With a
    cache `key` (and the tensors it holds the addresses of, `held`) it is
    a fit to keep: its target a buffer of its own and its draws from a
    key slot, both for _Fit.reset to fill."""
    slot = None
    if key is not None:
        target = torch.empty_like(target)
        slot = KeySlot(target.device)
        sampler = sampler.slotted(slot)
    params, rebuild = select_params(scene, fit_vertices)
    leaves = _leaves(params)
    # every gradient is a buffer of its own, zeroed and summed into by each
    # step. A parameter outside the render keeps a zero gradient: optax
    # updates it as such (its step count advances), torch's Adam would
    # skip a parameter without one
    for p in leaves:
        p.grad = torch.zeros_like(p)
    # optax.adam's defaults. On a card capturable (the step count and the
    # bias corrections on the device) on both routes, so that an eager
    # step does a replayed one's arithmetic
    device = leaves[0].device
    opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           capturable=device.type == "cuda")
    edge_tables = None
    if boundary and fit_vertices:
        from . import edges as edge_mod
        edge_tables = []
        for inst in scene.instances:
            if inst.kind == "mesh":
                e, f = edge_mod.build_edge_table(
                    inst.mesh.indices.cpu().numpy())
                dev = inst.mesh.indices.device
                edge_tables.append((torch.from_numpy(e).to(dev),
                                    torch.from_numpy(f).to(dev),
                                    inst.mesh.indices))

    def boundary_terms(k):
        """Silhouette gradients of every fitted mesh at the current
        parameters, weighted by dL/dI of the current render."""
        from . import edges as edge_mod
        with torch.no_grad():
            cur = rebuild(params)
            img = render_linear(cur, camera, width, height, k, n_samples,
                                max_depth)
        img.requires_grad_(True)
        (w_img,) = torch.autograd.grad(_loss_from_image(img, target), img)
        w2d = w_img.reshape(height, width, 3)

        def radiance_fn(rays):
            # the forward integrator over the live vertices
            return path_mod.trace(cur, rays, k, max_depth,
                                  mesh_backend="lockstep")

        def hit_fn(rays):
            return scene_ir.intersect_scene(cur, rays, sampler=k, bounce=0,
                                            mesh_backend="lockstep")

        out = []
        for v, (e, f, idx) in zip(params["verts"], edge_tables):
            g = edge_mod.boundary_grad(v, e, f, idx, camera, w2d, width,
                                       height, radiance_fn, k,
                                       n_samples=boundary_samples)
            if shadow_light is not None:
                light = torch.as_tensor(shadow_light, dtype=torch.float32,
                                        device=v.device)
                g = g + edge_mod.shadow_boundary_grad(
                    v, e, f, idx, light, camera, w2d, width, height,
                    radiance_fn, hit_fn, k, n_samples=boundary_samples)
            out.append(g)
        return out

    def step(k) -> torch.Tensor:
        with tracing.phase("fit.forward"):
            for p in leaves:
                p.grad.zero_()
            loss = render_loss(params, rebuild, camera, width, height, k,
                               n_samples, target, max_depth)
        with tracing.phase("fit.backward"):
            loss.backward()
            if edge_tables is not None:
                for v, b in zip(params["verts"], boundary_terms(k)):
                    v.grad.add_(b)
        with tracing.phase("fit.adam"):
            opt.step()
            project_materials(params)
        return loss.detach()

    return _Fit(params, rebuild, leaves, opt, target, step, graph, sampler,
                scene, camera, fit_vertices, key, list(held), slot)


def _owned(params: dict) -> dict:
    """Copies of the parameter leaves, with copies of their gradients,
    that share no storage with the fit's own (which a kept fit's graph
    writes into again)."""
    def own(p):
        out = p.detach().clone().requires_grad_(True)
        out.grad = p.grad.clone()
        return out

    return {name: ({f: own(p) for f, p in group.items()}
                   if isinstance(group, dict) else [own(p) for p in group])
            for name, group in params.items()}


def fit_materials(scene: scene_ir.SceneIR, camera, target, width, height,
                  steps: int = 50, lr: float = 2e-2, n_samples: int = 4,
                  max_depth: int = 6, sampler=None,
                  fit_vertices: bool = False, verbose: bool = True,
                  correlated: bool = True, boundary: bool = False,
                  boundary_samples: int = 4096,
                  shadow_light=None) -> FitResult:
    """Adam fit of the material parameters (and the mesh vertices with
    fit_vertices) to a target image, target (W*H, 3) linear radiance on the
    scene's device. losses[i] is the loss at the parameters step i started
    from. The result's params (leaves with their last gradients) and scene
    are the caller's own: no later fit writes into them.

    correlated=True (the default) renders every step from the same
    sampler: when the target was rendered with it at the same spp, the
    Monte Carlo noise cancels between render and target and the optimum is
    exact. correlated=False draws step i from sampler.fold_in(i), for
    targets with noise of their own.

    boundary=True (with fit_vertices) adds the edge-sampled silhouette
    term (diff/edges.py:boundary_grad) to each mesh's vertex gradient;
    shadow_light, a (3,) emitter position, adds the shadow-silhouette term
    as well (shadow_boundary_grad). Without them the vertices feel only the
    smooth shading-chain gradient.

    On fit_route's CUDA route step 0 runs eagerly (the warm-up: it builds
    the kernels and creates Adam's state), step 1 is captured into a CUDA
    graph and replayed at once, and every later step is a replay: the
    forward, the backward, Adam's update and project_materials. The
    parameters, their gradients, the target and the loss are the graph's
    static buffers, and the loss is read once a step, as the JAX package's
    loop reads it. The fit is kept (FIT_GRAPHS) under a key of everything
    its capture holds fixed: the scene and camera objects, and in them each
    tensor's address and layout and each plain attribute (such as
    Camera.use_lens), ops/intersect.py's switches, the sizes, spp, depth,
    lr, fit_vertices, the target's shape and dtype, the device and whether
    the fit is traced. A later fit of the same key resets the kept buffers
    in place (_Fit.reset) and replays every step, step 0 included, drawing
    under its own sampler's key (host words) from the key slot. Off
    fit_route's graph route every step runs eagerly. All routes give the
    same losses and parameters bit for bit where the device's sums are
    deterministic."""
    if sampler is None:
        sampler = Sampler(0, target.device)
    device = scene.materials.albedo.device
    on_graph = fit_route(scene, device, boundary, correlated)
    losses = []
    with tracing.job("fit", device, width=width, height=height,
                     spp=n_samples, steps=steps) as job:
        fit = key = None
        held = []
        if on_graph:
            key = (device, job is not None, isect.switches(), id(scene),
                   id(camera), kbuild.held(scene, held),
                   kbuild.held(camera, held),
                   width, height, n_samples, max_depth, lr, fit_vertices,
                   tuple(target.shape), target.dtype)
            fit = FIT_GRAPHS.take(key)
        how = "hit" if fit is not None else "capture" if on_graph else "eager"
        if fit is None:
            fit = _new_fit(
                scene, camera, target, width, height, lr, n_samples,
                max_depth, sampler, fit_vertices, boundary, boundary_samples,
                shadow_light,
                kbuild.GraphReplay(device) if on_graph else None, key, held)
        if on_graph:
            fit.reset(target, sampler.key)
        FIT_GRAPHS.hits += how == "hit"
        FIT_GRAPHS.captures += how == "capture"
        if job is not None:
            job.root.attrs["graph"] = how
            job.captured = fit.marks
        for i in range(steps):
            k = fit.sampler if correlated else sampler.fold_in(i)
            with tracing.span("fit.step", index=i):
                losses.append(float(_run_step(lambda: fit.step(k),
                                              fit.graph)))
                tracing.read_phases(1)
            if verbose and (i % max(1, steps // 10) == 0 or i == steps - 1):
                print(f"fit step {i}: loss {losses[-1]:.6f}")
        if on_graph:
            if job is not None:
                fit.marks = job.captured
            FIT_GRAPHS.give(fit)
    params = _owned(fit.params)
    with torch.no_grad():
        fitted = fit.rebuild(params)
    return FitResult(scene=fitted, losses=np.asarray(losses), params=params)
