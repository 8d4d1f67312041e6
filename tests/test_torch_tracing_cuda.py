"""The program's own tracing (hobbyraytracer_tpu_torch/tracing.py) on the
card: the timing events inside a replayed block graph against CUDA events
around the replay; the untraced block graph against the traced one, node
type by node type; the graph's kernel nodes against the kernels a profiler
sees a replayed segment; the fit's step graph, and its replays when a
later fit keeps it; a render's kept block graph replayed from its first
block by a later render; the profiler's copies of
the program's spans dropped by the benchmark's reduction. Every test needs
a CUDA card and skips without one; the file imports neither JAX nor the
JAX package:

    python -m pytest --noconftest -o markers=cuda \
        tests/test_torch_tracing_cuda.py -q
"""
import os

import numpy as np
import pytest
import torch

from hobbyraytracer_tpu_torch import tracing
from hobbyraytracer_tpu_torch.core.rng import Sampler
from hobbyraytracer_tpu_torch.diff import fit as pfit
from hobbyraytracer_tpu_torch.integrator import wavefront as pwf
from hobbyraytracer_tpu_torch.kernels import build as kbuild
from hobbyraytracer_tpu_torch.scene import build_scene, load_scene_desc
from hobbyraytracer_tpu_torch.scene import ir as pir

SCENES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "scenes")
PHASES = ("hrt.segment.regenerate", "hrt.segment.find", "hrt.segment.shade",
          "hrt.segment.retire")

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def teapot(card):
    job = build_scene(load_scene_desc(os.path.join(SCENES,
                                                   "teapot_scene.yaml")))
    return job.scene.to(card), job.camera.to(card)


@pytest.fixture(autouse=True)
def empty_recorder():
    tracing.RECORDER.drain()
    yield
    tracing.RECORDER.drain()


@pytest.fixture(autouse=True)
def own_render_graphs(monkeypatch):
    """Each test starts with no kept block graph (integrator/wavefront.py:
    RENDER_GRAPHS), so its first render of a configuration captures one,
    and leaves none behind."""
    monkeypatch.setattr(pwf, "RENDER_GRAPHS", pwf.RenderGraphs())


def _render(teapot, card, size=640, spp=8, seed=3):
    scene, camera = teapot
    img = pwf.render_image(scene, camera, size, size, spp,
                           Sampler(seed, card), max_depth=50)
    torch.cuda.synchronize(card)
    return img


def _counters(records, job=None):
    out = {}
    for c in records:
        if c["type"] == "counter" and (job is None or c["job"] == job):
            out[c["name"]] = out.get(c["name"], 0) + c["value"]
    return out


def test_replayed_block_phases_sum_to_the_replay(monkeypatch, teapot, card):
    """Each block after the capture: every phase reads > 0 ms, and the
    four phases sum to within 5% of CUDA events recorded around the graph's
    replay on the same stream."""
    timed = []
    replay = kbuild.GraphReplay.replay

    def around(graph):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = replay(graph)
        b.record()
        timed.append((a, b))
        return out

    monkeypatch.setattr(kbuild.GraphReplay, "replay", around)
    with tracing.recording() as rec:
        _render(teapot, card)
    phases = [p for p in rec.records() if p["type"] == "phase"
              and p["route"] != "eager"]
    blocks = [phases[i:i + 4] for i in range(0, len(phases), 4)]
    assert len(blocks) == len(timed) >= 3
    assert blocks[0][0]["route"] == "capture"
    for block, (a, b) in zip(blocks, timed):
        assert [p["name"] for p in block] == list(PHASES)
        assert all(p["ms"] > 0 and p["units"] == 8 for p in block)
        whole = a.elapsed_time(b)
        assert abs(sum(p["ms"] for p in block) - whole) <= 0.05 * whole


def _nodes_of_count_lanes(card, pool) -> dict:
    """The nodes that tracing.count_lanes adds to a graph, once."""
    cap = pwf.retire_cap(pool)
    masks = [torch.zeros(n, dtype=torch.bool, device=card)
             for n in (pool, pool, pool, cap)]
    with tracing.recording(), tracing.job("render", card):
        tracing.lane_counters(card, pool, cap)
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.device(card), torch.cuda.graph(g):
            tracing.count_lanes(*masks)
        return tracing.graph_nodes(g)


def test_untraced_block_graph_has_no_event_and_no_counter(monkeypatch,
                                                          teapot, card):
    """The block graph of an untraced render (kept past its capture here
    only to count it) holds no event-record node, and its kernel nodes are
    the traced graph's less the lane counters' kernels of each segment;
    its copies and fills are the traced graph's."""
    untraced = []
    graph_cls = torch.cuda.CUDAGraph
    capture = kbuild.GraphReplay.capture

    def counted(graph, fn):
        capture(graph, fn)
        untraced.append(tracing.graph_nodes(graph.graph))

    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "CUDAGraph",
                  lambda keep_graph=False: graph_cls(keep_graph=True))
        m.setattr(kbuild.GraphReplay, "capture", counted)
        _render(teapot, card, size=256, spp=4)
    assert tracing.RECORDER.records() == []
    (off,) = untraced
    with tracing.recording() as rec:
        _render(teapot, card, size=256, spp=4)
    on = {k[len("graph."):]: v for k, v in _counters(rec.records()).items()
          if k.startswith("graph.")}
    steps = 8
    per_count = _nodes_of_count_lanes(card,
                                      min(pwf.DEFAULT_POOL, 256 * 256))
    assert off["event_record"] == 0
    # the four phases of a segment share their boundaries: five events
    assert on["event_record"] == steps * (len(PHASES) + 1)
    assert per_count["kernel"] > 0
    assert off["kernel"] == on["kernel"] - steps * per_count["kernel"]
    assert (off["memcpy"], off["memset"]) == (on["memcpy"], on["memset"])


def test_kernel_nodes_a_segment_match_the_profiler(monkeypatch, teapot,
                                                    card):
    """kernel_nodes.segment's reading (the block graph's kernel nodes over
    its segments) within 5% of the kernel records a profiler sees in one
    replayed block, over its segments (it may lose a few records)."""
    from torch.profiler import ProfilerActivity, profile
    calls, seen = [0], []
    replay = kbuild.GraphReplay.replay

    def profiled(graph):
        calls[0] += 1
        if calls[0] != 3:
            return replay(graph)
        torch.cuda.synchronize(card)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = replay(graph)
            torch.cuda.synchronize(card)
        seen.extend(e for e in prof.profiler.kineto_results.events()
                    if str(e.device_type()).endswith("CUDA")
                    and not e.is_user_annotation()
                    and not e.name().startswith(("Memcpy", "Memset")))
        return out

    monkeypatch.setattr(kbuild.GraphReplay, "replay", profiled)
    with tracing.recording() as rec:
        _render(teapot, card)
    root = next(s for s in rec.records() if s["type"] == "span"
                and s["name"] == "hrt.render")
    steps = root["attrs"]["steps"]
    nodes = _counters(rec.records())["graph.kernel"] / steps
    assert seen
    assert abs(len(seen) / steps - nodes) <= 0.05 * nodes


def test_fit_step_graph_times_its_phases(card):
    """A traced fit on the card: the step graph's three phases read > 0 ms
    on every replayed step, the graph holds their four events (shared
    boundaries), and the losses are finite."""
    job = build_scene(load_scene_desc(os.path.join(SCENES,
                                                   "shiny_teapot.yaml")))
    scene, camera = job.scene.to(card), job.camera.to(card)
    sampler = Sampler(4, card)
    with torch.no_grad():
        target = pfit.render_linear(scene, camera, 60, 34, sampler, 4, 6)
    m = scene.materials
    start = pir.replace(scene, materials=pir.replace(
        m, albedo=torch.clamp(m.albedo * 0.3 + 0.3, 0, 1)))
    with tracing.recording() as rec:
        res = pfit.fit_materials(start, camera, target, 60, 34, steps=6,
                                 n_samples=4, max_depth=6, sampler=sampler,
                                 verbose=False)
    assert np.isfinite(res.losses).all()
    phases = [p for p in rec.records() if p["type"] == "phase"]
    routes = [p["route"] for p in phases[::3]]
    assert routes == ["eager", "capture"] + ["replay"] * 4
    assert all(p["ms"] > 0 for p in phases)
    counters = _counters(rec.records())
    assert counters["steps"] == 6 and counters["graph.event_record"] == 4
    assert counters["graph.kernel"] > 0


def test_kept_fit_graph_times_its_phases(monkeypatch, card):
    """Two traced fits of one start scene on the card: the second replays
    the first's kept step graph (diff/fit.py:FIT_GRAPHS) from its step 0,
    so its six steps all read the three phases, > 0 ms, from the events
    the first fit's capture recorded; it captures nothing, so it counts no
    graph nodes. Its hrt.fit reads graph "hit", the first's "capture"."""
    monkeypatch.setattr(pfit, "FIT_GRAPHS", pfit.FitGraphs())
    job = build_scene(load_scene_desc(os.path.join(SCENES,
                                                   "shiny_teapot.yaml")))
    scene, camera = job.scene.to(card), job.camera.to(card)
    with torch.no_grad():
        target = pfit.render_linear(scene, camera, 60, 34, Sampler(4, card),
                                    4, 6)
    with tracing.recording() as rec:
        for seed in (5, 6):
            res = pfit.fit_materials(scene, camera, target, 60, 34, steps=6,
                                     n_samples=4, max_depth=6,
                                     sampler=Sampler(seed, card),
                                     verbose=False)
            assert np.isfinite(res.losses).all()
    records = rec.records()
    roots = [s for s in records if s["type"] == "span"
             and s["name"] == "hrt.fit"]
    assert [r["attrs"]["graph"] for r in roots] == ["capture", "hit"]
    second = roots[1]["id"]
    phases = [p for p in records if p["type"] == "phase"
              and p["job"] == second]
    assert [p["route"] for p in phases] == ["replay"] * 18
    assert all(p["ms"] > 0 for p in phases)
    assert _counters(records, second) == {"steps": 6}
    assert "graph.kernel" in _counters(records, roots[0]["id"])


def test_kept_render_graph_times_its_phases(teapot, card):
    """Three traced renders of the teapot (256x256 @ 8 spp) with the seeds
    3, 4, 3: the second and third replay the first's kept block graph
    (integrator/wavefront.py:RENDER_GRAPHS) from their first block, so
    every block of theirs reads the four phases, > 0 ms, on the replay
    route from the events the first render's capture recorded; they
    capture nothing, so they count no graph nodes. Their lane counters,
    re-armed, count their own lanes: the third, of the first's seed,
    exactly the first's, the second others. hrt.render reads graph
    "capture", "hit", "hit"."""
    with tracing.recording() as rec:
        for seed in (3, 4, 3):
            _render(teapot, card, size=256, spp=8, seed=seed)
    records = rec.records()
    roots = [s for s in records if s["type"] == "span"
             and s["name"] == "hrt.render"]
    assert [r["attrs"]["graph"] for r in roots] == ["capture", "hit", "hit"]
    assert "graph.kernel" in _counters(records, roots[0]["id"])
    lanes = []
    for root in roots:
        counted = _counters(records, root["id"])
        lanes.append({k: v for k, v in counted.items()
                      if k.startswith(("lanes.", "rows."))})
        if root is roots[0]:
            continue
        assert not any(k.startswith("graph.") for k in counted)
        phases = [p for p in records if p["type"] == "phase"
                  and p["job"] == root["id"]]
        blocks = [phases[i:i + 4] for i in range(0, len(phases), 4)]
        assert len(blocks) * 8 == counted["segments"] and len(blocks) >= 3
        for block in blocks:
            assert [p["name"] for p in block] == list(PHASES)
            assert all(p["route"] == "replay" and p["ms"] > 0
                       and p["units"] == 8 for p in block)
    assert lanes[0]["lanes.active"] > 0
    assert lanes[2] == lanes[0] and lanes[1] != lanes[0]


def test_profiler_copies_of_the_spans_are_annotations(teapot, card):
    """Under torch.profiler on the card every range named hrt.* is a user
    annotation (host or device side), which the benchmark's reduction of a
    profiled job (perfbench/profiling.py:read_trace) leaves out of busy
    time; the recorder holds each span once."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _render(teapot, card, size=128, spp=4)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("hrt.")]
    assert events and all(e.is_user_annotation() for e in events)
    host = [e for e in events if not str(e.device_type()).endswith("CUDA")]
    spans = [s for s in tracing.RECORDER.records() if s["type"] == "span"]
    assert len(host) == len(spans)


def test_traced_render_equals_untraced_on_the_card(teapot, card):
    """With deterministic sums, a traced render's image equals the
    untraced one's bit for bit."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        off = _render(teapot, card, size=128, spp=8)
        with tracing.recording():
            on = _render(teapot, card, size=128, spp=8)
    finally:
        torch.use_deterministic_algorithms(before)
    assert torch.equal(off, on)


@pytest.fixture(scope="module")
def balls(card):
    job = build_scene(load_scene_desc(os.path.join(SCENES,
                                                   "scattered_balls.yaml")))
    return job.scene.to(card), job.camera.to(card)


def test_sphere_find_phase_reads_on_the_replay_route(balls, card):
    """A traced render of the 485 spheres by the default dense scan: each
    replayed block reads hrt.segment.find.spheres above 0 ms and at most
    its find; the traced block graph holds two events a segment more than
    the four phases' five; the render names the dense route, counts
    sphere hits among its active lanes, launches the sphere_scan kernel
    once a segment (its library's count) and no K4."""
    from hobbyraytracer_tpu_torch.kernels import sphere_scan as scmod
    from hobbyraytracer_tpu_torch.kernels import sphere_traverse as skmod
    launches = skmod.SPHERE_KERNEL.launches
    scans = scmod.SCAN_KERNEL.launches
    with tracing.recording() as rec:
        _render(balls, card, size=320, spp=4)
    records = rec.records()
    root = next(s for s in records if s["type"] == "span"
                and s["name"] == "hrt.render")
    assert root["attrs"]["spheres"] == 485
    assert root["attrs"]["sphere_route"] == "dense"
    replays = [p for p in records if p["type"] == "phase"
               and p["route"] == "replay"]
    blocks = [replays[i:i + 5] for i in range(0, len(replays), 5)]
    assert len(blocks) >= 2
    for block in blocks:
        ms = {p["name"]: p["ms"] for p in block}
        assert set(ms) == {*PHASES, "hrt.segment.find.spheres"}
        assert 0 < ms["hrt.segment.find.spheres"] <= ms["hrt.segment.find"]
    counted = _counters(records)
    steps = root["attrs"]["steps"]
    assert counted["graph.event_record"] == steps * (len(PHASES) + 1 + 2)
    assert 0 < counted["lanes.sphere_hit"] <= counted["lanes.active"]
    assert 0 < counted["lanes.dielectric"] < counted["lanes.sphere_hit"]
    assert skmod.SPHERE_KERNEL.launches == launches
    assert scmod.SCAN_KERNEL.launches - scans == counted["segments"] > 0
