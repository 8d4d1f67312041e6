"""The render's block graph kept across renders (integrator/wavefront.py:
RENDER_GRAPHS) on the CPU, with an eager stand-in for the graph: renders
that reuse it equal fresh eager renders bit for bit, each field of its key
and each change in place of what the capture holds tells renders apart,
the reset pool is init_state's, the state handed back is the caller's own,
a resumed render leaves the kept graph alone, and hrt.render says how its
graph ran. Also the key slot's folds by the stream purposes
(core/rng.py:KeySlot), which the kept graph's draws read. The card's
cases (kept graph against a cleared cache, bit for bit) are in
tests/test_torch_cuda.py and tests/test_torch_tracing_cuda.py."""
import contextlib
import dataclasses

import pytest
import torch

from hobbyraytracer_tpu_torch import tracing
from hobbyraytracer_tpu_torch.core import rng as rng_mod
from hobbyraytracer_tpu_torch.core.rng import KeySlot, Sampler
from hobbyraytracer_tpu_torch.integrator import wavefront as pwf
from hobbyraytracer_tpu_torch.kernels import build as kbuild
from hobbyraytracer_tpu_torch.ops import intersect as isect
from hobbyraytracer_tpu_torch.scene import build_scene, load_scene_desc
from hobbyraytracer_tpu_torch.scene import ir as pir

from _torch_parity import TEAPOT

torch.set_num_threads(2)

CUDA = torch.device("cuda")
FIELDS = ("fb", "o", "d", "thr", "rad", "item", "depth", "sub", "defer",
          "counter", "retired")
# 8x8 @ 2 spp, depth 4, on a 48-lane pool, 3 segments a block: the pool
# runs dry inside a block (it is no multiple of 3)
RENDER = dict(size=8, spp=2, depth=4, pool=48, steps=3, chunk=2, rr=True)


@pytest.fixture
def kept(monkeypatch):
    """The graph route on the CPU: graphs are on for it as for a card
    (kernels/build.py:graphs_on, outside its switches), _BlockGraph is a
    stand-in that runs each block eagerly on the state's tensors as static
    buffers (as a replay runs it), and RENDER_GRAPHS a cache of its own ->
    the list of stand-ins made (one a captured graph)."""
    made = []

    class EagerBlocks(pwf._BlockGraph):
        def __init__(self, device):
            self.device = torch.device(device)
            self.it = torch.zeros((), dtype=torch.int32, device=device)
            made.append(self)

        def run(self, state, block):
            self.it.fill_(state.it)
            counts = pwf._static_block(state, self.it, block)
            state.it += len(counts)
            return counts

    graphs_on = kbuild.graphs_on
    monkeypatch.setattr(kbuild, "graphs_on", lambda device: graphs_on(CUDA))
    monkeypatch.setattr(pwf, "_BlockGraph", EagerBlocks)
    monkeypatch.setattr(pwf, "RENDER_GRAPHS", pwf.RenderGraphs())
    tracing.RECORDER.drain()
    yield made
    tracing.RECORDER.drain()


@pytest.fixture(scope="module")
def teapot():
    job = build_scene(load_scene_desc(TEAPOT))
    return job.scene, job.camera


def _render(scene, camera, seed, size=8, width=None, height=None, spp=2,
            depth=4, pool=48, steps=3, chunk=2, rr=True, **kwargs):
    return pwf.render_state(scene, camera, width or size, height or size,
                            spp, Sampler(seed, "cpu"), max_depth=depth,
                            pool=pool, steps_per_call=steps,
                            sample_chunk=chunk, rr=rr, **kwargs)


def _eager(*args, **kwargs):
    """_render with nothing captured (kernels/build.py:eager)."""
    with kbuild.eager():
        return _render(*args, **kwargs)


def _assert_same_state(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.it == b.it


def _storage(state) -> set:
    return {getattr(state, f).data_ptr() for f in FIELDS}


def test_kept_render_equals_fresh_renders(kept, teapot):
    """Three renders of one scene and camera with three seeds: the first
    captures, the other two reset the kept pool and replay every block (1
    capture, 2 hits), and each equals a fresh eager render of its seed bit
    for bit, every field and `it`, which stops inside a block (the pool
    ran dry there); so does render_image's film. The seeds' images
    differ."""
    scene, camera = teapot
    states = [_render(scene, camera, seed) for seed in (1, 2, 3)]
    graphs = pwf.RENDER_GRAPHS
    assert (len(kept), graphs.captures, graphs.hits) == (1, 1, 2)
    for seed, st in zip((1, 2, 3), states):
        _assert_same_state(st, _eager(scene, camera, seed))
        assert int(st.retired) == 8 * 8 * 2
        assert st.it % RENDER["steps"] != 0
    assert len({float(st.fb.sum()) for st in states}) == 3
    img = pwf.render_image(scene, camera, 8, 8, 2, Sampler(4, "cpu"),
                           max_depth=4, pool=48, sample_chunk=2)
    with kbuild.eager():
        ref = pwf.render_image(scene, camera, 8, 8, 2, Sampler(4, "cpu"),
                               max_depth=4, pool=48, sample_chunk=2)
    assert torch.equal(img, ref)
    assert (graphs.captures, graphs.hits) == (2, 2)
    pwf.render_image(scene, camera, 8, 8, 2, Sampler(5, "cpu"), max_depth=4,
                     pool=48, sample_chunk=2)
    assert (graphs.captures, graphs.hits) == (2, 3)


MISSES = {
    "width": dict(width=6),
    "height": dict(height=6),
    "spp": dict(spp=1),
    "max_depth": dict(depth=3),
    "pool": dict(pool=40),
    "steps_per_call": dict(steps=2),
    "sample_chunk": dict(chunk=1),
    "rr": dict(rr=False),
    "scene object": dict(scene=lambda s: pir.replace(s)),
    "camera object": dict(camera=lambda c: pir.replace(c)),
    "traced": dict(traced=True),
}


@pytest.mark.parametrize("field_", list(MISSES))
def test_each_key_field_tells_renders_apart(kept, teapot, field_):
    """A render that differs from the kept one in one field of the key
    (the film's width or height, spp, depth, pool, block length, sample
    chunk, RR, the scene or camera object, traced) misses and captures a
    graph of its own, which equals a fresh eager render; a second such
    render hits it. A traced render's graph is kept beside the untraced
    one, so an untraced render after it still hits; any other miss
    replaces the kept graph."""
    scene, camera = teapot
    _render(scene, camera, 1)
    change = dict(MISSES[field_])
    traced = change.pop("traced", False)
    scene2 = change.pop("scene", lambda s: s)(scene)
    camera2 = change.pop("camera", lambda c: c)(camera)

    def second(seed):
        with tracing.recording() if traced else contextlib.nullcontext():
            return _render(scene2, camera2, seed, **change)

    st = second(2)
    graphs = pwf.RENDER_GRAPHS
    assert (len(kept), graphs.captures, graphs.hits) == (2, 2, 0)
    assert len(graphs.kept) == (2 if traced else 1)
    _assert_same_state(st, _eager(scene2, camera2, 2, **change))
    second(3)
    assert (len(kept), graphs.hits) == (2, 1)
    _render(scene, camera, 4)
    assert (len(kept), graphs.hits) == ((2, 2) if traced else (3, 1))


IN_PLACE = {
    "use_lens": lambda scene, camera: (camera, "use_lens", True),
    "scene buffer reassigned": lambda scene, camera: (
        scene.materials, "albedo", scene.materials.albedo.clone()),
    "find switch": lambda scene, camera: (
        isect, "NO_COHSORT", not isect.NO_COHSORT),
}


@pytest.mark.parametrize("change", list(IN_PLACE))
def test_a_change_in_place_tells_renders_apart(kept, teapot, change):
    """The same scene and camera objects, changed in place between two
    renders: a flag the segment branches on as it is recorded
    (Camera.use_lens), a scene buffer set to another tensor (the graph
    reads the old one's address) or a switch of the finds
    (ops/intersect.py). The render after the change misses, captures a
    graph of its own and equals a fresh eager render under the change;
    once the change is undone the next render misses again."""
    job = build_scene(load_scene_desc(TEAPOT))
    scene, camera = job.scene, job.camera
    _render(scene, camera, 1)
    graphs = pwf.RENDER_GRAPHS
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(*IN_PLACE[change](scene, camera))
        st = _render(scene, camera, 2)
        assert (len(kept), graphs.captures, graphs.hits) == (2, 2, 0)
        _assert_same_state(st, _eager(scene, camera, 2))
    _render(scene, camera, 3)
    assert (len(kept), graphs.captures, graphs.hits) == (3, 3, 0)


def test_reset_state_is_init_state(kept, teapot):
    """reset_state makes a used pool (the kept one, after a render) equal
    init_state's, field for field (values, dtype, shape), with `it` 0, in
    place: its tensors stay the same objects."""
    scene, camera = teapot
    _render(scene, camera, 1)
    (entry,) = pwf.RENDER_GRAPHS.kept.values()
    st = entry.state
    tensors = {f: getattr(st, f) for f in FIELDS}
    assert st.it > 0 and int(st.retired) > 0
    pwf.reset_state(st)
    fresh = pwf.init_state(8, 8, 48, "cpu")
    for f in FIELDS:
        a, b = getattr(st, f), getattr(fresh, f)
        assert a is tensors[f], f
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), f
    assert st.it == fresh.it == 0


def test_render_state_hands_back_the_caller_s_own(kept, teapot):
    """The state render_state returns on the graph route shares no tensor
    with the kept pool, and a later render of the same key (a hit, which
    writes into the kept pool) leaves it as it was."""
    scene, camera = teapot
    first = _render(scene, camera, 1)
    before = dataclasses.replace(
        first, **{f: getattr(first, f).clone() for f in FIELDS})
    (entry,) = pwf.RENDER_GRAPHS.kept.values()
    assert not _storage(first) & _storage(entry.state)
    second = _render(scene, camera, 2)
    assert pwf.RENDER_GRAPHS.hits == 1
    _assert_same_state(first, before)
    assert not torch.equal(first.fb, second.fb)


def test_resumed_render_leaves_the_kept_graph_alone(kept, teapot):
    """A render given `state=` (a resume) neither takes nor gives a kept
    graph: the kept entry and the counts stay as they were, the resume
    makes a block graph of its own, and it finishes the interrupted render
    as the uninterrupted one, bit for bit."""
    scene, camera = teapot
    saved = []

    def keep(state):
        if not saved:
            saved.append(dataclasses.replace(
                state, **{f: getattr(state, f).clone() for f in FIELDS}))

    ref = _render(scene, camera, 1, checkpoint_cb=keep)
    graphs = pwf.RENDER_GRAPHS
    (entry,) = graphs.kept.values()
    counts = (len(kept), graphs.captures, graphs.hits)
    assert 0 < int(saved[0].retired) < 8 * 8 * 2
    out = _render(scene, camera, 1, state=saved[0])
    assert out is saved[0]
    _assert_same_state(out, ref)
    assert list(graphs.kept.values()) == [entry]
    assert (len(kept), graphs.captures, graphs.hits) == (
        counts[0] + 1, counts[1], counts[2])


def test_clear_drops_the_kept_graphs(kept, teapot):
    """RenderGraphs.clear drops every kept graph, traced or not: the next
    render of the same key captures again, and the counts stay."""
    scene, camera = teapot
    _render(scene, camera, 1)
    with tracing.recording():
        _render(scene, camera, 1)
    graphs = pwf.RENDER_GRAPHS
    assert len(graphs.kept) == 2
    graphs.clear()
    assert not graphs.kept and (graphs.captures, graphs.hits) == (2, 0)
    _render(scene, camera, 2)
    _render(scene, camera, 3)
    assert (len(kept), graphs.captures, graphs.hits) == (3, 3, 1)


def test_a_render_that_raises_keeps_nothing(kept, teapot):
    """A render whose block raises gives no graph back: the next render of
    the same key captures again."""
    scene, camera = teapot
    _render(scene, camera, 1)

    def fail(retired, total):
        raise RuntimeError("stop")

    with pytest.raises(RuntimeError, match="stop"):
        _render(scene, camera, 2, progress_cb=fail)
    graphs = pwf.RENDER_GRAPHS
    assert not graphs.kept and (graphs.captures, graphs.hits) == (1, 1)
    _render(scene, camera, 3)
    assert (len(kept), graphs.captures, graphs.hits) == (2, 2, 1)


def test_render_span_says_how_its_graph_ran(kept, teapot):
    """hrt.render's attribute `graph`: "capture" for a render that made its
    graph, "hit" for one that replayed a kept graph, "eager" for an eager
    render. The hit re-arms the kept graph's lane counters: the same seed
    counts the same lanes as the capture did."""
    scene, camera = teapot
    with tracing.recording() as rec:
        _render(scene, camera, 1)
        _render(scene, camera, 1)
        _eager(scene, camera, 1)
        records = rec.drain()
    roots = [s for s in records if s["type"] == "span"
             and s["name"] == "hrt.render"]
    assert [r["attrs"]["graph"] for r in roots] == ["capture", "hit",
                                                    "eager"]
    lanes = {}
    for c in records:
        if c["type"] == "counter" and c["name"].startswith(("lanes.",
                                                            "rows.")):
            lanes.setdefault(c["job"], {})[c["name"]] = c["value"]
    counted = [lanes[r["id"]] for r in roots]
    assert counted[0]["lanes.active"] > 0
    assert counted[0] == counted[1] == counted[2]


def test_slot_folds_draw_the_host_streams():
    """A key slot with the stream purposes' folds: a slotted sampler's
    stream draws under a device iteration (uniform, unit_sphere and the
    lens' stream of a stream) equal the host key's bit for bit for every
    purpose the render uses; a purpose past the folds is carried on the
    path, and a device fold after it is refused as before."""
    host = Sampler(2 ** 31 + 11, "cpu")
    slot = KeySlot("cpu", rng_mod.STREAM_TAGS)
    slot.fill(host.key)
    slotted = host.slotted(slot)
    it = torch.tensor(5, dtype=torch.int32)
    for purpose in range(rng_mod.STREAM_TAGS):
        assert torch.equal(slotted.uniform(purpose, it, (33,)),
                           host.uniform(purpose, 5, (33,))), purpose
        assert torch.equal(slotted.unit_sphere(purpose, it, (7,)),
                           host.unit_sphere(purpose, 5, (7,))), purpose
    lens_s = slotted.stream(rng_mod.LENS, it)
    lens_h = host.stream(rng_mod.LENS, 5)
    assert torch.equal(lens_s.in_disk(rng_mod.LENS, 0, (9,)),
                       lens_h.in_disk(rng_mod.LENS, 0, (9,)))
    other = rng_mod.EDGE_PICK
    assert torch.equal(slotted.fold_in(other).key_uniform((4,)),
                       host.fold_in(other).key_uniform((4,)))
    with pytest.raises(ValueError, match="one fold by a device value"):
        slotted.uniform(other, it, (4,))
    plain = KeySlot("cpu")
    plain.fill(host.key)
    assert plain.folds is None and torch.equal(plain.words, slot.words)
