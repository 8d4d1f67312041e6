"""The reference against the program on the CPU, and the check's verdicts:
the reference on both sides passes; its bfloat16 control and each planted
fault of the timed path fail (tiny films; the program runs its eager route
and the plain versions of its kernels)."""
import dataclasses
import time

import pytest
import torch

from perfbench import faults, harness, jobs, manifest
from perfbench.reference import scene as ref_scene

TINY = {"render": dict(width=24, height=20, spp=4, pool=512),
        "fit": dict(width=24, height=14, spp=2, steps=3)}
CELLS = ("teapot.final640", "shiny_teapot.film1080", "shiny_teapot.fit")


def tiny_cell(name: str):
    cell = manifest.load_cell(name)
    return dataclasses.replace(cell, traffic={
        **cell.traffic, **TINY[cell.traffic["job"]]})


def run(cell, program_cls=None, seed=2 ** 31 + 7):
    return harness.run_cell(cell, seed, 0.5, False, "cpu",
                            time.perf_counter(), program_cls)


def as_program(dtype):
    """The reference in `dtype` put in the program's place."""
    def make(cls):
        class Reference(cls):
            def run(self, j):
                return cls.as_output(self.reference(j, dtype))
        return Reference
    return make


@pytest.mark.parametrize("name", CELLS)
def test_program_reads_as_the_reference_bit_for_bit(name):
    result = run(tiny_cell(name))
    assert result["correct"]
    assert all(c["value"] == 0.0 for c in result["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_reference_on_both_sides_is_correct(name):
    cell = tiny_cell(name)
    cls = jobs.kind(cell)
    assert run(cell, as_program(torch.float32)(cls))["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_bfloat16_control_is_not_correct(name):
    cell = tiny_cell(name)
    cls = jobs.kind(cell)
    result = run(cell, as_program(torch.bfloat16)(cls))
    assert not result["correct"]


@pytest.mark.parametrize("fault", ["half_the_samples", "answer_altered",
                                   "framebuffer_unchanged"])
def test_render_fault_is_not_correct(fault):
    cell = tiny_cell("teapot.final640")
    assert not run(cell, faults.broken(cell, fault))["correct"]


@pytest.mark.parametrize("fault", ["step_unchanged", "half_the_batch",
                                   "answer_altered"])
def test_fit_fault_is_not_correct(fault):
    cell = tiny_cell("shiny_teapot.fit")
    assert not run(cell, faults.broken(cell, fault))["correct"]


def test_cluster_split_keeps_equal_keys_as_std_sort_does():
    import numpy as np
    rng = np.random.default_rng(3)
    for n in (2, 16, 17, 100, 2000):
        keys = rng.integers(0, 5, n).tolist()
        order = list(range(n))
        ref_scene.std_sort(order, lambda p, q: keys[p] < keys[q])
        assert [keys[i] for i in order] == sorted(keys)


def test_cluster_split_is_the_host_builders():
    """The reference's clusters are the program's own host build's, leaf
    for leaf and slot for slot (where its native builder builds here)."""
    import numpy as np
    from hobbyraytracer_tpu_torch import native
    mesh = ref_scene.read_obj(manifest.ROOT + "/perfbench/assets/teapot.obj")
    built = native.build_clusters(mesh["verts"], mesh["indices"], 128,
                                  sah=True)
    if built is None:
        pytest.skip("the program's native host builder does not build here")
    groups = ref_scene.clusters(mesh["verts"], mesh["indices"])
    ids = built["tri_id"]
    assert len(groups) == len(ids)
    for g, row in zip(groups, ids):
        assert np.array_equal(g, row[row >= 0])
