"""The harness on the card (marked `cuda`; skips without one): a short
window of the film256 cell at its own size, correct through the program's
graph route and traced, and the bfloat16 control not correct."""
import time

import pytest
import torch

from perfbench import harness, jobs, manifest


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_film256_runs_correct_on_the_card(cuda_device, trace):
    cell = manifest.load_cell("teapot.film256")
    result = harness.run_cell(cell, 2 ** 31 + 99, 2.0, trace, cuda_device,
                              time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["device"]["kind"].startswith("NVIDIA")
    want = cell.per_layer if trace else cell.end_to_end
    assert set(result["metrics"]) == {m["name"] for m in want}
    if trace:
        assert 0 < result["device"]["busy_s"] < result["device"]["window_s"]


@pytest.mark.cuda
def test_film256_bfloat16_control_is_not_correct(cuda_device):
    cell = manifest.load_cell("teapot.film256")

    class Control(jobs.RenderJobs):
        def run(self, j):
            return self.reference(j, torch.bfloat16)

    result = harness.run_cell(cell, 2 ** 31 + 98, 1.0, False, cuda_device,
                              time.perf_counter(), Control)
    assert not result["correct"]
