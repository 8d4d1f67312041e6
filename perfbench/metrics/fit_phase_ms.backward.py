"""fit_phase_ms.backward: device milliseconds a fit step in the backward:
loss.backward(), over the replayed steps of the traced fits: the program's
timing events around the phase inside the step's CUDA graph
(perfbench/program_trace.py)."""
from perfbench import program_trace


def read(run, rec=None):
    if run.job != "fit":
        return None
    got = program_trace.phase_ms(rec, "fit", "fit.backward")
    if got is None:
        return None
    return got[0], f"over {got[1]} replayed steps"
