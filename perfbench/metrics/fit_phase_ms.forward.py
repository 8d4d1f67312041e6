"""fit_phase_ms.forward: device milliseconds a fit step in the forward: the
gradients zeroed and render_loss (trace_diff's bounces under checkpoints,
the loss), over the replayed steps of the traced fits: the program's timing
events around the phase inside the step's CUDA graph
(perfbench/program_trace.py)."""
from perfbench import program_trace


def read(run, rec=None):
    if run.job != "fit":
        return None
    got = program_trace.phase_ms(rec, "fit", "fit.forward")
    if got is None:
        return None
    return got[0], f"over {got[1]} replayed steps"
