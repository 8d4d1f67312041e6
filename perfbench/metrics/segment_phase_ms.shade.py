"""segment_phase_ms.shade: device milliseconds a segment in the shading:
emission, scatter, Russian roulette and the ray, sample and depth updates,
over the segments of the replayed blocks of the traced renders: the
program's timing events around the phase inside the block's CUDA graph
(perfbench/program_trace.py)."""
from perfbench import program_trace


def read(run, rec=None):
    if run.job != "render":
        return None
    got = program_trace.phase_ms(rec, "render", "segment.shade")
    if got is None:
        return None
    return got[0], f"over {got[1]} replayed segments"
