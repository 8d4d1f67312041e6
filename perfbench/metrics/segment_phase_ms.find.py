"""segment_phase_ms.find: device milliseconds a segment in the find: the pool
permutation where on, and intersect_scene (the mesh find's coherence sort,
gathers and K1), over the segments of the replayed blocks of the traced
renders: the program's timing events around the phase inside the block's
CUDA graph (perfbench/program_trace.py)."""
from perfbench import program_trace


def read(run, rec=None):
    if run.job != "render":
        return None
    got = program_trace.phase_ms(rec, "render", "segment.find")
    if got is None:
        return None
    return got[0], f"over {got[1]} replayed segments"
