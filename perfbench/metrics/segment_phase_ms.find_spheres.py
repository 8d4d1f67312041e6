"""segment_phase_ms.find_spheres: device milliseconds a segment in the
sphere find (the pooled spheres' find inside intersect_scene, by the route
the program takes; nested inside segment_phase_ms.find), over the segments
of the replayed blocks of the traced renders: the program's own pair of
timing events around it inside the block's CUDA graph
(perfbench/program_trace.py)."""
from perfbench import program_trace


def read(run, rec=None):
    if run.job != "render":
        return None
    got = program_trace.phase_ms(rec, "render", "segment.find.spheres")
    if got is None:
        return None
    return got[0], f"over {got[1]} replayed segments"
