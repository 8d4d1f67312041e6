"""graph_instantiate_ms.short: host milliseconds a traced render spends in
hrt.graph.instantiate, the instantiation of its captured graph
(kernels/build.py:GraphReplay.capture), averaged over the traced renders
(perfbench/program_trace.py)."""
from perfbench import program_trace


def read(run, rec=None):
    if run.job != "render":
        return None
    return program_trace.span_ms_a_job(rec, "render", "graph.instantiate")
