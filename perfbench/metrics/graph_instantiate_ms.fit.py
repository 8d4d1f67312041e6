"""graph_instantiate_ms.fit: host milliseconds a traced fit spends in
hrt.graph.instantiate, the instantiation of its captured graph
(kernels/build.py:GraphReplay.capture), averaged over the traced fits
(perfbench/program_trace.py)."""
from perfbench import program_trace


def read(run, rec=None):
    if run.job != "fit":
        return None
    return program_trace.span_ms_a_job(rec, "fit", "graph.instantiate")
