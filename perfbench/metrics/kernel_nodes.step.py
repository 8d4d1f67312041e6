"""kernel_nodes.step: kernel nodes of a traced fit's step graph, averaged
over the traced fits; the note gives its memcpy, memset and event-record
nodes. Counted by the program on the captured graph
(perfbench/program_trace.py)."""
from perfbench import program_trace


def read(run, rec=None):
    if run.job != "fit":
        return None
    got = program_trace.graph_nodes(rec, "fit")
    if got is None:
        return None
    kernel, other = got
    return kernel, ", ".join(f"{k} {v:g}" for k, v in other.items())
