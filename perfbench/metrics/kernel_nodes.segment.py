"""kernel_nodes.segment: kernel nodes of a traced render's block graph over
the segments the block holds, averaged over the traced renders; the note
gives the memcpy, memset and event-record nodes the same way. Counted by
the program on the captured graph (perfbench/program_trace.py); a traced
graph holds the program's own timing events and lane counters too."""
from perfbench import program_trace


def read(run, rec=None):
    if run.job != "render":
        return None
    got = program_trace.graph_nodes(rec, "render", per="steps")
    if got is None:
        return None
    kernel, other = got
    return kernel, ", ".join(f"{k} {v:g}" for k, v in other.items())
