"""deferred_lanes: 100 * the lanes left deferred by the retirement cap
after each segment (a finished chunk that waits for a later segment),
summed over every segment of the traced renders, over pool * those
segments; the note gives the cap's fill, 100 * rows retired over cap *
segments. The program's counters on the card
(perfbench/program_trace.py)."""
from perfbench import program_trace


def read(run, rec=None):
    if run.job != "render":
        return None
    got = program_trace.lane_shares(rec)
    if got is None:
        return None
    return got["deferred"], (f"cap fill {got['cap_fill']:.4f}% over "
                             f"{got['segments']} segments")
