"""lane_occupancy: 100 * the lanes active at the find, summed over every
segment of the traced renders, over pool * those segments; the note gives
the share of the active lanes that hit. The program's counters on the card
(perfbench/program_trace.py)."""
from perfbench import program_trace


def read(run, rec=None):
    if run.job != "render":
        return None
    got = program_trace.lane_shares(rec)
    if got is None:
        return None
    return got["occupancy"], (f"hit share {got['hit']:.4f}% over "
                              f"{got['segments']} segments")
