"""k1_roofline: the least time of K1's launches in the profiled
renders (counts.py: the rays given to the find read once, the hit records
written once, one triangle test a ray at most, at the card's peaks) over
the profiler's summed traverse_kernel time, in %."""
from perfbench import counts

NAME = "traverse_kernel"
LIBRARIES = ("mesh_traverse", "mesh_traverse_stream")


def read(run):
    if run.job != "render" or len(run.lanes) != 1 or not run.peaks:
        return None
    launches = sum(t.launches.get(lib, 0) for t in run.traces
                   for lib in LIBRARIES)
    seconds = sum(s for t in run.traces for name, s in t.by_name.items()
                  if NAME in name)
    if not launches or not seconds:
        return None
    lanes = next(iter(run.lanes))
    least, binds = counts.least_time(*counts.k1_work(launches, lanes),
                                     run.peaks)
    return (100.0 * least / seconds,
            f"{launches} launches of {lanes} rays in {seconds:.6f} s; least "
            f"{least:.6f} s, bound by {binds}")
