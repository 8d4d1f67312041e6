"""segment_busy_ms: device busy milliseconds of the replayed blocks of the
profiled renders, over the segments those blocks ran."""


def read(run):
    if run.job != "render":
        return None
    units = sum(t.units for t in run.traces)
    if not units:
        return None
    return 1e3 * sum(t.busy_by_span.get("replay", 0.0)
                     for t in run.traces) / units
