"""sphere_find_roofline: the least time of the sphere find over the
replayed segments of the traced renders (sphere_counts.py: each ray of the
pool read once and its hit record written once, one ray-sphere test a ray,
at the card's peaks) over the find's measured time in them
(segment_phase_ms.find_spheres times those segments), in %."""
from perfbench import counts, program_trace, sphere_counts


def read(run, rec=None):
    if run.job != "render" or not run.peaks:
        return None
    got = program_trace.phase_ms(rec, "render", "segment.find.spheres")
    pools = {r.get("pool") for r in program_trace.counters(rec, "render")}
    if got is None or len(pools) != 1:
        return None
    ms, segments = got
    lanes = pools.pop()
    n_bytes, n_ops = sphere_counts.sphere_find_work(segments, lanes)
    least, binds = counts.least_time(n_bytes, n_ops, run.peaks)
    seconds = 1e-3 * ms * segments
    return (100.0 * least / seconds,
            f"{segments} segments of {lanes} rays in {seconds:.6f} s: "
            f"{n_bytes} B, {n_ops} operations; least {least:.6f} s, bound "
            f"by {binds}")
