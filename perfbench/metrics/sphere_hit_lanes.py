"""sphere_hit_lanes: 100 * the active lanes whose closest hit is a pooled
sphere, summed over every segment of the traced renders, over the active
lanes; the note gives the share of the active lanes that the dielectric
lobe scattered and the route of the sphere find. The program's counters on
the card (perfbench/program_trace.py)."""
from perfbench import program_trace


def read(run, rec=None):
    if run.job != "render":
        return None
    rows = [r for r in program_trace.counters(rec, "render")
            if "lanes.sphere_hit" in r and r.get("lanes.active")]
    if not rows:
        return None
    active = sum(r["lanes.active"] for r in rows)
    dielectric = sum(r.get("lanes.dielectric", 0) for r in rows)
    routes = sorted({str(r.get("sphere_route")) for r in rows})
    return (100.0 * sum(r["lanes.sphere_hit"] for r in rows) / active,
            f"dielectric {100.0 * dielectric / active:.4f}% of the active "
            f"lanes; sphere route {', '.join(routes)}")
