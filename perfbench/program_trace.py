"""The program's own record of the traced jobs, for the per-layer metrics
of source program_span that read it.

In a `--trace 1` run the profiled jobs run while torch.profiler records,
so the program traces each of them itself
(hobbyraytracer_tpu_torch/tracing.py: `RECORDER`): host spans, device
milliseconds of each phase of a segment or fit step (events inside the
captured graph), the captured graph's nodes by type and the render's lane
counters. Nothing else in the run is traced. A checkout whose program has
no such record gives nothing: every reading here is then None.

Records (plain dicts, as tracing.py writes them): spans {"name", "id",
"parent", "job", "start_ns", "end_ns", "attrs"}, phases {"job", "name",
"route", "ms", "units"}, counters {"job", "name", "value"}; a job is a
top-level span "hrt.render" or "hrt.fit" and `job` its id.
"""
from __future__ import annotations


def recorder():
    """The program's recorder, or None where the program has none."""
    try:
        from hobbyraytracer_tpu_torch import tracing
    except ImportError:
        return None
    return getattr(tracing, "RECORDER", None)


def _rec(rec):
    return recorder() if rec is None else rec


def jobs(rec, kind: str) -> dict:
    """{job id: the job's root span} of the jobs "hrt.<kind>"."""
    rec = _rec(rec)
    if rec is None:
        return {}
    return {s["id"]: s for s in rec.spans
            if s["parent"] is None and s["name"] == "hrt." + kind}


def counters(rec, kind: str) -> list:
    """One dict a job of `kind`: its root span's attributes, then its
    counters summed by name (the graph's nodes as "graph.<type>")."""
    rec = _rec(rec)
    roots = jobs(rec, kind)
    out = {j: dict(root["attrs"]) for j, root in roots.items()}
    for c in (rec.counters if roots else []):
        if c["job"] in out:
            row = out[c["job"]]
            row[c["name"]] = row.get(c["name"], 0) + c["value"]
    return list(out.values())


def phase_ms(rec, kind: str, name: str):
    """Device ms of the phase "hrt.<name>" a unit (segment or step), over
    the replayed blocks or steps of the jobs of `kind` -> (ms, units), or
    None without a replayed reading."""
    rec = _rec(rec)
    ids = jobs(rec, kind)
    got = [p for p in (rec.phases if ids else [])
           if p["job"] in ids and p["name"] == "hrt." + name
           and p["route"] == "replay"]
    units = sum(p["units"] for p in got)
    if not units:
        return None
    return sum(p["ms"] for p in got) / units, units


def span_ms_a_job(rec, kind: str, name: str):
    """Host ms in the spans "hrt.<name>" a job of `kind`, or None without
    such a job."""
    rec = _rec(rec)
    ids = jobs(rec, kind)
    if not ids:
        return None
    ns = sum(s["end_ns"] - s["start_ns"] for s in rec.spans
             if s["job"] in ids and s["name"] == "hrt." + name)
    return 1e-6 * ns / len(ids)


def graph_nodes(rec, kind: str, per: str = ""):
    """Kernel nodes of each job's captured graph (over the job's attribute
    `per`, as the segments a block graph holds), averaged over the jobs
    that captured one -> (kernel, {other type: nodes}), or None."""
    rows = [r for r in counters(rec, kind)
            if "graph.kernel" in r and (not per or r.get(per))]
    if not rows:
        return None

    def mean(key):
        return sum(r.get(key, 0) / (r[per] if per else 1)
                   for r in rows) / len(rows)

    return mean("graph.kernel"), {t: mean("graph." + t) for t in
                                  ("memcpy", "memset", "event_record",
                                   "other")}


def lane_shares(rec):
    """Over the traced renders: {"occupancy", "hit", "deferred",
    "cap_fill"} in % (active lane-segments over pool x segments, hits
    over active, deferred over pool x segments, rows retired over cap x
    segments), or None."""
    rows = [r for r in counters(rec, "render")
            if "lanes.active" in r and r.get("segments")]
    if not rows:
        return None
    lanes = sum(r["pool"] * r["segments"] for r in rows)
    rows_cap = sum(r["cap"] * r["segments"] for r in rows)
    active = sum(r["lanes.active"] for r in rows)
    return {"occupancy": 100.0 * active / lanes,
            "hit": 100.0 * sum(r["lanes.hit"] for r in rows) / max(active, 1),
            "deferred": 100.0 * sum(r["lanes.deferred"] for r in rows)
            / lanes,
            "cap_fill": 100.0 * sum(r["rows.retired"] for r in rows)
            / rows_cap,
            "segments": sum(r["segments"] for r in rows)}
