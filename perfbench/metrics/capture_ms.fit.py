"""capture_ms.fit: host milliseconds a fit spends in GraphReplay.capture
plus its step 0 (eager), averaged over the window's fits."""


def read(run):
    if run.job != "fit" or not run.spans:
        return None
    s = sum(j.seconds.get("capture_record", 0.0) + j.seconds.get("eager", 0.0)
            for j in run.spans)
    return 1e3 * s / len(run.spans)
