"""capture_ms.render: host milliseconds a render spends in
GraphReplay.capture plus its first block's eager run (the warm-up of the
render's block graph), averaged over the window's renders."""


def read(run):
    if run.job != "render" or not run.spans:
        return None
    s = sum(j.seconds.get("capture_record", 0.0) + j.seconds.get("eager", 0.0)
            for j in run.spans)
    return 1e3 * s / len(run.spans)
