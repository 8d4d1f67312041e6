"""device_idle_share.render: 100 * (1 - device busy / wall) over the profiled
whole render jobs; busy is the union of the kernel, memcpy and memset records
of the profiler's trace, the wall the job's span."""


def read(run):
    traces = run.traces if run.job == "render" else []
    window = sum(t.window_s for t in traces)
    if not window:
        return None
    return 100.0 * (1.0 - sum(t.busy_s for t in traces) / window)
