"""fit_step_ms: the window's wall time over all the Adam steps of the fits
it completed, in milliseconds."""


def read(run):
    if run.job != "fit" or not run.walls:
        return None
    return 1e3 * run.window_s / sum(run.work)
