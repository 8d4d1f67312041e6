"""rays_per_s: W*H*spp of every render the window completed, over the
window's wall time (host clock; each render ends in a synchronize)."""


def read(run):
    if run.job != "render" or not run.walls:
        return None
    return sum(run.work) / run.window_s
