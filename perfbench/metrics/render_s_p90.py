"""render_s_p90: the 90th percentile (nearest rank) of the seconds from a
render's call to its synchronize, over every render of the window."""
import math


def read(run):
    if run.job != "render" or not run.walls:
        return None
    walls = sorted(run.walls)
    return walls[math.ceil(0.9 * len(walls)) - 1]
