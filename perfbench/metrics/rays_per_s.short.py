"""rays_per_s.short: rays_per_s's reading (W*H*spp of every render the window
completed over the window's wall time) in the short-render cells, which
report rays_per_s.short, whose bound is their own."""
import os

from perfbench import manifest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
read = manifest.reader("rays_per_s", BENCH)
