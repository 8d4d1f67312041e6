"""device_idle_share.short: device_idle_share.render's reading (100 * (1 -
device busy / wall) over the profiled whole renders) in the short-render
cells, which report rays_per_s.short, whose bound is their own."""
import os

from perfbench import manifest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
read = manifest.reader("device_idle_share.render", BENCH)
