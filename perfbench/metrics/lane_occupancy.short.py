"""lane_occupancy.short: lane_occupancy's reading (100 * active
lane-segments over pool * segments of the traced renders) in the
short-render cells, which report rays_per_s.short, whose bound is their
own."""
import os

from perfbench import manifest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
read = manifest.reader("lane_occupancy", BENCH)
