"""k1_roofline.short: k1_roofline's reading (K1's least time over the
profiler's traverse_kernel time, in %) in the short-render cells, which
report rays_per_s.short, whose bound is their own."""
import os

from perfbench import manifest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
read = manifest.reader("k1_roofline", BENCH)
