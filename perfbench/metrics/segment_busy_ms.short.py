"""segment_busy_ms.short: segment_busy_ms's reading (device busy ms of the
replayed blocks over their segments) in the short-render cells, which report
rays_per_s.short, whose bound is their own."""
import os

from perfbench import manifest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
read = manifest.reader("segment_busy_ms", BENCH)
