"""capture_ms.short: capture_ms.render's reading (host ms a render in
GraphReplay.capture plus its first, eager block) in the short-render cells,
which report rays_per_s.short, whose bound is their own."""
import os

from perfbench import manifest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
read = manifest.reader("capture_ms.render", BENCH)
