#!/usr/bin/env python3
"""The cost of checkpointing to a render: the CLI's render of a scene without
and with --checkpoint, in turns (plain, checkpointed, checkpointed, plain),
each in a process of its own, on one CUDA card.

    python3 scripts/time_checkpoint.py [--scene scenes/shiny_teapot.yaml]
        [--every 2] [--device cuda:0] [--out DIR]

Prints the card's name and power limit, each run's primary rays/s as the
CLI reports it (render time only, the scene's load excluded), then one
JSON line with the checkpointed runs' rays/s over the plain ones'. The
checkpointed runs write every --every seconds from the CLI's writer thread
(cli/main.py:AsyncCheckpoint), so this is what the thread's copies and
writes take from the render.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="scenes/shiny_teapot.yaml")
    ap.add_argument("--every", type=float, default=2.0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None,
                    help="directory for the images and checkpoints "
                         "(default a temporary one)")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        out = args.out or tmp
        os.makedirs(out, exist_ok=True)
        for i, ckpt in enumerate((False, True, True, False)):
            cmd = [sys.executable, "-m", "hobbyraytracer_tpu_torch.cli.main",
                   "render", args.scene, "-o",
                   os.path.join(out, f"run{i}.png"), "--device", args.device]
            ck = os.path.join(out, f"run{i}.npz")
            if ckpt:
                cmd += ["--checkpoint", ck, "--checkpoint-every",
                        str(args.every)]
            res = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                 text=True, timeout=1800)
            if res.returncode != 0:
                raise RuntimeError(f"run {i}: rc {res.returncode}\n"
                                   f"{res.stdout[-2000:]}{res.stderr[-2000:]}")
            m = re.search(r"\[([\d,]+) primary rays/s .*render ([\d.]+)s",
                          res.stdout)
            rate, seconds = float(m.group(1).replace(",", "")), float(
                m.group(2))
            runs.append({"checkpoint": ckpt, "rays_per_s": rate,
                         "render_s": seconds,
                         "checkpoint_bytes": (os.path.getsize(ck)
                                              if ckpt else None)})
            how = (f"--checkpoint-every {args.every}" if ckpt
                   else "no checkpoint")
            print(f"run {i} ({how}): {rate:,.0f} primary rays/s, render "
                  f"{seconds:.1f} s")
    plain = [r["rays_per_s"] for r in runs if not r["checkpoint"]]
    with_ck = [r["rays_per_s"] for r in runs if r["checkpoint"]]
    print(json.dumps({"card": card, "scene": args.scene,
                      "every_s": args.every, "runs": runs,
                      "ratio": sum(with_ck) / sum(plain)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
