"""The readings that the limits of `cells/<cell>.json` are set from, in one
process on the card: for each seed, job 0 of the cell as the program runs
it (its own route, after a warm-up job) against the reference (the sound
readings), and for each control seed the reference computed in bfloat16
put in the program's place against the float32 reference (the control's
readings), and for each fault seed job 0 as the program runs it and with
each of the job kind's planted faults (faults.planted), each after a
warm-up job of its own, against one reference (the faults' readings at the
cell's own size). The jobs are of
the cell's kind (jobs.kind), checked by the reference its configuration
names (manifest.reference).

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 3 \
        --control-seeds 4 5 6 --fault-seeds 7 8 9

One JSON line a reading.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from perfbench import faults, jobs, manifest  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = p.parse_args()
    for key in [k for k in os.environ if k.startswith("HRT_")]:
        del os.environ[key]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = manifest.load_cell(args.workload)
    manifest.verify_inputs(cell)
    dev = torch.device("cuda", 0)
    cls, ref = jobs.kind(cell), manifest.reference(cell)
    scene = cell.path(cell.config["scene"])
    for seed in args.seeds:
        program = cls(scene, cell.traffic, dev, seed, ref)
        program.run(-1)
        t0 = time.perf_counter()
        out = program.run(0)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = program.compare(out, program.reference(0))
        line = {"seed": seed, "side": "program", **got,
                "job_s": t1 - t0, "reference_s": time.perf_counter() - t1}
        print(json.dumps(line), flush=True)
    for seed in args.control_seeds:
        program = cls(scene, cell.traffic, dev, seed, ref)
        t0 = time.perf_counter()
        expected = program.reference(0)
        got = program.compare(
            cls.as_output(program.reference(0, torch.bfloat16)), expected)
        print(json.dumps({"seed": seed, "side": "control", **got,
                          "seconds": time.perf_counter() - t0}), flush=True)
    for seed in args.fault_seeds:
        line, expected = {"seed": seed}, None
        for name in ["sound", *faults.planted(cell)]:
            # jobs of their own and a warm-up job each, as in a whole run: a
            # fit replays the step graph that the process's first fit of
            # its scene captured, which a fault planted later never reaches
            broken = cls if name == "sound" else faults.broken(cell, name)
            program = broken(scene, cell.traffic, dev, seed, ref)
            program.run(-1)
            out = program.run(0)
            torch.cuda.synchronize()
            if expected is None:
                t0 = time.perf_counter()
                expected = program.reference(0)
                line["reference_s"] = time.perf_counter() - t0
            line[name] = program.compare(out, expected)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
