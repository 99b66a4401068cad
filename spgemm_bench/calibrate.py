"""The readings a cell's limits are set from (not part of a benchmark run):

    python3 -m spgemm_bench.calibrate --workload <cell> --seeds 1,2,3 \\
        --controls 4,5,6 [--seconds 1]

For each of ``--seeds`` one short run of the program, and for each of
``--controls`` one run whose compared outputs are the control's: the
reference computed in bfloat16 (every input value rounded to bfloat16,
products and sums in float32), the step below the float32 the
configurations state. Each line gives the numbers compared; the last line
is a JSON object with every reading, the lower reading (the largest the
program gives) and the upper one (the smallest the control gives) of each
number. A limit lies between the two.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from . import cells, harness


def readings(cell: dict, seeds: list, seconds: float, control: bool,
             device) -> list:
    out = []
    for seed in seeds:
        r = harness.run(cell, seed, seconds, False, device, control=control)
        row = {"seed": seed, "control": control, "correct": r["correct"],
               **{k: c["value"] for k, c in r["checks"].items()}}
        print(json.dumps(row), file=sys.stderr, flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m spgemm_bench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = [int(s) for s in args.controls.split(",")]
    prog = readings(cell, seeds, args.seconds, False, args.device)
    ctrl = readings(cell, controls, args.seconds, True, args.device)
    summary = {
        "cell": args.workload,
        "lower": {k: max(r[k] for r in prog) for k in cell["limits"]},
        "upper": {k: min(r[k] for r in ctrl) for k in cell["limits"]},
        "limits": cell["limits"],
        "program": prog,
        "control": ctrl,
    }
    print(json.dumps(harness.finite(summary), allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
