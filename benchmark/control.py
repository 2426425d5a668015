"""The control of ``correct`` at a cell's own size, on the card:

    python3 -m benchmark.control --workload <name> --seeds 11,12,13 --seconds 5

runs the cell once a seed with the control of ``benchmark/faults.py``
(``control_bf16``) in the program's place, and prints each run's
numbers compared beside their limits.  The control has to come out as
not correct on every seed; the exit code is 0 when it does.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    from . import faults, run, spec

    run.set_environment()
    import torch

    if not torch.cuda.is_available():
        print("[control] no CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(spec.load(), args.workload)
    failed = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        result, _ = run.run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0), fault=faults.control_bf16)
        failed += not result["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "control_bf16",
                          "correct": result["correct"], "checks": result["checks"]}), flush=True)
    return 0 if failed == len(args.seeds.split(",")) else 1


if __name__ == "__main__":
    sys.exit(main())
