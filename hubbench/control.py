#!/usr/bin/env python3
"""Read a cell's control, or a planted fault, over several seeds in one
process.  The control is the cell with its configuration's ``control``
overrides (the program's own path in the precision below the configured
one, or a setting that breaks a guarantee the configuration states); a
fault (``faults.FAULTS``) is planted under the timed path of the program
as configured.  The benchmark's own runs never run either; their readings
and the sound runs' set each limit (PERF.md).

    python3 hubbench/control.py --workload <name> --seeds 1,2,3 --seconds 10 \
        [--fault stale|half|altered|reversed]

Prints a JSON line a seed with the numbers compared and the recall.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from run import load_cell, run_cell  # noqa: E402  (run.py puts the root on the path)

import torch  # noqa: E402

from hubbench import faults  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"control: {args.workload} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    overrides = None if args.fault else cell.config["control"]
    for seed in (int(s) for s in args.seeds.split(",")):
        result, checks, _ = run_cell(cell, seed, args.seconds, False, overrides=overrides,
                                     fault=args.fault, t_start=time.perf_counter())
        recall = result["metrics"].get("recall_at_10", {}).get("value")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "read": args.fault or "control", "correct": result["correct"],
                          "recall_at_10": recall, "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
