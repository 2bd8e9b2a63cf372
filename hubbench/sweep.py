#!/usr/bin/env python3
"""A cell at several numbers of clients, one traced run each, in one
process: the rate every client together gets and the device's idle share,
to find how far concurrent callers load the card.  The benchmark's own
runs never run it.

    python3 hubbench/sweep.py --workload <name> --clients 1,2,4 --seed 1 --seconds 20

Prints a JSON line a client count.  The profiler covers each run's whole
window, so the rate read here is a traced one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from run import load_cell, run_cell  # noqa: E402  (run.py puts the root on the path)

import torch  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--clients", required=True, help="comma-separated")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"sweep: {args.workload} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    for n, clients in enumerate(int(c) for c in args.clients.split(",")):
        traffic = {"clients": clients, "trace_seconds": args.seconds}
        result, checks, run = run_cell(cell, args.seed + n, args.seconds, True,
                                       overrides={"traffic": traffic},
                                       t_start=time.perf_counter())
        d = result["device"]
        queries = sum(len(c.asked) for c in run.answered)
        print(json.dumps({"workload": args.workload, "clients": clients,
                          "correct": result["correct"],
                          "queries_per_s": queries / run.window_s,
                          "device_idle_share": 1.0 - d["busy_s"] / d["window_s"],
                          "idle_gaps": result["breakdown"]["idle_gaps"],
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
