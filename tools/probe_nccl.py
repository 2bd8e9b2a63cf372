#!/usr/bin/env python3
"""Whether two ranks of ``torch.distributed`` can share one CUDA card under
each backend.

    python3 tools/probe_nccl.py

Runs ``python -m embeddinghub_tpu_torch.parallel.multihost --procs 2
--local-shards 1 --device cuda:0`` twice, with ``--backend nccl`` and then
``--backend gloo``, each rank calling this file's :func:`gather`: one
``Mesh.all_gather_lists`` of ``[4, 2]`` lists whose values name their
rank, checked on every rank.  A run is bounded by ``--timeout 90`` (the
launcher kills its ranks past it).  Prints the card, then a line a backend
with its verdict ("works", or the launcher's exit code and the tail of its
errors), and the same as one JSON line.  Exits 0 once both runs have been
tried, non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def gather(mesh, args):
    """Each rank's lists hold its rank; the gathered columns must hold 0
    then 1."""
    import torch

    d = torch.full((4, 2), float(mesh.rank), device=mesh.devices[0])
    i = torch.full((4, 2), mesh.rank, dtype=torch.int64, device=mesh.devices[0])
    dd, ii = mesh.all_gather_lists(d, i)
    want = torch.arange(mesh.world, device=dd.device).repeat_interleave(2)
    if not (torch.equal(ii[0], want) and torch.equal(dd[0], want.float())):
        raise RuntimeError(f"gathered {ii[0].tolist()}, expected {want.tolist()}")
    return {"gathered": ii[0].tolist(), "device": str(dd.device)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_nccl: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tools")]))
    verdicts = {}
    for backend in ("nccl", "gloo"):
        cmd = [sys.executable, "-m", "embeddinghub_tpu_torch.parallel.multihost",
               "--procs", "2", "--local-shards", "1", "--device", "cuda:0",
               "--backend", backend, "--timeout", "90", "--entry", "probe_nccl:gather"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=150)
        took = time.perf_counter() - t0
        if proc.returncode == 0:
            verdicts[backend] = {"works": True, "s": round(took, 1)}
        else:
            tail = [ln for ln in proc.stderr.splitlines() if ln.strip()][-6:]
            verdicts[backend] = {"works": False, "rc": proc.returncode,
                                 "s": round(took, 1), "stderr": tail}
        print(f"[probe_nccl] two ranks on cuda:0, {backend}: "
              f"{'works' if proc.returncode == 0 else 'fails'} ({took:.1f} s)", flush=True)
        if proc.returncode != 0:
            print("\n".join(f"[probe_nccl]   {ln}" for ln in verdicts[backend]["stderr"]),
                  flush=True)
    print(json.dumps({"card": smi.stdout.strip(), "torch": torch.__version__,
                      "nccl": list(torch.cuda.nccl.version()), "two_ranks_one_card": verdicts}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
