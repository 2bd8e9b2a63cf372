"""One step of the sharded path on a mesh of ``n_shards`` shards of one
device: the twin of ``__graft_entry__.dryrun_multichip``.

    python -m embeddinghub_tpu_torch.parallel.dryrun [n_shards] [device]

The step: a batched insert scattered into a sharded arena that is already
on the device, a sharded search and the merge of the shards' lists (every
row returned must be one that was inserted), then the graph leg, a
sharded graph over ``96 n_shards`` rows that must find its own rows.  The
reference runs the step in a subprocess, only to give JAX a virtual mesh
of CPU devices; here a mesh may repeat a device, so it runs in process.
"""

from __future__ import annotations

import sys

import numpy as np

from embeddinghub_tpu_torch.parallel.mesh import Mesh
from embeddinghub_tpu_torch.parallel.sharded_flat import ShardedFlatIndex
from embeddinghub_tpu_torch.parallel.sharded_hnsw import ShardedHNSWIndex


def dryrun_multichip(n_shards: int, device="cuda") -> dict:
    """Run the step on ``Mesh([device] * n_shards)``; raises if a check
    fails.  Returns what it saw."""
    mesh = Mesh([device] * n_shards)
    cap_local, d, b, k, n_ins = 256, 32, 16, 4, 64
    rng = np.random.default_rng(0)

    flat = ShardedFlatIndex(d, "l2", mesh=mesh, capacity=n_shards * cap_local)
    flat._sync()  # the empty arena on the device, as the reference's zeros
    ins_rows = rng.permutation(n_shards * cap_local)[:n_ins]
    flat.add(ins_rows, rng.standard_normal((n_ins, d)).astype(np.float32))
    if flat._dirty or len(flat._dirty_rows) != n_ins:
        raise RuntimeError("the batched insert did not take the scatter")
    _, idx = flat.search(rng.standard_normal((b, d)).astype(np.float32), k)
    if not set(idx.ravel().tolist()) <= set(ins_rows.tolist()) | {-1} or (idx < 0).any():
        raise RuntimeError("the sharded search returned rows that were never inserted")

    n_rows = n_shards * 96
    gx = rng.standard_normal((n_rows, d)).astype(np.float32)
    graph = ShardedHNSWIndex(d, mesh=mesh, m=8, ef_construction=32, capacity=n_rows)
    graph.add(np.arange(n_rows), gx)
    probe = rng.permutation(n_rows)[:8]
    _, gi = graph.search(gx[probe] + 1e-5, 1, ef=32)
    found = float((gi[:, 0] == probe).mean())
    if found < 0.9:
        raise RuntimeError(f"the sharded graph found {found} of its own rows")
    return {"shards": n_shards, "device": str(mesh.devices[0]), "flat_ids": idx.tolist(),
            "graph_self_found": found}


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    print(dryrun_multichip(n, sys.argv[2] if len(sys.argv) > 2 else "cuda"))
