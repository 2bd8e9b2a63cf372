"""The scenarios of ``tests/test_torch_multihost.py``.

Each rank of a process mesh runs :func:`run` (``python -m
embeddinghub_tpu_torch.parallel.multihost --entry
_torch_multihost_scenarios:run``); the test process runs the same
scenario functions on the port's in-process mesh and on the JAX package's
mesh, whose indexes ``make`` builds.  Only numpy is imported at the top:
the ranks never import JAX.
"""

from pathlib import Path

import numpy as np

D, K = 32, 10
SHARDS = 4
FLAT_CASES = [f"{m}-{s}" for m in ("l2", "cosine") for s in ("float32", "int8", "int8x2")]
FLAT_STAGES = ("grown", "removed", "regrown", "rewritten")
GRAPH_STAGES = ("bulk", "streamed", "removed")
GRAPH_EFS = (32, 64)


def data(seed, n, d=D):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def flat_queries():
    return np.concatenate([data(2, 17), data(1, 4500)[3000:3008] + 0.01])


def flat_scenario(make, case):
    """``(lists, index)`` of a ``ShardedFlatIndex`` that ``make`` builds
    with the default capacity: 3,000 rows (growth before the first sync),
    lists at each stage: "grown"; 40 rows removed (the scatter after a
    sync): "removed"; 1,500 rows past the capacity (growth after a sync):
    "regrown"; 20 rows rewritten (a scatter): "rewritten"."""
    metric, storage = case.split("-")
    x, q = data(1, 4500), flat_queries()
    idx = make(dims=D, metric=metric, storage_dtype=storage)
    out = {}
    writes = (lambda: idx.add(np.arange(3000), x[:3000]),
              lambda: idx.remove(np.arange(5, 3000, 73)),
              lambda: idx.add(np.arange(3000, 4500), x[3000:]),
              lambda: idx.add(np.arange(100, 120), x[200:220] * 1.5))
    for stage, write in zip(FLAT_STAGES, writes):
        write()
        out[f"{stage}.d"], out[f"{stage}.i"] = idx.search(q, K)
    out["layout"] = np.asarray([idx.size, idx.total_capacity])
    return out, idx


def clustered(n=8192, d=D, centers=8, spread=2e-2, seed=0):
    """Near-duplicate clusters (``tests/test_quant_guard.py``'s): score
    gaps below int8 resolution, above int8x2's."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    return (c[np.arange(n) % centers]
            + spread * rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)


def guard_scenario(make):
    """An int8 arena of near duplicates: the guard's pick at the first
    sync, its sampled recalls (-1 where none) and the lists."""
    x = clustered()
    idx = make(dims=D, metric="l2", storage_dtype="int8")
    idx.add(np.arange(len(x)), x)
    d, i = idx.search(x[:32] + 1e-5, K)
    recalls = getattr(idx, "guard_recalls", {})  # the JAX index keeps none
    return {"d": d, "i": i, "storage": np.asarray(idx.storage_dtype),
            "recalls": np.asarray([recalls.get(s, -1.0) for s in ("int8", "int8x2")])}


def graph_data():
    return data(10, 8492), data(11, 24)


def graph_scenario(make):
    """A ``ShardedHNSWIndex`` on 4 shards: 8,192 rows in one add (a bulk
    build of 2,048 a shard), 300 rows in two streamed adds, then a remove;
    every shard's state after each (``<stage>.<name>``), the walks at
    ``GRAPH_EFS`` (``walk<ef>.d``/``.i``), the size and two vectors."""
    x, q = graph_data()
    idx = make(dims=D, metric="l2", m=8, ef_construction=40, capacity=8192)
    out = {}
    steps = ((lambda: idx.add(np.arange(8192), x[:8192])),
             (lambda: [idx.add(np.arange(lo, hi), x[lo:hi])
                       for lo, hi in ((8192, 8392), (8392, 8492))]),
             (lambda: idx.remove(np.arange(3, 8492, 29))))
    for stage, step in zip(GRAPH_STAGES, steps):
        step()
        for name, arr in idx.state_arrays().items():
            out[f"{stage}.{name}"] = np.array(arr)  # a copy: later writes change the index's
    out.update(walks(idx, q))
    out["size"] = np.asarray([idx.size, idx.total_capacity])
    out["vectors"] = idx.vectors([0, 8491, 8190])
    return out


def walks(idx, q):
    out = {}
    for ef in GRAPH_EFS:
        out[f"walk{ef}.d"], out[f"walk{ef}.i"] = idx.search(q, K, ef=ef)
    return out


def stage_state(lists, stage):
    """The ``state_arrays()`` a scenario recorded at ``stage``."""
    pre = f"{stage}."
    return {name[len(pre):]: arr for name, arr in lists.items() if name.startswith(pre)}


def _prefixed(lists, case):
    return {f"{case}/{name}": arr for name, arr in lists.items()}


def run(mesh, args):
    """Every scenario on this rank's process mesh; each rank's lists to
    ``rank<r>.npz`` under ``--out``.  Also: the flat indexes' shard files
    written and read back, a snapshot the JAX package wrote
    (``jax_graph.npz``, when present) walked on this mesh, a 4-shard
    snapshot onto a mesh of one shard a rank, the layout."""
    import torch

    from embeddinghub_tpu_torch.parallel import ShardedFlatIndex, ShardedHNSWIndex
    from embeddinghub_tpu_torch.parallel.mesh import process_mesh

    out_dir = Path(args.out)
    lists, report = {}, {}
    for case in FLAT_CASES:
        res, idx = flat_scenario(lambda **kw: ShardedFlatIndex(mesh=mesh, **kw), case)
        idx.save_shards(out_dir / f"shards-{case}")
        mesh.barrier()
        back = ShardedFlatIndex.from_state(D, idx.metric, idx.state_arrays(), mesh=mesh)
        back.restore_shards(out_dir / f"shards-{case}")
        res["restored.i"] = back.search(flat_queries(), K)[1]
        lists.update(_prefixed(res, case))
    lists.update(_prefixed(guard_scenario(lambda **kw: ShardedFlatIndex(mesh=mesh, **kw)),
                           "guard"))
    graph = graph_scenario(lambda **kw: ShardedHNSWIndex(mesh=mesh, **kw))
    lists.update(_prefixed(graph, "graph"))
    jax_state = out_dir / "jax_graph.npz"
    if jax_state.exists():
        with np.load(jax_state) as f:
            state = {name: f[name] for name in f.files}
        restored = ShardedHNSWIndex.from_state(D, "l2", state, mesh=mesh)
        lists.update(_prefixed(walks(restored, graph_data()[1]), "from_jax"))
        try:
            ShardedHNSWIndex.from_state(D, "l2", state, mesh=process_mesh(1, "cpu"))
        except ValueError as e:
            report["one_shard_a_rank"] = str(e)
    if not torch.cuda.is_available():
        try:
            process_mesh(1, "cuda")
        except RuntimeError as e:
            report["cuda"] = str(e)
    report["layout"] = {"rank": mesh.rank, "world": mesh.world, "size": mesh.size,
                        "shards": list(mesh.shards),
                        "owns": [s for s in range(mesh.size) if mesh.owns(s)]}
    np.savez(out_dir / f"rank{mesh.rank}.npz", **lists)
    return report


def rank_one_raises(mesh, args):
    """Rank 1 fails; rank 0 waits in a collective that rank 1 never joins."""
    if mesh.rank == 1:
        raise RuntimeError("a planted failure of rank 1")
    mesh.barrier()


def ranks_hang(mesh, args):
    """Both ranks outlast any bound a test gives the launcher."""
    import time

    time.sleep(600)


def guards_disagree(mesh, args):
    """Rank 1's guard asks for a recall no sample reaches, so it escalates
    where rank 0's does not: the first sync must raise on both ranks."""
    import embeddinghub_tpu_torch.index.flat as flat
    from embeddinghub_tpu_torch.parallel import ShardedFlatIndex

    if mesh.rank == 1:
        flat._GUARD_RECALL = 1.01
    idx = ShardedFlatIndex(D, "l2", mesh=mesh, storage_dtype="int8x2")
    x = data(9, 4096)
    idx.add(np.arange(len(x)), x)
    idx.search(x[:4], K)
