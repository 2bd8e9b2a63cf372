"""The sharded engines across processes: the twin of
``benchmarks/multihost_dryrun.py``.

    python -m embeddinghub_tpu_torch.parallel.multihost --procs 2 \\
        --local-shards 2 --device cuda --backend gloo [--port P] \\
        [--rows-per-shard N] [--dims D] [--timeout S]

The launcher starts ``--procs`` ranks, each a subprocess of this module,
and waits for them with a bound: once a rank fails it kills the others,
and past ``--timeout`` seconds it kills them all; either way it exits
non-zero.  Each rank joins the process group (``tcp://127.0.0.1:P``, a
free port when none is named, the same timeout), builds its
``process_mesh(--local-shards, --device)`` and runs the reference's three
legs on it, every rank the same calls:

  (a) ``ShardedFlatIndex`` in f32 and then int8 storage over ``S *
      rows-per-shard`` rows with planted exact matches: every query's top-1
      must be its planted row, and every rank must hold the same lists;
  (b) a per-rank snapshot of the int8 index: each rank writes its own
      shards' files (``ShardedFlatIndex.save_shards``: rows, scales, mask),
      a barrier, then each reads back its own into a new index over the
      same host rows (``restore_shards``), whose search must return the
      same ids;
  (c) ``ShardedHNSWIndex`` over ``96 S`` rows: 8 probes must find
      themselves at ef=32 (a share of at least 0.9: all 8).

Rank 0 prints the ``PASS multihost ...`` lines.  With ``--data`` and
``--queries`` (``.npy`` files, memory-mapped) the flat legs run over those
rows at ``--k`` in ``--metric`` instead, and with ``--graph-data`` and
``--graph-queries`` the graph leg (``--graph-m``, ``--graph-efc``,
``--graph-ef``); then nothing is planted and the caller judges the lists,
which every rank writes to ``--out``/``rank<r>.npz``.  ``--entry
module:function`` runs ``function(mesh, args)`` on each rank in place of
the legs.  Every rank ends with one line ``MULTIHOST_RANK {json}``: its
kernel launches (``ops/fused_topk.LAUNCHES``, zeroed after the group is
up) and what its legs measured; the launcher's last line is ``multihost
{json}`` with the ranks' lines and their launches summed.

The backend is the caller's: ``gloo`` stages the lists through host
memory (CPU shards, or ranks that share a card), ``nccl`` gathers them on
the cards and needs one for each rank.  No fallback either way.
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

RANK_TAG = "MULTIHOST_RANK "
SUMMARY_TAG = "multihost "
PLANTED = 8  # queries of the flat legs without --data, each planted as a row


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--local-shards", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    ap.add_argument("--port", type=int, default=0, help="0: a free port")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds for the whole run and for each collective")
    ap.add_argument("--rows-per-shard", type=int, default=128)
    ap.add_argument("--dims", type=int, default=16)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--metric", default="l2")
    ap.add_argument("--data", help=".npy rows for the flat legs")
    ap.add_argument("--queries", help=".npy queries for the flat legs")
    ap.add_argument("--graph-data", help=".npy rows for the graph leg")
    ap.add_argument("--graph-queries", help=".npy queries for the graph leg")
    ap.add_argument("--graph-m", type=int, default=8)
    ap.add_argument("--graph-efc", type=int, default=32)
    ap.add_argument("--graph-ef", type=int, default=32)
    ap.add_argument("--out", help="directory for the ranks' lists and shard files")
    ap.add_argument("--entry", help="module:function to run on each rank instead")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


# ------------------------------------------------------------------ launcher


def launch(args: argparse.Namespace) -> int:
    """Run the ranks; 0 when every rank exited 0 and reported its line."""
    port = args.port or free_port()
    made = None
    if args.out is None:
        made = tempfile.TemporaryDirectory(prefix="ehtorch_multihost_")
        args.out = made.name
    base = [sys.executable, "-m", "embeddinghub_tpu_torch.parallel.multihost"]
    for name, value in vars(args).items():
        if value is not None and name not in ("rank", "port"):
            base += [f"--{name.replace('_', '-')}", str(value)]
    root = str(Path(__file__).resolve().parents[2])  # the package's checkout
    env = dict(os.environ, PYTHONUNBUFFERED="1",
               PYTHONPATH=os.pathsep.join(filter(None, (root, os.environ.get("PYTHONPATH")))))
    procs = [subprocess.Popen(base + ["--port", str(port), "--rank", str(r)],
                              stdout=subprocess.PIPE, text=True, env=env)
             for r in range(args.procs)]
    lines: dict[int, dict] = {}
    lock = threading.Lock()

    def relay(r: int, stream) -> None:
        for line in stream:
            with lock:
                if line.startswith(RANK_TAG):  # kept for the summary line
                    lines[r] = json.loads(line[len(RANK_TAG):])
                    continue
                sys.stdout.write(line)
                sys.stdout.flush()

    readers = [threading.Thread(target=relay, args=(r, p.stdout), daemon=True)
               for r, p in enumerate(procs)]
    for t in readers:
        t.start()
    deadline = time.monotonic() + args.timeout
    why = None
    try:
        while why is None:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes):
                break
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                why = f"rank {bad[0][0]} exited {bad[0][1]}"
            elif time.monotonic() > deadline:
                why = f"the ranks ran past {args.timeout:g} s"
            else:
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for t in readers:
            t.join(timeout=10)
        if made is not None:
            made.cleanup()
    if why is None and len(lines) != args.procs:
        why = f"ranks {sorted(set(range(args.procs)) - set(lines))} reported no line"
    if why is not None:
        print(f"multihost: {why}; every rank stopped", file=sys.stderr, flush=True)
        return 1
    total: dict[str, int] = {}
    for r in sorted(lines):
        for name, n in lines[r].get("launches", {}).items():
            total[name] = total.get(name, 0) + n
    print(SUMMARY_TAG + json.dumps({"procs": args.procs, "local_shards": args.local_shards,
                                    "backend": args.backend, "launches": total,
                                    "ranks": [lines[r] for r in sorted(lines)]}), flush=True)
    return 0


# --------------------------------------------------------------------- ranks


def same_on_ranks(mesh, *arrays) -> bool:
    """Whether every rank holds the same ``arrays`` (a digest gathered)."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return len(set(mesh.gather_objects(h.hexdigest()))) == 1


def _timed(mesh, fn, runs: int = 3) -> dict:
    """Median wall ms of ``fn`` a call and median ms of its gathers
    (``Mesh.gather_s``) a call, over ``runs`` calls."""
    walls, gathers = [], []
    for _ in range(runs):
        g0, t0 = mesh.gather_s, time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
        gathers.append((mesh.gather_s - g0) * 1e3)
    return {"ms": float(np.median(walls)), "gather_ms": float(np.median(gathers))}


def _device_ms(torch, mesh, fn, runs: int = 3):
    """Median CUDA-event ms of ``fn`` on this rank's card; None on the CPU."""
    if mesh.devices[0].type != "cuda":
        return None
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _flat_data(args, s_n: int):
    """(rows, queries, planted targets or None)."""
    if args.data:
        return (np.load(args.data, mmap_mode="r"), np.load(args.queries), None)
    cap = args.rows_per_shard * s_n
    rng = np.random.default_rng(0)
    x = rng.standard_normal((cap, args.dims)).astype(np.float32)
    q = rng.standard_normal((PLANTED, args.dims)).astype(np.float32)
    targets = np.arange(0, cap, cap // PLANTED)[:PLANTED]
    x[targets] = q
    return x, q, targets


def flat_legs(torch, mesh, args, out: dict, report: dict) -> None:
    """Legs (a) and (b)."""
    from embeddinghub_tpu_torch.index.base import next_pow2
    from embeddinghub_tpu_torch.parallel.sharded_flat import ShardedFlatIndex, padded_queries

    x, q, targets = _flat_data(args, mesh.size)
    n, d, k = x.shape[0], x.shape[1], args.k
    rows = np.arange(n)
    kw = dict(dims=d, metric=args.metric, mesh=mesh, capacity=n)
    for storage in ("float32", "int8"):
        idx = None  # the last index's arenas go before the next one's
        idx = ShardedFlatIndex(storage_dtype=storage, **kw)
        t0 = time.perf_counter()
        idx.add(rows, x)
        dd, ii = idx.search(q, k)
        first_s = time.perf_counter() - t0
        timed = _timed(mesh, lambda: idx.search(q, k))
        qp = padded_queries(np.asarray(q, np.float32), args.metric)
        kk = min(next_pow2(k, floor=1), idx._cap_local)
        qd = mesh.put(qp)
        dev = _device_ms(torch, mesh, lambda: [
            idx._local_search(st, qq, kk, idx._local_rows(s))
            for s, st, qq in zip(mesh.shards, idx._shards, qd)])
        if not same_on_ranks(mesh, dd, ii):
            raise RuntimeError(f"the ranks' {storage} lists differ")
        if targets is not None and not (ii[:, 0] == targets).all():
            raise RuntimeError(f"{storage} top-1 {ii[:, 0].tolist()} != planted "
                               f"{targets.tolist()}")
        out[f"{storage}_d"], out[f"{storage}_i"] = dd, ii
        report[storage] = {"first_s": first_s, **timed, "device_ms": dev,
                           "storage": idx.storage_dtype,
                           "guard_recalls": idx.guard_recalls}
        if mesh.rank == 0:
            print(f"PASS multihost {mesh.world}x{len(mesh.devices)} {storage}: "
                  f"{idx._cap_local} rows/shard x {d}d, top-1 {ii[:8, 0].tolist()}, "
                  f"sharded search {timed['ms']:.1f} ms (gather {timed['gather_ms']:.2f} "
                  f"ms), storage {idx.storage_dtype}", flush=True)

    # (b) per-rank shard files of the int8 index, read back by their ranks
    snap = Path(args.out) / "shards"
    t0 = time.perf_counter()
    written = idx.save_shards(snap)
    mesh.barrier()
    save_s = time.perf_counter() - t0
    if sorted(p.name for p in written) != sorted(f"shard{s}.npz" for s in mesh.shards):
        raise RuntimeError(f"rank {mesh.rank} wrote {written}")
    t0 = time.perf_counter()
    back = ShardedFlatIndex(storage_dtype="int8", **kw)
    back.add(rows, x)
    back.restore_shards(snap)
    i2 = back.search(q, k)[1]
    restore_s = time.perf_counter() - t0
    if back.storage_dtype != idx.storage_dtype or not np.array_equal(i2, ii):
        raise RuntimeError("the restored shards' search ids differ")
    report["snapshot"] = {"save_s": save_s, "restore_s": restore_s,
                          "bytes": sum(p.stat().st_size for p in written)}
    if mesh.rank == 0:
        print("PASS multihost snapshot/restore: per-rank shard files, identical "
              "search ids after the reload", flush=True)


def graph_leg(mesh, args, out: dict, report: dict) -> None:
    """Leg (c)."""
    from embeddinghub_tpu_torch.parallel.sharded_hnsw import ShardedHNSWIndex

    if args.graph_data:
        gx, gq = np.load(args.graph_data, mmap_mode="r"), np.load(args.graph_queries)
        probe = None
    else:
        n_rows = mesh.size * 96
        gx = np.random.default_rng(1).standard_normal((n_rows, args.dims)).astype(np.float32)
        probe = np.arange(0, n_rows, n_rows // 8)[:8]
        gq = gx[probe] + 1e-5
    idx = ShardedHNSWIndex(gx.shape[1], mesh=mesh, m=args.graph_m,
                           ef_construction=args.graph_efc, capacity=gx.shape[0])
    t0 = time.perf_counter()
    idx.add(np.arange(gx.shape[0]), gx)
    add_s = time.perf_counter() - t0
    k = 1 if probe is not None else args.k
    dd, ii = idx.search(gq, k, ef=args.graph_ef)
    timed = _timed(mesh, lambda: idx.search(gq, k, ef=args.graph_ef))
    if not same_on_ranks(mesh, dd, ii):
        raise RuntimeError("the ranks' graph lists differ")
    if idx.size != gx.shape[0]:
        raise RuntimeError(f"graph size {idx.size} != {gx.shape[0]}")
    out["graph_d"], out["graph_i"] = dd, ii
    report["graph"] = {"add_s": add_s, **timed,
                       "build_s": {s: sum(idx._shards[s].build_seconds.values())
                                   for s in mesh.shards}}
    if probe is not None:
        found = float((ii[:, 0] == probe).mean())
        if found < 0.9:
            raise RuntimeError(f"graph top-1 {ii[:, 0].tolist()} != {probe.tolist()}")
        report["graph"]["self_found"] = found
    if mesh.rank == 0:
        print(f"PASS multihost graph {mesh.world}x{len(mesh.devices)}: "
              f"{gx.shape[0]} rows, top-1 {ii[:8, 0].tolist()}, search "
              f"{timed['ms']:.1f} ms", flush=True)


def legs(mesh, args) -> dict:
    """The three legs; returns what they measured.  Every rank's lists go
    to ``--out``/``rank<r>.npz``."""
    import torch

    out: dict[str, np.ndarray] = {}
    report: dict = {}
    flat_legs(torch, mesh, args, out, report)
    graph_leg(mesh, args, out, report)
    np.savez(Path(args.out) / f"rank{mesh.rank}.npz", **out)
    return report


def rank_main(args: argparse.Namespace) -> None:
    import torch.distributed as dist

    from embeddinghub_tpu_torch.ops import fused_topk as F
    from embeddinghub_tpu_torch.parallel.mesh import process_mesh

    dist.init_process_group(args.backend, init_method=f"tcp://127.0.0.1:{args.port}",
                            world_size=args.procs, rank=args.rank,
                            timeout=datetime.timedelta(seconds=args.timeout))
    try:
        mesh = process_mesh(args.local_shards, args.device)
        F.reset_launches()
        if args.entry:
            module, name = args.entry.split(":")
            report = getattr(importlib.import_module(module), name)(mesh, args)
        else:
            report = legs(mesh, args)
        mesh.barrier()
        print(RANK_TAG + json.dumps({"rank": args.rank, "shards": list(mesh.shards),
                                     "launches": dict(F.LAUNCHES), "legs": report or {}}),
              flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.rank is None:
        return launch(args)
    rank_main(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
