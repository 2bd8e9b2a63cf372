"""The port's twin of ``tests/test_soak_chain.py::test_chain_with_mid_write_crash``
on the ``hnsw`` engine, at CPU toy scale (3,000 x 16 base rows, M=8,
efC=60): a store on a data directory is driven by segments, each its own
process (this file run as a script), with concurrent sets, deletes,
searches, reads and snapshots.  The second segment dies mid-write
(``os._exit(137)``); the third reopens from snapshot + WAL and must find
every acknowledged write (each set key with its vector, no deleted key),
and the base rows' neighbors must stay reachable: recall@10 at ef=100 of
the base ground truth, over the search results that are base rows, at
least 0.85.

Writers stop after ``--rows`` rows a segment, so the store grows by a
bounded share (the reference's writers run free, and its recall measure
then counts the rows they add as misses).  A segment runs its seconds and
then on until it has set and deleted at least once, so a loaded host
cannot end it (or kill it) before it wrote; that wait is bounded by
``GRACE_S``, and every segment by ``SEGMENT_TIMEOUT_S``.

    python tests/test_torch_soak_chain.py --dir DIR --seconds 6 [--kill]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPACE, DIMS, BASE, K = "soak", 16, 3000, 10
GRACE_S = 40
SEGMENT_TIMEOUT_S = 120


def _base():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BASE, DIMS)).astype(np.float32)
    test = x[:32] + 0.01 * rng.standard_normal((32, DIMS)).astype(np.float32)
    gt = np.argsort(((test[:, None] - x[None]) ** 2).sum(-1), axis=1)[:, :K]
    return x, test, gt


def seed(store: str) -> None:
    """The base graph, built through the store (one bulk build), saved."""
    from embeddinghub_tpu_torch.store.hub import EmbeddingHub
    from embeddinghub_tpu_torch.utils.config import Config

    x, _, _ = _base()
    config = Config(engine="hnsw", hnsw_m=8, hnsw_ef_construction=60)
    hub = EmbeddingHub.load_or_create(store, engine="hnsw", device="cpu",
                                      config=config)
    version = hub.create_space(SPACE, DIMS, "l2").default_version()
    version.multiset((f"r{j:08d}", v) for j, v in enumerate(x))
    hub.save()


def segment(args) -> None:
    from embeddinghub_tpu_torch.store.hub import EmbeddingHub

    def rep(**kv):
        print(json.dumps(kv), flush=True)

    t_open = time.perf_counter()
    hub = EmbeddingHub.load_or_create(args.dir, engine="hnsw", device="cpu")
    ver = hub.get_version(SPACE)
    open_s = time.perf_counter() - t_open
    _, test, gt = _base()

    state_path = os.path.join(args.dir, "soak_state.json")
    prev = None
    if os.path.exists(state_path):
        with open(state_path) as f:
            prev = json.load(f)
        missing = [k for k in prev["acked"] if k not in ver]
        wrong = [k for k, v in prev["acked"].items()
                 if k in ver and not np.array_equal(ver.get(k), np.float32(v))]
        back = [k for k in prev["deleted"] if k in ver]
        rep(stage="recovery_check", after_kill=prev["killed"],
            acked=len(prev["acked"]), missing=len(missing), wrong=len(wrong),
            deleted_back=len(back), size=ver.size)
    seg = prev["segment"] + 1 if prev else 1

    stop = threading.Event()
    errors: list[str] = []
    lock = threading.Lock()
    acked = dict(prev["acked"]) if prev else {}   # key -> vector, acknowledged
    deleted = list(prev["deleted"]) if prev else []
    counts = {"inserts": 0, "deletes": 0, "queries": 0, "reads": 0, "snapshots": 0}

    def guard(fn):
        def run():
            try:
                while not stop.is_set():
                    fn()
            except Exception as e:  # noqa: BLE001 - reported, then the segment fails
                errors.append(repr(e))
                stop.set()
        return run

    def writer(wid):
        rng = np.random.default_rng(1000 * seg + wid)
        n = [0]

        def write():
            if n[0] >= args.rows:
                time.sleep(0.05)
                return
            keys = [f"s{seg:02d}_{wid}_{n[0] + j:05d}" for j in range(64)]
            vecs = rng.standard_normal((64, DIMS)).astype(np.float32)
            ver.multiset(zip(keys, vecs))
            n[0] += 64
            with lock:
                acked.update((k, v.tolist()) for k, v in zip(keys, vecs))
                counts["inserts"] += 64
        return write

    def deleter():
        time.sleep(0.02)
        with lock:  # a key being deleted is neither acked nor deleted yet
            mine = [k for k in acked if k.startswith(f"s{seg:02d}_")]
            if len(mine) < 200:
                return
            key = mine[len(mine) // 3]
            del acked[key]
        ver.delete(key)
        with lock:
            deleted.append(key)
            counts["deletes"] += 1

    def searcher():
        time.sleep(0.01)
        with ver.lock:  # as the server's batcher does
            got = ver.nearest_batch(test[:8], K)
        assert len(got) == 8
        with lock:
            counts["queries"] += 8

    def reader():
        time.sleep(0.01)
        v = ver.get(f"r{np.random.default_rng().integers(0, BASE):08d}")
        assert v.shape == (DIMS,)
        with lock:
            counts["reads"] += 1

    def snapshotter():
        time.sleep(args.snapshot_every)
        if not stop.is_set():
            hub.save()
            with lock:
                counts["snapshots"] += 1

    threads = [threading.Thread(target=guard(fn), daemon=True)
               for fn in (writer(0), writer(1), deleter, searcher, reader, snapshotter)]

    def wrote():
        with lock:
            return counts["inserts"] > 0 and counts["deletes"] > 0

    t0 = time.perf_counter()
    for t in threads:
        t.start()
    while not stop.is_set():
        time.sleep(0.2)
        elapsed = time.perf_counter() - t0
        if args.kill and elapsed > 0.6 * args.seconds and wrote():
            with lock:  # what must survive: every acknowledged write so far
                state = {"segment": seg, "killed": True, "acked": acked,
                         "deleted": deleted}
                with open(state_path + ".tmp", "w") as f:
                    json.dump(state, f)
                os.replace(state_path + ".tmp", state_path)
                rep(stage="killing", **counts)
                os._exit(137)  # a crash: no close, no save, writers mid-write
        if elapsed >= args.seconds + GRACE_S or (
                elapsed >= args.seconds and wrote()):
            break
    stop.set()
    for t in threads:
        t.join(timeout=20)

    # Recall of the base ground truth over the results that are base rows
    # (base rows are never deleted, so their rows stay below BASE).
    with ver.lock:
        got = ver.index.search(test, 2 * K, ef=100 + K)[1]
    rec = float(np.mean([
        len(set([i for i in row.tolist() if 0 <= i < BASE][:K]) & set(g.tolist())) / K
        for row, g in zip(got, gt)]))
    hub.save()
    with open(state_path + ".tmp", "w") as f:
        json.dump({"segment": seg, "killed": False, "acked": acked,
                   "deleted": deleted}, f)
    os.replace(state_path + ".tmp", state_path)
    rep(stage="segment_done", segment=seg, open_s=round(open_s, 2),
        size_end=ver.size, recall_ef100=rec, errors=errors, **counts)


def _run(store, seconds, kill=False):
    cmd = [sys.executable, os.path.abspath(__file__), "--dir", store,
           "--seconds", str(seconds), "--snapshot-every", "2"]
    if kill:
        cmd.append("--kill")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=SEGMENT_TIMEOUT_S)
    lines = [json.loads(ln) for ln in out.stdout.splitlines() if ln.startswith("{")]
    return out.returncode, lines, out.stderr[-2000:]


def test_chain_with_mid_write_crash(tmp_path):
    store = str(tmp_path / "store")
    seed(store)

    rc, lines, err = _run(store, 5)  # a clean segment
    assert rc == 0, (lines, err)
    done = [ln for ln in lines if ln.get("stage") == "segment_done"][0]
    assert done["errors"] == [] and done["inserts"] > 0 and done["deletes"] > 0

    rc, lines, err = _run(store, 6, kill=True)  # dies mid-write
    assert rc == 137, (rc, lines, err)
    killing = [ln for ln in lines if ln.get("stage") == "killing"][0]
    assert killing["inserts"] > 0

    rc, lines, err = _run(store, 4)  # recovers from snapshot + WAL
    assert rc == 0, (lines, err)
    rec = [ln for ln in lines if ln.get("stage") == "recovery_check"][0]
    assert rec["after_kill"] is True and rec["acked"] > 0
    assert rec["missing"] == 0 and rec["wrong"] == 0 and rec["deleted_back"] == 0
    done = [ln for ln in lines if ln.get("stage") == "segment_done"][0]
    assert done["errors"] == []
    assert done["recall_ef100"] >= 0.85, done  # base neighbors stay reachable


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--rows", type=int, default=512, help="rows each writer sets a segment")
    ap.add_argument("--snapshot-every", type=float, default=2.0)
    ap.add_argument("--kill", action="store_true",
                    help="die mid-write at 60%% of the segment")
    segment(ap.parse_args())


if __name__ == "__main__":
    main()
