#!/usr/bin/env python3
"""Time the composer's source registration in a main thread and in a
second thread.

    python3 tools/probe_composer.py [--rows 262144]
    MALLOC_ARENA_MAX=1 python3 tools/probe_composer.py

chip_smoke.py phase 14 registers phase 13's sqlite source (the first
262,144 of phase 3's 1M x 128 rows, keys "e<i>") in the composer's
coordinator thread.  This probe times the same registration
(SqliteOfflineStore.register_primary: the JSON encoding of every vector and
the inserts into an in-memory sqlite table) in the process's main thread
("bare") and in a second thread while the main thread waits on it
("thread"), and prints the seconds of each.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SEED, ROWS, DIMS = 20261016, 1_000_000, 128  # chip_smoke.py's phase 3 rows


def register(rows) -> float:
    from embeddinghub_tpu_torch.featurestore.providers.sqlite_offline import (
        SqliteOfflineStore,
    )

    store = SqliteOfflineStore()
    t0 = time.perf_counter()
    store.register_primary("items", "default", {"rows": rows})
    return time.perf_counter() - t0


def in_thread(fn) -> float:
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("s", fn()))
    t.start()
    t.join()
    return out["s"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 18)
    ns = ap.parse_args()
    x = np.random.default_rng(SEED).standard_normal((ROWS, DIMS), dtype=np.float32)
    rows = [{"key": f"e{i}", "vec": v} for i, v in enumerate(x[:ns.rows].tolist())]
    arenas = os.environ.get("MALLOC_ARENA_MAX", "unset")
    for name, run in (("bare", lambda: register(rows)),
                      ("thread", lambda: in_thread(lambda: register(rows)))):
        print(f"[probe_composer] {ns.rows} x {DIMS} rows, MALLOC_ARENA_MAX {arenas}, "
              f"{name}: {run():.2f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
