#!/usr/bin/env python3
"""Where the time of ``Version.nearest_batch`` goes, on one CUDA card.

    python3 tools/probe_breakdown.py

Fills an in-memory cosine space of 1,000,000 rows x 128 through
``Version.multiset`` in 4096-row batches, as ``chip_smoke.py`` does, then
takes ``nearest_batch`` at B=4096, k=10 under mode "auto" apart.  Medians
of 3 calls after one warm-up, on the host clock:

  * the whole ``nearest_batch``;
  * ``FlatIndex.search`` alone (device search plus readback);
  * the device search alone (query upload, K2, rerank; synchronized);
  * the row -> key lookups alone (``KeyMap.keys_for_rows`` per query).

Last, a ``torch.profiler`` trace of 3 whole calls gives the device time of
each kernel and the device's idle share: 1 - (device busy time / wall
time).  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import DIMS, FLUSH, MAIN_B, MAIN_K, ROWS, SEED  # noqa: E402


def median_ms(fn, runs: int = 3) -> float:
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("probe_breakdown: no CUDA device", file=sys.stderr)
        return 1
    from embeddinghub_tpu_torch.store.hub import EmbeddingHub

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    rng = np.random.default_rng(SEED)
    x_host = rng.standard_normal((ROWS, DIMS), dtype=np.float32)
    queries = np.random.default_rng(SEED + 2).standard_normal((MAIN_B, DIMS), dtype=np.float32)
    version = EmbeddingHub.in_memory(device="cuda").create_space(
        "probe", DIMS, "cosine").default_version()
    keys = [f"k{j}" for j in range(ROWS)]
    for s in range(0, ROWS, FLUSH):
        version.multiset(zip(keys[s:s + FLUSH], x_host[s:s + FLUSH]))
    index = version.index
    _, rows = index.search(queries, MAIN_K)

    def device_search():
        index._search_device(queries, MAIN_K, "auto", None)
        torch.cuda.synchronize()

    def lookups():
        for r in rows:
            version.keymap.keys_for_rows(r[r >= 0])

    parts = (
        ("nearest_batch, whole", lambda: version.nearest_batch(queries, MAIN_K)),
        ("FlatIndex.search", lambda: index.search(queries, MAIN_K)),
        ("device search (upload + K2 + rerank)", device_search),
        ("row -> key lookups", lookups),
    )
    print(f"nearest_batch B={MAIN_B} k={MAIN_K} auto, {ROWS} x {DIMS} cosine, "
          f"median ms of 3:")
    for name, fn in parts:
        print(f"  {name}: {median_ms(fn):.3f}", flush=True)

    calls = 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            version.nearest_batch(queries, MAIN_K)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernels and copies on the card; the host ops that launch them repeat
    # their device time, so only device-side events are summed
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"profiled {calls} calls: wall {wall_us / 1e3 / calls:.3f} ms per call, "
          f"device busy {busy_us / 1e3 / calls:.3f} ms per call, "
          f"idle share {1 - busy_us / wall_us:.3f}")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=12),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
