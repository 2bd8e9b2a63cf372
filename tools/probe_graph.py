#!/usr/bin/env python3
"""Where the time of a graph search goes, on one CUDA card.

    python3 tools/probe_graph.py

Builds the graph of ``chip_smoke.py`` phase 8 (1,000,000 x 128 SIFT proxy,
l2, M=16, efC=200, one exact bulk build through ``HNSWIndex.add``) and
takes ``HNSWIndex.search`` at B=1024, k=10 apart at ef 50, 100 and 200 on
the bf16 walk.  Medians of 5 calls after 2 warm-ups, on the host clock with
the device synchronized:

  * the whole ``search`` (query upload, descent, beam, rerank, readback);
  * the greedy descent through the upper layers alone;
  * the layer-0 beam alone, its iterations (hops) and ms per hop.

Last, a ``torch.profiler`` trace of one beam gives its kernel launches per
hop, the device's busy time and its idle share (1 - busy / wall, against the
wall under the profiler and without it), and the kernels that take the most
device time.  About two minutes, most of it the
data and the build.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (  # noqa: E402
    DIMS, GRAPH_EFC, GRAPH_EFS, GRAPH_K, GRAPH_M, GRAPH_QUERIES, ROWS, sift_proxy)


def median_ms(torch, fn, runs: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("probe_graph: no CUDA device", file=sys.stderr)
        return 1
    from embeddinghub_tpu_torch.index.base import next_pow2
    from embeddinghub_tpu_torch.index.hnsw import HNSWIndex
    from embeddinghub_tpu_torch.ops import _build
    from embeddinghub_tpu_torch.ops import beam as beam_ops

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    _build.library()  # before the build, whose pools would time nvcc otherwise
    print(f"kernel build {time.perf_counter() - t0:.1f} s", flush=True)
    train, test = sift_proxy(ROWS, GRAPH_QUERIES, DIMS)
    index = HNSWIndex(DIMS, "l2", m=GRAPH_M, ef_construction=GRAPH_EFC, device="cuda")
    t0 = time.perf_counter()
    index.add(np.arange(ROWS), train)
    print(f"build {time.perf_counter() - t0:.2f} s: "
          + ", ".join(f"{k} {v:.2f}" for k, v in index.build_seconds.items()), flush=True)

    state = index._device_arrays()
    xa = index._walk_arena(state)
    q = torch.from_numpy(test).cuda()
    upper = state["ustack"]

    def descend():
        cur = torch.full((q.shape[0],), index._entry, dtype=torch.int64, device="cuda")
        for layer in range(upper.shape[0], 0, -1):
            cur = beam_ops.greedy_descend(q, cur, upper[layer - 1], xa, None, metric="l2")
        return cur

    entries = descend()
    print(f"search B={GRAPH_QUERIES} k={GRAPH_K}, bf16 walk, {upper.shape[0]} upper "
          f"layers; median ms of 5:", flush=True)
    for ef in GRAPH_EFS:
        ef_l = min(next_pow2(ef, floor=8), 1024)

        def beam():
            return beam_ops.beam_search(q, entries, state["nb0"], xa, None, None,
                                        metric="l2", ef=ef_l, expand=index.expand,
                                        max_hops=2 * ef_l + 64, with_hops=True)

        hops = beam()[2]
        whole = median_ms(torch, lambda: index.search(test, GRAPH_K, ef=ef))
        walk = median_ms(torch, beam)
        print(f"  ef={ef} (pool {ef_l}): search {whole:.3f}; descent "
              f"{median_ms(torch, descend):.3f}; beam {walk:.3f} in {hops} hops, "
              f"{walk / hops:.3f} per hop", flush=True)

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            beam()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.time_range.elapsed_us() for e in dev)
        print(f"    profiled beam: {len(dev) / hops:.1f} device events per hop, "
              f"device busy {busy_us / 1e3 / hops:.3f} ms per hop of "
              f"{wall_us / 1e3 / hops:.3f} under the profiler (idle share "
              f"{1 - busy_us / wall_us:.3f}), of {walk / hops:.3f} without it "
              f"(idle share {1 - busy_us / 1e3 / walk:.3f})", flush=True)
        if ef == 100:
            print(prof.key_averages().table(sort_by="self_device_time_total",
                                            row_limit=12), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
