#!/usr/bin/env python3
"""Sweep the split heuristic of K1/K2 over batch sizes on one CUDA card.

    python3 tools/sweep_splits.py

Builds a cosine arena of 1,000,000 rows x 128 (capacity 1,048,576) on the
card and times K1 (k=16) and K2 (k=128) with CUDA events, median of 5 runs
after 2 warm-ups, at B = 1, 16, 64, 256, 1024 and 4096, for every pairing
of the scan blocks aimed at per SM (1, 2, 4, 8) and the merge size (4,096
or 16,384 slots).  Those two are ``_BLOCKS_PER_SM`` and ``_MERGE_SLOTS`` of
``embeddinghub_tpu_torch/ops/fused_topk.py``.  Then, with the constants as
they are in the file, it prints a markdown table of kernel and plain
version times by batch size.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import CAP, DIMS, ROWS, SEED, device_ms  # noqa: E402

BATCHES = (1, 16, 64, 256, 1024, 4096)
BLOCKS_PER_SM = (1, 2, 4, 8)
MERGE_SLOTS = (4096, 16384)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_splits: no CUDA device", file=sys.stderr)
        return 1
    from embeddinghub_tpu_torch.ops import distance as D
    from embeddinghub_tpu_torch.ops import fused_topk as F

    D.full_f32()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    rng = np.random.default_rng(SEED)
    x = torch.zeros((CAP, DIMS), dtype=torch.float32, device="cuda")
    x[:ROWS] = torch.from_numpy(rng.standard_normal((ROWS, DIMS), dtype=np.float32)).cuda()
    x = D.preprocess_vectors(x, "cosine")
    x_sq = D.sqnorms(x)
    valid = torch.zeros(CAP, dtype=torch.bool, device="cuda")
    valid[:ROWS] = True
    q_all = torch.from_numpy(rng.standard_normal((max(BATCHES), DIMS), dtype=np.float32)).cuda()

    def k1(q):
        return F.exact_topk(q, x, valid, x_sq, k=16, metric="cosine")

    def k2(q):
        return F.approx_candidates(q, x, valid, x_sq, k=128, metric="cosine")

    committed = (F._BLOCKS_PER_SM, F._MERGE_SLOTS)
    try:
        for blocks in BLOCKS_PER_SM:
            for slots in MERGE_SLOTS:
                F._BLOCKS_PER_SM, F._MERGE_SLOTS = blocks, slots
                cells = []
                for b in BATCHES:
                    q = q_all[:b]
                    cells.append(f"B={b}: K1 {device_ms(torch, lambda: k1(q)):.3f} "
                                 f"K2 {device_ms(torch, lambda: k2(q)):.3f}")
                print(f"blocks/SM={blocks} slots={slots}: " + "; ".join(cells), flush=True)
    finally:
        F._BLOCKS_PER_SM, F._MERGE_SLOTS = committed

    print(f"\nms by batch size, blocks/SM={committed[0]} slots={committed[1]}:")
    print("| B | K2 k=128 | K1 k=16 | plain K1 | plain K2 |")
    print("| --- | --- | --- | --- | --- |")
    for b in BATCHES:
        q = q_all[:b]
        times = (
            device_ms(torch, lambda: k2(q)),
            device_ms(torch, lambda: k1(q)),
            device_ms(torch, lambda: F.fused_topk_search_reference(
                q, x, valid, x_sq, k=16, metric="cosine")),
            device_ms(torch, lambda: F.fused_topk_search_v2_reference(
                q, x, valid, x_sq, k=128, metric="cosine")),
        )
        print(f"| {b} | " + " | ".join(f"{t:.3f}" for t in times) + " |", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
