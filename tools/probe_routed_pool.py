#!/usr/bin/env python3
"""Where K1's time goes at the cluster-routed build's pool shapes, on one
CUDA card.

    python3 tools/probe_routed_pool.py

Builds an l2 arena of 4,000,000 rows x 128 (Gaussian, the seed of
chip_smoke.py's phase 2) on the card and times, with CUDA events (median of
5 runs after 2 warm-ups), at two shapes of the cluster-routed build, B=4096
with bf16 operands (``exact=False``):

  * the routed pool: k=257 over a block's 32,768 gathered rows;
  * the boundary repair's pool: k=256 over the 4,000,000 rows;

for each: K1's running lists at 1, 2, 4 and 8 scan blocks aimed at per SM
(``_BLOCKS_PER_SM`` of ``embeddinghub_tpu_torch/ops/fused_topk.py``), the
committed setting split into its scan and merge kernels by
``torch.profiler``, K1's large-k route (scores stored, then radix select)
on the same inputs, the plain version, and the product alone as one bf16
``torch.mm`` with f32 output per arena chunk.  Prints the card's name and
power limit first.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (BIG_ROWS, DIMS, FLUSH, GRAPH_POOL_K, ROUTED_K,  # noqa: E402
                        ROUTED_S, SEED, device_ms, library_product)
from sweep_splits import kernel_split_ms  # noqa: E402

BLOCKS_PER_SM = (1, 2, 4, 8)
SHAPES = (("routed pool", ROUTED_K, ROUTED_S), ("boundary repair pool", GRAPH_POOL_K,
                                                 BIG_ROWS))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_routed_pool: no CUDA device", file=sys.stderr)
        return 1
    from embeddinghub_tpu_torch.ops import distance as D
    from embeddinghub_tpu_torch.ops import fused_topk as F

    D.full_f32()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    rng = np.random.default_rng(SEED)
    x_all = torch.from_numpy(rng.standard_normal((BIG_ROWS, DIMS), dtype=np.float32)).cuda()
    q = torch.from_numpy(rng.standard_normal((FLUSH, DIMS), dtype=np.float32)).cuda()
    committed = F._BLOCKS_PER_SM
    for label, k, rows in SHAPES:
        x = x_all[:rows]
        x_sq = D.sqnorms(x)
        valid = torch.ones(rows, dtype=torch.bool, device="cuda")
        args = dict(k=k, metric="l2", exact=False)

        def lists():
            return F.exact_topk(q, x, valid, x_sq, **args)

        try:
            for blocks in BLOCKS_PER_SM:
                F._BLOCKS_PER_SM = blocks
                print(f"[{label}] K1 lists, blocks/SM={blocks}: "
                      f"{device_ms(torch, lists):.3f} ms", flush=True)
        finally:
            F._BLOCKS_PER_SM = committed
        split = kernel_split_ms(torch, lists)
        print(f"[{label}] K1 lists, blocks/SM={committed}, by kernel: " + "; ".join(
            f"{name} {ms:.3f} ms" for name, ms in sorted(split.items(),
                                                          key=lambda kv: -kv[1])),
            flush=True)
        large = device_ms(torch, lambda: F.exact_topk_large_k(q, x, valid, x_sq, **args))
        plain = device_ms(torch, lambda: F.fused_topk_search_reference(
            q, x, valid, x_sq, **args))
        library = device_ms(torch, library_product(torch, "fused_topk_search", q, x,
                                                   F.arena_bf16(x), exact=False))
        print(f"[{label}] B={FLUSH} k={k} rows={rows}: K1 large-k route {large:.3f} ms; "
              f"plain {plain:.3f} ms; library product {library:.3f} ms", flush=True)
        del x_sq, valid
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
