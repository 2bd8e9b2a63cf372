"""Deep-style clustered rows: ``centers`` centres drawn as
``center_scale * N(0, 1)``, then each row (and each query) a centre picked
uniformly plus ``noise * N(0, 1)``.  The pattern of ``gen_chunk`` in
benchmarks/capacity.py, drawn on the device from the run's seed.  At
``noise`` 0.35 around 10,000 rows share a centre at 10M rows, and the
score gaps among a query's nearest rows sit below int8 noise: the
near-duplicate regime that needs the int8x2 residual plane."""

from __future__ import annotations

import torch

_STEP = 1 << 20  # rows drawn at a time (bounds the temporaries)


def generate(spec: dict, rows: int, queries: int, dims: int, gen: torch.Generator,
             device) -> tuple[torch.Tensor, torch.Tensor]:
    centers = spec["center_scale"] * torch.randn(
        (spec["centers"], dims), generator=gen, device=device)

    def draw(n: int) -> torch.Tensor:
        out = torch.empty((n, dims), dtype=torch.float32, device=device)
        for s in range(0, n, _STEP):
            c = min(_STEP, n - s)
            pick = torch.randint(0, spec["centers"], (c,), generator=gen, device=device)
            out[s:s + c] = centers[pick] + spec["noise"] * torch.randn(
                (c, dims), generator=gen, device=device)
        return out

    return draw(rows), draw(queries)
