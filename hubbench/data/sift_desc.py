"""SIFT-descriptor-statistics rows of 128 integer-valued floats: a 4 x 4
grid of 8-bin orientation histograms with a drifting dominant orientation,
gamma-distributed energy and noise, normalized, clipped at 0.2,
normalized again and scaled to ``floor(512 d)``, as SIFT's are.  The
pattern of ``sift_desc_chunked`` in benchmarks/cluster_build.py, drawn on
the device from the run's seed (queries after the rows, from the same
stream)."""

from __future__ import annotations

import torch

_STEP = 1 << 18  # rows drawn at a time (bounds the temporaries)


def _exponential(shape, gen, device) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=device).exponential_(generator=gen)


def _sample(n: int, gen: torch.Generator, device) -> torch.Tensor:
    base = 8.0 * torch.rand((n, 1, 1), generator=gen, device=device)
    drift = (1.2 * torch.randn((n, 4, 4), generator=gen, device=device)).cumsum(2)
    ori = torch.remainder(base + drift, 8.0)
    bins = torch.arange(8, dtype=torch.float32, device=device)
    diff = (bins - ori[..., None]).abs()
    ang = torch.minimum(diff, 8.0 - diff)
    resp = torch.exp(-(ang ** 2) / (2 * 1.1 ** 2))
    # gamma(2, 1) as the sum of two unit exponentials; gamma(1, 0.25) as 0.25 Exp(1)
    energy = _exponential((n, 4, 4, 1), gen, device) + _exponential((n, 4, 4, 1), gen, device)
    noise = 0.25 * _exponential((n, 4, 4, 8), gen, device)
    d = (resp * energy + noise).reshape(n, 128)
    d = d / (d.norm(dim=1, keepdim=True) + 1e-12)
    d = torch.clamp(d, max=0.2)
    d = d / (d.norm(dim=1, keepdim=True) + 1e-12)
    return torch.floor(512.0 * d)


def generate(spec: dict, rows: int, queries: int, dims: int, gen: torch.Generator,
             device) -> tuple[torch.Tensor, torch.Tensor]:
    if dims != 128:
        raise ValueError(f"SIFT descriptors have 128 dimensions, not {dims}")

    def draw(n: int) -> torch.Tensor:
        out = torch.empty((n, dims), dtype=torch.float32, device=device)
        for s in range(0, n, _STEP):
            out[s:s + _STEP] = _sample(min(_STEP, n - s), gen, device)
        return out

    return draw(rows), draw(queries)
