"""The plain reference: exact nearest rows by f32 products with TF32 off, in
PyTorch, in blocks that fit.  It takes the generated rows and queries as
the benchmark made them and imports nothing of the program.

Scores are "higher is nearer": the dot product of unit vectors for
``cosine``, the negated squared distance ``-(|q|^2 + |x|^2 - 2 q.x)`` for
``l2`` (exact for the integer-valued SIFT rows: every sum stays below
2**24).
"""

from __future__ import annotations

import torch

_ROW_BLOCK = 1 << 17  # rows a product takes at a time
_QUERY_BLOCK = 1 << 16  # answers scored at a time


def f32_products() -> None:
    """Float32 products in full f32 (no TF32), for every product below."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def prepare(rows: torch.Tensor, queries: torch.Tensor, metric: str):
    """The rows and queries as the metric compares them (unit vectors for
    cosine), in f32; the rows are normalized in place."""
    if metric not in ("cosine", "l2"):
        raise ValueError(f"unknown metric {metric!r}")
    rows = rows.to(torch.float32)
    queries = queries.to(torch.float32)
    if metric == "cosine":
        rows.div_(rows.norm(dim=1, keepdim=True).clamp_(min=1e-30))
        queries = queries / queries.norm(dim=1, keepdim=True).clamp(min=1e-30)
    return rows, queries


def _scores(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    dots = q @ x.T
    if metric == "cosine":
        return dots
    return -((q * q).sum(1, keepdim=True) + (x * x).sum(1)[None, :] - 2.0 * dots)


def exact_topk(rows: torch.Tensor, queries: torch.Tensor, k: int, metric: str):
    """The ``k`` nearest rows of every query: ``(scores [Q, k], ids [Q, k])``,
    nearest first, over prepared rows and queries."""
    f32_products()
    best_s = torch.full((queries.shape[0], k), -float("inf"), device=queries.device)
    best_i = torch.full((queries.shape[0], k), -1, dtype=torch.int64, device=queries.device)
    for s in range(0, rows.shape[0], _ROW_BLOCK):
        sc = _scores(queries, rows[s:s + _ROW_BLOCK], metric)
        v, i = torch.topk(sc, min(k, sc.shape[1]), dim=1)
        best_s, pos = torch.topk(torch.cat([best_s, v], 1), k, dim=1)
        best_i = torch.gather(torch.cat([best_i, i + s], 1), 1, pos)
    return best_s, best_i


def scores_of(rows: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor,
              metric: str) -> torch.Tensor:
    """Scores ``[M, k]`` of the rows ``ids [M, k]`` (``-1``: none, scored
    ``-inf``) for the queries ``queries [M, D]``, over prepared rows."""
    f32_products()
    out = torch.empty(ids.shape, dtype=torch.float32, device=queries.device)
    for s in range(0, ids.shape[0], _QUERY_BLOCK):
        blk = ids[s:s + _QUERY_BLOCK]
        q = queries[s:s + _QUERY_BLOCK]
        x = rows[blk.clamp(min=0)]  # [m, k, D]
        dots = torch.einsum("mkd,md->mk", x, q)
        if metric == "l2":
            dots = -((q * q).sum(1)[:, None] + (x * x).sum(2) - 2.0 * dots)
        out[s:s + _QUERY_BLOCK] = torch.where(blk >= 0, dots, -float("inf"))
    return out
