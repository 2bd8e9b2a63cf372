"""Distance + top-k selection: the twin of ``embeddinghub_tpu/ops/topk.py``
for the functions the flat engine uses.

On CUDA the two searches run on the hand-written kernels of
:mod:`embeddinghub_tpu_torch.ops.fused_topk`:

  * :func:`exact_search` (and :func:`chunked_topk_search`, the reference's
    name and contract for it) is K1 (exact: a compensated TF32 product on
    the tensor cores, f32-grade): its running lists
    for ``k`` up to ``MAX_K_EXACT``, its large-k route above that, up to
    the arena's capacity;
  * :func:`approx_oversample_search` is K2 for ``k * oversample`` bf16
    candidates, scored on the arena's bf16 mirror, then an f32 rerank of
    those candidates on the f32 arena in PyTorch, as the reference left the
    rerank to XLA outside its kernels.

PyTorch has neither XLA's fused chunked scan nor ``lax.approx_max_k``; a
plain ``q @ x.T`` + ``torch.topk`` would write the whole ``[B, N]`` score
matrix.  On the CPU the same functions run the kernels' plain versions.

``certified_topk_search`` is not ported: it exists only to repair
``approx_max_k`` into an exact answer, and K1 is exact by itself.
"""

from __future__ import annotations

import torch

from embeddinghub_tpu_torch.ops import distance as D
from embeddinghub_tpu_torch.ops import fused_topk

INF = float("inf")


def masked_topk(dists, valid, k):
    """Smallest-k of ``dists [B, N]`` over rows where ``valid [N]`` holds.
    Returns ``(dist [B, k], idx [B, k])``; masked-out slots are ``+inf``."""
    if valid is not None:
        dists = torch.where(valid[None, :], dists, INF)
    return torch.topk(dists, k, dim=1, largest=False)


def chunked_topk_search(q, x, valid, x_sq, *, metric="l2", k=10, chunk=65536,
                        compute_dtype="float32"):
    """Exact k-NN of ``q [B, D]`` against ``x [cap, D]`` (global row ids).
    ``cap`` must be a multiple of ``chunk``, as in the reference; the
    kernels tile the arena themselves.  Empty slots come back as id -1
    with distance ``+inf``."""
    cap = x.shape[0]
    if cap % chunk != 0:
        raise ValueError(f"capacity {cap} not a multiple of chunk {chunk}")
    return exact_search(q, x, valid, x_sq, metric=metric, k=k,
                        exact=not D.is_bf16(compute_dtype))


def exact_search(q, x, valid, x_sq, *, metric="l2", k=10, exact=True):
    """Exact k-NN for any ``1 <= k <= cap``.  ``k`` alone picks K1's
    route, before anything is launched: its running lists up to
    ``MAX_K_EXACT``, radix select above it."""
    if k <= fused_topk.MAX_K_EXACT:
        return fused_topk.exact_topk(q, x, valid, x_sq, k=k, metric=metric,
                                     exact=exact)
    return fused_topk.exact_topk_large_k(q, x, valid, x_sq, k=k, metric=metric,
                                         exact=exact)


def approx_oversample_search(q, x, xb, valid, x_sq, *, metric="l2", k=10,
                             oversample=8):
    """Fast path: K2 picks ``k * oversample`` bf16-graded candidates from
    ``xb``, the bf16 mirror of ``x`` (``fused_topk.arena_bf16``), then an
    exact f32 rerank of just those on ``x`` keeps the best ``k``."""
    _, cand = fused_topk.approx_candidates(q, xb, valid, x_sq,
                                           k=k * oversample, metric=metric)
    q = q.to(torch.float32)
    if metric == "cosine":
        q = D.normalize(q)
    hit = cand >= 0
    rows = torch.where(hit, cand, 0).long()
    # elementwise product + sum: full f32 whatever the process's TF32 switch
    edots = (x[rows] * q[:, None, :]).sum(dim=2)  # [B, k*oversample] gather
    escore = 2.0 * edots - x_sq[rows] if metric == "l2" else edots
    escore = torch.where(hit, escore, -INF)
    nv, pos = torch.topk(escore, k, dim=1)
    idx = torch.gather(cand, 1, pos)
    if metric == "l2":
        dist = torch.clamp(D.sqnorms(q)[:, None] - nv, min=0.0)
    else:
        dist = 1.0 - nv
    fin = torch.isfinite(nv)
    return torch.where(fin, dist, INF), torch.where(fin, idx, -1)


# The merge of two candidate sets lives with the kernels' plain versions,
# which use it; these are the reference's names for it.
merge_topk = fused_topk.merge_topk
_merge_topk = merge_topk


# ------------------------------------------------------------- graph pools

# Rows at most this wide are ordered by one stable sort; wider ones by a
# top-k whose boundary ties are then settled by column.
_SORT_WIDTH = 2048


def smallest_k(d: torch.Tensor, k: int):
    """The ``k`` smallest values of each row of ``d`` and their columns,
    smallest first, equal values in column order: ``lax.top_k(-d, k)``'s
    order, on which every id the graph engine picks depends.  (``torch.topk``
    leaves the order of equal values open.)"""
    if d.shape[1] <= _SORT_WIDTH:
        v, i = torch.sort(d, dim=1, stable=True)
        return v[:, :k], i[:, :k]
    kth = torch.topk(d, k, dim=1, largest=False).values[:, -1:]
    below = d < kth
    tied = d == kth
    need = k - below.sum(dim=1, keepdim=True)
    take = below | (tied & (torch.cumsum(tied, dim=1) <= need))
    cols = torch.arange(d.shape[1], device=d.device).expand_as(d)
    cols = torch.topk(torch.where(take, cols, d.shape[1]), k, dim=1,
                      largest=False).values
    v, pos = torch.sort(torch.gather(d, 1, cols), dim=1, stable=True)
    return v, torch.gather(cols, 1, pos)


def pooled_topk_ids(q, x, valid, x_sq, *, metric="l2", k=256, chunk=1 << 16,
                    margin=2):
    """The graph build's candidate pool (``ops/topk.py:846`` of the
    reference): the ids of each query's ``k`` best rows on bf16-rounded
    operands with f32 sums, ``-1`` where fewer than ``k`` rows are live.

    On CUDA it is K1 with ``exact=False`` (one pass on bf16-rounded
    operands).  The reference's per-chunk ``approx_max_k`` pool and its
    containment margin work around the TPU's sort; K1 keeps an exact running
    list instead, so ``chunk`` and ``margin`` are accepted and unused.  The
    cosine callers pass ``metric="ip"`` on unit rows, as the reference's
    do."""
    if x.device.type == "cpu":
        return pooled_topk_ids_reference(q, x, valid, x_sq, metric=metric, k=k)
    _, ids = fused_topk.exact_topk(q, x, valid, x_sq, k=k, metric=metric,
                                   exact=False)
    return ids


def pooled_topk_ids_reference(q, x, valid, x_sq, *, metric="l2", k=256,
                              chunk=1 << 16):
    """Plain :func:`pooled_topk_ids`: a chunked product on bf16-rounded
    operands in f32, then a top-k that breaks ties to the lower row."""
    q = q.to(torch.float32)
    if metric == "cosine":
        q = D.normalize(q)
    qc = D.round_bf16(q)
    best_s = best_i = None
    for s in range(0, x.shape[0], chunk):
        dots = qc @ D.round_bf16(x[s:s + chunk].to(torch.float32)).T
        sc = x_sq[s:s + chunk][None, :] - 2.0 * dots if metric == "l2" else -dots
        sc = torch.where(valid[s:s + chunk][None, :], sc, INF)
        cols = torch.arange(s, s + sc.shape[1], device=q.device).expand_as(sc)
        if best_s is not None:  # earlier chunks hold lower rows: first on ties
            sc, cols = torch.cat([best_s, sc], 1), torch.cat([best_i, cols], 1)
        best_s, pos = smallest_k(sc, min(k, sc.shape[1]))
        best_i = torch.gather(cols, 1, pos)
    ids = torch.where(torch.isfinite(best_s), best_i, -1)
    if ids.shape[1] < k:
        ids = torch.nn.functional.pad(ids, (0, k - ids.shape[1]), value=-1)
    return ids.to(torch.int32)
