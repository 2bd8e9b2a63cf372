"""Batched graph beam search: the twin of ``embeddinghub_tpu/ops/beam.py``.

The same fixed-shape walk over a query batch as the reference:

  * candidate pool   -- ``[B, ef]`` (dist, id, expanded-flag), kept sorted
    nearest first by a merge after every hop;
  * expansion        -- the ``E`` best unexpanded candidates per query;
  * neighbor fetch   -- one gather of their ``E*M`` neighbor rows and one
    batched product against the queries;
  * visited set      -- none: new fetches are deduped against the pool, and
    an evicted node can never re-enter (the pool's worst distance only
    improves);
  * termination      -- the reference's condition, over the whole batch:
    the loop runs while any query's nearest unexpanded candidate is no
    farther than its pool's bar, up to ``max_hops``.

The hop loop is a Python loop over tensor operations.  It reads the exit
flag once per hop (one device-to-host copy), so it stops at the hop the
reference's ``lax.while_loop`` stops at; queries never exit on their own.
Every order that decides an id (the pool merge, the picks of the next
expansion, ``argmin`` of the greedy descent) breaks ties to the lower
column, as ``lax.top_k`` and ``argmin`` do (``ops/topk.smallest_k``).

Products run in f32: ``torch.bmm`` with TF32 off (the port's ``full_f32``
policy, set by ``HNSWIndex`` on CUDA), or on bf16 rows widened to f32, as
XLA does with the reference's mixed-dtype einsum.  The walk is plain PyTorch
on the card: the reference's is XLA, not Pallas.
"""

from __future__ import annotations

import torch

from embeddinghub_tpu_torch.ops import distance as D
from embeddinghub_tpu_torch.ops.topk import smallest_k

INF = float("inf")


def _dots(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``einsum("bkd,bd->bk")`` in f32: ``rows [B, K, D]``, ``q [B, D]``."""
    return torch.bmm(rows.to(torch.float32), q[:, :, None])[:, :, 0]


def _qsq(q: torch.Tensor) -> torch.Tensor:
    return (q * q).sum(dim=1, keepdim=True)


def _pairwise_to_neighbors(q, nvecs, metric, nsq):
    """dist(q [B, D], nvecs [B, K, D]) -> [B, K] (squared L2 or 1-dot)."""
    dots = _dots(nvecs, q)
    if metric == "l2":
        return torch.clamp(nsq - 2.0 * dots + _qsq(q), min=0.0)
    return 1.0 - dots


def augment_arena(x, x_sq, valid, metric: str):
    """``x`` with the squared norms and liveness folded in as trailing
    penalty columns, so the walk gathers one row per candidate: one f32
    column ``pen`` (``x_sq`` for l2, 0 otherwise, +inf on dead rows), or for
    a bf16 ``x`` two columns hi/lo with hi + lo == pen to f32 round-off
    (bf16 alone quantizes ``x_sq`` to about 0.4 %)."""
    pen = x_sq if metric == "l2" else torch.zeros_like(x_sq)
    pen = torch.where(valid, pen.to(torch.float32), INF)
    if x.dtype == torch.bfloat16:
        hi = pen.to(torch.bfloat16)
        lo = torch.where(torch.isfinite(pen), pen - hi.to(torch.float32), 0.0)
        cols = torch.stack([hi, lo.to(torch.bfloat16)], dim=1)
    else:
        cols = pen[:, None].to(x.dtype)
    return torch.cat([x, cols], dim=1)


def _pairwise_fused(q, g, metric, d):
    """dist(q [B, D], g [B, K, D+A]) for rows of an :func:`augment_arena`
    table; the trailing A columns are the penalty."""
    dots = _dots(g[..., :d], q)
    pen = g[..., d].to(torch.float32)
    if g.shape[-1] > d + 1:
        pen = pen + g[..., d + 1].to(torch.float32)
    if metric == "l2":
        return torch.clamp(pen - 2.0 * dots + _qsq(q), min=0.0)
    return 1.0 - dots + pen


def pack_neighbors(x, neighbors, scale=None, chunk: int = 1 << 16):
    """The packed-neighbor arena: ``packed[n]`` holds the int8-quantized
    vectors of node ``n``'s neighbors contiguously, ``[N, M*D]`` int8, and
    the dequantization step ``scale / 127`` as an f32 scalar.  A hop then
    gathers ``E`` block rows instead of ``E*M`` scattered ones; the walk's
    distances are int8-grade, so callers re-score what they read.  Missing
    neighbors (-1) pack as zeros.  Built in chunks of ``chunk`` nodes (the
    whole ``[N, M, D]`` f32 gather is 16 GB at 1M x 32 x 128)."""
    n, d = x.shape
    m = neighbors.shape[1]
    if scale is None:
        scale = float(x.abs().max())
    inv = 127.0 / scale
    out = torch.zeros((n, m * d), dtype=torch.int8, device=x.device)
    for s in range(0, n, chunk):
        nb = neighbors[s:s + chunk].long()
        g = x[nb.clamp(min=0)].to(torch.float32)
        g = torch.where((nb >= 0)[:, :, None], g, 0.0)
        qv = torch.clamp(torch.round(g * inv), -127, 127).to(torch.int8)
        out[s:s + nb.shape[0]] = qv.reshape(-1, m * d)
    return out, torch.tensor(scale / 127.0, dtype=torch.float32, device=x.device)


def _repeats(nb: torch.Tensor) -> torch.Tensor:
    """True where a row's entry equals an earlier entry of the same row."""
    sv, perm = torch.sort(nb, dim=1, stable=True)
    dup = torch.zeros_like(sv, dtype=torch.bool)
    dup[:, 1:] = sv[:, 1:] == sv[:, :-1]
    return torch.zeros_like(dup).scatter_(1, perm, dup)


def _member(nb: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``nb [B, K]`` entries found in the same row of ``ids [B, P]``."""
    return (nb[:, :, None] == ids[:, None, :]).any(dim=2)


def _mark(flags: torch.Tensor, cols: torch.Tensor, on: torch.Tensor):
    """``flags`` with the given columns of each row set where ``on``."""
    return flags | torch.zeros_like(flags).scatter_(1, cols, on)


def beam_search(
    q, entry_ids, neighbors, x, x_sq, valid, *,
    metric: str = "l2", ef: int = 64, expand: int = 4, max_hops: int = 256,
    with_hops: bool = False, spec: int = 1, exit_k: int = 0,
    packed=None, dscale=None,
):
    """Beam search one layer from ``entry_ids`` (``[B]``, or ``[B, S]``
    seeds with S < ef; duplicate and negative seeds are masked).

    ``spec=2`` also expands the ``E`` best just-fetched neighbors before the
    merge (two graph hops per iteration); ``exit_k`` stops once the nearest
    unexpanded candidate is past the ``exit_k``-th pool entry instead of the
    ``ef``-th (0 = hnswlib's condition).  With ``x_sq=None`` and
    ``valid=None`` (FUSED mode) ``x`` is an :func:`augment_arena` table;
    with ``packed`` and ``dscale`` also set (PACKED mode) the hop reads
    neighbor vectors from a :func:`pack_neighbors` arena and deleted rows
    are not masked, so the caller reranks with ``valid``.

    Returns ``(dist [B, ef], ids [B, ef])`` sorted nearest first (+inf / -1
    padding), ids as int64 row indices into ``x``; with ``with_hops`` also
    the number of iterations the batch took."""
    b, d = q.shape
    fused = x_sq is None
    if packed is not None and not fused:
        raise ValueError("packed mode requires the fused (augment) arena")
    m = neighbors.shape[1]
    e = min(expand, ef)
    q = q.to(torch.float32)
    qsq_col = _qsq(q)
    if metric == "cosine":
        q = D.normalize(q)

    def score(ids, rows):
        """Distances of the queries to gathered ``rows`` of ``x``."""
        if fused:
            return _pairwise_fused(q, rows, metric, d)
        dist = _pairwise_to_neighbors(q, rows, metric, x_sq[ids])
        return torch.where(valid[ids], dist, INF)

    # --- init the pool with the entry point(s) ---
    entry_ids = entry_ids.to(torch.int64)
    if entry_ids.dim() == 1:
        entry_ids = entry_ids[:, None]
    s = entry_ids.shape[1]
    if s >= ef:
        raise ValueError(f"seed count {s} must be < ef {ef}")
    first = ~_repeats(entry_ids)
    live_seed = first & (entry_ids >= 0)
    safe_seed = entry_ids.clamp(min=0)
    ed = torch.where(live_seed, score(safe_seed, x[safe_seed]), INF)
    pool_d = torch.cat([ed, torch.full((b, ef - s), INF, device=q.device)], dim=1)
    pool_i = torch.cat([torch.where(live_seed, entry_ids, -1),
                        torch.full((b, ef - s), -1, dtype=torch.int64,
                                   device=q.device)], dim=1)
    pool_x = torch.zeros((b, ef), dtype=torch.bool, device=q.device)
    pool_d, pos0 = smallest_k(pool_d, ef)
    pool_i = torch.gather(pool_i, 1, pos0)

    bar_col = (exit_k if exit_k and exit_k < ef else ef) - 1

    def active(pool_d, pool_i, pool_x) -> bool:
        unexp = torch.where(~pool_x & (pool_i >= 0), pool_d, INF)
        best_unexp = unexp.min(dim=1).values
        # the pool is sorted with +inf padding: column bar_col is the
        # (bar_col+1)-th best distance, +inf while the pool is not full
        bar = pool_d[:, bar_col]
        return bool((torch.isfinite(best_unexp) & (best_unexp <= bar)).any())

    def fetch(sel_ids, sel_valid, pool_i, exclude):
        """Gather and score the neighbor lists of ``sel_ids [B, E]``,
        deduped against the pool, this fetch (first kept) and every id
        array in ``exclude``: ``(ids [B, E*M], dist)``."""
        nb = neighbors[sel_ids].reshape(b, e * m).to(torch.int64)
        nb = torch.where(sel_valid.repeat_interleave(m, dim=1), nb, -1)
        drop = _member(nb, pool_i) | _repeats(nb)
        for ex in exclude:
            drop |= _member(nb, ex)
        live = (nb >= 0) & ~drop
        nb_safe = torch.where(live, nb, 0)
        if packed is not None:
            blk = packed[sel_ids]                               # [B, E, M*D]
            # int8 times the bf16 step, not rounded back to bf16: XLA keeps
            # the reference's bf16 multiply in f32 ahead of its dot
            xq = blk.reshape(b, e * m, d).to(torch.float32)
            xq = xq * D.round_bf16(dscale)
            dots = _dots(xq, D.round_bf16(q))
            if metric == "l2":
                nsq = (xq * xq).sum(dim=2)
                ndist = torch.clamp(nsq - 2.0 * dots + qsq_col, min=0.0)
            else:
                ndist = 1.0 - dots
            return torch.where(live, nb, -1), torch.where(live, ndist, INF)
        ndist = torch.where(live, score(nb_safe, x[nb_safe]), INF)
        return torch.where(live, nb, -1), ndist

    hops = 0
    while hops < max_hops and active(pool_d, pool_i, pool_x):
        # --- pick the E best unexpanded candidates per query ---
        unexp_d = torch.where(~pool_x & (pool_i >= 0), pool_d, INF)
        sd, sel = smallest_k(unexp_d, e)                       # pool positions
        sel_valid = sd < INF
        sel_ids = torch.where(sel_valid, torch.gather(pool_i, 1, sel), 0)
        pool_x = _mark(pool_x, sel, sel_valid)

        nb1_id, ndist1 = fetch(sel_ids, sel_valid, pool_i, [])
        parts_d, parts_i = [pool_d, ndist1], [pool_i, nb1_id]
        x1 = torch.zeros_like(ndist1, dtype=torch.bool)
        if spec >= 2:
            # speculative second hop: expand the E best of the fetch too
            sd2, ssel = smallest_k(ndist1, e)                  # fetch columns
            s_valid = torch.isfinite(sd2)
            s_ids = torch.where(s_valid, torch.gather(nb1_id, 1, ssel), 0)
            x1 = _mark(x1, ssel, s_valid)
            nb2_id, ndist2 = fetch(s_ids, s_valid, pool_i, [nb1_id])
            parts_d.append(ndist2)
            parts_i.append(nb2_id)

        # --- merge into the pool (expanded flags travel with entries) ---
        all_x = [pool_x, x1] + ([torch.zeros_like(x1)] if spec >= 2 else [])
        pool_d, pos = smallest_k(torch.cat(parts_d, dim=1), ef)
        pool_i = torch.gather(torch.cat(parts_i, dim=1), 1, pos)
        pool_x = torch.gather(torch.cat(all_x, dim=1), 1, pos)
        hops += 1

    if with_hops:
        return pool_d, pool_i, hops
    return pool_d, pool_i


def greedy_descend(q, entry_ids, neighbors, x, x_sq, *, metric: str = "l2",
                   max_hops: int = 64):
    """hnswlib's upper-layer ef=1 greedy walk, batched: each query moves to
    its closest neighbor (the first of equals) while that improves, until no
    query improves or ``max_hops``.  ``x_sq=None``: ``x`` is an
    :func:`augment_arena` table.  Returns ``[B]`` ids."""
    q = q.to(torch.float32)
    if metric == "cosine":
        q = D.normalize(q)
    d = q.shape[1]
    fused = x_sq is None

    def dist(ids, rows):
        if fused:
            return _pairwise_fused(q, rows, metric, d)
        return _pairwise_to_neighbors(q, rows, metric, x_sq[ids])

    cur = entry_ids.to(torch.int64)
    cur_d = dist(cur[:, None], x[cur][:, None, :])[:, 0]
    hops = 0
    improved = True
    while improved and hops < max_hops:
        nb = neighbors[cur].to(torch.int64)
        live = nb >= 0
        nb_safe = torch.where(live, nb, 0)
        nd = torch.where(live, dist(nb_safe, x[nb_safe]), INF)
        best = torch.argmin(nd, dim=1, keepdim=True)        # first of equals
        best_d = torch.gather(nd, 1, best)[:, 0]
        step = best_d < cur_d
        cur = torch.where(step, torch.gather(nb_safe, 1, best)[:, 0], cur)
        cur_d = torch.where(step, best_d, cur_d)
        improved = bool(step.any())
        hops += 1
    return cur
