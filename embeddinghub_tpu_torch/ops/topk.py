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

The quantized arenas' searches (``int8_oversample_search``,
``quantized_chunked_search``/``_ids``/``_exact``, ``quantized_pool_rerank``
and the numpy ``host_rerank``) keep the reference's signatures.  Their
phase 1 (the score scan and the candidate pick, the reference's int8
``dot_general`` + ``approx_max_k``) is K2's candidate pool
(``fused_topk.pool_candidates``): one winner per 32 strided rows, the
``k * oversample`` (or per chunk ``kc``) best of them.  The rerank
dequantizes the candidates as the reference does (``hi (+ lo/254)`` times
the row scale, or the bf16 values) and scores them with f32 sums in plain
PyTorch, as the reference leaves it to XLA.  Where a pool would cover a
quarter of the bins or more (tiny arenas, a chunk its pool covers) or pass
``MAX_K_POOL``, the route is chosen by shape before any launch: every row
is a candidate, an exact rerank of the whole arena by K1 over f32 upcasts
of the planes, a bounded block at a time -- never worse than the
reference's pool.

``certified_topk_search`` is not ported: it exists only to repair
``approx_max_k`` into an exact answer, and K1 is exact by itself.
"""

from __future__ import annotations

import numpy as np
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
    exact f32 rerank of just those on ``x`` keeps the best ``k``.  A bf16
    arena passes its mirror's values as ``x`` (``xb[:, :D]``): the rerank
    scores the bf16-valued rows in f32, as the reference's does on a bf16
    ``x``."""
    _, cand = fused_topk.approx_candidates(q, xb, valid, x_sq,
                                           k=k * oversample, metric=metric)
    q = q.to(torch.float32)
    if metric == "cosine":
        q = D.normalize(q)
    hit = cand >= 0
    rows = torch.where(hit, cand, 0).long()
    # elementwise product + sum: full f32 whatever the process's TF32 switch
    edots = (x[rows].to(torch.float32) * q[:, None, :]).sum(dim=2)  # [B, k*oversample] gather
    escore = 2.0 * edots - x_sq[rows] if metric == "l2" else edots
    return _best(q, torch.where(hit, escore, -INF), cand, k, metric)


# The merge of two candidate sets lives with the kernels' plain versions,
# which use it; these are the reference's names for it.
merge_topk = fused_topk.merge_topk
_merge_topk = merge_topk


# ---------------------------------------------------------- quantized arenas

# A pool takes at most a quarter of a segment's bins; a wider one routes to
# the exact rerank of every row.
POOL_BIN_SHARE = 4
# The f32 temporaries of one step of a rerank or an upcast block.
RERANK_BYTES = 1 << 29


def _unit(q, metric):
    q = q.to(torch.float32)
    return D.normalize(q) if metric == "cosine" else q


def _binned(kc: int, bins: int) -> bool:
    """Whether a pool of ``kc`` candidates from ``bins`` bins takes K2's
    pool (else every row is a candidate)."""
    return kc <= fused_topk.MAX_K_POOL and kc * POOL_BIN_SHARE <= bins


def _dequant(xq, scales, x_lo, rows, dims):
    """f32 rows of a plane: ``hi (+ lo * (1/254)) * scale`` for int8 (the
    reference's order), the bf16 values otherwise."""
    cx = xq[rows, :dims].to(torch.float32)
    if x_lo is not None:
        cx = cx + x_lo[rows, :dims].to(torch.float32) * (1.0 / 254.0)
    if xq.dtype == torch.int8 and scales is not None:
        cx = cx * scales[rows][..., None]
    return cx


def _rerank(qf, xq, scales, x_sq, x_lo, cand, metric):
    """Exact f32 scores (to maximize) of the candidate rows ``cand [B,
    C]`` on the dequantized planes, -inf where ``cand < 0``; elementwise
    products with f32 sums, in blocks of queries."""
    b, c = cand.shape
    dims = qf.shape[1]
    hit = cand >= 0
    rows = torch.where(hit, cand, 0).long()
    out = torch.empty((b, c), dtype=torch.float32, device=qf.device)
    step = max(1, RERANK_BYTES // max(1, 4 * c * dims))
    for s in range(0, b, step):
        r = rows[s:s + step]
        edots = (_dequant(xq, scales, x_lo, r, dims) * qf[s:s + step, None, :]).sum(dim=2)
        out[s:s + step] = 2.0 * edots - x_sq[r] if metric == "l2" else edots
    return torch.where(hit, out, -INF)


def _finish(qf, nv, idx, metric):
    """Scores (maximized) -> the metric's distances; empty slots +inf, -1."""
    if metric == "l2":
        dist = torch.clamp(D.sqnorms(qf)[:, None] - nv, min=0.0)
    else:
        dist = 1.0 - nv
    fin = torch.isfinite(nv)
    return torch.where(fin, dist, INF), torch.where(fin, idx, -1).to(torch.int32)


def _best(qf, escore, cand, k, metric):
    kk = min(k, escore.shape[1])
    nv, pos = torch.topk(escore, kk, dim=1)
    d, i = _finish(qf, nv, torch.gather(cand, 1, pos), metric)
    if kk < k:
        d = torch.nn.functional.pad(d, (0, k - kk), value=INF)
        i = torch.nn.functional.pad(i, (0, k - kk), value=-1)
    return d, i


def exact_over_planes(q, xq, scales, valid, x_sq, x_lo=None, *, metric="l2", k=10):
    """Exact top-``k`` over every row of a plane's f32 upcasts (int8
    dequantized, bf16 values), queries in f32 and not rounded: K1
    (``exact_search``) on a bounded block of upcast rows at a time, merged
    with ``merge_topk``.  The exact search of a bf16 arena (the reference's
    ``chunked_topk_search`` on a bf16 ``x`` with f32 compute), and the
    route of a pool that would cover a quarter of the bins or more."""
    return _exact_planes(_unit(q, metric), xq, scales, valid, x_sq, x_lo,
                         metric=metric, k=k)


def _exact_planes(qf, xq, scales, valid, x_sq, x_lo=None, *, metric, k):
    """:func:`exact_over_planes` for queries already normalized for cosine
    (K1 scores them as "ip": the same ``1 - dot``)."""
    cap = xq.shape[0]
    b, dims = qf.shape
    m = "ip" if metric == "cosine" else metric
    block = max(fused_topk.GROUP, RERANK_BYTES // (4 * max(dims, 1))
                // fused_topk.GROUP * fused_topk.GROUP)
    best_d = torch.full((b, k), INF, dtype=torch.float32, device=qf.device)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=qf.device)
    for s in range(0, cap, block):
        e = min(cap, s + block)
        rows = torch.arange(s, e, device=xq.device)
        x = fused_topk.arena_f32(_dequant(xq, scales, x_lo, rows, dims))
        kb = min(k, e - s)
        d, i = exact_search(qf, x, valid[s:e], x_sq[s:e], metric=m, k=kb)
        i = torch.where(i >= 0, i + s, -1).to(torch.int32)
        best_d, best_i = merge_topk(best_d, best_i, d, i, k)
    return best_d, best_i.to(torch.int32)


def _phase1(qf, xq, scales, valid, x_sq, metric, kc, seg=None, rows=None):
    """K2's pool: ``(scores, ids)`` of ``[B, segments * kc]``, scanned up
    to ``rows`` (every live row lies below it; ``None``: the capacity)."""
    sv, si = fused_topk.pool_candidates(qf, xq, valid, x_sq, scales, k=kc,
                                        metric=metric, seg=seg, rows=rows)
    return sv.reshape(sv.shape[0], -1), si.reshape(si.shape[0], -1)


def _bins(rows: int) -> int:
    return -(-rows // fused_topk.GROUP) * (fused_topk.GROUP // fused_topk.POOL_BIN)


def int8_oversample_search(q, xq, scales, valid, x_sq, x_lo=None, *, metric="l2",
                           k=10, oversample=8, rows=None):
    """Quantized search over a whole arena (``ops/topk.py:269`` of the
    reference): K2's int8 pool picks ``k * oversample`` candidates from the
    hi plane ``xq [cap, D]`` int8 (``scales [cap]``), then a rerank of the
    dequantized candidates (``hi + lo/254`` with the residual plane
    ``x_lo``) keeps the best ``k``.  ``rows`` (here and in
    :func:`quantized_chunked_exact`): a bound every live row lies below,
    the arena's high-water mark, where the pool's scan stops on the card
    (``None``: the capacity); the result does not depend on it."""
    qf = _unit(q, metric)
    kk = k * oversample
    if not _binned(kk, _bins(xq.shape[0])):
        return _exact_planes(qf, xq, scales, valid, x_sq, x_lo, metric=metric, k=k)
    _, cand = _phase1(qf, xq, scales, valid, x_sq, metric, kk, rows=rows)
    return _best(qf, _rerank(qf, xq, scales, x_sq, x_lo, cand, metric), cand, k, metric)


def _chunked_pool(qf, xq, scales, valid, x_sq, metric, k, kk, chunk):
    """The stacked per-chunk pools of ``quantized_chunked_search`` and
    ``_ids`` cut to the ``kk`` best by phase-1 score: ``cand [B, kk]`` (-1
    for none), or ``None`` where the pool routes to every row."""
    cap = xq.shape[0]
    if cap % chunk != 0:
        raise ValueError(f"capacity {cap} not a multiple of chunk {chunk}")
    n_chunks = cap // chunk
    kc = min(kk, max(k, (1 << 17) // n_chunks))
    if not _binned(kc, _bins(chunk)) or chunk % fused_topk.GROUP:
        return None
    sv, si = _phase1(qf, xq, scales, valid, x_sq, metric, kc, seg=chunk)
    if sv.shape[1] > kk:
        sv, pos = torch.topk(sv, kk, dim=1, largest=False)
        si = torch.gather(si, 1, pos)
    return torch.where(torch.isfinite(sv), si, -1)


def quantized_chunked_search(q, xq, scales, valid, x_sq, x_lo=None, *, metric="l2",
                             k=10, oversample=8, chunk=1 << 20):
    """Deep quantized search (``ops/topk.py:408``): each chunk's best
    ``kc`` candidates by K2's pool, the ``k * oversample`` best of their
    stack by phase-1 score, one rerank.  ``xq``: an int8 hi plane, or a bf16
    plane (``scales`` None)."""
    qf = _unit(q, metric)
    kk = min(k * oversample, chunk)
    cand = _chunked_pool(qf, xq, scales, valid, x_sq, metric, k, kk, chunk)
    if cand is None:
        return _exact_planes(qf, xq, scales, valid, x_sq, x_lo, metric=metric, k=k)
    return _best(qf, _rerank(qf, xq, scales, x_sq, x_lo, cand, metric), cand, k, metric)


def quantized_chunked_ids(q, xq, scales, valid, x_sq, *, metric="l2", k=10,
                          oversample=8, chunk=1 << 20):
    """Phase 1 of :func:`quantized_chunked_search` alone
    (``ops/topk.py:538``): the pooled ``[B, k * oversample]`` candidate ids,
    -1 for none.  Where the pool routes to every row, the exact top of the
    upcast rows."""
    qf = _unit(q, metric)
    kk = min(k * oversample, chunk)
    cand = _chunked_pool(qf, xq, scales, valid, x_sq, metric, k, kk, chunk)
    if cand is None:
        kk = min(kk, xq.shape[0])
        return _exact_planes(qf, xq, scales, valid, x_sq, metric=metric, k=kk)[1]
    return cand.to(torch.int32)


def quantized_chunked_exact(q, xq, scales, valid, x_sq, x_lo=None, *, metric="l2",
                            k=10, oversample=8, chunk=1 << 20, pool_budget=1 << 17,
                            rows=None):
    """The flat engine's search past 2M rows (``ops/topk.py:628``): K2's
    pool takes ``kc = min(kk, max(k, pool_budget // n_chunks), chunk)``
    candidates from every chunk of ``chunk`` rows in one scan (a select per
    chunk's segment of keys), each scored exactly on the dequantized planes,
    then the ``k`` best of the stacked pool (an exact top-k, which contains
    the reference's ``approx_max_k`` pre-select)."""
    cap = xq.shape[0]
    if cap % chunk != 0:
        raise ValueError(f"capacity {cap} not a multiple of chunk {chunk}")
    n_chunks = cap // chunk
    qf = _unit(q, metric)
    kk = min(k * oversample, chunk)
    kc = min(kk, max(k, pool_budget // n_chunks), chunk)
    if not _binned(kc, _bins(chunk)) or chunk % fused_topk.GROUP:
        return _exact_planes(qf, xq, scales, valid, x_sq, x_lo, metric=metric, k=k)
    _, cand = _phase1(qf, xq, scales, valid, x_sq, metric, kc, seg=chunk, rows=rows)
    return _best(qf, _rerank(qf, xq, scales, x_sq, x_lo, cand, metric), cand, k, metric)


def quantized_pool_rerank(q, xq, scales, x_sq, x_lo, cand, *, metric="l2", k=10):
    """Rerank of pooled candidate ids ``cand [B, kk]`` on the dequantized
    planes, then the best ``k`` (``ops/topk.py:750``)."""
    qf = _unit(q, metric)
    cand = cand.to(torch.int32)
    return _best(qf, _rerank(qf, xq, scales, x_sq, x_lo, cand, metric), cand, k, metric)


def host_rerank(hx, hvalid, q, cand, k, metric):
    """Exact f32 rerank of pooled candidate ids on the host arena
    (``ops/topk.py:798``, numpy).  Returns (dist [B,k] f32, idx [B,k]
    int32), -1/inf padded like the device paths."""
    b, kk = cand.shape
    qn = np.asarray(q, np.float32)
    if metric == "cosine":
        qn = qn / np.maximum(np.linalg.norm(qn, axis=1, keepdims=True), 1e-30)
    safe = np.maximum(cand, 0)
    cx = hx[safe.ravel()].reshape(b, kk, -1).astype(np.float32)
    if metric == "cosine":
        cx = cx / np.maximum(np.linalg.norm(cx, axis=2, keepdims=True), 1e-30)
    dots = np.einsum("bkd,bd->bk", cx, qn)
    if metric == "l2":
        score = 2.0 * dots - np.einsum("bkd,bkd->bk", cx, cx)
    else:
        score = dots
    score = np.where((cand >= 0) & hvalid[safe], score, -np.inf)
    pos = np.argsort(-score, axis=1)[:, :k]
    svals = np.take_along_axis(score, pos, axis=1)
    idx = np.take_along_axis(cand, pos, axis=1)
    if metric == "l2":
        qsq = np.einsum("bd,bd->b", qn, qn)
        dist = np.maximum(qsq[:, None] - svals, 0.0)
    else:
        dist = 1.0 - svals
    dist = np.where(np.isfinite(svals), dist, np.inf).astype(np.float32)
    idx = np.where(np.isfinite(svals), idx, -1).astype(np.int32)
    return dist, idx


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
