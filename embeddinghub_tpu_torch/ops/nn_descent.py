"""NN-descent and neighbor selection for the graph build: the twin of
``embeddinghub_tpu/ops/nn_descent.py``.

* :func:`nn_descent` builds an approximate kNN graph from a random one by
  refining every node's list from its neighbors, its reverse neighbors and
  its neighbors' neighbors (Dong et al., WWW'11), block by block; the bulk
  build runs it past ``cluster_build_max`` rows;
* :func:`heuristic_prune` is hnswlib's neighbor-selection heuristic, batched;
* :func:`gather_reciprocal` adds each row's incoming edges to its list.

All of it is plain PyTorch on the card: the reference's are XLA, not
Pallas.  Every product is f32 (``torch.bmm`` with TF32 off, the port's
``full_f32`` policy), and every order that decides an id follows the
reference's: ``argmin`` takes the first of equals, the final pick breaks
ties to the lower candidate column (``ops/topk.smallest_k``), and the
reciprocal gather sorts its edges stably.
"""

from __future__ import annotations

import torch

from embeddinghub_tpu_torch.ops.topk import smallest_k

INF = float("inf")
_DUMP = 1 << 30  # sort key of masked edges: after every row id

# Rows pruned at a time: the [rows, K, K] f32 pair matrix is the memory hot
# spot, 1 GiB at 4096 x 256 x 256.
PRUNE_BLOCK_BYTES = 1 << 30


def reverse_sample(nb: torch.Tensor) -> torch.Tensor:
    """``rev [N, M]``: column j of row t holds a node i with ``nb[i, j] ==
    t``, or -1.  The reference scatters every i at once (``rev.at[nb[:, j],
    j].set(ids)``), so with several such i either copy may win; here the
    largest id wins, which is also the last write of the reference's scatter
    on the CPU.  A -1 entry of ``nb`` adds nothing (the reference's index -1
    would write row N-1)."""
    n, m = nb.shape
    ids = torch.arange(n, device=nb.device)
    rev = torch.full((n, m), -1, dtype=torch.int64, device=nb.device)
    for j in range(m):
        col, ok = nb[:, j], nb[:, j] >= 0
        rev[:, j].scatter_reduce_(0, col[ok], ids[ok], reduce="amax")
    return rev


def _block_refine(x, x_sq, nb, rev, block_ids, metric):
    """One NN-descent step for the nodes ``block_ids [B]``: each one's new
    ``M`` nearest among its own neighbors, its reverse sample and its
    neighbors' neighbors (deduplicated, itself left out), by f32 distance,
    nearer first, -1 where fewer remain."""
    b, m = block_ids.shape[0], nb.shape[1]
    own = nb[block_ids]
    hop2 = nb[own.clamp(min=0)].reshape(b, m * m)
    hop2 = torch.where(torch.repeat_interleave(own >= 0, m, dim=1), hop2, -1)
    cand = torch.sort(torch.cat([own, rev[block_ids], hop2], dim=1), dim=1).values
    dup = torch.zeros_like(cand, dtype=torch.bool)
    dup[:, 1:] = cand[:, 1:] == cand[:, :-1]
    cand = torch.where(dup | (cand == block_ids[:, None]), -1, cand)
    safe = cand.clamp(min=0)
    dots = torch.bmm(x[safe].to(torch.float32),
                     x[block_ids].to(torch.float32)[:, :, None])[:, :, 0]
    if metric == "l2":
        d = x_sq[safe] - 2.0 * dots + x_sq[block_ids][:, None]
    else:
        d = 1.0 - dots
    nd, pos = smallest_k(torch.where(cand >= 0, d, INF), m)
    return torch.where(torch.isfinite(nd), torch.gather(cand, 1, pos), -1)


def nn_descent(x, x_sq, *, m: int = 32, iters: int = 8, block: int = 4096,
               metric: str = "l2", generator: torch.Generator | None = None,
               init: torch.Tensor | None = None) -> torch.Tensor:
    """Approximate kNN graph ``[N, m]`` of ``x [N, D]`` (metric-preprocessed
    rows, ``x_sq`` their squared norms): int64 ids, itself excluded, -1
    padded.  N must be a multiple of ``block``.  The initial graph is
    ``init [N, m]`` when given (the reference's own draw, say), else uniform
    ids from ``generator``; an entry equal to its row moves to the next id,
    as in the reference."""
    n = x.shape[0]
    if n % block:
        raise ValueError(f"N={n} not a multiple of block={block}")
    dev = x.device
    if init is None:
        nb = torch.randint(0, n, (n, m), generator=generator, device=dev)
    else:
        nb = init.to(device=dev, dtype=torch.int64)
    ids = torch.arange(n, device=dev)
    nb = torch.where(nb == ids[:, None], (nb + 1) % n, nb)
    for _ in range(iters):
        rev = reverse_sample(nb)
        nb = torch.cat([_block_refine(x, x_sq, nb, rev, ids[s:s + block], metric)
                        for s in range(0, n, block)])
    return nb


def heuristic_prune(x, x_sq, nb, *, m_keep: int, metric: str = "l2",
                    cand_k: int = 64, q=None, q_sq=None):
    """Batched hnswlib neighbor-selection heuristic: scanning candidates
    nearest first, keep c iff d(c, node) < d(c, s) for every kept s.
    Works on the first ``cand_k`` candidates of each row of ``nb [B, C]``
    (global rows of ``x``, -1 padded).  With ``q=None`` rows of ``nb``
    align with rows of ``x``.  Returns ``[B, m_keep]`` ids, nearest first,
    -1 padded."""
    if q is None:
        q, q_sq = x, x_sq
    n = q.shape[0]
    block = max(1, PRUNE_BLOCK_BYTES // (4 * cand_k * cand_k))
    out = torch.empty((n, m_keep), dtype=torch.int64, device=nb.device)
    for s in range(0, n, block):
        out[s:s + block] = _prune_block(
            x, x_sq, q[s:s + block].to(torch.float32), q_sq[s:s + block],
            nb[s:s + block, :cand_k].to(torch.int64), m_keep, metric)
    return out


def _prune_block(x, x_sq, qb, qsqb, cand, m_keep, metric):
    b, k = cand.shape
    safe = cand.clamp(min=0)
    cvecs = x[safe].to(torch.float32)                          # [B, K, D]
    dots = torch.bmm(cvecs, qb[:, :, None])[:, :, 0]
    csq = x_sq[safe]
    if metric == "l2":
        d_q = csq - 2.0 * dots + qsqb[:, None]
    else:
        d_q = 1.0 - dots
    d_q = torch.where(cand >= 0, d_q, INF)
    pr = torch.bmm(cvecs, cvecs.transpose(1, 2))               # [B, K, K]
    del cvecs
    if metric == "l2":
        pair = csq[:, :, None] - 2.0 * pr + csq[:, None, :]
    else:
        pair = 1.0 - pr
    del pr

    # Slot loop (the reference's formulation of the greedy scan): each step
    # keeps the nearest candidate not dominated by a kept one, then marks
    # everything it dominates.  The kept set equals the candidate scan's.
    fin = torch.isfinite(d_q)
    kept = torch.zeros((b, k), dtype=torch.bool, device=cand.device)
    dominated = torch.zeros_like(kept)
    cols = torch.arange(k, device=cand.device)
    for _ in range(m_keep):
        dm = torch.where(~kept & ~dominated & fin, d_q, INF)
        ci = torch.argmin(dm, dim=1, keepdim=True)             # first of equals
        ok = torch.isfinite(torch.gather(dm, 1, ci))           # [B, 1]
        kept |= (cols[None, :] == ci) & ok
        pair_ci = torch.gather(pair, 1, ci[:, :, None].expand(b, 1, k))[:, 0]
        dominated |= (pair_ci < d_q) & ok
    nd, pos = smallest_k(torch.where(kept, d_q, INF), m_keep)
    return torch.where(torch.isfinite(nd), torch.gather(cand, 1, pos), -1)


def gather_reciprocal(fwd, valid_n, *, cap_in: int):
    """Reciprocal-edge gather of the bulk build.  ``fwd [P, W]`` are forward
    link lists (-1 padded); returns ``(comb [P, W+cap_in], fits [P])``:
    each row's forward and incoming edges, deduped, ids in descending order
    with -1 last, and whether the row holds at most ``W`` of them (hnswlib
    prunes a list only when it overflows).  A row keeps its first
    ``cap_in`` incoming edges in source order (a stable sort of the edges by
    target), from sources where ``valid_n`` holds."""
    p, w = fwd.shape
    dev = fwd.device
    fwd = fwd.to(torch.int64)
    src = torch.arange(p, device=dev).repeat_interleave(w)
    dst = fwd.reshape(-1)
    ev = (dst >= 0) & valid_n.repeat_interleave(w)
    key = torch.where(ev, dst, _DUMP)
    order = torch.argsort(key, stable=True)
    gd = key[order]
    gs = torch.where(ev[order], src[order], -1)
    iota = torch.arange(gd.shape[0], device=dev)
    head = torch.ones_like(gd, dtype=torch.bool)
    head[1:] = gd[1:] != gd[:-1]
    run_start = torch.cummax(torch.where(head, iota, 0), dim=0).values
    pos = iota - run_start
    ok = (pos < cap_in) & (gd < _DUMP)
    # masked edges land in a garbage row p
    rev = torch.full((p + 1, cap_in), -1, dtype=torch.int64, device=dev)
    rev[torch.where(ok, gd, p), torch.where(ok, pos, 0)] = torch.where(ok, gs, -1)
    comb = torch.cat([fwd, rev[:p]], dim=1)
    # dedup (neighbor lists are sets): sort descending, mask repeats, recompact
    comb = torch.sort(comb, dim=1, descending=True).values
    dup = torch.zeros_like(comb, dtype=torch.bool)
    dup[:, 1:] = (comb[:, 1:] == comb[:, :-1]) & (comb[:, 1:] >= 0)
    comb = torch.sort(torch.where(dup, -1, comb), dim=1, descending=True).values
    return comb, (comb >= 0).sum(dim=1) <= w
