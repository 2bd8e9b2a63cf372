"""Distance + top-k selection: the twin of ``embeddinghub_tpu/ops/topk.py``
for the functions the flat engine uses.

On CUDA the two searches run on the hand-written kernels of
:mod:`embeddinghub_tpu_torch.ops.fused_topk`:

  * :func:`chunked_topk_search` is K1 (exact, f32 FMA);
  * :func:`approx_oversample_search` is K2 for ``k * oversample`` bf16
    candidates, then an f32 rerank of those candidates in PyTorch, as the
    reference left the rerank to XLA outside its kernels.

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
    ``cap`` must be a multiple of ``chunk``, as in the reference; empty
    slots come back as id -1 with distance ``+inf``."""
    cap = x.shape[0]
    if cap % chunk != 0:
        raise ValueError(f"capacity {cap} not a multiple of chunk {chunk}")
    return fused_topk.exact_topk(q, x, valid, x_sq, k=k, metric=metric,
                                 exact=not D.is_bf16(compute_dtype))


def approx_oversample_search(q, x, valid, x_sq, *, metric="l2", k=10,
                             oversample=8):
    """Fast path: K2 picks ``k * oversample`` bf16-graded candidates, then an
    exact f32 rerank of just those keeps the best ``k``."""
    _, cand = fused_topk.approx_candidates(q, x, valid, x_sq,
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
