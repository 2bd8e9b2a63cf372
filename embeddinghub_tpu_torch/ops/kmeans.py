"""Batched k-means: the twin of ``embeddinghub_tpu/ops/kmeans.py``, the
routing stage of the cluster-routed graph build
(``index/hnsw.HNSWIndex._cluster_build_fwd``) and of the centroid route
(``HNSWIndex.build_route``).

Every stage is a dense product with an argmax or a min: Lloyd's assignment
is ``[n, d] x [d, k]``, the centroid update a segment sum (a product with
the one-hot assignment, in f32: TF32 is off on the card, ``ops/distance``),
and the routing (which clusters a row's candidate pool scans) a ``[k, k]``
centroid kNN on the host.  The reference computes these outside its Pallas
kernels, so here they are plain PyTorch.  Scores use bf16-rounded operands
with f32 sums, as the reference's bf16 products with f32 accumulation: a
product of two bf16 values is exact in f32, so an f32 ``matmul`` of the
rounded operands is the same arithmetic.  ``argmax`` takes the first of
equal scores in both packages.  Rows go through in chunks of at most
65,536, so no ``[n, k]`` score matrix is ever whole (16 GB in f32 at 4M
rows and k = 1024).
"""

from __future__ import annotations

import numpy as np
import torch

from embeddinghub_tpu_torch.ops.distance import round_bf16, sqnorms

CHUNK = 1 << 16


def _scores(xc: torch.Tensor, cent_t: torch.Tensor, csq: torch.Tensor):
    """``2 x.c - |c|^2`` of each row against each centroid (the larger, the
    nearer): bf16-rounded operands, f32 sums.  ``cent_t`` is the rounded
    ``[d, k]`` transpose."""
    return 2.0 * (round_bf16(xc.to(torch.float32)) @ cent_t) - csq[None, :]


def _assign(x: torch.Tensor, cent: torch.Tensor, chunk: int) -> torch.Tensor:
    """Nearest centroid of each row of ``x``, an int64 tensor on its device."""
    csq = sqnorms(cent)
    cent_t = round_bf16(cent).T.contiguous()
    return torch.cat([torch.argmax(_scores(x[s:s + chunk], cent_t, csq), dim=1)
                      for s in range(0, x.shape[0], chunk)])


def _lloyd(xs: torch.Tensor, cent: torch.Tensor, iters: int, chunk: int):
    """``iters`` Lloyd iterations on ``xs [s, d]`` from ``cent [k, d]``.  An
    empty cluster keeps its centroid.  Each cluster's sum is a product with
    the chunk's one-hot assignment, not a scatter-add, whose atomics would
    sum in a different order on every run on the card: the same rows give
    the same centroids."""
    k = cent.shape[0]
    ids = torch.arange(k, device=xs.device)
    for _ in range(iters):
        csq = sqnorms(cent)
        cent_t = round_bf16(cent).T.contiguous()
        sums = torch.zeros_like(cent)
        cnts = torch.zeros((k,), dtype=torch.float32, device=xs.device)
        for s in range(0, xs.shape[0], chunk):
            xc = xs[s:s + chunk]
            hot = (torch.argmax(_scores(xc, cent_t, csq), dim=1)[:, None]
                   == ids[None, :]).to(torch.float32)
            sums += hot.T @ xc
            cnts += hot.sum(dim=0)
        new = sums / torch.clamp(cnts, min=1.0)[:, None]
        cent = torch.where(cnts[:, None] > 0, new, cent)
    return cent


def fit_kmeans(xd: torch.Tensor, k: int, *, iters: int = 8, sample: int = 1 << 18,
               seed: int = 0, chunk: int = CHUNK, limit: int | None = None
               ) -> torch.Tensor:
    """Centroids ``[k, d]`` (f32, on ``xd``'s device) fitted on a sample of
    the first ``limit`` rows (all of them by default): the reference's
    ``np.random.default_rng(seed)`` draws pick the same sample rows and the
    same initial centroids."""
    n = xd.shape[0] if limit is None else min(limit, xd.shape[0])
    rng = np.random.default_rng(seed)
    if n > sample:
        idx = np.sort(rng.choice(n, size=sample, replace=False))
        xs = xd[torch.from_numpy(idx).to(xd.device)]
    else:
        xs = xd[:n]
    xs = xs.to(torch.float32).contiguous()
    init = np.sort(rng.choice(xs.shape[0], size=k, replace=False))
    cent0 = xs[torch.from_numpy(init).to(xd.device)]
    return _lloyd(xs, cent0, iters, min(chunk, xs.shape[0]))


def assign_clusters(xd: torch.Tensor, cent: torch.Tensor, chunk: int = CHUNK
                    ) -> np.ndarray:
    """Nearest-centroid id of each row, on the host (int32): the build's
    block planning is host logic."""
    return _assign(xd, cent, chunk).to(torch.int32).cpu().numpy()


def probe_order(cent) -> np.ndarray:
    """``[k, k]`` centroid ids sorted by distance (row i is cluster i's probe
    order, itself first): which clusters a row's candidate pool scans.  Host
    numpy, as the reference's."""
    if isinstance(cent, torch.Tensor):
        cent = cent.cpu().numpy()
    c = np.asarray(cent, np.float32)
    d2 = (c * c).sum(1)[:, None] - 2.0 * (c @ c.T) + (c * c).sum(1)[None, :]
    return np.argsort(d2, axis=1, kind="stable").astype(np.int32)


def boundary_margins(xd: torch.Tensor, cent: torch.Tensor, assign: np.ndarray,
                     probes: np.ndarray, limit: int | None = None,
                     chunk: int = CHUNK) -> np.ndarray:
    """Routing margin of each row: the distance to the nearest centroid its
    pool did not probe, less the distance to its own (``|x|^2`` cancels).  A
    small margin means the row sits at the edge of its probed neighbourhood,
    so its routed pool may have missed true neighbours: the boundary repair
    gives the smallest-margin rows exact pools
    (``HNSWIndex.cluster_boundary_rows``).  Host f32 ``[n]``."""
    n = xd.shape[0] if limit is None else min(limit, xd.shape[0])
    dev = xd.device
    csq = sqnorms(cent)
    cent_t = round_bf16(cent).T.contiguous()
    a_all = torch.from_numpy(np.asarray(assign[:n], np.int64)).to(dev)
    probes_d = torch.from_numpy(np.asarray(probes, np.int64)).to(dev)
    out = []
    for s in range(0, n, chunk):
        d2 = -_scores(xd[s:min(n, s + chunk)], cent_t, csq)   # |c|^2 - 2 x.c
        a = a_all[s:s + d2.shape[0]]
        d_own = torch.gather(d2, 1, a[:, None])[:, 0]
        d2.scatter_(1, probes_d[a], float("inf"))  # the probed clusters
        out.append(d2.min(dim=1).values - d_own)
    return torch.cat(out).cpu().numpy()
