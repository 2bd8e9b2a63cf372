"""The fused full-graph query of ``embeddinghub_tpu/ops/wave_insert.py``:
:func:`make_graph_search` and its exact rerank.  The wave commit that gives
the module its name (inserts into a built graph) waits for ROADMAP.md
queue 1, graph engine, construction and mutation.
"""

from __future__ import annotations

import torch

from embeddinghub_tpu_torch.ops import beam as beam_ops
from embeddinghub_tpu_torch.ops.topk import smallest_k

INF = float("inf")


def make_graph_search(*, metric: str, ef: int, expand: int, max_hops: int,
                      seed_probes: int = 0, spec: int = 1, exit_k: int = 0,
                      rerank_k: int = 0, packed: bool = False):
    """A full-graph query: greedy descent through the stacked upper layers,
    then the layer-0 beam.  The returned function takes the reference's
    arguments in the reference's order:

      * plain:  ``(q, entry, nb0, upper, x, x_sq, valid, *exact)``;
      * routed (``seed_probes > 0``): ``(q, entry, cent, cent_sq, medoids,
        nb0, upper, x, x_sq, valid, *exact)`` -- the beam is also seeded
        with the medoid rows of the query's ``seed_probes`` nearest
        centroids;
      * packed: ``(q, entry, [cent, cent_sq, medoids,] nb0, upper, xa,
        packed_arr, dscale, x_exact, x_exact_sq, valid)``.

    With ``rerank_k > 0`` the trailing ``exact = (x_exact, x_exact_sq)``
    re-score the best ``rerank_k`` pool entries in f32 and the result is
    ``[B, rerank_k]`` wide, the pairing for a bf16 (``augment_arena``) walk.
    It returns ``(dist, ids, hops)``: ``hops`` is the beam's iteration count
    (the reference's returns no hop count)."""
    if packed and rerank_k <= 0:
        raise ValueError("packed walk requires rerank_k > 0 "
                         "(phase-1 distances are int8-quantized)")
    s = seed_probes

    def _rerank(q, d, ids, x_exact, x_exact_sq, valid=None):
        kk = min(rerank_k, d.shape[1])
        top = ids[:, :kk]
        safe = top.clamp(min=0)
        # elementwise product and sum: full f32 whatever the TF32 switch
        dots = (x_exact[safe] * q[:, None, :]).sum(dim=2)
        if metric == "l2":
            qsq = (q * q).sum(dim=1, keepdim=True)
            nd = torch.clamp(x_exact_sq[safe] - 2.0 * dots + qsq, min=0.0)
        else:
            nd = 1.0 - dots
        nd = torch.where((top >= 0) & torch.isfinite(d[:, :kk]), nd, INF)
        if valid is not None:
            # packed fetches do not see deletions; the exact pass drops them
            nd = torch.where(valid[safe], nd, INF)
        ns, pos = smallest_k(nd, kk)
        return ns, torch.gather(top, 1, pos)

    def _entries(q, entry, upper, x, x_sq, route):
        b = q.shape[0]
        cur = torch.full((b,), int(entry), dtype=torch.int64, device=q.device)
        for layer in range(upper.shape[0], 0, -1):
            cur = beam_ops.greedy_descend(q, cur, upper[layer - 1], x, x_sq,
                                          metric=metric)
        if not route:
            return cur
        cent, cent_sq, medoids = route
        dots = q @ cent.T
        score = 2.0 * dots - cent_sq[None, :] if metric == "l2" else dots
        _, cid = smallest_k(-score, min(s, cent.shape[0]))
        return torch.cat([cur[:, None], medoids[cid].to(torch.int64)], dim=1)

    def _beam(q, entries, nb0, x, x_sq, valid, **kw):
        return beam_ops.beam_search(
            q, entries, nb0, x, x_sq, valid, metric=metric, ef=ef,
            expand=min(expand, ef), max_hops=max_hops, spec=spec,
            exit_k=exit_k, with_hops=True, **kw)

    if packed:
        def graph_search_packed(q, entry, *args):
            route = args[:3] if s > 0 else ()
            (nb0, upper, xa, packed_arr, dscale,
             x_exact, x_exact_sq, valid_arr) = args[len(route):]
            entries = _entries(q, entry, upper, xa, None, route)
            d, ids, hops = _beam(q, entries, nb0, xa, None, None,
                                 packed=packed_arr, dscale=dscale)
            return (*_rerank(q, d, ids, x_exact, x_exact_sq, valid_arr), hops)

        return graph_search_packed

    def run(q, entry, route, nb0, upper, x, x_sq, valid, exact):
        entries = _entries(q, entry, upper, x, x_sq, route)
        d, ids, hops = _beam(q, entries, nb0, x, x_sq, valid)
        if rerank_k:
            d, ids = _rerank(q, d, ids, *exact)
        return d, ids, hops

    if s <= 0:
        def graph_search(q, entry, nb0, upper, x, x_sq, valid, *exact):
            return run(q, entry, (), nb0, upper, x, x_sq, valid, exact)

        return graph_search

    def graph_search_routed(q, entry, cent, cent_sq, medoids,
                            nb0, upper, x, x_sq, valid, *exact):
        return run(q, entry, (cent, cent_sq, medoids), nb0, upper, x, x_sq,
                   valid, exact)

    return graph_search_routed
