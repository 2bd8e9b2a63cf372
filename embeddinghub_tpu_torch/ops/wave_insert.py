"""The graph engine's device steps, the twin of
``embeddinghub_tpu/ops/wave_insert.py``: the insert wave
(:func:`make_wave_commit`) and the full-graph query
(:func:`make_graph_search`).

A wave inserts up to a few thousand rows into a built graph at once, with
hnswlib's ``addPoint`` semantics: each row's candidate pool per layer is its
``ef0 = min(max(efC, 16), 1024)`` nearest live rows (a flat scan, not a
graph walk: K1 with ``exact=False`` on the card), forward links are the
neighbor-selection heuristic's ``M`` at every layer, and each selected edge
is mirrored into its target's list, appended while the list fits and
re-pruned by the same heuristic when it overflows.  Wave rows do not see
each other in their pools, as in the reference.

The reference is one jitted step on donated buffers; here the steps are
PyTorch calls that write the index's device tensors in place.  The
reference also pads a wave to a power of two by repeating its first row and
parks masked edges on a "dump row", both so that its fixed-shape scatters
stay deterministic; the port drops padding and masked edges instead, so
every scatter here writes unique indices (duplicate indices let either copy
win on CUDA).
"""

from __future__ import annotations

import time

import torch

from embeddinghub_tpu_torch.ops import beam as beam_ops
from embeddinghub_tpu_torch.ops import fused_topk
from embeddinghub_tpu_torch.ops import nn_descent as nnd
from embeddinghub_tpu_torch.ops import topk as topk_ops
from embeddinghub_tpu_torch.ops.topk import smallest_k

INF = float("inf")
_DUMP = 1 << 62  # sort key of masked edges: after every row id
# the device parts of a wave, as make_wave_commit's ``seconds`` keys
WAVE_PARTS = ("pool0", "pools_upper", "scatter", "prune", "reciprocal")


def _pool_metric(metric: str) -> str:
    return "l2" if metric == "l2" else "ip"  # cosine rows arrive unit-norm


def _pad_cols(ids: torch.Tensor, width: int) -> torch.Tensor:
    if ids.shape[1] < width:
        ids = torch.nn.functional.pad(ids, (0, width - ids.shape[1]), value=-1)
    return ids


def _masked_scan_topk(q, x, mask, x_sq, *, kk, metric, hi=None):
    """Layer-0 candidate pool: the ids of each query's ``kk`` best live rows
    (``mask``) on bf16-rounded operands with f32 sums, ``-1`` in slots no
    live row fills.  ``hi``, the arena's high-water mark, bounds the scan:
    rows at or past it are all dead, so the pool scans the prefix ``x[:hi]``
    and not the capacity (after a capacity doubling half the arena is
    dead).  On the card it is K1 with ``exact=False`` over that prefix; on
    the CPU its plain version.  Order within the pool is irrelevant: the
    heuristic re-sorts by distance."""
    cap = x.shape[0]
    kk = min(kk, cap)
    n = cap if hi is None else max(1, min(int(hi), cap))
    ids = topk_ops.pooled_topk_ids(q, x[:n], mask[:n], x_sq[:n],
                                   metric=_pool_metric(metric), k=min(kk, n))
    return _pad_cols(ids.to(torch.int64), kk)


def _member_scan_topk(q, x, x_sq, valid, levels, layer, members, count, *, kk,
                      metric):
    """Upper-layer candidate pool from the layer's member ids ``members
    [S]`` (``count`` filled): the member rows gathered into a compact
    sub-arena, then the same scan as :func:`_masked_scan_topk` over it (K1
    on the card), ids mapped back through ``members``.  Stale entries filter
    themselves: a member counts only while it is live and its level still
    reaches ``layer``."""
    kk = min(kk, members.shape[0])
    count = int(count)
    if count <= 0:
        return torch.full((q.shape[0], kk), -1, dtype=torch.int64, device=q.device)
    mem = members[:count].to(torch.int64)
    safe = mem.clamp(min=0)
    alive = (mem >= 0) & valid[safe] & (levels[safe] >= layer)
    local = topk_ops.pooled_topk_ids(q, fused_topk.arena_f32(x[safe]), alive,
                                     x_sq[safe], metric=_pool_metric(metric),
                                     k=min(kk, count)).to(torch.int64)
    ids = torch.where(local >= 0, mem[local.clamp(min=0)], -1)
    return _pad_cols(ids, kk)


def _reciprocal_commit(table, x, x_sq, src, dst, edge_valid, *, mmax, metric):
    """Mirror the edges ``src -> dst`` as ``dst -> src`` into ``table
    [cap, width]`` in place, with hnswlib's overflow rule: a target whose
    current list and new sources fit in ``mmax`` keeps them all (current
    first, then the sources in edge order), any other is re-pruned by the
    heuristic over both.  At most ``min(mmax, 32)`` incoming edges per
    target are taken per wave, the first in edge order.  Each target is
    written once.  Returns ``table``."""
    e = src.shape[0]
    r = min(mmax, 32)
    dev = table.device
    key = torch.where(edge_valid, dst.to(torch.int64), _DUMP)
    order = torch.argsort(key, stable=True)
    gd = key[order]
    gs = torch.where(edge_valid[order], src.to(torch.int64)[order], -1)
    head = torch.ones_like(gd, dtype=torch.bool)
    head[1:] = gd[1:] != gd[:-1]
    owners = torch.nonzero(head & (gd < _DUMP))[:, 0]
    if owners.numel() == 0:
        return table
    t = gd[owners]
    pos = owners[:, None] + torch.arange(r, device=dev)[None, :]
    inside = pos < e
    pos = pos.clamp(max=e - 1)
    inc = torch.where(inside & (gd[pos] == t[:, None]), gs[pos], -1)
    comb = torch.cat([table[t].to(torch.int64), inc], dim=1)
    # valid first, each side's order kept
    final = torch.gather(
        comb, 1, torch.argsort((comb < 0).to(torch.int8), dim=1, stable=True)
    )[:, :mmax]
    over = torch.nonzero((comb >= 0).sum(dim=1) > mmax)[:, 0]
    if over.numel():
        tv = t[over]
        final[over] = nnd.heuristic_prune(
            x, x_sq, comb[over], m_keep=mmax, metric=_pool_metric(metric),
            cand_k=comb.shape[1], q=x[tv], q_sq=x_sq[tv])[:, :mmax]
    table[t] = final.to(table.dtype)
    return table


def make_wave_commit(*, metric: str, m: int, m0: int, ef_construction: int):
    """The wave commit for one graph configuration.  The returned function
    takes the reference's arguments in the reference's order, less its
    padding mask ``wave_valid`` (a wave here is its rows, unpadded),

        (x, x_sq, valid, levels, nb0, upper, members, mcount,
         rows, vecs, vecs_sq, wave_levels, link_top, scan_hi)

    and the keyword ``seconds``, a dict to whose ``WAVE_PARTS`` entries it
    adds its seconds (synchronizing the device between parts).  It writes
    the eight graph tensors in place and returns them: ``upper`` is the
    ``[L, cap, m]`` stack of upper tables, ``members``/``mcount`` the
    ``[L, S]`` member ids of each upper layer and their counts, ``levels``
    the per-row level (-1: not in the graph), ``wave_levels`` each wave
    row's drawn level and ``link_top`` the highest layer it links on
    (``min(level, pre-wave max level)``).  The caller guarantees ``mcount +
    appends <= S``.

    Steps, in the reference's order: the pools against the pre-wave arena
    (the wave's rows are not live yet), the member appends, the vector
    scatter, self masking, forward selection at ``m`` on every layer (``m``
    and not ``m0`` at layer 0 leaves free slots for later reciprocal edges,
    as hnswlib does), then the reciprocal commits per layer."""
    ef0 = min(max(ef_construction, 16), 1024)
    pm = _pool_metric(metric)

    def wave_commit(x, x_sq, valid, levels, nb0, upper, members, mcount,
                    rows, vecs, vecs_sq, wave_levels, link_top, scan_hi, *,
                    seconds=None):
        dev = x.device
        t_last = [time.perf_counter()]

        def tick(part):
            if seconds is None:
                return
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            seconds[part] = seconds.get(part, 0.0) + now - t_last[0]
            t_last[0] = now

        rows = rows.to(torch.int64)
        dump = rows[:1]  # the reference's dump row: no wave row links to it
        w = rows.shape[0]
        L = upper.shape[0]
        counts = mcount.tolist()
        vecs = vecs.to(torch.float32)
        vecs_sq = vecs_sq.to(torch.float32)

        # 1. pools against the pre-wave arena
        pools = [_masked_scan_topk(vecs, x, valid, x_sq, kk=ef0, metric=metric,
                                   hi=scan_hi)]
        tick("pool0")
        for layer in range(1, L + 1):
            pools.append(_member_scan_topk(
                vecs, x, x_sq, valid, levels, layer, members[layer - 1],
                counts[layer - 1], kk=min(ef0, 4 * m), metric=metric))
        tick("pools_upper")

        # 1b. the wave's upper-layer rows join the member lists (after the
        # pools: a wave never pools its own rows); appends past S drop
        S = members.shape[1] if L else 0
        for layer in range(1, L + 1):
            mk = wave_levels >= layer
            pos = int(counts[layer - 1]) + torch.cumsum(mk.to(torch.int64), 0) - 1
            ok = mk & (pos < S)
            members[layer - 1, pos[ok]] = rows[ok].to(members.dtype)
            mcount[layer - 1] += mk.sum().to(mcount.dtype)

        # 2. the vector scatter
        x[rows] = vecs
        x_sq[rows] = vecs_sq
        valid[rows] = True
        levels[rows] = wave_levels.to(levels.dtype)
        tick("scatter")

        # a row never links to itself (a re-set row was live in the pools),
        # nor to the dump row
        pools = [torch.where((p == rows[:, None]) | (p == dump), -1, p)
                 for p in pools]

        # 3. forward selection, per layer
        sels = []
        for layer, pool in enumerate(pools):
            sel = nnd.heuristic_prune(x, x_sq, pool, m_keep=m, metric=pm,
                                      cand_k=pool.shape[1], q=vecs,
                                      q_sq=vecs_sq)[:, :m]
            member = link_top >= layer
            sel = torch.where(member[:, None], sel, -1)
            sels.append(sel)
            if layer == 0:
                payload = torch.full((w, m0), -1, dtype=nb0.dtype, device=dev)
                payload[:, :m] = sel.to(nb0.dtype)
                nb0[rows] = payload
            else:
                upper[layer - 1, rows[member]] = sel[member].to(upper.dtype)
        tick("prune")

        # 4. reciprocal commits, per layer
        src = rows[:, None].expand(w, m).reshape(-1)
        for layer, sel in enumerate(sels):
            ev = ((sel >= 0) & (link_top >= layer)[:, None]).reshape(-1)
            _reciprocal_commit(nb0 if layer == 0 else upper[layer - 1], x, x_sq,
                               src, sel.reshape(-1), ev,
                               mmax=m0 if layer == 0 else m, metric=metric)
        tick("reciprocal")
        return x, x_sq, valid, levels, nb0, upper, members, mcount

    return wave_commit


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
