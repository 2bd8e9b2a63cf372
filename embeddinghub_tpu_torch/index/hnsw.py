"""HNSWIndex: the twin of ``embeddinghub_tpu/index/hnsw.py`` for a graph
that is built once and then served.

The same hnswlib-semantic graph in array form (reference: hnswlib
``HierarchicalNSW`` behind ``embeddingstore/index.cc:12-15``, defaults M=16,
efConstruction=200, ef=10): flat int32 neighbor tables (``[cap, 2M]`` for
layer 0, ``{node: [ids]}`` per upper layer on the host, stacked into
``[L, cap, M]`` on the device), geometric levels, greedy descent through
the upper layers, then a batched beam on layer 0.

What is ported:

  * the exact bulk build, the reference's default up to ``exact_build_max``
    rows: each row's candidate pool is its exact top-``efC`` set on
    bf16-rounded operands (``ops/topk.pooled_topk_ids``, K1 on the card),
    heuristic selection at ``2M`` (``ops/nn_descent.heuristic_prune``),
    reciprocal edges with overflow-only pruning
    (``ops/nn_descent.gather_reciprocal``), random long edges into free
    slots, the level draws and the upper layers, each step drawing from the
    same numpy generators as the reference, so the graph is the reference's;
  * search (``ops/wave_insert.make_graph_search``): plain, routed by a
    snapshot's centroids, on the bf16 walk arena (``EHTPU_WALK_DTYPE``) and
    on the packed-neighbor arena (``EHTPU_WALK_PACKED=1`` or
    :meth:`pack_walk`);
  * ``state_arrays``/``from_state`` in the reference's array names, so
    either package opens the other's graph.  A graph the JAX package built
    comes across as ``HNSWIndex.from_state(dims, metric,
    jax_index.state_arrays(), device=...)`` on its numpy arrays.

What is not ported yet raises ``NotImplementedError`` naming ROADMAP.md
queue 1, graph engine, construction and mutation: an add into a built
graph, a cold add of fewer than 2048 rows or of more than
``exact_build_max``, ``remove``, ``refine`` and ``build_route`` (k-means).

The host arrays are authoritative; the device state is rebuilt whole from
them on first use after a build.  On CUDA every f32 product of the build
and the walk runs with TF32 off (``ops/distance.full_f32``, set here).
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from embeddinghub_tpu_torch.index.base import Index, as_f32_matrix, next_pow2
from embeddinghub_tpu_torch.ops import beam as beam_ops
from embeddinghub_tpu_torch.ops import distance as dist_ops
from embeddinghub_tpu_torch.ops import fused_topk
from embeddinghub_tpu_torch.ops import nn_descent as nnd
from embeddinghub_tpu_torch.ops import topk as topk_ops
from embeddinghub_tpu_torch.ops import wave_insert
from embeddinghub_tpu_torch.utils.device import DEFAULT as DEFAULT_DEVICE
from embeddinghub_tpu_torch.utils.device import resolve as resolve_device

NOT_PORTED = ("is not ported yet; see ROADMAP.md queue 1, graph engine, "
              "construction and mutation")
BULK_MIN = 2048  # a cold add of at least this many rows is one bulk build

# Query batches are padded up to one of these sizes (then powers of two).
# The reference pads for its jit shapes; here the padding stays because it
# changes results: the beam's exit condition is over the whole batch, so
# the zero pad queries keep it walking while they are active.
_BUCKETS = (1, 8, 64, 256, 1024)


def _bucket(b: int) -> int:
    for s in _BUCKETS:
        if b <= s:
            return s
    return next_pow2(b, floor=_BUCKETS[-1])


class HNSWIndex(Index):
    def __init__(
        self,
        dims: int,
        metric: str = "l2",
        m: int = 16,
        ef_construction: int = 200,
        ef_search: int = 10,
        capacity: int = 1024,
        expand: int = 8,
        seed: int = 100,
        device: torch.device | str = DEFAULT_DEVICE,
    ):
        if metric not in dist_ops.METRICS:
            raise ValueError(f"unknown metric {metric!r}")
        self.dims = int(dims)
        self.metric = metric
        self.m = int(m)
        self.m0 = 2 * self.m
        self.ef_construction = int(ef_construction)
        self.ef_search = int(ef_search)
        self.expand = int(expand)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            dist_ops.full_f32()
        # Walk shape knobs (ops/beam.beam_search): spec=2 covers two graph
        # hops per iteration, exit_k stops once the top exit_k pool entries
        # are converged; 0 = hnswlib's semantics (index.cc:41-51).
        self.spec = 1
        self.exit_k = 0
        # The walk gathers one [D+2] bf16 row per candidate (the vectors
        # with x_sq and liveness folded in, ops/beam.augment_arena) and
        # re-scores the k rows the caller reads on the exact f32 arena;
        # "off" walks the f32 arena with three gathers per candidate.
        self.walk_dtype = os.environ.get("EHTPU_WALK_DTYPE", "bfloat16")
        # Packed-neighbor walk (ops/beam.pack_neighbors): m0*D int8 bytes a
        # node of device memory for E block rows per hop instead of E*M
        # scattered ones, then an exact rerank; for frozen graphs.
        self.walk_packed = bool(int(os.environ.get("EHTPU_WALK_PACKED", "0")))
        # Exact-scan construction up to this many rows (the reference's
        # default build; its cluster-routed build takes over beyond).
        self.exact_build_max = 2_000_000
        # Centroid-routed multi-entry search: a snapshot's route seeds the
        # beam with seed_probes medoids (fitting a route, build_route, is
        # not ported yet).
        self.seed_probes = 0
        self._mult = 1.0 / math.log(self.m)
        self._rng = np.random.default_rng(seed)

        self._cap = next_pow2(max(capacity, 128), floor=128)
        self._hx = np.zeros((self._cap, self.dims), np.float32)   # raw
        self._hvalid = np.zeros((self._cap,), bool)
        self._levels = np.full((self._cap,), -1, np.int32)
        self._nb0 = np.full((self._cap, self.m0), -1, np.int32)
        self._upper: dict[int, dict[int, list[int]]] = {}
        self._entry = -1
        self._max_level = -1
        self._size = 0
        self._device_state = None  # None = rebuilt from the host on next use
        self._gs_fns: dict[tuple, object] = {}
        self._cluster_route = None
        # seconds of the last bulk build, by part (see _bulk_build)
        self.build_seconds: dict[str, float] = {}
        # iterations of the last search's layer-0 beam
        self.last_hops = 0

    # ---------------------------------------------------------------- helpers

    def _prep(self, v: np.ndarray) -> np.ndarray:
        if self.metric == "cosine":
            n = np.linalg.norm(v, axis=-1, keepdims=True)
            return v / np.maximum(n, 1e-30)
        return v

    def _assign_level(self) -> int:
        return int(-math.log(max(self._rng.random(), 1e-12)) * self._mult)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        a = np.require(a, requirements=("C", "W"))  # a copy of a read-only view
        return torch.from_numpy(a).to(self.device, copy=True)

    def _sync_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _graph_size(self) -> int:
        return int(np.count_nonzero(self._levels >= 0))

    # ------------------------------------------------------------------ write

    def add(self, rows: np.ndarray, vecs: np.ndarray) -> None:
        """A cold add of ``BULK_MIN`` to ``exact_build_max`` rows: one exact
        bulk build.  Every other add raises ``NotImplementedError``."""
        rows = np.asarray(rows, dtype=np.int64).ravel()
        vecs = as_f32_matrix(vecs, self.dims)
        if rows.shape[0] != vecs.shape[0]:
            raise ValueError("rows / vecs length mismatch")
        if rows.size == 0:
            return
        if self._graph_size() > 0:
            raise NotImplementedError(f"adding to a built graph {NOT_PORTED}")
        if not BULK_MIN <= rows.size <= self.exact_build_max:
            raise NotImplementedError(
                f"a first add of {rows.size} rows (the exact bulk build takes "
                f"{BULK_MIN} to {self.exact_build_max}) {NOT_PORTED}")
        self._ensure_capacity(int(rows.max()) + 1)
        order = np.argsort(rows)  # deterministic
        pending = rows[order]
        pvecs = self._prep(vecs)[order]
        rng_state = self._rng.bit_generator.state
        self._hx[pending] = vecs[order]
        self._hvalid[pending] = True
        self._size += rows.size
        self._device_state = None
        try:
            self._bulk_build(pending, pvecs)
        except BaseException:
            # back to the empty graph, level draws included, so that a
            # retry builds the graph a first try would have
            self._hx[pending] = 0
            self._hvalid[pending] = False
            self._levels[pending] = -1
            self._nb0[pending] = -1
            self._upper = {}
            self._entry = self._max_level = -1
            self._size -= rows.size
            self._rng.bit_generator.state = rng_state
            raise

    def remove(self, rows: np.ndarray) -> None:
        raise NotImplementedError(f"HNSWIndex.remove {NOT_PORTED}")

    def refine(self, rows: np.ndarray | None = None) -> None:
        raise NotImplementedError(f"HNSWIndex.refine {NOT_PORTED}")

    def build_route(self, seed_probes: int = 8, k: int | None = None):
        raise NotImplementedError(f"HNSWIndex.build_route (kmeans) {NOT_PORTED}")

    def _ensure_capacity(self, need: int) -> None:
        if need <= self._cap:
            return
        new_cap = next_pow2(need, floor=self._cap)
        for name, fill in (("_hx", 0), ("_hvalid", False), ("_levels", -1),
                           ("_nb0", -1)):
            old = getattr(self, name)
            grown = np.full((new_cap,) + old.shape[1:], fill, dtype=old.dtype)
            grown[: self._cap] = old
            setattr(self, name, grown)
        self._cap = new_cap
        self._device_state = None

    # ------------------------------------------------------------- bulk build

    def _bulk_build(self, rows: np.ndarray, pvecs: np.ndarray) -> None:
        """Exact bulk construction (``hnsw.py:484-609`` of the reference,
        its ``n <= exact_build_max`` branch): layer 0 from exact pools,
        heuristic selection and a symmetrize; random long edges; levels and
        upper layers.  Records its seconds by part in ``build_seconds``:
        pools (K1), prune, symmetrize, upper (the upper layers, their own
        pools included) and host (everything else: padding, upload, long
        edges, id mapping, level draws)."""
        t_start = time.perf_counter()
        self.build_seconds = dict.fromkeys(
            ("pools", "prune", "symmetrize", "upper", "host"), 0.0)
        n = len(rows)
        block = 2048 if n < 32768 else 4096
        # padded to a multiple of the query block, and past 64k rows of the
        # reference's 64k scan chunk, which keeps its pool widths
        grain = block if n < (1 << 16) else (1 << 16)
        padded = -(-n // grain) * grain
        x = np.empty((padded, self.dims), np.float32)
        x[:n] = pvecs
        if padded > n:
            if self.metric == "l2":
                # far-offset pad rows never enter real neighbor lists
                x[n:] = pvecs[0] + 1e4
            else:
                rngp = np.random.default_rng(1)
                pad = rngp.standard_normal((padded - n, self.dims))
                x[n:] = pad / np.linalg.norm(pad, axis=1, keepdims=True)
        xd = fused_topk.arena_f32(self._upload(x))
        xsq = dist_ops.sqnorms(xd)

        fwd = self._exact_build_fwd(xd, xsq, n, padded, block)
        t0 = time.perf_counter()
        nb_local = self._symmetrize_device(fwd, xd, xsq, n, padded)
        self.build_seconds["symmetrize"] = time.perf_counter() - t0
        del fwd, xd, xsq

        # Connectivity insurance: random long-range edges into FREE slots
        # only (never overwriting selected links).
        rng_e = np.random.default_rng(7)
        n_rand = min(3, self.m0 - 1)
        deg = (nb_local[:n] >= 0).sum(1)
        rand_local = rng_e.integers(0, n, size=(n, n_rand)).astype(np.int32)
        rand_local[rand_local == np.arange(n, dtype=np.int32)[:, None]] = -1
        cols = deg[:, None] + np.arange(n_rand)[None, :]
        ok = (cols < self.m0) & (rand_local >= 0)
        rows_i = np.repeat(np.arange(n), n_rand).reshape(n, n_rand)
        nb_local[rows_i[ok], cols[ok]] = rand_local[ok]

        # local (position) ids -> global row ids; padding / -1 dropped
        local_to_row = rows.astype(np.int64)
        valid = (nb_local[:n] >= 0) & (nb_local[:n] < n)
        mapped = np.where(valid, local_to_row[np.clip(nb_local[:n], 0, n - 1)], -1)
        self._nb0[rows] = mapped.astype(np.int32)

        levels = np.asarray([self._assign_level() for _ in range(n)], np.int32)
        self._levels[rows] = levels
        t0 = time.perf_counter()
        self._build_upper_layers(rows, pvecs, levels)
        self.build_seconds["upper"] = time.perf_counter() - t0
        parts = sum(self.build_seconds.values())
        self.build_seconds["host"] = time.perf_counter() - t_start - parts

    def _exact_build_fwd(self, xd, xsqd, n: int, padded: int, block: int):
        """Forward link lists from exact top-efC pools, one query block at a
        time: ``pooled_topk_ids`` then heuristic selection at ``m0``.
        Returns a device ``[padded, m0]`` tensor of local ids (-1 past
        ``n``)."""
        chunk = min(1 << 16, padded)
        while padded % chunk:
            chunk //= 2
        # pow2 pool: self-exclusion masks one slot, so >= efC-1 remain
        pool_k = min(next_pow2(self.ef_construction, floor=64), chunk, padded)
        metric = self.metric if self.metric != "cosine" else "ip"
        validd = torch.arange(padded, device=self.device) < n
        fwd = torch.full((padded, self.m0), -1, dtype=torch.int64, device=self.device)
        for s in range(0, -(-n // block) * block, block):
            t0 = time.perf_counter()
            qv, qsq = xd[s:s + block], xsqd[s:s + block]
            ids_b = topk_ops.pooled_topk_ids(qv, xd, validd, xsqd, metric=metric,
                                             k=pool_k, chunk=chunk).to(torch.int64)
            self._sync_device()
            t1 = time.perf_counter()
            self_col = s + torch.arange(block, device=self.device)[:, None]
            ids_b = torch.where(ids_b == self_col, -1, ids_b)
            fwd[s:s + block] = nnd.heuristic_prune(
                xd, xsqd, ids_b, m_keep=self.m0, metric=self.metric,
                cand_k=pool_k, q=qv, q_sq=qsq)
            self._sync_device()
            t2 = time.perf_counter()
            self.build_seconds["pools"] += t1 - t0
            self.build_seconds["prune"] += t2 - t1
        real = (torch.arange(padded, device=self.device) < n)[:, None]
        return torch.where(real & (fwd < n), fwd, -1)

    def _symmetrize_device(self, fwd, xd, xsqd, n: int, padded: int,
                           width: int | None = None) -> np.ndarray:
        """Reciprocal edges (``gather_reciprocal``) with hnswlib's
        overflow-only pruning: rows that hold at most ``width`` (default
        ``m0``) edges keep them all, the others are heuristic-pruned over
        their forward and incoming edges.  Returns a host ``[padded, width]``
        int32 table (-1 past ``n``)."""
        m0 = self.m0 if width is None else int(width)
        cap_in = 3 * m0
        validd = torch.arange(padded, device=self.device) < n
        comb, fits = nnd.gather_reciprocal(fwd, validd, cap_in=cap_in)
        out = comb[:, :m0].clone()
        over = torch.nonzero(~fits)[:, 0]
        if over.numel():
            out[over] = nnd.heuristic_prune(
                xd, xsqd, comb[over], m_keep=m0, metric=self.metric,
                cand_k=m0 + cap_in, q=xd[over], q_sq=xsqd[over])
        out = out.cpu().numpy().astype(np.int32)
        out[n:] = -1
        out[:n] = np.where(out[:n] >= n, -1, out[:n])
        return out

    def _build_upper_layers(self, rows: np.ndarray, pvecs: np.ndarray,
                            levels: np.ndarray) -> None:
        """Every upper layer from exact pools over that layer's members (a
        sub-arena rounded up to a power of two, ``4M`` wide pools), heuristic
        selection at ``M`` and a symmetrize at width ``M``; then the entry
        point (the first node of the top level)."""
        local_to_row = rows.astype(np.int64)
        metric = self.metric if self.metric != "cosine" else "ip"
        top = int(levels.max(initial=0))
        for layer in range(1, top + 1):
            members = np.flatnonzero(levels >= layer)
            gids = local_to_row[members]
            if members.size <= 1:
                for g in gids:
                    self._upper.setdefault(layer, {})[int(g)] = []
                continue
            sub = pvecs[members]
            cap = max(128, next_pow2(members.size, floor=128))
            subx = np.zeros((cap, self.dims), np.float32)
            subx[: members.size] = sub
            sxd = fused_topk.arena_f32(self._upload(subx))
            ssq = dist_ops.sqnorms(sxd)
            svalid = torch.arange(cap, device=self.device) < members.size
            qblk = min(next_pow2(members.size, floor=8), 4096)
            schunk = min(cap, 1 << 16)
            while cap % schunk:
                schunk //= 2
            kpool = min(next_pow2(4 * self.m, floor=32), schunk)
            pool = torch.full((cap, kpool), -1, dtype=torch.int64, device=self.device)
            for s in range(0, members.size, qblk):
                e = min(members.size, s + qblk)
                pool[s:e] = topk_ops.pooled_topk_ids(
                    sxd[s:e], sxd, svalid, ssq, metric=metric, k=kpool,
                    chunk=schunk).to(torch.int64)
            rows_j = torch.arange(cap, device=self.device)[:, None]
            pool = torch.where(pool == rows_j, -1, pool)
            fwd = nnd.heuristic_prune(sxd, ssq, pool, m_keep=self.m,
                                      metric=self.metric, cand_k=kpool)
            fwd = torch.where((fwd >= members.size) | (rows_j >= members.size), -1, fwd)
            sym = self._symmetrize_device(fwd, sxd, ssq, members.size, cap,
                                          width=self.m)
            layer_map = self._upper.setdefault(layer, {})
            for j, g in enumerate(gids):
                layer_map[int(g)] = [
                    int(local_to_row[members[t]])
                    for t in sym[j]
                    if 0 <= t < members.size and t != j
                ]
        top_nodes = np.flatnonzero(levels == top)
        self._entry = int(local_to_row[top_nodes[0]])
        self._max_level = top

    # ----------------------------------------------------------------- search

    def _device_arrays(self) -> dict:
        """The device graph: the prepped f32 arena, its squared norms (from
        the host, as the reference's), liveness, levels, layer-0 table, the
        ``[L, cap, M]`` stack of upper tables and the per-layer member
        arenas; rebuilt from the host arrays whenever they changed."""
        if self._device_state is not None:
            return self._device_state
        x = self._prep(self._hx)
        L = max(self._max_level, 0)
        ustack = np.full((L, self._cap, self.m), -1, np.int32)
        for layer in range(1, L + 1):
            for node, lst in self._upper.get(layer, {}).items():
                ustack[layer - 1, node, : len(lst)] = lst[: self.m]
        members, mcount = self._build_members_host(L)
        self._device_state = {
            "x": fused_topk.arena_f32(self._upload(x)),
            "x_sq": self._upload(np.einsum("nd,nd->n", x, x)),
            "valid": self._upload(self._hvalid),
            "levels": self._upload(self._levels),
            "nb0": self._upload(self._nb0),
            "ustack": self._upload(ustack),
            "members": self._upload(members),
            "mcount": self._upload(mcount),
        }
        return self._device_state

    def _member_slab_width(self) -> int:
        """Width S of the per-upper-layer member arenas: about twice the
        expected layer-1 population (cap/M)."""
        return int(next_pow2(max(4096, self._cap // 8)))

    def _build_members_host(self, L: int):
        """``[L, S]`` member-id arenas and counts from the host level table;
        S grows past the default width when a layer needs it."""
        S = self._member_slab_width()
        ids_by_layer = [np.flatnonzero(self._levels >= layer)
                        for layer in range(1, L + 1)]
        need = max((ids.size for ids in ids_by_layer), default=0)
        while S < need:
            S *= 2
        members = np.full((L, S), -1, np.int32)
        mcount = np.zeros((L,), np.int32)
        for layer, ids in enumerate(ids_by_layer):
            members[layer, : ids.size] = ids
            mcount[layer] = ids.size
        return members, mcount

    def _walk_arena(self, state):
        """The cached ``augment_arena`` table of the walk: bf16 (or f32
        under ``walk_dtype="float32"``) rows with the penalty columns."""
        if state.get("xa") is None:
            x = state["x"]
            if self.walk_dtype == "bfloat16":
                x = x.to(torch.bfloat16)
            state["xa"] = beam_ops.augment_arena(x, state["x_sq"], state["valid"],
                                                 self.metric)
        return state["xa"]

    def _packed_arena(self, state):
        """The cached ``pack_neighbors`` arena and its dequantization step."""
        if state.get("xp") is None:
            state["xp"], state["xp_scale"] = beam_ops.pack_neighbors(
                state["x"], state["nb0"])
        return state["xp"], state["xp_scale"]

    def pack_walk(self) -> None:
        """Build the packed walk arena now (a freeze-time hook), so the first
        query does not pay for it, and walk it from then on."""
        self.walk_packed = True
        self._packed_arena(self._device_arrays())

    def search(self, queries: np.ndarray, k: int, ef: int | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
        queries = as_f32_matrix(queries, self.dims)
        b = queries.shape[0]
        if self._size == 0 or k <= 0 or self._entry < 0:
            return (np.full((b, max(k, 0)), np.inf, np.float32),
                    np.full((b, max(k, 0)), -1, np.int64))
        ef = max(ef or self.ef_search, k)
        state = self._device_arrays()
        q = np.zeros((_bucket(b), self.dims), np.float32)
        q[:b] = self._prep(queries)
        q = self._upload(q)
        ef_l = min(next_pow2(ef, floor=8), 1024)
        route = self._cluster_route or {}
        seeds = (min(self.seed_probes, ef_l - 1)
                 if self.seed_probes > 0 and route.get("_dev") is not None else 0)
        spec = max(1, int(self.spec))
        exit_k = int(self.exit_k)
        fused = self.walk_dtype != "off"
        packed = fused and self.walk_packed
        # the bf16 walk's k rows (bucketed) are re-scored on the f32 arena
        kk = min(ef_l, next_pow2(k, floor=8)) if fused else 0
        key = (ef_l, seeds, spec, exit_k, kk, packed)
        gs = self._gs_fns.get(key)
        if gs is None:
            gs = self._gs_fns[key] = wave_insert.make_graph_search(
                metric=self.metric, ef=ef_l, expand=self.expand,
                max_hops=2 * ef_l + 64, seed_probes=seeds, spec=spec,
                exit_k=exit_k, rerank_k=kk, packed=packed)
        seed_args = tuple(route["_dev"]) if seeds else ()
        if packed:
            xp, xp_scale = self._packed_arena(state)
            d, ids, hops = gs(q, self._entry, *seed_args, state["nb0"],
                              state["ustack"], self._walk_arena(state), xp, xp_scale,
                              state["x"], state["x_sq"], state["valid"])
        elif fused:
            d, ids, hops = gs(q, self._entry, *seed_args, state["nb0"],
                              state["ustack"], self._walk_arena(state), None, None,
                              state["x"], state["x_sq"])
        else:
            d, ids, hops = gs(q, self._entry, *seed_args, state["nb0"],
                              state["ustack"], state["x"], state["x_sq"],
                              state["valid"])
        self.last_hops = hops
        d = d[:b, :k].cpu().numpy()
        ids = ids[:b, :k].cpu().numpy().astype(np.int64)
        ids[~np.isfinite(d)] = -1
        return d, ids

    # ------------------------------------------------------------------ misc

    @property
    def size(self) -> int:
        return self._size

    def vector(self, row: int) -> np.ndarray:
        return self._hx[row].copy()

    def vectors(self, rows: np.ndarray) -> np.ndarray:
        return self._hx[np.asarray(rows, dtype=np.int64)]

    # -------------------------------------------------------------- snapshot

    def state_arrays(self) -> dict[str, np.ndarray]:
        """The reference's snapshot arrays: ``x``, ``valid``, ``levels``,
        ``nb0``, ``meta = [entry, max_level, m, efC, ef]``, ``upper{L}`` rows
        ``[node, ids..., -1...]`` and, with a route, ``route_cent``,
        ``route_medoids`` and ``route_seed_probes``."""
        arrs = {
            "x": self._hx,
            "valid": self._hvalid,
            "levels": self._levels,
            "nb0": self._nb0,
            "meta": np.asarray([self._entry, self._max_level, self.m,
                                self.ef_construction, self.ef_search], np.int64),
        }
        for layer, nodes in self._upper.items():
            flat = [[node] + lst + [-1] * (self.m - len(lst))
                    for node, lst in nodes.items()]
            if flat:
                arrs[f"upper{layer}"] = np.asarray(flat, np.int64)
        route = self._cluster_route
        if route and "medoids" in route:
            arrs["route_cent"] = route["cent"]
            arrs["route_medoids"] = route["medoids"]
            arrs["route_seed_probes"] = np.asarray([self.seed_probes], np.int64)
        return arrs

    @classmethod
    def from_state(cls, dims: int, metric: str, arrays: dict[str, np.ndarray],
                   **kw) -> "HNSWIndex":
        """Rebuild from ``state_arrays()`` of either package."""
        meta = arrays["meta"]
        if len(meta) >= 5 and "ef_search" not in kw:
            kw = dict(kw, ef_search=int(meta[4]))
        idx = cls(dims, metric=metric, m=int(meta[2]), ef_construction=int(meta[3]),
                  capacity=arrays["x"].shape[0], **kw)
        idx._hx[:] = arrays["x"]
        idx._hvalid[:] = arrays["valid"]
        idx._levels[:] = arrays["levels"]
        idx._nb0[:] = arrays["nb0"]
        idx._entry, idx._max_level = int(meta[0]), int(meta[1])
        idx._size = int(np.count_nonzero(idx._hvalid))
        for name, arr in arrays.items():
            if name.startswith("upper"):
                idx._upper[int(name[5:])] = {
                    int(row[0]): [int(v) for v in row[1:] if v >= 0] for row in arr}
        if "route_cent" in arrays:
            cent = np.asarray(arrays["route_cent"], np.float32)
            medoids = np.asarray(arrays["route_medoids"], np.int32)
            idx._cluster_route = {
                "cent": cent,
                "medoids": medoids,
                "_dev": (idx._upload(idx._prep(cent)),
                         idx._upload(np.einsum("kd,kd->k", cent, cent)
                                     .astype(np.float32)),
                         idx._upload(medoids)),
            }
            idx.seed_probes = int(arrays["route_seed_probes"][0])
        return idx
