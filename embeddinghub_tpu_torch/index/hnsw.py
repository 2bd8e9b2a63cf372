"""HNSWIndex: the twin of ``embeddinghub_tpu/index/hnsw.py``.

The same hnswlib-semantic graph in array form (reference: hnswlib
``HierarchicalNSW`` behind ``embeddingstore/index.cc:12-15``, defaults M=16,
efConstruction=200, ef=10): flat int32 neighbor tables (``[cap, 2M]`` for
layer 0, ``{node: [ids]}`` per upper layer on the host, stacked into
``[L, cap, M]`` on the device), geometric levels, greedy descent through
the upper layers, then a batched beam on layer 0.

What is ported (all of the reference's graph engine):

  * the bulk build of a cold add of at least 2048 rows, by its size, as the
    reference's ``_bulk_build``: up to ``exact_build_max`` rows each row's
    candidate pool is its exact top-``efC`` set on bf16-rounded operands
    (``ops/topk.pooled_topk_ids``, K1 on the card); up to
    ``cluster_build_max`` rows the pools come from a k-means-routed scan
    (``ops/kmeans.py``: each cluster's rows scan their ``cluster_probes``
    nearest clusters' rows, K1 on the card), followed by an exact re-pool
    of the rows nearest the routing boundary (:meth:`cluster_boundary_rows`
    then :meth:`refine`); past it, NN-descent (``ops/nn_descent.py``) and
    graph-walk refinement rounds (:meth:`_bulk_refine`).  Then heuristic
    selection at ``2M`` (``ops/nn_descent.heuristic_prune``), reciprocal
    edges with overflow-only pruning (``ops/nn_descent.gather_reciprocal``),
    random long edges into free slots, the level draws and the upper layers.
    Past ``exact_full_max`` rows only a ``stream_base`` core is bulk-built
    and the rest streams in by waves (the hybrid stream);
  * every later write, as the reference makes it: waves of up to
    ``max_wave`` rows, on the host while the graph is tiny (a cold add of
    fewer than 2048 rows starts so) and on the device after
    (``ops/wave_insert.make_wave_commit``: pools from K1 over the arena's
    live prefix and over each upper layer's members, heuristic selection,
    reciprocal commits); re-sets (unlink, then insert again), ``remove``
    and ``refine``;
  * search (``ops/wave_insert.make_graph_search``): plain, or routed by the
    centroids of :meth:`build_route` (fitted here, after a cluster-routed
    build or by itself, or a snapshot's; ``auto_seed_probes`` fits it once
    the index passes ``auto_route_min`` rows), on the bf16 walk arena
    (``EHTPU_WALK_DTYPE``) and on the packed-neighbor arena
    (``EHTPU_WALK_PACKED=1`` or :meth:`pack_walk`);
  * ``state_arrays``/``from_state`` in the reference's array names, so
    either package opens the other's graph.  A graph the JAX package built
    comes across as ``HNSWIndex.from_state(dims, metric,
    jax_index.state_arrays(), device=...)`` on its numpy arrays.

Every step draws from the same numpy generators in the same order as the
reference, so the graph is the reference's, except NN-descent's initial
graph: the reference draws it with JAX's generator, the port with a
``torch.Generator`` seeded alike (``ops/nn_descent.nn_descent`` takes an
explicit initial graph for a test to pass the reference's draw).

The device state is built whole from the host arrays after a bulk build or
a capacity growth.  After that the host's changes (host waves, re-sets,
removes) go in as deltas, and fused waves write the device tensors in
place: the device's link tables then lead until :meth:`_sync_host` pulls
them down (before host surgery and snapshots).  Every write drops the walk
arenas cached from the old graph (``WALK_CACHES``).  On CUDA every f32
product of the build and the walk runs with TF32 off
(``ops/distance.full_f32``, set here).
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
from embeddinghub_tpu_torch.ops import kmeans as km
from embeddinghub_tpu_torch.ops import nn_descent as nnd
from embeddinghub_tpu_torch.ops import topk as topk_ops
from embeddinghub_tpu_torch.ops import wave_insert
from embeddinghub_tpu_torch.utils.device import DEFAULT as DEFAULT_DEVICE
from embeddinghub_tpu_torch.utils.device import resolve as resolve_device

BULK_MIN = 2048  # a cold add of at least this many rows is one bulk build
# the reference's layer-0 wave scan goes in chunks of this many rows
SCAN_CHUNK = 1 << 19
# the NN-descent build: its iterations, and the beam width and hops of its
# graph-walk refinement rounds (_bulk_refine)
NND_ITERS = 4
REFINE_EXPAND = REFINE_HOPS = 32
# the device state's entries derived from the graph, which every write drops
WALK_CACHES = ("xa", "xp", "xp_scale")
# the parts of HNSWIndex.wave_seconds: the wave commit's device parts, the
# device state's rebuild or delta flush, the host's share of the waves, and
# the add's copies for a rollback
WAVE_SECONDS = wave_insert.WAVE_PARTS + ("rebuild", "host", "checkpoint")

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
        refine_rounds: int = 3,
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
        # Graph-walk refinement rounds of the NN-descent build (_bulk_refine).
        self.refine_rounds = int(refine_rounds)
        # The bulk build by size (the reference's defaults): exact pools up
        # to exact_build_max rows, cluster-routed ones up to
        # cluster_build_max, NN-descent beyond.
        self.exact_build_max = 2_000_000
        self.exact_refine_rounds = 0
        self.cluster_build_max = 64_000_000
        # k-means clusters of about cluster_target rows; a row's pool scans
        # its own and its cluster_probes - 1 nearest clusters' rows; then the
        # cluster_repair_frac of rows nearest the routing boundary get exact
        # pools (refine); cluster_refine_rounds adds graph-walk rounds.
        self.cluster_target = 4_096
        self.cluster_probes = 8
        self.cluster_repair_frac = 0.5
        self.cluster_refine_rounds = 0
        # The hybrid stream: past exact_full_max rows a cold add bulk-builds
        # a stream_base core and streams the rest by waves, then refines the
        # whole graph when stream_refine is set.
        self.exact_full_max = self.cluster_build_max
        self.stream_base = 65_536
        self.stream_refine = False
        # Centroid-routed multi-entry search: the beam is also seeded with
        # the medoids of the query's seed_probes nearest clusters
        # (build_route).  auto_seed_probes > 0 fits the route once the index
        # holds auto_route_min rows and again once it has doubled (the
        # store's hnsw_seed_probes knob).
        self.seed_probes = 0
        self.auto_seed_probes = 0
        self.auto_route_min = 1 << 20
        # rows a wave inserts at most (the reference's measured sweet spot:
        # wave rows do not see each other)
        self.max_wave = 4_096
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
        # host rows changed since the device state was written (deltas)
        self._dirty_vec: set[int] = set()
        self._dirty_nb0: set[int] = set()
        self._dirty_upper: dict[int, set[int]] = {}
        # True after fused waves: the device's link tables lead
        self._host_stale = False
        self._wave_fn = None
        # the host's exact copy of the device's member counts
        self._mcount_host = np.zeros(0, np.int64)
        self._hi_water: int | None = None  # see _scan_hi_water
        self._gs_fns: dict[tuple, object] = {}
        # the route: centroids, and after a cluster-routed build its
        # assignment, probe lists and build order; medoids once build_route
        # ran (see build_route)
        self._cluster_route: dict | None = None
        # the last cluster-routed build's plan: clusters, truncated probe
        # lists, own clusters cut, candidates dropped, the arena width S
        self._cluster_stats: dict | None = None
        # rows the last cluster-routed build's boundary repair re-pooled
        self.boundary_rows = 0
        # seconds of the last bulk build, by part (see _bulk_build)
        self.build_seconds: dict[str, float] = {}
        # seconds of the last add's waves, by part (WAVE_SECONDS), and the
        # waves inserted so far
        self.wave_seconds: dict[str, float] = {}
        self.waves = 0
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
        """hnswlib's ``addPoint`` for a batch (the reference's ``add``,
        ``hnsw.py:261-368``): rows already in the graph are unlinked and
        inserted again (a re-set); a cold add of ``BULK_MIN`` rows or more
        is one bulk build (of a ``stream_base`` core only, past
        ``exact_full_max`` rows), after a cluster-routed one the boundary
        repair; everything else goes in by waves of ``min(rest, max(8, graph
        size), max_wave)`` rows, on the host while the graph is tiny and by
        the fused device wave after.  An add that raises part way leaves the
        graph, its device state, the route and the level generator as they
        were."""
        rows = np.asarray(rows, dtype=np.int64).ravel()
        vecs = as_f32_matrix(vecs, self.dims)
        if rows.shape[0] != vecs.shape[0]:
            raise ValueError("rows / vecs length mismatch")
        if rows.size == 0:
            return
        self.wave_seconds = dict.fromkeys(WAVE_SECONDS, 0.0)
        t0 = time.perf_counter()
        cp = self._checkpoint(rows)
        self._sync_device()
        self.wave_seconds["checkpoint"] = time.perf_counter() - t0
        try:
            self._add(rows, vecs)
        except BaseException:
            self._rollback(cp)
            raise

    def _add(self, rows: np.ndarray, vecs: np.ndarray) -> None:
        self._ensure_capacity(int(rows.max()) + 1)
        raw = vecs.copy()
        prepped = self._prep(vecs)
        updates = self._hvalid[rows]
        # a re-set relinks the row: out of the graph, then inserted again
        for r in rows[updates]:
            self._unlink(int(r))
        self._size += int(np.count_nonzero(~updates))
        order = np.argsort(rows)  # deterministic
        pending, praw, pvecs = rows[order], raw[order], prepped[order]

        def commit_host(lo, hi, mark_dirty):
            # per wave, not up front: a wave pools against the pre-wave
            # liveness, so later waves' rows must not be live yet
            w_rows = pending[lo:hi]
            self._hx[w_rows] = praw[lo:hi]
            self._hvalid[w_rows] = True
            if mark_dirty:  # the fused wave scatters its own rows
                self._dirty_vec.update(int(r) for r in w_rows)

        streamed = False
        if self._graph_size() == 0 and len(pending) >= BULK_MIN:
            # past exact_full_max rows a core is bulk-built, the rest streams
            base = len(pending)
            if base > self.exact_full_max:
                base, streamed = self.stream_base, True
            commit_host(0, base, mark_dirty=False)  # built whole below
            self._bulk_build(pending[:base], pvecs[:base])
            self._invalidate_device()
            self._hi_water = max(self._scan_hi_water(), int(rows.max()) + 1)
            route = self._cluster_route
            if route and route.pop("fresh", False) and self.cluster_repair_frac > 0:
                # the boundary repair: exact pools over the whole arena for
                # the rows whose routed pools were neighbourhood-limited
                t0 = time.perf_counter()
                b_rows = self.cluster_boundary_rows()
                if b_rows.size:
                    self.refine(b_rows)
                self._sync_device()
                self.build_seconds["boundary_repair"] = time.perf_counter() - t0
                self.boundary_rows = int(b_rows.size)
            pending, praw, pvecs = pending[base:], praw[base:], pvecs[base:]
        tiny = max(4 * self.ef_construction, 512)
        i = 0
        while i < len(pending):
            built = max(self._graph_size(), 8)
            wave = min(len(pending) - i, max(8, built), self.max_wave)
            fused = built > tiny
            commit_host(i, i + wave, mark_dirty=not fused)
            t0 = time.perf_counter()
            parts = sum(self.wave_seconds.values())
            if fused:
                self._insert_wave_fused(pending[i:i + wave], pvecs[i:i + wave])
            else:
                self._insert_wave(pending[i:i + wave], pvecs[i:i + wave])
            # host: whatever the wave's timed parts leave
            self.wave_seconds["host"] += (time.perf_counter() - t0
                                          - sum(self.wave_seconds.values()) + parts)
            self.waves += 1
            i += wave
        if streamed and self.stream_refine:
            self.refine()
        self._hi_water = max(self._scan_hi_water(), int(rows.max()) + 1)

    def _checkpoint(self, rows: np.ndarray) -> dict:
        """What :meth:`_rollback` needs to undo an add of ``rows``: the host
        arrays it may write (the link tables only while the host copy is
        authoritative: after a fused wave the device's are), the level
        generator, and copies of the device tensors a wave writes in place
        (about 1 GB at 2**21 rows, one copy on the card)."""
        inside = rows[rows < self._cap]
        cp = {
            "scalars": (self._cap, self._entry, self._max_level, self._size,
                        self._hi_water, self._host_stale),
            "host": (self._hx, self._hvalid, self._levels, self._nb0),
            "rows": inside, "hx": self._hx[inside].copy(),
            "hvalid": self._hvalid.copy(), "levels": self._levels.copy(),
            "rng": self._rng.bit_generator.state,
            "mcount_host": self._mcount_host.copy(),
            "dirty": (set(self._dirty_vec), set(self._dirty_nb0),
                      {k: set(v) for k, v in self._dirty_upper.items()}),
            "upper": self._upper, "state": self._device_state, "device": None,
            "route": (self._cluster_route, dict(self._cluster_route or {}),
                      self._cluster_stats, self.seed_probes, self.boundary_rows),
        }
        if not self._host_stale:
            cp["nb0"] = self._nb0.copy()
            cp["upper"] = {layer: {n: list(v) for n, v in nodes.items()}
                           for layer, nodes in self._upper.items()}
        st = self._device_state
        if st is not None:
            rows_d = torch.from_numpy(inside).to(self.device)
            cp["device"] = {name: st[name].clone() for name in (
                "valid", "levels", "nb0", "ustack", "members", "mcount")}
            cp["device"]["rows"] = rows_d
            cp["device"]["x_rows"] = st["x"][rows_d].clone()
            cp["device"]["x_sq_rows"] = st["x_sq"][rows_d].clone()
        return cp

    def _rollback(self, cp: dict) -> None:
        (self._cap, self._entry, self._max_level, self._size,
         self._hi_water, self._host_stale) = cp["scalars"]
        self._hx, self._hvalid, self._levels, self._nb0 = cp["host"]
        self._hx[cp["rows"]] = cp["hx"]
        self._hvalid[:] = cp["hvalid"]
        self._levels[:] = cp["levels"]
        if "nb0" in cp:
            self._nb0[:] = cp["nb0"]
        self._upper = cp["upper"]
        self._rng.bit_generator.state = cp["rng"]
        self._mcount_host = cp["mcount_host"]
        route, fields, self._cluster_stats, self.seed_probes, self.boundary_rows = cp["route"]
        if route is not None:  # the same dict, its entries as they were
            route.clear()
            route.update(fields)
        self._cluster_route = route
        vec, nb0, upper = cp["dirty"]
        self._dirty_vec, self._dirty_nb0, self._dirty_upper = vec, nb0, upper
        st, dev = cp["state"], cp["device"]
        if st is not None:
            for name in ("valid", "levels", "nb0", "ustack", "members", "mcount"):
                st[name] = dev[name]
            st["x"][dev["rows"]] = dev["x_rows"]
            st["x_sq"][dev["rows"]] = dev["x_sq_rows"]
            for name in WALK_CACHES:
                st.pop(name, None)
        self._device_state = st

    def remove(self, rows: np.ndarray) -> None:
        rows = np.asarray(rows, dtype=np.int64).ravel()
        for r in rows:
            r = int(r)
            if 0 <= r < self._cap and self._hvalid[r]:
                self._unlink(r)
                self._hvalid[r] = False
                self._size -= 1
                self._dirty_vec.add(r)  # the liveness delta

    def _unlink(self, r: int) -> None:
        """Take ``r`` out of the graph: its lists, and ``r`` from the lists
        of the rows it links to (hnswlib leaves other rows' edges to it;
        the walk skips dead rows)."""
        self._sync_host()  # after fused waves the device tables lead
        peers = self._nb0[r]
        for p in peers[peers >= 0]:
            lst = self._nb0[p]
            lst[lst == r] = -1
            self._dirty_nb0.add(int(p))
        self._nb0[r] = -1
        self._dirty_nb0.add(r)
        lvl = int(self._levels[r])
        for layer in range(1, lvl + 1):
            nodes = self._upper.get(layer, {})
            mine = nodes.pop(r, [])
            dirty = self._dirty_upper.setdefault(layer, set())
            dirty.add(r)
            for p in mine:
                if p in nodes:
                    nodes[p] = [y for y in nodes[p] if y != r]
                    dirty.add(int(p))
        self._levels[r] = -1
        if r == self._entry:
            self._pick_new_entry()

    def _pick_new_entry(self) -> None:
        self._entry, self._max_level = -1, -1
        live = np.flatnonzero(self._levels >= 0)
        if live.size:
            lv = self._levels[live]
            j = int(np.argmax(lv))
            self._entry = int(live[j])
            self._max_level = int(lv[j])

    def refine(self, rows: np.ndarray | None = None) -> None:
        """Layer-0 repair (the reference's ``refine``, ``hnsw.py:370-452``):
        the given rows (default: every row in the graph) get new forward
        lists from exact pools over the whole live arena (K1 with bf16
        operands, ``k = next_pow2(efC)``, heuristic selection at ``2M``),
        then the whole layer is symmetrized again.  Levels, the entry and
        the upper layers stay."""
        self._sync_host()
        if rows is None:
            rows = np.flatnonzero(self._levels >= 0)
        rows = np.asarray(rows, np.int64).ravel()
        rows = rows[self._hvalid[rows]]
        if rows.size == 0 or self._graph_size() == 0:
            return
        state = self._device_arrays()
        xd, xsqd, validd = state["x"], state["x_sq"], state["valid"]
        cap = self._cap
        hi = max(1, min(self._scan_hi_water(), cap))
        pool_k = min(next_pow2(self.ef_construction, floor=64), cap)
        metric = self.metric if self.metric != "cosine" else "ip"
        # the current lists seed the rows not refined; dead rows add no edge
        fwd = torch.where(self._upload(self._hvalid)[:, None],
                          self._upload(self._nb0).to(torch.int64), -1)
        for s in range(0, len(rows), self.max_wave):
            grp = rows[s:s + self.max_wave]
            qv = self._prep(self._hx[grp].astype(np.float32))
            qd = self._upload(qv)
            ids = topk_ops.pooled_topk_ids(
                qd, xd[:hi], validd[:hi], xsqd[:hi], metric=metric,
                k=min(pool_k, hi)).to(torch.int64)
            grp_d = self._upload(grp)
            ids = torch.where(ids == grp_d[:, None], -1, ids)
            fwd[grp_d] = nnd.heuristic_prune(
                xd, xsqd, ids, m_keep=self.m0, metric=self.metric,
                cand_k=ids.shape[1], q=qd, q_sq=self._upload(
                    np.einsum("wd,wd->w", qv, qv)))[:, :self.m0]
        nb0 = self._symmetrize_device(fwd, xd, xsqd, cap, cap)
        dead = ~self._hvalid
        nb0[dead] = -1
        nb0[(nb0 >= 0) & dead[np.clip(nb0, 0, cap - 1)]] = -1
        self._nb0[:] = nb0
        state["nb0"] = self._upload(nb0)
        for name in WALK_CACHES:
            state.pop(name, None)
        self._host_stale = False

    def cluster_boundary_rows(self, frac: float | None = None) -> np.ndarray:
        """The rows of the last cluster-routed build with the smallest
        routing margins (``ops/kmeans.boundary_margins``), the
        ``cluster_repair_frac`` of them by default: the rows whose pools
        were held to a probed neighbourhood their true neighbours may
        straddle.  :meth:`refine` of them is the boundary repair, the
        cluster-routed build's default post-pass (:meth:`add`)."""
        route = self._cluster_route
        if not route or "rows" not in route:
            return np.empty(0, np.int64)
        frac = self.cluster_repair_frac if frac is None else frac
        rows = route["rows"]
        take = int(rows.size * max(0.0, min(1.0, frac)))
        if take == 0:
            return np.empty(0, np.int64)
        # the device arena gathered into build order
        xd = self._device_arrays()["x"][self._upload(rows)]
        margins = km.boundary_margins(xd, self._upload(route["cent"]), route["assign"],
                                      route["probes"])
        return rows[np.argsort(margins, kind="stable")[:take]]

    def build_route(self, seed_probes: int = 8, k: int | None = None):
        """Centroid-routed multi-entry search (the reference's
        ``build_route``, ``hnsw.py:1812-1896``): the k-means route of the
        cluster-routed build, or one fitted now on a sample of at most 2**18
        live rows (``k`` clusters, by default about one per
        ``cluster_target`` rows), and again once the index has doubled
        since the route was built; then each cluster's medoid, the live row
        nearest its centroid.  From then on every layer-0 beam also starts
        from the medoids of the query's ``seed_probes`` nearest clusters.
        Everything is computed before anything is kept, so a failure leaves
        the index as it was."""
        route = self._cluster_route
        state = self._device_arrays()
        if route is not None and route.get("built_size") \
                and self._size >= 2 * route["built_size"]:
            route = None  # the index doubled: refit
        # (a snapshot's route holds no assignment, which the medoids need:
        # the reference fails on it, the port refits)
        if route is None or "assign" not in route:
            if k is None:
                k = max(16, next_pow2(max(1, self._size // max(self.cluster_target, 1)),
                                      floor=16))
            self._sync_host()
            live = np.flatnonzero(self._hvalid)
            samp = live[:: max(1, live.size // (1 << 18))][: 1 << 18]
            cent = km.fit_kmeans(self._upload(self._prep(self._hx[samp])), k,
                                 iters=8, seed=11, limit=samp.size)
            route = {"cent": cent.cpu().numpy(),
                     "assign": km.assign_clusters(state["x"], cent)}
        route = dict(route)
        cent, cap = route["cent"], self._cap
        assign = np.full((cap,), -1, np.int64)
        if "rows" in route:
            # a cluster-routed build's assignment is in build order (the
            # reference reads it as row order, the same when the rows were
            # 0..n-1)
            assign[route["rows"]] = route["assign"]
        else:
            assign[: min(cap, route["assign"].shape[0])] = route["assign"][:cap]
        # each row's squared distance to its centroid, in chunks
        cent_d = self._upload(cent)
        d2 = torch.empty((cap,), dtype=torch.float32, device=self.device)
        safe = self._upload(np.maximum(assign, 0))
        for s in range(0, cap, 1 << 18):
            d2[s:s + (1 << 18)] = ((state["x"][s:s + (1 << 18)]
                                    - cent_d[safe[s:s + (1 << 18)]]) ** 2).sum(dim=1)
        d2 = d2.cpu().numpy()
        d2[~state["valid"][:cap].cpu().numpy()] = np.inf
        d2[assign < 0] = np.inf
        # the medoid of a cluster: its live row nearest the centroid
        medoids = np.full((cent.shape[0],), -1, np.int32)
        order = np.lexsort((d2, assign))
        ga = assign[order]
        heads = np.flatnonzero(np.concatenate([[True], ga[1:] != ga[:-1]]))
        ok = (ga[heads] >= 0) & np.isfinite(d2[order[heads]])
        medoids[ga[heads[ok]]] = order[heads[ok]]
        route["medoids"] = medoids
        route["built_size"] = self._size
        route["_dev"] = (self._upload(self._prep(cent.astype(np.float32))),
                         self._upload(np.einsum("kd,kd->k", cent, cent).astype(np.float32)),
                         self._upload(medoids))
        self._cluster_route = route
        self.seed_probes = int(seed_probes)
        return self

    def _ensure_capacity(self, need: int) -> None:
        if need <= self._cap:
            return
        # the device's link tables lead after fused waves: pull them down
        # at the old capacity before the host arrays grow
        self._sync_host()
        new_cap = next_pow2(need, floor=self._cap)
        for name, fill in (("_hx", 0), ("_hvalid", False), ("_levels", -1),
                           ("_nb0", -1)):
            old = getattr(self, name)
            grown = np.full((new_cap,) + old.shape[1:], fill, dtype=old.dtype)
            grown[: self._cap] = old
            setattr(self, name, grown)
        self._cap = new_cap
        self._invalidate_device()

    # ------------------------------------------------------------- bulk build

    def _bulk_build(self, rows: np.ndarray, pvecs: np.ndarray) -> None:
        """Bulk construction (``hnsw.py:484-609`` of the reference): layer 0
        by the branch the row count picks (exact pools up to
        ``exact_build_max``, cluster-routed ones up to
        ``cluster_build_max``, NN-descent and refinement rounds beyond), each
        followed by the same symmetrize; then random long edges, levels and
        upper layers.  Records its seconds by part in ``build_seconds``: the
        branch's own parts (exact: pools, K1; cluster-routed: kmeans, plan,
        routed_pools, K1 over each block's gathered candidates; NN-descent:
        nn_descent, refine), prune, symmetrize, upper (the upper layers,
        their own pools included) and host (everything else: padding,
        upload, long edges, id mapping, level draws).  :meth:`add` adds the
        boundary repair's seconds."""
        t_start = time.perf_counter()
        n = len(rows)
        exact, routed = n <= self.exact_build_max, n <= self.cluster_build_max
        first = (("pools",) if exact else ("kmeans", "plan", "routed_pools") if routed
                 else ("nn_descent",))
        self.build_seconds = dict.fromkeys(
            first + ("prune", "symmetrize", "upper", "host"), 0.0)
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

        if exact or routed:
            if exact:
                fwd = self._exact_build_fwd(xd, xsq, n, padded, block)
            else:
                fwd = self._cluster_build_fwd(xd, xsq, n, padded)
                self._cluster_route["rows"] = rows.astype(np.int64)
            t0 = time.perf_counter()
            nb_local = self._symmetrize_device(fwd, xd, xsq, n, padded)
            self.build_seconds["symmetrize"] = time.perf_counter() - t0
            del fwd
            rounds = self.exact_refine_rounds if exact else self.cluster_refine_rounds
            if rounds:
                nb_local = self._bulk_refine(xd, xsq, nb_local, n, padded, rounds)
        else:
            t0 = time.perf_counter()
            m0 = min(self.m0, 32)
            nb = nnd.nn_descent(xd, xsq, m=m0, iters=NND_ITERS, block=block,
                                metric=self.metric,
                                generator=torch.Generator(device=self.device).manual_seed(0))
            self._sync_device()
            t1 = time.perf_counter()
            self.build_seconds["nn_descent"] = t1 - t0
            # forward and reverse-sample candidates, then the heuristic
            cand = torch.cat([nb, nnd.reverse_sample(nb)], dim=1)
            nb_local = nnd.heuristic_prune(xd, xsq, cand, m_keep=self.m0,
                                           metric=self.metric, cand_k=2 * m0)
            nb_local = nb_local.cpu().numpy().astype(np.int32)
            nb_local[n:] = -1
            nb_local = np.where(nb_local >= n, -1, nb_local)  # drop pads
            self.build_seconds["prune"] = time.perf_counter() - t1
            del nb, cand
            nb_local = self._bulk_refine(xd, xsq, nb_local, n, padded)
        del xd, xsq

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

    def _cluster_build_fwd(self, xd, xsqd, n: int, padded: int):
        """Forward link lists from cluster-routed pools (the reference's
        ``_cluster_build_fwd``, ``hnsw.py:723-910``): k-means the rows into
        about ``n / cluster_target`` clusters; each cluster's rows, in query
        blocks of up to ``min(cluster_target, 4096)``, scan a candidate
        arena made of their ``cluster_probes`` nearest clusters' rows (own
        cluster first), cut to ``S = next_pow2(probes * target)`` rows;
        heuristic selection at ``m0`` over each row's ``next_pow2(efC)``
        best.  Scan work grows as ``n * S``, not ``n**2``.  Keeps the route
        (centroids, assignment, probe lists; ``fresh`` asks :meth:`add` for
        the boundary repair) and the plan's counts in ``_cluster_stats``.
        Returns a device ``[padded, m0]`` tensor of local ids (-1 past
        ``n``)."""
        secs = self.build_seconds
        t0 = time.perf_counter()
        target = self.cluster_target
        qb = min(target, 4096)
        k = max(16, next_pow2(max(1, n // target), floor=16))
        cent = km.fit_kmeans(xd, k, iters=8, seed=11, limit=n,
                             sample=min(n, max(1 << 18, 64 * k)))
        assign = km.assign_clusters(xd[:n], cent)
        probes = km.probe_order(cent)[:, : max(self.cluster_probes, 1)]
        self._cluster_route = {"cent": cent.cpu().numpy(), "assign": assign,
                               "probes": probes, "fresh": True}
        t1 = time.perf_counter()
        secs["kmeans"] += t1 - t0

        # the plan, on the host: members sorted stably by cluster; a
        # cluster's candidate arena is its probe list's members, cut or
        # padded with -1 to S
        order = np.argsort(assign, kind="stable")
        sorted_assign = assign[order]
        starts = np.searchsorted(sorted_assign, np.arange(k))
        ends = np.searchsorted(sorted_assign, np.arange(k), side="right")
        members = [order[starts[c]:ends[c]] for c in range(k)]
        S = next_pow2(self.cluster_probes * target, floor=qb)
        # a probe list longer than S loses its tail (the own cluster leads);
        # an own cluster larger than S loses own rows too (own_truncated)
        stats = {"clusters": 0, "truncated": 0, "own_truncated": 0,
                 "dropped_cands": 0, "total_cands": 0, "S": int(S)}
        arenas, blocks = [], []   # blocks: (arena index, query rows)
        for c in range(k):
            mem = members[c]
            if mem.size == 0:
                continue
            stats["clusters"] += 1
            cand = np.concatenate([members[p] for p in probes[c]])
            stats["total_cands"] += int(cand.size)
            if cand.size >= S:
                stats["truncated"] += int(cand.size > S)
                stats["dropped_cands"] += int(cand.size - S)
                if mem.size > S:
                    stats["own_truncated"] += 1
                    # spread the cut over the own cluster, so that every
                    # region of it keeps rows in the arena
                    own_keep = max(S // 2, S - qb)
                    cand = np.concatenate([
                        mem[np.linspace(0, mem.size - 1, own_keep).astype(np.int64)],
                        cand[mem.size:], np.full(S, -1, np.int64)])[:S]
                else:
                    cand = cand[:S]
            else:
                cand = np.concatenate([cand, np.full(S - cand.size, -1, np.int64)])
            blocks += [(len(arenas), mem[s:s + qb]) for s in range(0, mem.size, qb)]
            arenas.append(cand)
        self._cluster_stats = stats
        arenas_d = self._upload(np.stack(arenas).astype(np.int64))
        queries_d = self._upload(np.concatenate([blk for _, blk in blocks]).astype(np.int64))
        pool_k = min(next_pow2(self.ef_construction, floor=64), S)
        metric = self.metric if self.metric != "cosine" else "ip"
        fwd = torch.full((padded, self.m0), -1, dtype=torch.int64, device=self.device)
        self._sync_device()
        t2 = time.perf_counter()
        secs["plan"] += t2 - t1

        # the routed scan: each block's own rows only (no padding), so every
        # scatter below writes unique rows
        at = 0
        for a, blk in blocks:
            qids = queries_d[at:at + blk.size]
            at += blk.size
            ids_b = self._routed_pool(xd, xsqd, qids, arenas_d[a], pool_k, metric)
            self._sync_device()
            t3 = time.perf_counter()
            fwd[qids] = nnd.heuristic_prune(
                xd, xsqd, ids_b, m_keep=self.m0, metric=self.metric, cand_k=pool_k,
                q=xd[qids], q_sq=xsqd[qids])[:, :self.m0]
            self._sync_device()
            t4 = time.perf_counter()
            secs["routed_pools"] += t3 - t2
            secs["prune"] += t4 - t3
            t2 = t4
        real = (torch.arange(padded, device=self.device) < n)[:, None]
        return torch.where(real & (fwd < n), fwd, -1)

    def _routed_pool(self, xd, xsqd, qids, cids, pool_k: int, metric: str):
        """The ``pool_k`` best candidates of each query row ``qids [B]``
        among the candidate rows ``cids [S]`` (-1 padded), the query's own
        row left out: the rows gathered into a compact sub-arena, K1 with
        bf16 operands over it on the card (its plain version on the CPU).
        The reference masks each query's own row before its top-k; K1 masks
        rows, not (query, row) pairs, so it is asked for ``pool_k + 1`` and
        then the own row goes, or the last column where the own row is not
        among them.  Returns ``[B, pool_k]`` global ids, nearest first, -1
        padded."""
        safe = cids.clamp(min=0)
        kk = min(pool_k + 1, cids.shape[0])
        local = topk_ops.pooled_topk_ids(
            xd[qids], fused_topk.arena_f32(xd[safe]), cids >= 0, xsqd[safe],
            metric=metric, k=kk).to(torch.int64)
        ids = torch.where(local >= 0, cids[local.clamp(min=0)], -1)
        drop = ids == qids[:, None]
        if kk > pool_k:
            drop[:, -1] |= ~drop.any(dim=1)
        keep = torch.argsort(drop.to(torch.int8), dim=1, stable=True)[:, :pool_k]
        ids = torch.where(torch.gather(drop, 1, keep), -1, torch.gather(ids, 1, keep))
        return wave_insert._pad_cols(ids, pool_k)

    def _bulk_refine(self, xd, xsqd, nb_local: np.ndarray, n: int, padded: int,
                     rounds: int | None = None) -> np.ndarray:
        """Graph-walk refinement of a layer-0 table in local ids (the
        reference's ``_bulk_refine``, ``hnsw.py:1000-1088``), ``rounds``
        rounds (``refine_rounds`` by default).  A round beam-searches every
        row on the current graph from the medoid of the rows (ef 64, the
        last round ``min(efC, 512)``; ``REFINE_EXPAND`` wide,
        ``REFINE_HOPS`` hops), selects ``m0`` links by the heuristic from
        the found ids and the current list, and symmetrizes.  Adds its
        seconds to ``build_seconds["refine"]``."""
        rounds = self.refine_rounds if rounds is None else int(rounds)
        if rounds <= 0 or n < 8:
            return nb_local
        t_start = time.perf_counter()
        m0 = self.m0
        ef_final = min(self.ef_construction, 512)
        schedule = [min(64, ef_final)] * (rounds - 1) + [ef_final]
        validd = torch.arange(padded, device=self.device) < n
        # the medoid of the rows is every search's entry (the mean summed in
        # f64, the l2 distances to it in chunks: no arena-sized temporary)
        xq = xd[:n]
        mean = (xq.sum(0, dtype=torch.float64) / n).to(torch.float32)
        if self.metric == "l2":
            step = 1 << 20
            d = torch.cat([((xq[s:s + step] - mean) ** 2).sum(1)
                           for s in range(0, n, step)])
            entry_local = int(d.argmin())
        else:
            entry_local = int((xq @ mean).argmax())
        bq = 4096 if n >= 4096 else next_pow2(n, floor=8)
        entries = torch.full((bq,), entry_local, dtype=torch.int64, device=self.device)
        self_col = torch.arange(n, device=self.device)[:, None]
        for ef in schedule:
            nbd = self._upload(nb_local)
            found = []
            for s in range(0, n, bq):
                e = min(s + bq, n)
                # the block's first row pads a short block (the beam's exit
                # is over the whole batch, as in the reference)
                q = xq[s].expand(bq, self.dims).clone()
                q[: e - s] = xq[s:e]
                _, ids_b = beam_ops.beam_search(
                    q, entries, nbd, xd, xsqd, validd,
                    metric=self.metric, ef=ef, expand=REFINE_EXPAND,
                    max_hops=REFINE_HOPS)
                found.append(ids_b[: e - s].to(torch.int32))
            cand = torch.full((padded, ef + m0), -1, dtype=torch.int32, device=self.device)
            cand[:n, :ef] = torch.cat(found)
            cand[:n, ef:] = nbd[:n]
            cand[:n] = torch.where(cand[:n] == self_col, -1, cand[:n])
            pruned = nnd.heuristic_prune(xd, xsqd, cand, m_keep=m0,
                                         metric=self.metric, cand_k=ef + m0)
            pruned[n:] = -1
            nb_local = self._symmetrize_device(pruned, xd, xsqd, n, padded)
        self.build_seconds["refine"] = (self.build_seconds.get("refine", 0.0)
                                        + time.perf_counter() - t_start)
        return nb_local

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

    # ----------------------------------------------------- fused insert wave

    def _insert_wave_fused(self, rows: np.ndarray, pvecs: np.ndarray) -> None:
        """One wave on the device (``ops/wave_insert.make_wave_commit``):
        pools, forward selection, reciprocal links and the vector scatter
        write the device state in place.  Nothing comes back: the device's
        link tables lead until :meth:`_sync_host`."""
        levels = np.asarray([self._assign_level() for _ in rows], np.int32)
        old_max = self._max_level
        new_max = max(old_max, int(levels.max(initial=0)))

        self._dirty_vec.difference_update(int(r) for r in rows)
        t0 = time.perf_counter()
        before = self._device_state
        state = self._device_arrays()
        self._sync_device()
        self.wave_seconds["rebuild"] += time.perf_counter() - t0
        hi = self._scan_hi_water()
        if state is not before:
            # A state built whole now read the host's liveness after this
            # wave's rows were committed, so they are live in its pools, as
            # in the reference's, whose scan reaches them in whole chunks
            # of SCAN_CHUNK rows (the whole arena below one chunk).
            ext = self._cap if self._cap <= SCAN_CHUNK else min(
                self._cap, -(-hi // SCAN_CHUNK) * SCAN_CHUNK)
            hi = max(hi, min(ext, int(rows.max()) + 1))

        # a wave that raises the top level grows the stack by empty layers:
        # it links only up to the old top, as hnswlib's new entry point
        # has no links above it until a peer arrives
        ustack, members, mcount = state["ustack"], state["members"], state["mcount"]
        if new_max > ustack.shape[0]:
            ustack = torch.cat([ustack, torch.full(
                (new_max - ustack.shape[0], self._cap, self.m), -1,
                dtype=ustack.dtype, device=self.device)])
            grow = new_max - members.shape[0]
            members = torch.cat([members, torch.full(
                (grow, members.shape[1]), -1, dtype=members.dtype,
                device=self.device)])
            mcount = torch.cat([mcount, torch.zeros(
                (grow,), dtype=mcount.dtype, device=self.device)])
            self._mcount_host = np.concatenate(
                [self._mcount_host, np.zeros((grow,), np.int64)])
        # widen the member lists if this wave's appends could overflow them
        # (the host's counts are the device's, exactly)
        L_now = int(members.shape[0])
        if L_now:
            adds = np.array([int((levels >= layer).sum())
                             for layer in range(1, L_now + 1)], np.int64)
            need = int((self._mcount_host[:L_now] + adds).max())
            S_now = new_S = int(members.shape[1])
            while new_S < need:
                new_S *= 2
            if new_S > S_now:
                members = torch.cat([members, torch.full(
                    (L_now, new_S - S_now), -1, dtype=members.dtype,
                    device=self.device)], dim=1)

        if self._wave_fn is None:
            self._wave_fn = wave_insert.make_wave_commit(
                metric=self.metric, m=self.m, m0=self.m0,
                ef_construction=self.ef_construction)
        link_top = np.minimum(levels, max(old_max, 0))
        out = self._wave_fn(
            state["x"], state["x_sq"], state["valid"], state["levels"],
            state["nb0"], ustack, members, mcount,
            self._upload(rows), self._upload(pvecs),
            self._upload(np.einsum("wd,wd->w", pvecs, pvecs)),
            self._upload(levels), self._upload(link_top), hi,
            seconds=self.wave_seconds)
        (state["x"], state["x_sq"], state["valid"], state["levels"],
         state["nb0"], state["ustack"], state["members"], state["mcount"]) = out
        for name in WALK_CACHES:
            state.pop(name, None)
        self._hi_water = max(self._scan_hi_water(), int(rows.max()) + 1)
        # the device appended the same members
        for layer in range(1, int(state["ustack"].shape[0]) + 1):
            self._mcount_host[layer - 1] += int((levels >= layer).sum())
        self._host_stale = True
        for j, r in enumerate(rows):
            lvl = int(levels[j])
            self._levels[r] = lvl
            if lvl > self._max_level:
                self._entry, self._max_level = int(r), lvl

    def _sync_host(self) -> None:
        """Download the device's link tables into the host copy, which the
        fused waves leave behind; needed before host surgery (re-sets,
        removes, refine) and snapshots."""
        if not self._host_stale or self._device_state is None:
            self._host_stale = False
            return
        state = self._device_state
        self._nb0[:] = state["nb0"].cpu().numpy()
        ustack = state["ustack"].cpu().numpy()
        self._upper = {}
        for layer in range(1, ustack.shape[0] + 1):
            nodes = np.flatnonzero(self._levels >= layer)
            tbl = ustack[layer - 1]
            self._upper[layer] = {int(nd): [int(v) for v in tbl[nd] if v >= 0]
                                  for nd in nodes}
        self._host_stale = False

    # ------------------------------------------------------------ host waves

    def _insert_wave(self, rows: np.ndarray, pvecs: np.ndarray) -> None:
        """A wave into a tiny graph, on the host: exact candidates per layer
        from numpy, then the links (:meth:`_commit_wave_links`)."""
        levels = np.asarray([self._assign_level() for _ in rows], np.int32)
        if self._entry < 0:
            # bootstrap: the first row is the entry point
            first = int(rows[0])
            self._levels[first] = levels[0]
            self._entry, self._max_level = first, int(levels[0])
            for layer in range(1, levels[0] + 1):
                self._upper.setdefault(layer, {})[first] = []
                self._dirty_upper.setdefault(layer, set()).add(first)
            rows, pvecs, levels = rows[1:], pvecs[1:], levels[1:]
            if len(rows) == 0:
                return
        searched_max = self._max_level  # the layers the candidates cover
        cand_ids = self._search_candidates(pvecs, self.ef_construction)
        self._commit_wave_links(rows, pvecs, levels, searched_max, cand_ids)
        for j, r in enumerate(rows):
            r = int(r)
            lvl = int(levels[j])
            self._levels[r] = lvl
            for layer in range(self._max_level + 1, lvl + 1):
                self._upper.setdefault(layer, {})[r] = []
                self._dirty_upper.setdefault(layer, set()).add(r)
            if lvl > self._max_level:
                self._entry, self._max_level = r, lvl

    def _commit_wave_links(self, rows, pvecs, levels, searched_max, cand_ids) -> None:
        """A host wave's links: one heuristic selection of ``M`` for every
        (layer, row) pair, reciprocal edges appended where they fit, then
        one heuristic re-prune per ``mmax`` class for the lists that
        overflow."""
        state = self._device_arrays()
        metric = "ip" if self.metric != "l2" else "l2"
        q_sq_all = np.einsum("wd,wd->w", pvecs, pvecs)
        top = min(int(levels.max(initial=0)), searched_max)
        pairs = [(layer, j) for layer in range(top, -1, -1)
                 for j in range(len(rows)) if min(int(levels[j]), searched_max) >= layer]
        if not pairs:
            return
        cw = 128
        ids_p = np.full((len(pairs), cw), -1, np.int64)
        for i, (layer, j) in enumerate(pairs):
            ids = cand_ids[layer][j]
            ids_p[i, :min(cw, len(ids))] = ids[:cw]
        js = np.asarray([j for _, j in pairs])
        pruned = nnd.heuristic_prune(
            state["x"], state["x_sq"], self._upload(ids_p), m_keep=self.m,
            metric=metric, cand_k=cw, q=self._upload(pvecs[js]),
            q_sq=self._upload(q_sq_all[js])).cpu().numpy()

        overflow: dict[int, list] = {0: [], 1: []}
        for layer in range(top, -1, -1):
            mmax = self.m0 if layer == 0 else self.m
            recip: dict[int, list[int]] = {}
            for i, (lyr, j) in enumerate(pairs):
                if lyr != layer:
                    continue
                r = int(rows[j])
                sel = pruned[i][pruned[i] >= 0]
                self._set_links(r, layer, sel)
                for t in sel:
                    recip.setdefault(int(t), []).append(r)
            for t, new_ns in recip.items():
                cur = self._links_of(t, layer)
                if len(cur) + len(new_ns) <= mmax:
                    self._set_links(t, layer, np.asarray(cur + new_ns, np.int64))
                else:
                    overflow[1 if layer else 0].append(
                        (layer, t, (cur + new_ns)[: 2 * mmax]))

        for cls, items in overflow.items():
            if not items:
                continue
            mmax = self.m if cls else self.m0
            width = next_pow2(2 * mmax, floor=8)
            cm = np.full((len(items), width), -1, np.int64)
            for i, (_, _, cand) in enumerate(items):
                cm[i, : len(cand)] = cand
            tvecs = self._prep(self._hx[np.asarray([t for _, t, _ in items])])
            pruned_t = nnd.heuristic_prune(
                state["x"], state["x_sq"], self._upload(cm), m_keep=mmax,
                metric=metric, cand_k=width, q=self._upload(tvecs),
                q_sq=self._upload(np.einsum("td,td->t", tvecs, tvecs))
            ).cpu().numpy()
            for i, (layer, t, _) in enumerate(items):
                self._set_links(t, layer, pruned_t[i][pruned_t[i] >= 0])

    def _links_of(self, node: int, layer: int) -> list[int]:
        if layer == 0:
            lst = self._nb0[node]
            return [int(v) for v in lst[lst >= 0]]
        return list(self._upper.get(layer, {}).get(node, []))

    def _search_candidates(self, pvecs, ef):
        """Each wave row's ``ef`` nearest nodes on every layer of a tiny
        graph, exactly, in numpy: ``{layer: ids [W, ef]}`` (-1 padded)."""
        w = len(pvecs)
        out = {}
        for layer in range(0, self._max_level + 1):
            nodes = self._layer_nodes(layer)
            if nodes.size == 0:
                out[layer] = np.full((w, ef), -1, np.int64)
                continue
            nv = self._prep(self._hx[nodes])
            if self.metric == "l2":
                dmat = ((pvecs[:, None, :] - nv[None, :, :]) ** 2).sum(-1)
            else:
                dmat = 1.0 - pvecs @ nv.T
            kk = min(ef, nodes.size)
            ids = nodes[np.argsort(dmat, axis=1)[:, :kk]]
            out[layer] = np.pad(ids, ((0, 0), (0, ef - kk)), constant_values=-1)
        return out

    def _layer_nodes(self, layer: int) -> np.ndarray:
        if layer == 0:
            return np.flatnonzero(self._levels >= 0)
        return np.asarray(sorted(self._upper.get(layer, {})), np.int64)

    def _set_links(self, r: int, layer: int, targets: np.ndarray) -> None:
        if layer == 0:
            lst = np.full((self.m0,), -1, np.int32)
            lst[: len(targets)] = targets
            self._nb0[r] = lst
            self._dirty_nb0.add(int(r))
        else:
            self._upper.setdefault(layer, {})[r] = [int(t) for t in targets]
            self._dirty_upper.setdefault(layer, set()).add(int(r))

    # ----------------------------------------------------------------- search

    def _invalidate_device(self) -> None:
        if self._host_stale:
            self._sync_host()  # the device's tables lead: keep them
        self._device_state = None
        self._clear_dirty()

    def _clear_dirty(self) -> None:
        self._dirty_vec.clear()
        self._dirty_nb0.clear()
        self._dirty_upper.clear()

    def _upper_rows(self, layer: int, rows: np.ndarray) -> np.ndarray:
        nodes = self._upper.get(layer, {})
        tbl = np.full((len(rows), self.m), -1, np.int32)
        for i, r in enumerate(rows):
            lst = nodes.get(int(r))
            if lst:
                tbl[i, : min(len(lst), self.m)] = lst[: self.m]
        return tbl

    def _flush_delta(self, state) -> None:
        """Write the rows the host changed into the device state in place:
        O(changed rows) instead of the whole graph.  Each scatter's rows are
        a set, so unique."""
        if self._dirty_vec:
            vrows = np.fromiter(sorted(self._dirty_vec), np.int64)
            vecs = self._prep(self._hx[vrows])
            vr = self._upload(vrows)
            state["x"][vr] = self._upload(vecs)
            state["x_sq"][vr] = self._upload(np.einsum("rd,rd->r", vecs, vecs))
            state["valid"][vr] = self._upload(self._hvalid[vrows])
            state["levels"][vr] = self._upload(self._levels[vrows])
        if self._dirty_nb0:
            nrows = np.fromiter(sorted(self._dirty_nb0), np.int64)
            state["nb0"][self._upload(nrows)] = self._upload(self._nb0[nrows])
        if self._dirty_vec or self._dirty_nb0:
            for name in WALK_CACHES:
                state.pop(name, None)
        for layer, dirty in self._dirty_upper.items():
            if not dirty:
                continue
            if layer > state["ustack"].shape[0]:
                # a host wave raised the top level: rebuild the stack
                self._device_state = None
                self._device_arrays()
                return
            rows = np.fromiter(sorted(dirty), np.int64)
            state["ustack"][layer - 1, self._upload(rows)] = self._upload(
                self._upper_rows(layer, rows))
        if self._dirty_upper:
            # host surgery may have added or dropped upper-layer rows: the
            # member lists come from the host's levels again
            members, mcount = self._build_members_host(int(state["ustack"].shape[0]))
            state["members"] = self._upload(members)
            state["mcount"] = self._upload(mcount)
        self._clear_dirty()

    def _device_arrays(self) -> dict:
        """The device graph: the prepped f32 arena, its squared norms (from
        the host, as the reference's), liveness, levels, layer-0 table, the
        ``[L, cap, M]`` stack of upper tables and the per-layer member
        lists.  Built whole from the host arrays after a build or a
        capacity growth; after that the host's changes are written in as
        deltas (:meth:`_flush_delta`) and fused waves write it directly."""
        if self._device_state is not None:
            if self._dirty_vec or self._dirty_nb0 or self._dirty_upper:
                self._flush_delta(self._device_state)
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
        self._clear_dirty()
        return self._device_state

    def _scan_hi_water(self) -> int:
        """The arena's high-water mark, 1 + the largest row ever live: the
        layer-0 wave pool scans only the rows below it.  It never falls (a
        stale high value only scans dead rows)."""
        if self._hi_water is None:
            live = np.flatnonzero(self._hvalid)
            self._hi_water = int(live[-1]) + 1 if live.size else 0
        return self._hi_water

    def _member_slab_width(self) -> int:
        """Width S of the per-upper-layer member lists: about twice the
        expected layer-1 population (cap/M)."""
        return int(next_pow2(max(4096, self._cap // 8)))

    def _build_members_host(self, L: int):
        """``[L, S]`` member ids and counts from the host's levels (and the
        host's exact copy of the counts); S grows past the default width
        when a layer needs it."""
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
        self._mcount_host = mcount.astype(np.int64)
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
        if self.auto_seed_probes > 0 and self._size >= self.auto_route_min and (
                route.get("_dev") is None
                or self._size >= 2 * route.get("built_size", self._size + 1)):
            self.build_route(self.auto_seed_probes)
            route = self._cluster_route
        # the beam starts from the descent's entry and the seeds, fewer than
        # ef_l in all (the reference allows ef_l - 1 seeds, one too many: its
        # beam then refuses the search)
        seeds = (min(self.seed_probes, ef_l - 2)
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
        self._sync_host()  # fused waves leave the host's tables behind
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
