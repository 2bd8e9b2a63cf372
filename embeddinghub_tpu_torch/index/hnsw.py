"""HNSWIndex: the twin of ``embeddinghub_tpu/index/hnsw.py``.

The same hnswlib-semantic graph in array form (reference: hnswlib
``HierarchicalNSW`` behind ``embeddingstore/index.cc:12-15``, defaults M=16,
efConstruction=200, ef=10): flat int32 neighbor tables (``[cap, 2M]`` for
layer 0, ``{node: [ids]}`` per upper layer on the host, stacked into
``[L, cap, M]`` on the device), geometric levels, greedy descent through
the upper layers, then a batched beam on layer 0.

What is ported:

  * the exact bulk build, the reference's default for a cold add of 2048
    to ``exact_build_max`` rows: each row's candidate pool is its exact
    top-``efC`` set on bf16-rounded operands (``ops/topk.pooled_topk_ids``,
    K1 on the card), heuristic selection at ``2M``
    (``ops/nn_descent.heuristic_prune``), reciprocal edges with
    overflow-only pruning (``ops/nn_descent.gather_reciprocal``), random
    long edges into free slots, the level draws and the upper layers;
  * every later write, as the reference makes it: waves of up to
    ``max_wave`` rows, on the host while the graph is tiny (a cold add of
    fewer than 2048 rows starts so) and on the device after
    (``ops/wave_insert.make_wave_commit``: pools from K1 over the arena's
    live prefix and over each upper layer's members, heuristic selection,
    reciprocal commits); re-sets (unlink, then insert again), ``remove``
    and ``refine``;
  * search (``ops/wave_insert.make_graph_search``): plain, routed by a
    snapshot's centroids, on the bf16 walk arena (``EHTPU_WALK_DTYPE``) and
    on the packed-neighbor arena (``EHTPU_WALK_PACKED=1`` or
    :meth:`pack_walk`);
  * ``state_arrays``/``from_state`` in the reference's array names, so
    either package opens the other's graph.  A graph the JAX package built
    comes across as ``HNSWIndex.from_state(dims, metric,
    jax_index.state_arrays(), device=...)`` on its numpy arrays.

Every step draws from the same numpy generators in the same order as the
reference, so the graph is the reference's.  What is not ported yet raises
``NotImplementedError`` naming ROADMAP.md queue 1, graph engine,
construction and mutation: a cold add of more than ``exact_build_max`` rows
(the cluster-routed build) and ``build_route`` (k-means).

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
from embeddinghub_tpu_torch.ops import nn_descent as nnd
from embeddinghub_tpu_torch.ops import topk as topk_ops
from embeddinghub_tpu_torch.ops import wave_insert
from embeddinghub_tpu_torch.utils.device import DEFAULT as DEFAULT_DEVICE
from embeddinghub_tpu_torch.utils.device import resolve as resolve_device

NOT_PORTED = ("is not ported yet; see ROADMAP.md queue 1, graph engine, "
              "construction and mutation")
BULK_MIN = 2048  # a cold add of at least this many rows is one bulk build
# the reference's layer-0 wave scan goes in chunks of this many rows
SCAN_CHUNK = 1 << 19
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
        self._cluster_route = None
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
        is one exact bulk build; everything else goes in by waves of
        ``min(rest, max(8, graph size), max_wave)`` rows, on the host while
        the graph is tiny and by the fused device wave after.  An add that
        raises part way leaves the graph, its device state and the level
        generator as they were."""
        rows = np.asarray(rows, dtype=np.int64).ravel()
        vecs = as_f32_matrix(vecs, self.dims)
        if rows.shape[0] != vecs.shape[0]:
            raise ValueError("rows / vecs length mismatch")
        if rows.size == 0:
            return
        if self._graph_size() == 0 and rows.size > self.exact_build_max:
            raise NotImplementedError(
                f"a cold add of {rows.size} rows (the exact bulk build takes up "
                f"to {self.exact_build_max}; the cluster-routed build beyond) "
                f"{NOT_PORTED}")
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

        if self._graph_size() == 0 and len(pending) >= BULK_MIN:
            commit_host(0, len(pending), mark_dirty=False)  # built whole below
            self._bulk_build(pending, pvecs)
            self._invalidate_device()
            self._hi_water = max(self._scan_hi_water(), int(rows.max()) + 1)
            return
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

    def build_route(self, seed_probes: int = 8, k: int | None = None):
        raise NotImplementedError(f"HNSWIndex.build_route (kmeans) {NOT_PORTED}")

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
