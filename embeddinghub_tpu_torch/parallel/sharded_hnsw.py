"""ShardedHNSWIndex: the graph engine over a mesh of shards.

The twin of ``embeddinghub_tpu/parallel/sharded_hnsw.py``.  Rows are
sharded round robin as in :class:`~.sharded_flat.ShardedFlatIndex` (host
row ``r`` on shard ``r % S`` at local row ``r // S``), and each shard owns
an independent :class:`~embeddinghub_tpu_torch.index.hnsw.HNSWIndex` over
its local rows on ``mesh.devices[s]`` (seed ``seed + 1000 s``): its bulk
build, waves, removes and device state are the single-device index's.

A search runs the reference's sharded walk on each shard: a greedy descent
through the shard's upper layers, then ``ops/beam.beam_search`` over layer
0 on the f32 rows, their squared norms and the mask (no centroid route, no
bf16 walk table, no rerank), with ``ef_l = min(next_pow2(ef, floor=8),
1024)``, ``expand = min(expand, ef_l)`` and ``2 ef_l + 64`` hops at most.
Each shard's first ``kk = min(next_pow2(k), ef_l)`` entries are merged as
the flat index merges them: on the first device, ``[B, S * kk]``
shard-major, the ``kk`` smallest with ties to the lower column.

On a mesh that spans processes (:func:`~.mesh.process_mesh`) a rank builds
and keeps an ``HNSWIndex`` only for its own shards (the same seeds), and
for every other shard the host record of what the SPMD writes put there
(:class:`_RemoteShard`: its raw rows, mask, size and capacity), so
``size``, ``vector``, ``vectors`` and ``total_capacity`` give every rank
the in-process answer without a collective.  A search walks the rank's own
shards and merges every rank's lists as the flat index does;
``state_arrays`` gathers the shards' arrays from their ranks.

Not ported: the reference's stacking of every shard's graph into ``[S,
...]`` slabs padded to the largest shard (and the shards' host syncs and
device drops that go with it), which exist for ``shard_map`` and the TPU's
memory; each shard here searches its own device state.
"""

from __future__ import annotations

import numpy as np
import torch

from embeddinghub_tpu_torch.index.base import Index, as_f32_matrix, next_pow2
from embeddinghub_tpu_torch.index.hnsw import HNSWIndex
from embeddinghub_tpu_torch.ops import beam as beam_ops
from embeddinghub_tpu_torch.ops import distance as dist_ops
from embeddinghub_tpu_torch.parallel.mesh import Mesh, default_mesh
from embeddinghub_tpu_torch.parallel.sharded_flat import (
    empty_lists,
    host_lists,
    merge_lists,
    padded_queries,
)


class _RemoteShard:
    """The host record of a shard that another rank owns, kept from the
    SPMD writes as ``HNSWIndex`` keeps its own: the raw rows, the mask, the
    size and the capacity (the same growth), without a graph."""

    def __init__(self, dims: int, capacity: int):
        self._cap = next_pow2(max(capacity, 128), floor=128)
        self._hx = np.zeros((self._cap, dims), np.float32)
        self._hvalid = np.zeros((self._cap,), bool)
        self._size = 0

    @classmethod
    def from_state(cls, sub: dict[str, np.ndarray]) -> "_RemoteShard":
        x = np.asarray(sub["x"], np.float32)
        rec = cls(x.shape[1], x.shape[0])
        rec._hx[:x.shape[0]] = x
        rec._hvalid[:x.shape[0]] = sub["valid"]
        rec._size = int(np.count_nonzero(rec._hvalid))
        return rec

    @property
    def size(self) -> int:
        return self._size

    def add(self, rows: np.ndarray, vecs: np.ndarray) -> None:
        if rows.size == 0:
            return
        need = int(rows.max()) + 1
        if need > self._cap:
            cap = next_pow2(need, floor=self._cap)
            for name in ("_hx", "_hvalid"):
                old = getattr(self, name)
                grown = np.zeros((cap,) + old.shape[1:], old.dtype)
                grown[:self._cap] = old
                setattr(self, name, grown)
            self._cap = cap
        self._size += int(np.count_nonzero(~self._hvalid[rows]))
        order = np.argsort(rows)
        self._hx[rows[order]] = vecs[order]
        self._hvalid[rows] = True

    def remove(self, rows: np.ndarray) -> None:
        for r in rows:
            r = int(r)
            if 0 <= r < self._cap and self._hvalid[r]:
                self._hvalid[r] = False
                self._size -= 1

    def vector(self, row: int) -> np.ndarray:
        return self._hx[row].copy()


class ShardedHNSWIndex(Index):
    def __init__(
        self,
        dims: int,
        metric: str = "l2",
        mesh: Mesh | None = None,
        m: int = 16,
        ef_construction: int = 200,
        ef_search: int = 10,
        capacity: int = 1024,
        seed: int = 0,
    ):
        if metric not in dist_ops.METRICS:
            raise ValueError(f"unknown metric {metric!r}")
        self.dims = int(dims)
        self.metric = metric
        self.m = int(m)
        self.ef_search = int(ef_search)
        self.mesh = mesh if mesh is not None else default_mesh()
        self.n_shards = self.mesh.size
        cap_l = next_pow2(-(-max(capacity, 128) // self.n_shards), floor=128)
        own = dict(zip(self.mesh.shards, self.mesh.devices))
        # every shard: an HNSWIndex for this process's own, else the host
        # record of another rank's
        self._shards: list = [
            HNSWIndex(dims, metric=metric, m=m, ef_construction=ef_construction,
                      ef_search=ef_search, capacity=cap_l, seed=seed + 1000 * s,
                      device=own[s])
            if s in own else _RemoteShard(dims, cap_l)
            for s in range(self.n_shards)
        ]

    def _own(self) -> list[HNSWIndex]:
        """This process's shards, in the order of ``mesh.shards``."""
        return [self._shards[s] for s in self.mesh.shards]

    # ------------------------------------------------------------------ write

    def _route(self, rows: np.ndarray):
        """``(shard, local rows, mask)`` for each shard that ``rows`` reach."""
        s_n = self.n_shards
        for j in range(s_n):
            mask = (rows % s_n) == j
            if mask.any():
                yield self._shards[j], rows[mask] // s_n, mask

    def add(self, rows: np.ndarray, vecs: np.ndarray) -> None:
        rows = np.asarray(rows, dtype=np.int64).ravel()
        vecs = as_f32_matrix(vecs, self.dims)
        if rows.shape[0] != vecs.shape[0]:
            raise ValueError("rows / vecs length mismatch")
        for shard, local, mask in self._route(rows):
            shard.add(local, vecs[mask])

    def remove(self, rows: np.ndarray) -> None:
        rows = np.asarray(rows, dtype=np.int64).ravel()
        for shard, local, _ in self._route(rows):
            shard.remove(local)

    @property
    def size(self) -> int:
        return sum(sh.size for sh in self._shards)

    @property
    def total_capacity(self) -> int:
        return max(sh._cap for sh in self._shards) * self.n_shards

    def vector(self, row: int) -> np.ndarray:
        return self._shards[row % self.n_shards].vector(row // self.n_shards)

    def vectors(self, rows: np.ndarray) -> np.ndarray:
        rows = np.asarray(rows, dtype=np.int64)
        return np.stack([self.vector(int(r)) for r in rows])

    # ----------------------------------------------------------------- search

    def _walk(self, sh: HNSWIndex, q: torch.Tensor, ef_l: int, kk: int):
        """One shard's ``(dist, ids)`` ``[B, kk]``, local ids: the greedy
        descent from its entry through its upper layers, then the layer-0
        beam on its f32 rows."""
        b = q.shape[0]
        if sh.size == 0 or sh._entry < 0:
            return (torch.full((b, kk), torch.inf, device=q.device),
                    torch.full((b, kk), -1, dtype=torch.int64, device=q.device))
        st = sh._device_arrays()
        cur = torch.full((b,), sh._entry, dtype=torch.int64, device=q.device)
        for layer in range(st["ustack"].shape[0], 0, -1):
            cur = beam_ops.greedy_descend(q, cur, st["ustack"][layer - 1], st["x"],
                                          st["x_sq"], metric=self.metric)
        dl, il = beam_ops.beam_search(
            q, cur, st["nb0"], st["x"], st["x_sq"], st["valid"], metric=self.metric,
            ef=ef_l, expand=min(sh.expand, ef_l), max_hops=2 * ef_l + 64)
        return dl[:, :kk], il[:, :kk]

    def search(self, queries: np.ndarray, k: int, ef: int | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
        queries = as_f32_matrix(queries, self.dims)
        b = queries.shape[0]
        if self.size == 0 or k <= 0:
            return empty_lists(b, k)
        ef = max(ef or self.ef_search, k)
        ef_l = min(next_pow2(ef, floor=8), 1024)
        kk = min(next_pow2(k, floor=1), ef_l)
        q = self.mesh.put(padded_queries(queries, self.metric))
        merged = merge_lists(self.mesh, [self._walk(sh, qd, ef_l, kk)
                                         for sh, qd in zip(self._own(), q)], kk)
        return host_lists(merged, b, k)

    # -------------------------------------------------------------- snapshot

    def state_arrays(self) -> dict[str, np.ndarray]:
        """The reference's arrays: ``nshards``, then each shard's
        ``HNSWIndex.state_arrays()`` as ``s{j}.<name>``; on a process mesh
        gathered from the shards' ranks (a collective of every rank)."""
        own = {}
        for j in self.mesh.shards:
            for name, arr in self._shards[j].state_arrays().items():
                own[f"s{j}.{name}"] = arr
        out = {"nshards": np.asarray([self.n_shards], np.int32)}
        for part in self.mesh.gather_objects(own):
            out.update(part)
        return out

    @classmethod
    def from_state(cls, dims: int, metric: str, arrays: dict[str, np.ndarray],
                   **kw) -> "ShardedHNSWIndex":
        """Rebuild from ``state_arrays()`` of either package onto a mesh of
        as many shards as the snapshot's (else ``ValueError``).  A process
        builds the graphs of its own shards from their ``s{j}.*`` entries,
        and keeps the ``x`` and ``valid`` of every other shard."""
        s = int(np.asarray(arrays["nshards"]).ravel()[0])
        idx = cls(dims, metric=metric, **kw)
        if idx.n_shards != s:
            raise ValueError(f"snapshot has {s} shards, mesh has {idx.n_shards}")
        for j in range(s):
            sub = {name[len(f"s{j}."):]: arr for name, arr in arrays.items()
                   if name.startswith(f"s{j}.")}
            if idx.mesh.owns(j):
                dev = idx.mesh.devices[j - idx.mesh.shards.start]
                idx._shards[j] = HNSWIndex.from_state(dims, metric, sub, device=dev)
            elif "x" in sub and "valid" in sub:
                idx._shards[j] = _RemoteShard.from_state(sub)
            else:
                raise ValueError(f"snapshot lacks s{j}.x or s{j}.valid, which every "
                                 f"rank of a process mesh keeps")
        first = idx._own()[0]
        idx.m = first.m
        idx.ef_search = first.ef_search
        return idx
