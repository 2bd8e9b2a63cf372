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
        self._shards = [
            HNSWIndex(dims, metric=metric, m=m, ef_construction=ef_construction,
                      ef_search=ef_search, capacity=cap_l, seed=seed + 1000 * s,
                      device=dev)
            for s, dev in enumerate(self.mesh.devices)
        ]

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
        merged = merge_lists([self._walk(sh, qd, ef_l, kk) for sh, qd in zip(self._shards, q)],
                             self.mesh.devices[0], kk)
        return host_lists(merged, b, k)

    # -------------------------------------------------------------- snapshot

    def state_arrays(self) -> dict[str, np.ndarray]:
        """The reference's arrays: ``nshards``, then each shard's
        ``HNSWIndex.state_arrays()`` as ``s{j}.<name>``."""
        out = {"nshards": np.asarray([self.n_shards], np.int32)}
        for j, sh in enumerate(self._shards):
            for name, arr in sh.state_arrays().items():
                out[f"s{j}.{name}"] = arr
        return out

    @classmethod
    def from_state(cls, dims: int, metric: str, arrays: dict[str, np.ndarray],
                   **kw) -> "ShardedHNSWIndex":
        """Rebuild from ``state_arrays()`` of either package onto a mesh of
        as many shards as the snapshot's (else ``ValueError``)."""
        s = int(np.asarray(arrays["nshards"]).ravel()[0])
        idx = cls(dims, metric=metric, **kw)
        if idx.n_shards != s:
            raise ValueError(f"snapshot has {s} shards, mesh has {idx.n_shards}")
        for j, dev in enumerate(idx.mesh.devices):
            sub = {name[len(f"s{j}."):]: arr for name, arr in arrays.items()
                   if name.startswith(f"s{j}.")}
            idx._shards[j] = HNSWIndex.from_state(dims, metric, sub, device=dev)
        idx.m = idx._shards[0].m
        idx.ef_search = idx._shards[0].ef_search
        return idx
