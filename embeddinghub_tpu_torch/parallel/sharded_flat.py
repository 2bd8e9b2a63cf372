"""ShardedFlatIndex: exact k-NN over a mesh of shards.

The twin of ``embeddinghub_tpu/parallel/sharded_flat.py``: the flat arena
scaled out over the shards of a :class:`~.mesh.Mesh` (BASELINE configs
4-5).  Rows are sharded round robin, as in the reference: host row ``r``
lives on shard ``r % S`` at local row ``r // S``, so keys allocated in
order stay balanced and a batched insert reaches every shard.

  * Host side, as the reference's: the f32 arena ``_hx`` and the mask
    ``_hvalid`` in host row order, ``cap_local * S`` rows; ``cap_local`` is
    a power of two of at least 128 and doubles as the arena grows.
  * Device side: shard ``s`` keeps its own state on ``mesh.devices[s]``,
    its local rows preprocessed for the metric: the f32 arena (rows 16
    bytes apart, as K1 reads them), or the int8 hi plane and its row
    scales (``int8x2`` adds the residual plane), quantized on the device
    by ``index/flat.quantize_planes``; then ``x_sq`` and the mask.  A full
    sync builds it (after the quantization guard, ``index/flat.
    apply_quant_guard``); small dirty sets are scattered into it, each
    scatter's rows unique, and past a quarter of the capacity the next
    sync is full again.
  * Search, the reference's routing for each shard: an f32 arena takes
    K1 (``topk.chunked_topk_search``), an int8 or int8x2 one K2's int8
    pool and a rerank of the dequantized candidates
    (``topk.int8_oversample_search``), or past ``_DEEP_CAP_THRESHOLD``
    local rows the chunked pool in chunks of ``_DEEP_CHUNK`` rows
    (``topk.quantized_chunked_exact``).  Every shard's ``[B, kk]`` list
    comes to ``mesh.devices[0]``, local ids become host rows, and the
    ``kk`` smallest of the ``[B, S * kk]`` shard-major columns win, ties
    to the lower column as ``lax.top_k`` orders them
    (``topk.smallest_k``).  The reference's all-gather over the chip
    interconnect is a copy to the first device here.
  * On a mesh that spans processes (:func:`~.mesh.process_mesh`) every
    rank keeps the whole host arena, as every reference process does, so
    ``vector``, ``vectors``, ``state_arrays`` and the guard stay local and
    alike, and device state only for its own shards.  A search merges the
    lists of its own shards and every other rank's, gathered in rank order
    (:meth:`~.mesh.Mesh.all_gather_lists`): the same ``[B, S * kk]``
    columns, so every rank holds the lists of the in-process mesh.
    :meth:`ShardedFlatIndex.save_shards` writes a rank's shards' device
    state, a file a shard, and :meth:`ShardedFlatIndex.restore_shards`
    reads it back in place of a sync.

Not ported, because they serve ``shard_map`` and the TPU's memory rather
than the index: the shard-major relayout of the host arena for a sharded
``device_put``, and the scatter's padding to a power of two with repeats
of its first row.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from embeddinghub_tpu_torch.index.base import Index, as_f32_matrix, next_pow2
from embeddinghub_tpu_torch.index.flat import (
    _adoptable,
    _bucket,
    _high_water_of,
    _i8_plane,
    apply_quant_guard,
    quantize_planes,
)
from embeddinghub_tpu_torch.ops import distance as dist_ops
from embeddinghub_tpu_torch.ops import topk as topk_ops
from embeddinghub_tpu_torch.parallel.mesh import Mesh, default_mesh

# A shard past this many local rows searches its quantized arena in chunks
# of _DEEP_CHUNK rows (the reference's 2M-row shard limit).
_DEEP_CAP_THRESHOLD = 1 << 21
_DEEP_CHUNK = 1 << 18
# Rewriting more than this fraction of the capacity makes the next sync full.
_SCATTER_LIMIT = 0.25
# Bytes of raw f32 host rows a full sync uploads at a time.
_SYNC_BLOCK_BYTES = 1 << 28
_INT8 = ("int8", "int8x2")


def padded_queries(queries: np.ndarray, metric: str) -> np.ndarray:
    """Queries as the reference's sharded searches upload them: unit rows
    for cosine, zero rows up to the padded batch size (``_bucket``)."""
    if metric == "cosine":
        queries = queries / np.maximum(np.linalg.norm(queries, axis=1, keepdims=True), 1e-30)
    q = np.zeros((_bucket(queries.shape[0]), queries.shape[1]), np.float32)
    q[:queries.shape[0]] = queries
    return q


def merge_lists(mesh: Mesh, parts, kk: int, width: int | None = None):
    """This process's shards' ``(dist, local ids)`` lists, in the order of
    ``mesh.shards``, merged with every other rank's on ``mesh.devices[0]``:
    local row ``i`` of shard ``s`` is host row ``i * S + s`` (-1 kept), the
    columns ``[B, S * kk]`` shard-major (the ranks' lists gathered in rank
    order, :meth:`~.mesh.Mesh.all_gather_lists`), +inf where an id is -1,
    then the ``width`` smallest (``kk`` when ``None``), ties to the lower
    column (``lax.top_k``'s order)."""
    s_n, home = mesh.size, mesh.devices[0]
    ds, ids = [], []
    for s, (d, i) in zip(mesh.shards, parts):
        i = i.to(torch.int64)
        ids.append(torch.where(i >= 0, i * s_n + s, -1).to(home))
        ds.append(d.to(home))
    dd, ii = mesh.all_gather_lists(torch.cat(ds, dim=1), torch.cat(ids, dim=1))
    width = kk if width is None else min(width, dd.shape[1])
    nd, pos = topk_ops.smallest_k(torch.where(ii >= 0, dd, torch.inf), width)
    return nd, torch.gather(ii, 1, pos)


def host_lists(merged, b: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """The first ``b`` rows and ``k`` columns of merged lists on the host,
    -1 behind every +inf; empty slots (+inf, -1) past the lists' width."""
    d, i = empty_lists(b, k)
    w = min(k, merged[0].shape[1])
    d[:, :w] = merged[0][:b, :w].cpu().numpy()
    i[:, :w] = merged[1][:b, :w].cpu().numpy()
    i[~np.isfinite(d)] = -1
    return d, i


def empty_lists(b: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    return (np.full((b, max(k, 0)), np.inf, np.float32),
            np.full((b, max(k, 0)), -1, np.int64))


class ShardedFlatIndex(Index):
    _STORAGE_CODES = {"float32": 0, "int8": 2, "int8x2": 3}

    def __init__(
        self,
        dims: int,
        metric: str = "l2",
        mesh: Mesh | None = None,
        capacity: int = 1024,
        chunk_target: int = 16384,
        compute_dtype: str = "float32",
        storage_dtype: str = "float32",
        quant_guard: bool = True,
    ):
        """``storage_dtype`` "int8" keeps each shard's arena quantized
        (per-row symmetric scales, K2's int8 pool, a rerank of the
        dequantized candidates); "int8x2" adds the residual plane for dense
        near-duplicate data.  ``quant_guard`` escalates int8 -> int8x2 ->
        float32 at a full sync while a sampled recall@10 is below 0.95.
        ``mesh``: the shards' devices, all visible cards by default."""
        if metric not in dist_ops.METRICS:
            raise ValueError(f"unknown metric {metric!r}")
        if storage_dtype not in self._STORAGE_CODES:
            raise ValueError(f"unsupported storage_dtype {storage_dtype!r}")
        self.dims = int(dims)
        self.metric = metric
        self.compute_dtype = compute_dtype
        self.storage_dtype = storage_dtype
        self.mesh = mesh if mesh is not None else default_mesh()
        self.n_shards = self.mesh.size
        if any(d.type == "cuda" for d in self.mesh.devices):
            dist_ops.full_f32()
        self._chunk_target = int(chunk_target)
        self._cap_local = next_pow2(-(-max(capacity, 128) // self.n_shards), floor=128)
        self._hx = np.zeros((self.total_capacity, self.dims), dtype=np.float32)
        self._hvalid = np.zeros((self.total_capacity,), dtype=bool)
        self._size = 0
        self._high_water = 0  # host rows at or past it were never written
        # per shard: "x" (f32 arena or int8 hi plane), "sc" (row scales),
        # "lo" (residual plane), "sq", "valid"; None until the first sync
        self._shards: list[dict] | None = None
        self._dirty = True  # the next sync is full
        self._dirty_rows: set[int] = set()
        self.quant_guard = bool(quant_guard)
        self._guard_checked_size = 0
        self.guard_recalls: dict[str, float] = {}

    # ------------------------------------------------------------ properties

    @property
    def total_capacity(self) -> int:
        return self._cap_local * self.n_shards

    @property
    def size(self) -> int:
        return self._size

    # ------------------------------------------------------------------ write

    def add(self, rows: np.ndarray, vecs: np.ndarray) -> None:
        rows = np.asarray(rows, dtype=np.int64).ravel()
        vecs = as_f32_matrix(vecs, self.dims)
        if rows.shape[0] != vecs.shape[0]:
            raise ValueError("rows / vecs length mismatch")
        if rows.size == 0:
            return
        top = int(rows.max()) + 1
        self._ensure_capacity(top)
        self._high_water = max(self._high_water, top)
        newly = ~self._hvalid[rows]
        self._size += int(np.count_nonzero(newly))
        self._hx[rows] = vecs
        self._hvalid[rows] = True
        self._mark_dirty(rows)

    def remove(self, rows: np.ndarray) -> None:
        rows = np.asarray(rows, dtype=np.int64).ravel()
        rows = rows[(rows >= 0) & (rows < self.total_capacity)]
        self._size -= int(np.count_nonzero(self._hvalid[rows]))
        self._hvalid[rows] = False
        self._mark_dirty(rows)

    def _mark_dirty(self, rows: np.ndarray) -> None:
        """Track rows for the scatter; a large dirty set degrades to a full
        re-upload."""
        if self._dirty:
            return
        self._dirty_rows.update(int(r) for r in rows)
        if len(self._dirty_rows) > _SCATTER_LIMIT * self.total_capacity:
            self._dirty = True
            self._dirty_rows.clear()

    def _ensure_capacity(self, need: int) -> None:
        if need <= self.total_capacity:
            return
        new_local = next_pow2(-(-need // self.n_shards), floor=self._cap_local)
        old_cap = self.total_capacity
        self._cap_local = new_local
        grown_x = np.zeros((self.total_capacity, self.dims), dtype=np.float32)
        grown_x[:old_cap] = self._hx
        grown_v = np.zeros((self.total_capacity,), dtype=bool)
        grown_v[:old_cap] = self._hvalid
        self._hx, self._hvalid = grown_x, grown_v
        self._dirty = True

    # ------------------------------------------------------------------- sync

    def _new_shard(self, dev: torch.device, s: int) -> dict:
        """Shard ``s``'s device state on ``dev``, its mask written and its
        planes empty."""
        capl, dims = self._cap_local, self.dims
        int8 = self.storage_dtype in _INT8
        return {
            # f32 rows 16 bytes apart (K1's TMA rule); int8 planes likewise
            "x": (_i8_plane(capl, dims, dev) if int8 else torch.empty(
                (capl, -(-dims // 4) * 4), dtype=torch.float32, device=dev)[:, :dims]),
            "sc": torch.empty((capl,), dtype=torch.float32, device=dev) if int8 else None,
            "lo": (_i8_plane(capl, dims, dev) if self.storage_dtype == "int8x2"
                   else None),
            "sq": torch.empty((capl,), dtype=torch.float32, device=dev),
            "valid": torch.tensor(self._hvalid[s::self.n_shards], device=dev),
        }

    def _write(self, st: dict, at, vecs: torch.Tensor) -> None:
        """Preprocess raw f32 rows ``vecs`` for the metric (and quantize
        them) into a shard's local rows ``at``: a slice (full sync) or a
        tensor of unique rows (scatter)."""
        if self.storage_dtype in _INT8:
            planes = quantize_planes(vecs, self.metric, self.storage_dtype)
            parts = (("x", planes["hi"]), ("sc", planes["sc"]), ("lo", planes["lo"]),
                     ("sq", planes["sq"]))
        else:
            xp = dist_ops.preprocess_vectors(vecs, self.metric)
            parts = (("x", xp), ("sq", dist_ops.sqnorms(xp)))
        for name, val in parts:
            if val is None:
                continue
            if isinstance(at, slice):
                st[name][at] = val
            else:
                st[name].index_copy_(0, at, val)

    def _full_sync(self) -> None:
        self._dirty_rows.clear()
        apply_quant_guard(self)
        self._agree_on_storage()
        self._shards = None  # the old arenas go before the new ones are made
        mesh, s_n, capl = self.mesh, self.n_shards, self._cap_local
        shards = [self._new_shard(dev, s) for s, dev in zip(mesh.shards, mesh.devices)]
        own = slice(mesh.shards.start, mesh.shards.stop)
        step = max(1, _SYNC_BLOCK_BYTES // max(1, 4 * self.dims * len(shards)))
        for a in range(0, capl, step):
            b = min(capl, a + step)
            # host rows a*S .. b*S are local rows a .. b of every shard
            block = self._hx[a * s_n:b * s_n].reshape(b - a, s_n, self.dims)[:, own]
            blocks = mesh.put(np.ascontiguousarray(block))
            for j, (st, blk) in enumerate(zip(shards, blocks)):
                self._write(st, slice(a, b), blk[:, j].contiguous())
        self._shards = shards
        self._dirty = False

    def _agree_on_storage(self) -> None:
        """On a process mesh, every rank's guard must have picked the same
        storage (the guard is a host computation on the same arena, so it
        does): ranks that differ would build different arenas and stall in
        the next gather, so each raises here instead."""
        if self.mesh.world == 1:
            return
        picked = self.mesh.gather_objects(self.storage_dtype)
        if len(set(picked)) != 1:
            raise RuntimeError(f"the ranks' quantization guards disagree: {picked}")

    def _scatter_sync(self) -> None:
        """Write the dirty host rows into this process's shards' device
        state in place; host row ``r`` is local row ``r // S`` of shard
        ``r % S``."""
        rows = np.fromiter(self._dirty_rows, dtype=np.int64, count=len(self._dirty_rows))
        rows.sort()
        s_n = self.n_shards
        for s, dev, st in zip(self.mesh.shards, self.mesh.devices, self._shards):
            mine = rows[rows % s_n == s]
            if mine.size == 0:
                continue
            local = torch.from_numpy(mine // s_n).to(dev)
            self._write(st, local, torch.from_numpy(self._hx[mine]).to(dev))
            st["valid"].index_copy_(0, local, torch.from_numpy(self._hvalid[mine]).to(dev))
        self._dirty_rows.clear()

    def _sync(self) -> None:
        if self._dirty or self._shards is None:
            self._full_sync()
        elif self._dirty_rows:
            self._scatter_sync()

    # ----------------------------------------------------------------- search

    def _local_rows(self, s: int) -> int:
        """Shard ``s``'s high-water mark in local rows: host row ``r`` is
        local row ``r // S`` of shard ``r % S``."""
        return max(0, -(-(self._high_water - s) // self.n_shards))

    def _local_search(self, st: dict, q: torch.Tensor, kk: int, rows: int):
        """One shard's ``(dist, ids)`` ``[B, kk]``, local ids: the
        reference's ``_build_search`` routing; ``rows``: the shard's
        high-water mark (:meth:`_local_rows`), where its pool stops."""
        capl = self._cap_local
        if self.storage_dtype not in _INT8:
            return topk_ops.chunked_topk_search(
                q, st["x"], st["valid"], st["sq"], metric=self.metric, k=kk,
                chunk=min(capl, self._chunk_target), compute_dtype=self.compute_dtype)
        over = min(16 if self.storage_dtype == "int8x2" else 8, max(1, capl // kk))
        args = (q, st["x"], st["sc"], st["valid"], st["sq"], st["lo"])
        if capl > _DEEP_CAP_THRESHOLD:
            return topk_ops.quantized_chunked_exact(
                *args, metric=self.metric, k=kk, oversample=over,
                chunk=min(capl, _DEEP_CHUNK), rows=rows)
        return topk_ops.int8_oversample_search(*args, metric=self.metric, k=kk,
                                               oversample=over, rows=rows)

    def search_device(self, q: np.ndarray, kk: int, width: int | None = None):
        """The sharded search of prepared queries ``q [pb, D]``
        (:func:`padded_queries`), each shard at width ``kk``, merged to
        ``width`` columns (``kk`` when ``None``): device ``(dist, ids)`` on
        this process's first device, ids host rows."""
        self._sync()
        mesh = self.mesh
        return merge_lists(mesh, [self._local_search(st, qd, kk, self._local_rows(s))
                                  for s, st, qd in zip(mesh.shards, self._shards, mesh.put(q))],
                           kk, width)

    def search(self, queries: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        queries = as_f32_matrix(queries, self.dims)
        b = queries.shape[0]
        if self._size == 0 or k <= 0:
            return empty_lists(b, k)
        # Each shard returns at most its capacity; the merge keeps k whenever
        # the shards hold k rows between them (the reference keeps kk, so
        # past a shard's capacity it returns fewer; not copied on purpose).
        kk = min(next_pow2(k, floor=1), self._cap_local)
        return host_lists(self.search_device(padded_queries(queries, self.metric), kk,
                                             next_pow2(k, floor=1)), b, k)

    # ------------------------------------------------------------------ misc

    def vector(self, row: int) -> np.ndarray:
        return self._hx[row].copy()

    def vectors(self, rows: np.ndarray) -> np.ndarray:
        return self._hx[np.asarray(rows, dtype=np.int64)]

    # -------------------------------------------------------------- snapshot

    def state_arrays(self) -> dict[str, np.ndarray]:
        """The reference's arrays: ``x`` and ``valid`` in host row order and
        ``sflat_meta = [storage code]``."""
        return {
            "x": self._hx,
            "valid": self._hvalid,
            "sflat_meta": np.asarray([self._STORAGE_CODES[self.storage_dtype]], np.int32),
        }

    def save_shards(self, path) -> list[Path]:
        """This process's shards' device state, one file a shard under the
        directory ``path`` (``shard<s>.npz``: the arena or the int8 planes,
        the row scales, ``sq``, the mask and ``meta = [S, s, cap_local,
        dims, storage code, high-water mark]``), after a sync: the per-host
        snapshot of the reference's multi-process leg, which no rank
        gathers.  Returns the files written."""
        self._sync()
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        code = self._STORAGE_CODES[self.storage_dtype]
        out = []
        for s, st in zip(self.mesh.shards, self._shards):
            arrays = {name: t.cpu().numpy() for name, t in st.items() if t is not None}
            arrays["meta"] = np.asarray([self.n_shards, s, self._cap_local, self.dims, code,
                                         self._high_water], np.int64)
            out.append(path / f"shard{s}.npz")
            np.savez(out[-1], **arrays)
        return out

    def restore_shards(self, path) -> None:
        """Read this process's shards' device state from the files
        :meth:`save_shards` wrote under ``path``, in place of a sync (no
        guard, no quantization).  The host arena must already hold the rows
        the files were made from (every rank's SPMD writes): a file whose
        layout or mask differs from this index's raises ``ValueError``."""
        codes = {v: n for n, v in self._STORAGE_CODES.items()}
        shards, high = [], self._high_water
        for s, dev in zip(self.mesh.shards, self.mesh.devices):
            with np.load(Path(path) / f"shard{s}.npz") as f:
                arrays = {name: f[name] for name in f.files}
            meta = [int(v) for v in arrays.pop("meta")]
            want = [self.n_shards, s, self._cap_local, self.dims]
            if meta[:4] != want or meta[4] not in codes:
                raise ValueError(f"shard file {s}: layout {meta[:5]}, index {want}")
            self.storage_dtype = codes[meta[4]]
            st = self._new_shard(dev, s)
            if not np.array_equal(arrays["valid"], st["valid"].cpu().numpy()):
                raise ValueError(f"shard file {s}: its mask differs from the host arena's")
            planes = {name for name, t in st.items() if t is not None}
            if set(arrays) != planes:
                raise ValueError(f"shard file {s}: planes {sorted(arrays)}, "
                                 f"{self.storage_dtype} storage has {sorted(planes)}")
            for name, arr in arrays.items():
                st[name].copy_(torch.from_numpy(arr))
            shards.append(st)
            high = max(high, meta[5])
        self._shards = shards
        self._high_water = high  # where the files' pools stopped
        self._guard_checked_size = self._size
        self._dirty = False
        self._dirty_rows.clear()

    @classmethod
    def from_state(cls, dims: int, metric: str, arrays: dict[str, np.ndarray],
                   **kw) -> "ShardedFlatIndex":
        """Rebuild from ``state_arrays()`` of either package, on any mesh
        (the host arena is in host row order); the next sync quantizes and
        uploads again."""
        if "sflat_meta" in arrays and "storage_dtype" not in kw:
            codes = {v: n for n, v in cls._STORAGE_CODES.items()}
            code = int(np.asarray(arrays["sflat_meta"]).ravel()[0])
            if code not in codes:
                raise ValueError(f"unknown sflat_meta storage code {code}")
            kw = dict(kw, storage_dtype=codes[code])
        x, valid = arrays["x"], arrays["valid"]
        idx = cls(dims, metric=metric, capacity=x.shape[0], **kw)
        n = x.shape[0]
        if _adoptable(x, idx._hx):
            idx._hx = x
        else:
            idx._hx[:n] = x
        if _adoptable(valid, idx._hvalid):
            idx._hvalid = valid
        else:
            idx._hvalid[:n] = valid
        idx._size = int(np.count_nonzero(idx._hvalid))
        idx._high_water = _high_water_of(idx._hvalid)
        idx._dirty = True
        return idx
