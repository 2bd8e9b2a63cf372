"""Version: an embedding table that can be frozen.

The twin of ``embeddinghub_tpu/store/version.py``:

  * ``set``/``multiset`` write the index's host arena and mark its device
    mirror dirty; a batch with repeated keys keeps the last value; a batch
    the index refuses or fails to add leaves the keys as they were;
  * with a WAL (``store/persistence.py``), every write, delete and freeze
    is appended before the call returns, under ``lock``, so an
    acknowledged write is in the log and a snapshot taken under the same
    lock never truncates one away;
  * immutability is enforced at write time (``ImmutableVersionError``);
    freezing runs the quantization audit when ``EMBEDDINGHUB_QUANT_AUDIT``
    is "freeze";
  * the iterator yields a stable snapshot for Download;
  * keyed nearest-neighbor queries over-fetch k+1 and drop the key itself.
"""

from __future__ import annotations

import threading
from typing import Iterable, Iterator

import numpy as np

from embeddinghub_tpu_torch.index.base import Index
from embeddinghub_tpu_torch.index.flat import FlatIndex
from embeddinghub_tpu_torch.store import errors
from embeddinghub_tpu_torch.store.keymap import KeyMap
from embeddinghub_tpu_torch.utils.config import get_config
from embeddinghub_tpu_torch.utils.device import DEFAULT as DEFAULT_DEVICE


class Version:
    def __init__(
        self,
        space: str,
        name: str,
        dims: int,
        metric: str = "l2",
        index: Index | None = None,
        device=DEFAULT_DEVICE,
        wal=None,
    ):
        self.space = space
        self.name = name
        self.dims = int(dims)
        self.metric = metric
        self.index = (index if index is not None
                      else FlatIndex(self.dims, metric, device=device))
        self.keymap = KeyMap()
        self.immutable = False
        self._wal = wal
        # Writers, snapshots and batched searches synchronize here (the
        # server and the QueryBatcher share it).
        self.lock = threading.RLock()

    # ------------------------------------------------------------------ write

    def set(self, key: str, vec) -> None:
        self.multiset([(key, vec)])

    def multiset(self, pairs: Iterable[tuple[str, "np.ndarray"]]) -> None:
        with self.lock:
            if self.immutable:
                raise errors.ImmutableVersionError(self.space, self.name)
            keys = []
            vecs = []
            for key, vec in pairs:
                v = np.asarray(vec, dtype=np.float32).ravel()
                if v.shape[0] != self.dims:
                    raise errors.DimensionMismatchError(self.dims, v.shape[0])
                keys.append(str(key))
                vecs.append(v)
            if not keys:
                return
            if len(set(keys)) != len(keys):
                # Keep-last dedup: one row per key, so the index's size
                # counts each key once.
                last = {k: i for i, k in enumerate(keys)}
                order = sorted(last.values())
                keys = [keys[i] for i in order]
                vecs = [vecs[i] for i in order]
            mat = np.stack(vecs)
            mark = self.keymap.mark()
            rows = self.keymap.assign_many(keys)
            try:
                self.index.add(rows, mat)
            except BaseException:
                self.keymap.rollback(mark)
                raise
            if self._wal is not None:
                self._wal.append_many(keys, mat)

    def delete(self, key: str) -> None:
        with self.lock:
            if self.immutable:
                raise errors.ImmutableVersionError(self.space, self.name)
            row = self.keymap.row(str(key))
            if row is None:
                raise errors.KeyNotFoundError(self.space, key)
            self.index.remove(np.asarray([row]))
            self.keymap.release(str(key))
            if self._wal is not None:
                self._wal.append_delete(str(key))

    def make_immutable(self) -> None:
        with self.lock:
            self.immutable = True
            if self._wal is not None:
                self._wal.append_freeze()
        # Freezing is the load -> serve transition, where the measured
        # quantization audit is cheap next to the load and early enough to
        # come before any query (the reference's, opt-in:
        # EMBEDDINGHUB_QUANT_AUDIT=freeze).
        cfg = get_config()
        if cfg.quant_audit == "freeze":
            self.audit_quantization(bar=cfg.quant_audit_bar)

    def audit_quantization(self, bar: float = 0.95, nq: int = 64) -> dict:
        """The measured quantization audit of a quantized flat arena
        (``FlatIndex.audit_and_escalate``): device recall against an exact
        host oracle, the pool widened or the dtype escalated until ``bar``
        clears or nothing wider fits.  Returns its report; for any other
        index an empty one."""
        with self.lock:
            fn = getattr(self.index, "audit_and_escalate", None)
            if fn is None or getattr(self.index, "storage_dtype", "float32") \
                    not in ("int8", "int8x2", "bfloat16"):
                return {"audited": [], "escalated": [], "fit_blocked": None}
            return fn(bar=bar, nq=nq)

    # ------------------------------------------------------------------- read

    def get(self, key: str) -> np.ndarray:
        row = self.keymap.row(str(key))
        if row is None:
            raise errors.KeyNotFoundError(self.space, str(key))
        return self.index.vector(row)

    def multiget(self, keys: Iterable[str]) -> list[np.ndarray]:
        return [self.get(k) for k in keys]

    def __contains__(self, key: str) -> bool:
        return str(key) in self.keymap

    @property
    def size(self) -> int:
        return len(self.keymap)

    def iterator(self) -> Iterator[tuple[str, np.ndarray]]:
        """Stable snapshot scan (keys fixed at call time)."""
        items = list(self.keymap.items())
        for key, row in items:
            yield key, self.index.vector(row)

    # ---------------------------------------------------------------- nearest

    def nearest(self, num: int, key: str | None = None, vector=None) -> list[str]:
        """Single query by key (self excluded) XOR by vector."""
        has_key = key is not None and key != ""
        has_vec = vector is not None and len(vector) != 0
        if has_key and has_vec:
            raise errors.InvalidArgumentError("Key and embedding cannot both be set")
        if not has_key and not has_vec:
            raise errors.InvalidArgumentError("Key or embedding must be set")
        if has_key:
            vector = self.get(key)
            fetch = num + 1
        else:
            vector = np.asarray(vector, dtype=np.float32)
            fetch = num
        keys = self.nearest_batch(vector[None, :], fetch)[0]
        if has_key:
            if str(key) in keys:
                keys.remove(str(key))
            elif len(keys) > num:
                keys.pop()
        return keys

    def nearest_batch(self, queries: np.ndarray, k: int) -> list[list[str]]:
        """Batched k-NN returning keys, nearest first: many concurrent RPCs
        share one device dispatch."""
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim != 2 or queries.shape[1] != self.dims:
            raise errors.DimensionMismatchError(self.dims, queries.shape[-1])
        _, rows = self.index.search(queries, k)
        out: list[list[str]] = []
        for r in rows:
            keys = self.keymap.keys_for_rows(r[r >= 0])
            out.append([k for k in keys if k is not None])
        return out
