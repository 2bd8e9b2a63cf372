"""Version: an embedding table that can be frozen.

The twin of ``embeddinghub_tpu/store/version.py``, in memory (no WAL yet):

  * ``set``/``multiset`` write the index's host arena and mark its device
    mirror dirty; a batch with repeated keys keeps the last value;
  * immutability is enforced at write time (``ImmutableVersionError``);
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


class Version:
    def __init__(
        self,
        space: str,
        name: str,
        dims: int,
        metric: str = "l2",
        index: Index | None = None,
        device="cpu",
    ):
        self.space = space
        self.name = name
        self.dims = int(dims)
        self.metric = metric
        self.index = (index if index is not None
                      else FlatIndex(self.dims, metric, device=device))
        self.keymap = KeyMap()
        self.immutable = False
        # Writers and batched searches synchronize here (the server and the
        # QueryBatcher share it).
        self.lock = threading.RLock()

    # ------------------------------------------------------------------ write

    def set(self, key: str, vec) -> None:
        self.multiset([(key, vec)])

    def multiset(self, pairs: Iterable[tuple[str, "np.ndarray"]]) -> None:
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
            # Keep-last dedup: one row per key, so the index's size counts
            # each key once.
            last = {k: i for i, k in enumerate(keys)}
            order = sorted(last.values())
            keys = [keys[i] for i in order]
            vecs = [vecs[i] for i in order]
        rows = self.keymap.assign_many(keys)
        self.index.add(rows, np.stack(vecs))

    def delete(self, key: str) -> None:
        if self.immutable:
            raise errors.ImmutableVersionError(self.space, self.name)
        row = self.keymap.release(str(key))
        if row is None:
            raise errors.KeyNotFoundError(self.space, key)
        self.index.remove(np.asarray([row]))

    def make_immutable(self) -> None:
        self.immutable = True

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
