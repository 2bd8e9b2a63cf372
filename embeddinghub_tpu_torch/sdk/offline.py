"""Offline (in-process) index.

The twin of ``embeddinghub_tpu/sdk/offline.py``: the ``Index`` surface
(``set``/``get``/``multiset``/``multiget``/``nearest_neighbor``/``size``)
for local training workflows, on the port's ``FlatIndex`` on an explicit
``device`` (default ``"cuda"``, as ``EmbeddingHub``'s; ``"cpu"`` only when
asked for).  On CUDA its searches run the port's kernels.

Example::

    client = EmbeddingHubClient()
    offline = Index(client.download("space"), dims, device="cuda")
    offline.nearest_neighbor(5, key="a")
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from embeddinghub_tpu_torch.index.flat import FlatIndex
from embeddinghub_tpu_torch.ops import distance as dist_ops
from embeddinghub_tpu_torch.store.keymap import KeyMap
from embeddinghub_tpu_torch.utils.device import DEFAULT as DEFAULT_DEVICE
from embeddinghub_tpu_torch.utils.device import resolve as resolve_device


class Index:
    def __init__(self, key_emb_iter, dims: int, metric: str = "l2",
                 device: torch.device | str = DEFAULT_DEVICE):
        self._dims = int(dims)
        device = resolve_device(device)
        if device.type == "cuda":
            dist_ops.full_f32()
        self._idx = FlatIndex(self._dims, metric=metric, capacity=1024, device=device)
        self._mapper = KeyMap()
        self.multiset(key_emb_iter)

    def set(self, key, embedding) -> None:
        """Insert or overwrite one embedding."""
        self.multiset([(key, embedding)])

    def multiset(self, embedding_tuples) -> None:
        """Bulk insert from a mapping or a (key, embedding) iterable: one
        batched write of the host arena for the whole set."""
        if isinstance(embedding_tuples, Mapping):
            embedding_tuples = embedding_tuples.items()
        keys, vecs = [], []
        for key, embedding in embedding_tuples:
            keys.append(key)
            vecs.append(np.asarray(embedding, dtype=np.float32))
        if not keys:
            return
        rows = np.fromiter(
            (self._mapper.assign(k) for k in keys), dtype=np.int64, count=len(keys)
        )
        self._idx.add(rows, np.stack(vecs))

    def get(self, key):
        """The stored embedding for ``key`` (KeyError if absent)."""
        row = self._mapper.row(key)
        if row is None:
            raise KeyError(key)
        return self._idx.vector(row)

    def multiget(self, keys):
        return [self.get(k) for k in keys]

    def nearest_neighbor(self, num, key=None, embedding=None):
        """``num`` nearest neighbors; keyed queries exclude the key itself."""
        has_key = key is not None
        if has_key:
            embedding = self.get(key)
            fetch = num + 1
        else:
            fetch = num
        q = np.asarray(embedding, np.float32)[None, :]
        _, rows = self._idx.search(q, fetch)
        results = [self._mapper.key(int(r)) for r in rows[0] if r >= 0]
        if has_key:
            if key in results:
                results.remove(key)
            elif len(results) > num:
                results.pop()
        return results

    def nearest_neighbor_batch(self, num, embeddings) -> list[list]:
        """Many queries in one device dispatch."""
        q = np.asarray(embeddings, np.float32)
        _, rows = self._idx.search(q, num)
        return [[self._mapper.key(int(r)) for r in row if r >= 0] for row in rows]

    def size(self) -> int:
        """Number of embeddings in the index."""
        return len(self._mapper)
