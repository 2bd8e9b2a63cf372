"""Index interface: the twin of ``embeddinghub_tpu/index/base.py``.

Indexes speak integer row ids; the key <-> row mapping is the store's
(:mod:`embeddinghub_tpu_torch.store.keymap`).  The original cannot be
imported without jax, because its package ``__init__`` imports the JAX
``FlatIndex``.
"""

from __future__ import annotations

import abc

import numpy as np


class Index(abc.ABC):
    """A batched nearest-neighbor index over integer row ids."""

    dims: int
    metric: str

    @abc.abstractmethod
    def add(self, rows: np.ndarray, vecs: np.ndarray) -> None:
        """Insert or overwrite vectors at the given row ids."""

    @abc.abstractmethod
    def remove(self, rows: np.ndarray) -> None:
        """Invalidate row ids (they stop appearing in search results)."""

    @abc.abstractmethod
    def search(self, queries: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Batched k-NN.  ``queries [B, D]`` -> ``(dists [B, k], rows [B, k])``
        with ``rows == -1`` (dist ``+inf``) for empty slots."""

    @property
    @abc.abstractmethod
    def size(self) -> int:
        """Number of live rows."""


def as_f32_matrix(vecs, dims: int) -> np.ndarray:
    v = np.asarray(vecs, dtype=np.float32)
    if v.ndim == 1:
        v = v[None, :]
    if v.ndim != 2 or v.shape[1] != dims:
        raise ValueError(f"expected [*, {dims}] vectors, got shape {v.shape}")
    return v


def next_pow2(n: int, floor: int = 1) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def quantize_rows(x: np.ndarray, residual: bool = False):
    """Per-row symmetric int8 quantization (``x ~ scale*hi``, or with
    ``residual`` ``x ~ scale*(hi + lo/254)``).  The scheme of the
    reference's quantized arenas and int8 query upload; the port uses it
    for the int8 ``query_dtype``.  Returns ``(hi int8, scales f32, lo int8 |
    None)``."""
    scales = np.maximum(np.abs(x).max(axis=1) / 127.0, 1e-30).astype(np.float32)
    hi = np.clip(np.round(x / scales[:, None]), -127, 127).astype(np.int8)
    if not residual:
        return hi, scales, None
    resid = x / scales[:, None] - hi
    lo = np.clip(np.round(resid * 254.0), -127, 127).astype(np.int8)
    return hi, scales, lo
