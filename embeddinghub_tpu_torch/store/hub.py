"""EmbeddingHub: the store root.

The twin of ``embeddinghub_tpu/store/hub.py``, in memory, on one explicit
``torch.device`` that every space's index is created on.  On CUDA it
turns TF32 off for the process (``ops/distance.py`` says why):

  * ``create_space`` is idempotent for an existing space;
  * ``delete_space`` drops the space.

Only the default ``flat`` engine (float32 arena) is ported; every other
engine of the reference raises ``NotImplementedError`` naming its ROADMAP
item.
"""

from __future__ import annotations

import threading

import torch

from embeddinghub_tpu_torch.ops import distance as dist_ops
from embeddinghub_tpu_torch.store.space import DEFAULT_VERSION, Space

# engine -> the ROADMAP.md queue 1 item that ports it
_NOT_PORTED = {
    "flat-bf16": "quantized flat arenas",
    "flat-int8": "quantized flat arenas",
    "flat-int8x2": "quantized flat arenas",
    "sharded": "multi-device",
    "sharded-int8": "multi-device",
    "sharded-int8x2": "multi-device",
    "hnsw": "graph engine, serving",
    "hnsw-sharded": "multi-device",
}


class EmbeddingHub:
    def __init__(self, engine: str = "flat", device: torch.device | str = "cpu"):
        if engine in _NOT_PORTED:
            raise NotImplementedError(
                f"engine {engine!r} is not ported yet; see ROADMAP.md queue 1, "
                f"{_NOT_PORTED[engine]}"
            )
        if engine != "flat":
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine
        self.device = torch.device(device)
        if self.device.type == "cuda":
            dist_ops.full_f32()
        self._spaces: dict[str, Space] = {}
        self._lock = threading.RLock()

    @classmethod
    def in_memory(cls, **kw) -> "EmbeddingHub":
        return cls(**kw)

    # ----------------------------------------------------------------- spaces

    def create_space(self, name: str, dims: int, metric: str = "l2") -> Space:
        """Create a space with its default "initial" version."""
        name = str(name)
        with self._lock:
            if name in self._spaces:
                return self._spaces[name]
            space = Space(name, device=self.device)
            space.create_version(DEFAULT_VERSION, dims, metric)
            self._spaces[name] = space
            return space

    def get_space(self, name: str) -> Space | None:
        with self._lock:
            return self._spaces.get(str(name))

    def delete_space(self, name: str) -> None:
        with self._lock:
            self._spaces.pop(str(name), None)

    def spaces(self) -> list[str]:
        with self._lock:
            return list(self._spaces)

    def get_version(self, space_name: str, version_name: str = DEFAULT_VERSION):
        space = self.get_space(space_name)
        if space is None:
            return None
        return space.get_version(version_name)
