"""EmbeddingHub: the store root.

The twin of ``embeddinghub_tpu/store/hub.py``, on one explicit
``torch.device`` that every space's index is created or loaded on:
``"cuda"`` unless the caller passes another (on a host without CUDA that
default raises).  On CUDA it turns TF32 off for the process
(``ops/distance.py`` says why):

  * ``load_or_create(path)`` opens a data directory (``manifest.json``,
    written atomically, plus one directory per space) or starts one;
    ``in_memory()`` keeps nothing on disk;
  * ``create_space`` is idempotent for an existing space;
  * ``delete_space`` drops the space and its directory;
  * ``save`` snapshots every space, which truncates their WALs.

The on-disk format is the reference's, so a data directory written by
either package opens in the other.  The engines: ``flat`` (the float32
arena, the default), ``flat-bf16``, ``flat-int8`` and ``flat-int8x2`` (a
``FlatIndex`` of that ``storage_dtype``, with the quantization guard on)
``hnsw`` (``index/hnsw.py``, built with the ``hnsw_*`` knobs of
``utils/config.py``, as the reference's ``_make_index``), and the engines
over a mesh of shards (``parallel/``): ``sharded``, ``sharded-int8`` and
``sharded-int8x2`` (a ``ShardedFlatIndex`` of that storage) and
``hnsw-sharded`` (a ``ShardedHNSWIndex`` with the same ``hnsw_*`` knobs).
The mesh is the caller's ``mesh``, else every visible card for a CUDA
device and the one device otherwise (``parallel/mesh.mesh_for``); with a
mesh and no ``device`` the hub's device is the mesh's first.  A sharded
snapshot reopens onto the hub's mesh.  The engine picks the index
of new versions and of versions rebuilt from a WAL alone; a snapshot names
its own index type.  The hnsw knobs come from the ``config`` the caller
passes (``get_config()`` without one); ``hnsw_seed_probes > 0`` routes a
graph's searches by k-means centroids once it holds ``hnsw_route_min`` rows
(``HNSWIndex.auto_seed_probes``), as the reference's hub does.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path

import torch

from embeddinghub_tpu_torch.index.flat import FlatIndex
from embeddinghub_tpu_torch.index.hnsw import HNSWIndex
from embeddinghub_tpu_torch.ops import distance as dist_ops
from embeddinghub_tpu_torch.parallel.mesh import Mesh, mesh_for
from embeddinghub_tpu_torch.parallel.sharded_flat import ShardedFlatIndex
from embeddinghub_tpu_torch.parallel.sharded_hnsw import ShardedHNSWIndex
from embeddinghub_tpu_torch.store.space import DEFAULT_VERSION, Space
from embeddinghub_tpu_torch.utils.config import Config, get_config
from embeddinghub_tpu_torch.utils.device import DEFAULT as DEFAULT_DEVICE
from embeddinghub_tpu_torch.utils.device import resolve as resolve_device

class EmbeddingHub:
    def __init__(
        self,
        base_path: str | Path | None = None,
        engine: str = "flat",
        device: torch.device | str | None = None,
        config: Config | None = None,
        mesh: Mesh | None = None,
    ):
        if engine not in ("flat", "hnsw", "hnsw-sharded", *self._QUANTIZED,
                          *self._SHARDED):
            raise ValueError(f"unknown engine {engine!r}")
        self.config = config if config is not None else get_config()
        self.base_path = Path(base_path) if base_path is not None else None
        self.engine = engine
        if device is None:
            device = mesh.devices[0] if mesh is not None else DEFAULT_DEVICE
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else mesh_for(self.device)
        if self.device.type == "cuda":
            dist_ops.full_f32()
        self._spaces: dict[str, Space] = {}
        self._lock = threading.RLock()
        if self.base_path is not None:
            self.base_path.mkdir(parents=True, exist_ok=True)
            self._load_manifest()

    @classmethod
    def load_or_create(cls, path: str | Path, **kw) -> "EmbeddingHub":
        return cls(path, **kw)

    @classmethod
    def in_memory(cls, **kw) -> "EmbeddingHub":
        return cls(None, **kw)

    _QUANTIZED = {
        "flat-bf16": "bfloat16",
        "flat-int8": "int8",
        "flat-int8x2": "int8x2",
    }
    _SHARDED = {"sharded": "float32", "sharded-int8": "int8", "sharded-int8x2": "int8x2"}

    def _make_index(self, dims: int, metric: str):
        """The index of a new version: ``None`` (the version's default
        ``FlatIndex``), a quantized ``FlatIndex``, a ``ShardedFlatIndex`` or
        ``ShardedHNSWIndex`` on the hub's mesh, or an ``HNSWIndex`` from the
        configuration."""
        if self.engine == "flat":
            return None
        if self.engine in self._QUANTIZED:
            return FlatIndex(dims, metric=metric, storage_dtype=self._QUANTIZED[self.engine],
                             device=self.device)
        if self.engine in self._SHARDED:
            return ShardedFlatIndex(dims, metric=metric, mesh=self.mesh,
                                    storage_dtype=self._SHARDED[self.engine])
        cfg = self.config
        if self.engine == "hnsw-sharded":
            return ShardedHNSWIndex(dims, metric=metric, mesh=self.mesh, m=cfg.hnsw_m,
                                    ef_construction=cfg.hnsw_ef_construction,
                                    ef_search=cfg.hnsw_ef_search)
        idx = HNSWIndex(dims, metric=metric, m=cfg.hnsw_m,
                        ef_construction=cfg.hnsw_ef_construction,
                        ef_search=cfg.hnsw_ef_search, device=self.device)
        # the centroid route, fitted by the index's first search past
        # hnsw_route_min rows
        idx.auto_seed_probes = cfg.hnsw_seed_probes
        idx.auto_route_min = cfg.hnsw_route_min
        return idx

    # ----------------------------------------------------------------- spaces

    def create_space(self, name: str, dims: int, metric: str = "l2") -> Space:
        """Create a space with its default "initial" version."""
        name = str(name)
        with self._lock:
            if name in self._spaces:
                return self._spaces[name]
            space = Space(name, self._space_path(name), device=self.device,
                          make_index=self._make_index, mesh=self.mesh)
            space.create_version(DEFAULT_VERSION, dims, metric,
                                 index=self._make_index(dims, metric))
            self._spaces[name] = space
            self._save_manifest()
            return space

    def get_space(self, name: str) -> Space | None:
        with self._lock:
            return self._spaces.get(str(name))

    def delete_space(self, name: str) -> None:
        name = str(name)
        with self._lock:
            self._spaces.pop(name, None)
            if self.base_path is not None:
                shutil.rmtree(self.base_path / name, ignore_errors=True)
            self._save_manifest()

    def spaces(self) -> list[str]:
        with self._lock:
            return list(self._spaces)

    def get_version(self, space_name: str, version_name: str = DEFAULT_VERSION):
        space = self.get_space(space_name)
        if space is None:
            return None
        return space.get_version(version_name)

    # ------------------------------------------------------------ persistence

    def save(self) -> None:
        """Snapshot every space (subsumes and truncates the WALs)."""
        with self._lock:
            for space in self._spaces.values():
                space.save()
            self._save_manifest()

    def _space_path(self, name: str) -> Path | None:
        return self.base_path / name if self.base_path is not None else None

    def _manifest_path(self) -> Path:
        return self.base_path / "manifest.json"

    def _save_manifest(self) -> None:
        if self.base_path is None:
            return
        manifest = {"spaces": {name: {"path": str(self._space_path(name)), "name": name}
                               for name in self._spaces}}
        tmp = self._manifest_path().with_suffix(".tmp")
        tmp.write_text(json.dumps(manifest))
        os.replace(tmp, self._manifest_path())

    def _load_manifest(self) -> None:
        mp = self._manifest_path()
        if not mp.exists():
            return
        manifest = json.loads(mp.read_text())
        for name in manifest.get("spaces", {}):
            # the space's directory under this base path: the manifest's
            # "path" goes stale when the data directory moves
            self._spaces[name] = Space.load(name, self._space_path(name),
                                            device=self.device,
                                            make_index=self._make_index, mesh=self.mesh)
