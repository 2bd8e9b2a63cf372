"""Space: a named table holding versions.

The twin of ``embeddinghub_tpu/store/space.py``.  With a ``path`` a space
is a directory with one subdirectory per version: its ``config.json``
row (space, name, dims, metric), its WAL ``wal.bin`` and, once saved, its
snapshot (``store/persistence.py``).  Every index is created or loaded on
the space's ``device`` (a sharded snapshot onto its ``mesh``);
``make_index(dims, metric)`` gives the index of a version rebuilt from its
WAL alone (``None``: a ``FlatIndex``).
"""

from __future__ import annotations

import json
from pathlib import Path

from embeddinghub_tpu_torch.store.persistence import (
    VersionWal,
    _replay_into,
    load_version,
    save_version,
)
from embeddinghub_tpu_torch.store.version import Version
from embeddinghub_tpu_torch.utils.device import DEFAULT as DEFAULT_DEVICE

DEFAULT_VERSION = "initial"


class Space:
    def __init__(self, name: str, path: str | Path | None = None,
                 device=DEFAULT_DEVICE, make_index=None, mesh=None):
        self.name = name
        self.path = Path(path) if path is not None else None
        self.device = device
        self.mesh = mesh
        self.make_index = make_index
        self._versions: dict[str, Version] = {}

    def create_version(self, name: str, dims: int, metric: str = "l2",
                       index=None) -> Version:
        if name in self._versions:
            return self._versions[name]
        wal = None
        if self.path is not None:
            vdir = self.path / name
            wal = VersionWal(vdir / "wal.bin")
            # The config row written up front lets a WAL-only recovery know
            # dims and metric.
            (vdir / "config.json").write_text(json.dumps(
                {"space": self.name, "name": name, "dims": int(dims), "metric": metric}))
        version = Version(self.name, name, dims, metric, index=index,
                          device=self.device, wal=wal)
        self._versions[name] = version
        return version

    def get_version(self, name: str) -> Version | None:
        return self._versions.get(name)

    def default_version(self) -> Version | None:
        return self._versions.get(DEFAULT_VERSION)

    def versions(self) -> list[str]:
        return list(self._versions)

    # -------------------------------------------------------------- snapshot

    def save(self) -> None:
        if self.path is None:
            return
        for name, version in self._versions.items():
            save_version(self.path / name, version)

    @classmethod
    def load(cls, name: str, path: str | Path, device=DEFAULT_DEVICE,
             make_index=None, mesh=None) -> "Space":
        space = cls(name, path, device=device, make_index=make_index, mesh=mesh)
        path = Path(path)
        if path.exists():
            for vdir in sorted(p for p in path.iterdir() if p.is_dir()):
                if (vdir / "meta.json").exists():
                    v = load_version(vdir, wal_path=vdir / "wal.bin", device=device,
                                     mesh=mesh)
                    space._versions[v.name] = v
                elif (vdir / "wal.bin").exists():
                    space._rebuild_from_wal(vdir)
        return space

    def _rebuild_from_wal(self, vdir: Path) -> None:
        """A version with a WAL and no snapshot yet: replay it whole."""
        cfg_path = vdir / "config.json"
        if cfg_path.exists():
            cfg = json.loads(cfg_path.read_text())
            dims, metric = cfg["dims"], cfg.get("metric", "l2")
        else:
            # A WAL without a config row: dims from the first set record,
            # metric l2, as the reference assumes.
            dims, metric = None, "l2"
            for rec in VersionWal.replay(vdir / "wal.bin"):
                if rec[0] == "set":
                    dims = len(rec[2])
                    break
            if dims is None:
                return
        index = self.make_index(dims, metric) if self.make_index else None
        version = Version(self.name, vdir.name, dims, metric, index=index,
                          device=self.device)
        _replay_into(version, vdir / "wal.bin")
        version._wal = VersionWal(vdir / "wal.bin")
        self._versions[vdir.name] = version
