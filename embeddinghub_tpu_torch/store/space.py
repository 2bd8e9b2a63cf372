"""Space: a named table holding versions.

The twin of ``embeddinghub_tpu/store/space.py``, in memory only: snapshots
and the WAL come with the port of ``store/persistence.py`` (ROADMAP.md,
queue 1).
"""

from __future__ import annotations

from embeddinghub_tpu_torch.store.version import Version

DEFAULT_VERSION = "initial"


class Space:
    def __init__(self, name: str, path=None, device="cpu"):
        if path is not None:
            raise NotImplementedError(
                "persistent spaces are not ported yet; see ROADMAP.md queue 1, "
                "store/persistence.py"
            )
        self.name = name
        self.device = device
        self._versions: dict[str, Version] = {}

    def create_version(self, name: str, dims: int, metric: str = "l2",
                       index=None) -> Version:
        if name in self._versions:
            return self._versions[name]
        version = Version(self.name, name, dims, metric, index=index,
                          device=self.device)
        self._versions[name] = version
        return version

    def get_version(self, name: str) -> Version | None:
        return self._versions.get(name)

    def default_version(self) -> Version | None:
        return self._versions.get(DEFAULT_VERSION)

    def versions(self) -> list[str]:
        return list(self._versions)
