"""In-memory online store.

The reference tests "distributed" logic against an in-memory mock
online store (``provider/unit_test_store.go``, registered as the
UNIT_TEST type); this is the same idea promoted to a first-class local
provider (type ``MEMORY_ONLINE``).
"""

from __future__ import annotations

import threading
from typing import Any, Iterable

from embeddinghub_tpu_torch.featurestore import fferr
from embeddinghub_tpu_torch.featurestore.providers import base


class MemoryOnlineTable(base.OnlineStoreTable):
    def __init__(self):
        self._d: dict[str, Any] = {}
        self._lock = threading.Lock()

    def set(self, entity: str, value: Any) -> None:
        with self._lock:
            self._d[str(entity)] = value

    def batch_set(self, items: Iterable[tuple[str, Any]]) -> None:
        with self._lock:
            for entity, value in items:
                self._d[str(entity)] = value

    def get(self, entity: str) -> Any:
        try:
            return self._d[str(entity)]
        except KeyError:
            raise fferr.EntityNotFoundError("", "", str(entity))

    def entities(self) -> list[str]:
        with self._lock:
            return list(self._d)


class MemoryOnlineStore(base.OnlineStore):
    ptype = "MEMORY_ONLINE"

    def __init__(self, config: dict | None = None):
        self._tables: dict[tuple[str, str], MemoryOnlineTable] = {}
        self._lock = threading.Lock()

    def as_online_store(self):
        return self

    def create_table(self, feature, variant, value_type="float32"):
        with self._lock:
            return self._tables.setdefault(
                (feature, variant), MemoryOnlineTable()
            )

    def get_table(self, feature, variant):
        try:
            return self._tables[(feature, variant)]
        except KeyError:
            raise fferr.ResourceNotFoundError("online table", feature, variant)

    def delete_table(self, feature, variant):
        with self._lock:
            self._tables.pop((feature, variant), None)


base.register_factory("MEMORY_ONLINE", lambda cfg: MemoryOnlineStore(cfg))
