"""MetadataStore — the resource registry.

Rebuild of the reference metadata service core
(``metadata/metadata.go``: create with equivalence dedupe, variant
listing, status transitions, deletion staging ``MarkForDeletion``/
``PruneResource`` at ``metadata.go:2402-2429``) minus the gRPC hop: the
store is an embeddable object (the serving/coordinator layers call it
directly; a gRPC facade can front it unchanged).

Storage is pluggable (reference ``storage/``: memory/psql/etcd): a
dict-backed store and a sqlite-backed store ship here.
"""

from __future__ import annotations

import sqlite3
import threading
import time
from typing import Callable, Iterable

from embeddinghub_tpu_torch.featurestore import fferr
from embeddinghub_tpu_torch.featurestore.resources import (
    Resource,
    ResourceID,
    ResourceType,
    Status,
    VARIANT_TYPES,
)


class MetadataStore:
    def __init__(self, storage: "KVStorage | None" = None):
        self._kv = storage if storage is not None else MemoryStorage()
        self._lock = threading.RLock()
        self._watchers: list[Callable[[Resource], None]] = []

    # ------------------------------------------------------------------ write

    def create(self, res: Resource) -> bool:
        """Create a resource.  Variant resources are immutable: identical
        re-registration is a no-op (returns False), conflicting
        re-registration raises (the GetEquivalent path).  Non-variant
        resources (users, providers, entities) upsert."""
        rid = res.rid()
        with self._lock:
            existing = self._get_raw(rid)
            if existing is not None:
                if rid.type in VARIANT_TYPES:
                    if existing.equiv_hash() == res.equiv_hash():
                        return False
                    raise fferr.ResourceChangedError(
                        rid.type.value, rid.name, rid.variant,
                        diff="differing fields: "
                        + ", ".join(existing.equiv_diff(res)),
                    )
                # upsert mutable resource types
            res.status = (
                Status.PENDING if res.needs_job() else Status.READY
            )
            self._put_raw(res)
        for w in list(self._watchers):
            w(res)
        return True

    def set_status(
        self, rid: ResourceID, status: Status, error: str = ""
    ) -> None:
        with self._lock:
            res = self._must_get(rid)
            res.status = status
            res.status_error = error
            self._put_raw(res)

    _STAGED = "staged-deletion/"

    def delete(self, rid: ResourceID) -> None:
        """Phase 1 of the two-phase delete (reference MarkForDeletion,
        ``metadata.go:2429``): the resource leaves the live namespace
        (gets/lists/dependency checks stop seeing it) but stays readable
        under a staged key until :meth:`prune` — the reference's
        DeletedOnly lookup that backs GetStagedForDeletionResource
        (``metadata.go:2558``)."""
        with self._lock:
            res = self._must_get(rid)
            dependents = self.dependents(rid)
            if dependents:
                raise fferr.InvalidResourceError(
                    f"cannot delete {rid.key()}: required by "
                    + ", ".join(d.key() for d in dependents)
                )
            res.status = Status.DELETING
            self._kv.put(self._STAGED + rid.key(), res)
            self._kv.delete(rid.key())

    def get_staged(self, rid: ResourceID) -> Resource:
        """The staged-for-deletion copy (reference DeletedOnly lookup)."""
        with self._lock:
            res = self._kv.get(self._STAGED + rid.key())
            if res is None:
                raise fferr.ResourceNotFoundError(
                    rid.type.value, rid.name, rid.variant or None
                )
            return res

    def prune(self, rid: ResourceID) -> None:
        """Phase 2: drop the staged copy (reference FinalizeDeletion /
        PruneResource, ``metadata.go:2402``).  Idempotent."""
        with self._lock:
            self._kv.delete(self._STAGED + rid.key())

    # ------------------------------------------------------------------- read

    def get(self, rid: ResourceID) -> Resource:
        with self._lock:
            return self._must_get(rid)

    def maybe_get(self, rid: ResourceID) -> Resource | None:
        with self._lock:
            return self._get_raw(rid)

    def list_type(self, rtype: ResourceType) -> list[Resource]:
        with self._lock:
            return [
                r
                for r in self._kv.values()
                if r.rtype == rtype and r.status != Status.DELETING
            ]

    def variants(self, rtype: ResourceType, name: str) -> list[Resource]:
        with self._lock:
            return [
                r
                for r in self._kv.values()
                if r.rtype == rtype and r.name == name
                and r.status != Status.DELETING
            ]

    def dependents(self, rid: ResourceID) -> list[ResourceID]:
        """Resources that list rid as a dependency (staged-for-deletion
        rows no longer hold their dependencies)."""
        out = []
        for r in self._kv.values():
            if r.status == Status.DELETING:
                continue
            if any(d.key() == rid.key() for d in r.dependencies()):
                out.append(r.rid())
        return out

    def all(self) -> list[Resource]:
        with self._lock:
            return [
                r for r in self._kv.values() if r.status != Status.DELETING
            ]

    # --------------------------------------------------------------- helpers

    def watch(self, fn: Callable[[Resource], None]) -> None:
        """Register a creation watcher (the coordinator subscribes)."""
        self._watchers.append(fn)

    def _must_get(self, rid: ResourceID) -> Resource:
        res = self._get_raw(rid)
        if res is None:
            raise fferr.ResourceNotFoundError(
                rid.type.value, rid.name, rid.variant or None
            )
        return res

    def _get_raw(self, rid: ResourceID) -> Resource | None:
        return self._kv.get(rid.key())

    def _put_raw(self, res: Resource) -> None:
        self._kv.put(res.rid().key(), res)


# ------------------------------------------------------------------ storage


class KVStorage:
    """Metadata KV interface (reference storage/metadata_storage.go)."""

    def get(self, key: str):
        raise NotImplementedError

    def put(self, key: str, value) -> None:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def values(self) -> Iterable:
        raise NotImplementedError


class MemoryStorage(KVStorage):
    def __init__(self):
        self._d: dict[str, Resource] = {}

    def get(self, key):
        return self._d.get(key)

    def put(self, key, value):
        self._d[key] = value

    def delete(self, key):
        self._d.pop(key, None)

    def values(self):
        return list(self._d.values())


class SqliteStorage(KVStorage):
    """Durable metadata KV (the psql analog for a single node).

    Resources are stored as typed JSON (resources.to_wire — pickle is
    gone at rest too); sqlite gives atomic writes + survives restarts.
    Versioned migrations run at open, each in its own transaction with
    the recorded version advancing alongside (the reference's goose
    migration boot step, main.go:93-105 / db/migrations) — an old data
    file from an earlier release upgrades in place, and a NEWER file
    than the code refuses to open rather than corrupt.
    """

    # append-only; never edit or reorder an entry that has shipped
    _MIGRATIONS: list[str] = [
        "CREATE TABLE IF NOT EXISTS resources "
        "(key TEXT PRIMARY KEY, val BLOB)",
        # v2: updated_at audit column + write-time index for the
        # dashboard's recency views
        "ALTER TABLE resources ADD COLUMN updated_at REAL",
        "CREATE INDEX IF NOT EXISTS resources_updated "
        "ON resources (updated_at)",
    ]

    def __init__(self, path: str):
        self._path = path
        self._local = threading.local()
        self._migrate(self._con())

    def _migrate(self, con: sqlite3.Connection) -> None:
        have = con.execute("PRAGMA user_version").fetchone()[0]
        want = len(self._MIGRATIONS)
        if have > want:
            raise fferr.InternalError(
                f"metadata file {self._path!r} is schema v{have}, newer "
                f"than this build (v{want}) — refusing to open"
            )
        for version in range(have, want):
            con.execute(self._MIGRATIONS[version])
            con.execute(f"PRAGMA user_version = {version + 1}")
            con.commit()

    @property
    def schema_version(self) -> int:
        return self._con().execute("PRAGMA user_version").fetchone()[0]

    def _con(self) -> sqlite3.Connection:
        if not hasattr(self._local, "con"):
            self._local.con = sqlite3.connect(self._path)
        return self._local.con

    def get(self, key):
        row = self._con().execute(
            "SELECT val FROM resources WHERE key=?", (key,)
        ).fetchone()
        if row is None:
            return None
        from embeddinghub_tpu_torch.featurestore.resources import from_wire

        return from_wire(row[0])

    def put(self, key, value):
        from embeddinghub_tpu_torch.featurestore.resources import to_wire

        blob = to_wire(value)
        con = self._con()
        con.execute(
            "INSERT INTO resources (key, val, updated_at) VALUES (?, ?, ?) "
            "ON CONFLICT(key) DO UPDATE SET val=excluded.val, "
            "updated_at=excluded.updated_at",
            (key, blob, time.time()),
        )
        con.commit()

    def delete(self, key):
        con = self._con()
        con.execute("DELETE FROM resources WHERE key=?", (key,))
        con.commit()

    def values(self):
        from embeddinghub_tpu_torch.featurestore.resources import from_wire

        return [
            from_wire(row[0])
            for row in self._con().execute("SELECT val FROM resources")
        ]
