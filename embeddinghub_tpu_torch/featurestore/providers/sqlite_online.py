"""SQLite-backed online store (type ``SQLITE_ONLINE``).

A durable, *cross-process* online store: the materialization worker
binary (``featurestore/worker.py``, analog of the reference's
``runner/worker/worker.go``) writes chunks into it from separate
processes, the serving layer reads them back — the role DynamoDB /
Cassandra play behind ``provider/online.go:42`` in the reference,
scaled to what exists in this image.

Values are stored as JSON (scalars/lists/dicts); numpy arrays land as
lists.  Writes use one transaction per batch (the reference's
``BatchSet``, ``online.go:66-70``).
"""

from __future__ import annotations

import json
import sqlite3
import threading
from typing import Any, Iterable

import numpy as np

from embeddinghub_tpu_torch.featurestore import fferr
from embeddinghub_tpu_torch.featurestore.providers import base


def _enc(v: Any) -> str:
    if isinstance(v, np.ndarray):
        v = v.tolist()
    if isinstance(v, (np.floating, np.integer)):
        v = v.item()
    return json.dumps(v)


def _dec(s: str) -> Any:
    return json.loads(s)


class SqliteOnlineTable(base.OnlineStoreTable):
    def __init__(self, store: "SqliteOnlineStore", feature: str, variant: str):
        self._store = store
        self._f, self._v = feature, variant

    def set(self, entity: str, value: Any) -> None:
        self.batch_set([(entity, value)])

    def batch_set(self, items: Iterable[tuple[str, Any]]) -> None:
        with self._store._txn() as cur:
            cur.executemany(
                "INSERT INTO online_values(feature, variant, entity, value)"
                " VALUES(?,?,?,?) ON CONFLICT(feature, variant, entity)"
                " DO UPDATE SET value=excluded.value",
                [
                    (self._f, self._v, str(e), _enc(val))
                    for e, val in items
                ],
            )

    def get(self, entity: str) -> Any:
        with self._store._txn() as cur:
            cur.execute(
                "SELECT value FROM online_values WHERE feature=? AND"
                " variant=? AND entity=?",
                (self._f, self._v, str(entity)),
            )
            row = cur.fetchone()
        if row is None:
            raise fferr.EntityNotFoundError(self._f, self._v, str(entity))
        return _dec(row[0])

    def entities(self) -> list[str]:
        with self._store._txn() as cur:
            cur.execute(
                "SELECT entity FROM online_values WHERE feature=? AND"
                " variant=?",
                (self._f, self._v),
            )
            return [r[0] for r in cur.fetchall()]


class SqliteOnlineStore(base.OnlineStore):
    ptype = "SQLITE_ONLINE"

    def __init__(self, config: dict | None = None):
        cfg = config or {}
        self._path = cfg.get("path", ":memory:")
        self._conn = sqlite3.connect(self._path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._txn() as cur:
            cur.execute(
                "CREATE TABLE IF NOT EXISTS online_tables("
                " feature TEXT, variant TEXT, value_type TEXT,"
                " PRIMARY KEY(feature, variant))"
            )
            cur.execute(
                "CREATE TABLE IF NOT EXISTS online_values("
                " feature TEXT, variant TEXT, entity TEXT, value TEXT,"
                " PRIMARY KEY(feature, variant, entity))"
            )

    class _Txn:
        def __init__(self, store):
            self._store = store

        def __enter__(self):
            self._store._lock.acquire()
            self._cur = self._store._conn.cursor()
            return self._cur

        def __exit__(self, et, ev, tb):
            try:
                if et is None:
                    self._store._conn.commit()
                else:
                    self._store._conn.rollback()
                self._cur.close()
            finally:
                self._store._lock.release()
            return False

    def _txn(self):
        return SqliteOnlineStore._Txn(self)

    def as_online_store(self):
        return self

    def check_health(self) -> bool:
        with self._txn() as cur:
            cur.execute("SELECT 1")
        return True

    def create_table(self, feature, variant, value_type="float32"):
        with self._txn() as cur:
            cur.execute(
                "INSERT OR IGNORE INTO online_tables(feature, variant,"
                " value_type) VALUES(?,?,?)",
                (feature, variant, value_type),
            )
        return SqliteOnlineTable(self, feature, variant)

    def get_table(self, feature, variant):
        with self._txn() as cur:
            cur.execute(
                "SELECT 1 FROM online_tables WHERE feature=? AND variant=?",
                (feature, variant),
            )
            if cur.fetchone() is None:
                raise fferr.ResourceNotFoundError(
                    "online table", feature, variant
                )
        return SqliteOnlineTable(self, feature, variant)

    def delete_table(self, feature, variant):
        with self._txn() as cur:
            cur.execute(
                "DELETE FROM online_tables WHERE feature=? AND variant=?",
                (feature, variant),
            )
            cur.execute(
                "DELETE FROM online_values WHERE feature=? AND variant=?",
                (feature, variant),
            )


base.register_factory("SQLITE_ONLINE", lambda cfg: SqliteOnlineStore(cfg))
