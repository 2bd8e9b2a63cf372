"""SQLite offline store.

Stands where the reference's SQL offline stores stand
(``provider/postgres.go`` et al.): primary table registration, SQL
transformations, point-in-time-correct materialization, training-set
joins.  A single-file local engine keeps the whole contract testable
without external infra (the role ``provider/memory.go`` plays in the
reference), while the SQL surface mirrors the production providers.
"""

from __future__ import annotations

import json
import re
import sqlite3
import threading
from typing import Any, Iterator

from embeddinghub_tpu_torch.featurestore import fferr
from embeddinghub_tpu_torch.featurestore.providers import base


def _table_name(kind: str, name: str, variant: str) -> str:
    safe = re.sub(r"[^A-Za-z0-9_]", "_", f"{kind}__{name}__{variant}")
    return safe


class SqliteOfflineStore(base.OfflineStore):
    ptype = "SQLITE_OFFLINE"

    def __init__(self, config: dict | None = None):
        config = config or {}
        self._path = config.get("path", ":memory:")
        self._local = threading.local()
        self._lock = threading.RLock()
        # one shared connection for :memory:, per-thread for files
        self._shared = (
            sqlite3.connect(":memory:", check_same_thread=False)
            if self._path == ":memory:"
            else None
        )

    def _con(self) -> sqlite3.Connection:
        if self._shared is not None:
            return self._shared
        if not hasattr(self._local, "con"):
            self._local.con = sqlite3.connect(self._path)
        return self._local.con

    def as_offline_store(self):
        return self

    # ------------------------------------------------------------- datasets

    def register_primary(self, name: str, variant: str, location: Any) -> None:
        """location: {"rows": [dict, ...]} inline data or
        {"csv": path} / {"table": existing-table-name}."""
        if isinstance(location, dict) and "rows" in location:
            self.write_rows(name, variant, location["rows"])
        elif isinstance(location, dict) and "csv" in location:
            import csv

            with open(location["csv"]) as f:
                rows = list(csv.DictReader(f))
            self.write_rows(name, variant, rows)
        elif isinstance(location, dict) and "table" in location:
            tbl = _table_name("src", name, variant)
            with self._lock:
                self._con().execute(
                    f"CREATE TABLE IF NOT EXISTS {tbl} AS SELECT * FROM {location['table']}"
                )
                self._con().commit()
        else:
            raise fferr.InvalidResourceError(
                f"unsupported primary location: {location!r}"
            )

    def write_rows(self, name: str, variant: str, rows: list[dict]) -> None:
        if not rows:
            raise fferr.InvalidResourceError("cannot register empty primary data")
        tbl = _table_name("src", name, variant)
        cols = list(rows[0].keys())
        col_defs = ", ".join(f'"{c}"' for c in cols)
        ph = ", ".join("?" for _ in cols)
        with self._lock:
            con = self._con()
            con.execute(f"DROP TABLE IF EXISTS {tbl}")
            con.execute(f"CREATE TABLE {tbl} ({col_defs})")
            con.executemany(
                f"INSERT INTO {tbl} VALUES ({ph})",
                [tuple(_encode(r.get(c)) for c in cols) for r in rows],
            )
            con.commit()

    def create_transformation(
        self, name: str, variant: str, transformation: dict, inputs: list
    ) -> None:
        """SQL transformations reference inputs as ``{{ name.variant }}``
        (the reference's template style in register.py sql_transformation
        decorators); DF transformations receive input row-lists and
        return a row-list."""
        tbl = _table_name("src", name, variant)
        if "sql" in transformation:
            query = transformation["sql"]
            for n, v in inputs:
                query = re.sub(
                    r"\{\{\s*" + re.escape(f"{n}.{v}") + r"\s*\}\}",
                    _table_name("src", n, v),
                    query,
                )
            query = re.sub(r"\{\{\s*([\w-]+)\.([\w-]+)\s*\}\}",
                           lambda m: _table_name("src", m.group(1), m.group(2)),
                           query)
            with self._lock:
                con = self._con()
                con.execute(f"DROP TABLE IF EXISTS {tbl}")
                con.execute(f"CREATE TABLE {tbl} AS {query}")
                con.commit()
        elif "df" in transformation:
            fn = transformation["df"]
            frames = [self.table_rows(n, v) for n, v in inputs]
            out = fn(*frames)
            if not isinstance(out, list) or not out:
                raise fferr.InvalidResourceError(
                    "df transformation must return a non-empty list of dicts"
                )
            self.write_rows(name, variant, out)
        else:
            raise fferr.InvalidResourceError(
                f"unsupported transformation: {list(transformation)}"
            )

    def table_rows(self, name: str, variant: str) -> list[dict]:
        tbl = _table_name("src", name, variant)
        con = self._con()
        try:
            cur = con.execute(f"SELECT * FROM {tbl}")
        except sqlite3.OperationalError:
            raise fferr.ResourceNotFoundError("source table", name, variant)
        cols = [c[0] for c in cur.description]
        return [dict(zip(cols, (_decode(v) for v in row))) for row in cur]

    # -------------------------------------------------------- materialization

    def materialize(
        self, name, variant, entity_column, value_column, timestamp_column=""
    ) -> base.Materialization:
        """Latest value per entity (point-in-time by timestamp when
        given — the reference's materialize_ts.sql semantics)."""
        rows = self.table_rows(name, variant)
        latest: dict[str, tuple[Any, Any]] = {}
        for r in rows:
            if entity_column not in r or value_column not in r:
                raise fferr.InvalidResourceError(
                    f"materialization columns missing: have {list(r)}, "
                    f"want {entity_column}/{value_column}"
                )
            e = str(r[entity_column])
            ts = r.get(timestamp_column) if timestamp_column else None
            if e not in latest or (ts is not None and ts >= latest[e][1]):
                latest[e] = (r[value_column], ts)
        mat_rows = [(e, v) for e, (v, _) in latest.items()]
        return base.Materialization(f"{name}.{variant}", mat_rows)

    # ----------------------------------------------------------- trainingsets

    def create_training_set(self, ts_name, ts_variant, label, features) -> None:
        """Join label rows with the latest feature value per entity at
        or before the label's timestamp (point-in-time correctness —
        the reference's training-set query)."""
        lab_rows = self.table_rows(label["source"][0], label["source"][1])
        feat_data = []
        for f in features:
            rows = self.table_rows(f["source"][0], f["source"][1])
            feat_data.append((f, rows))

        out = []
        for lr in lab_rows:
            entity = str(lr[label["entity_column"]])
            lab_ts = lr.get(label.get("timestamp_column") or "", None)
            fvals = []
            for f, rows in feat_data:
                ecol, vcol = f["entity_column"], f["value_column"]
                tcol = f.get("timestamp_column") or ""
                # lagged features shift the cutoff back by lag seconds
                # (reference provider/k8s.go:63-75 LagDelta semantics)
                cutoff = base.lag_cutoff(lab_ts, f.get("lag"))
                best, best_ts = None, None
                for r in rows:
                    if str(r[ecol]) != entity:
                        continue
                    ts = r.get(tcol) if tcol else None
                    if cutoff is not None and ts is not None and ts > cutoff:
                        continue  # feature from the future
                    if best is None or (ts is not None and (best_ts is None or ts >= best_ts)):
                        best, best_ts = r[vcol], ts
                fvals.append(best)
            out.append(
                {"features": json.dumps(fvals), "label": _encode(lr[label["value_column"]])}
            )
        self.write_rows(
            _ts_key(ts_name), ts_variant, out
        )

    def training_set_rows(self, ts_name, ts_variant) -> Iterator[tuple[list, Any]]:
        for r in self.table_rows(_ts_key(ts_name), ts_variant):
            feats = r["features"]
            if isinstance(feats, str):
                feats = json.loads(feats)
            yield feats, _decode(r["label"])


def _ts_key(name: str) -> str:
    return f"ts__{name}"


def _encode(v):
    if isinstance(v, (list, dict, tuple)):
        return json.dumps(v)
    return v


def _decode(v):
    if isinstance(v, str) and v[:1] in "[{":
        try:
            return json.loads(v)
        except (ValueError, TypeError):
            return v
    return v


base.register_factory("SQLITE_OFFLINE", lambda cfg: SqliteOfflineStore(cfg))
