"""Pandas + filestore offline store.

Occupies the reference's *filestore-backed* offline seat — Spark/k8s
offline stores compute over DataFrames read from object storage
(``provider/spark.go`` + ``provider/scripts/spark/
offline_store_spark_runner.py:1112`` executes dill'd pandas/pyspark DF
transforms; ``provider/filestore.go`` supplies the path abstraction).
Here the compute engine is in-process pandas and the filestore is a
local directory of jsonl datasets, so the whole contract runs without
external infra while keeping the architecture's shape: datasets are
*files*, transformations produce new files, and a fresh process can
reopen the directory and serve the same tables.

SQL transformations execute on a transient sqlite connection fed from
the input frames — the local stand-in for shipping SQL to an external
engine, exactly the role ``offline_store_spark_runner.py:851``
(execute_sql_query) plays on Spark.

Row-list semantics (register/table_rows/df-transform signatures) are
identical to :mod:`.sqlite_offline`, so the shared provider contract
suite runs unchanged against both engines
(``tests/test_provider_contract.py``).
"""

from __future__ import annotations

import json
import os
import re
import sqlite3
import threading
from typing import Any, Iterator

from embeddinghub_tpu_torch.featurestore import fferr
from embeddinghub_tpu_torch.featurestore.providers import base


def _safe(kind: str, name: str, variant: str) -> str:
    return re.sub(r"[^A-Za-z0-9_]", "_", f"{kind}__{name}__{variant}")


class PandasOfflineStore(base.OfflineStore):
    ptype = "PANDAS_OFFLINE"

    def __init__(self, config: dict | None = None):
        import pandas as pd  # deferred: keep provider registry import light

        self._pd = pd
        config = config or {}
        self._dir = config.get("path")  # None = memory-only
        self._frames: dict[str, Any] = {}
        self._lock = threading.RLock()
        if self._dir:
            os.makedirs(self._dir, exist_ok=True)

    def as_offline_store(self):
        return self

    def check_health(self) -> bool:
        return self._dir is None or os.path.isdir(self._dir)

    # ------------------------------------------------------------ files

    def _file(self, key: str) -> str:
        return os.path.join(self._dir, f"{key}.jsonl")

    def _put(self, key: str, df) -> None:
        with self._lock:
            self._frames[key] = df.reset_index(drop=True)
            if self._dir:
                tmp = self._file(key) + ".tmp"
                df.to_json(tmp, orient="records", lines=True)
                os.replace(tmp, self._file(key))

    def _get(self, key: str, name: str, variant: str):
        with self._lock:
            if key in self._frames:
                return self._frames[key]
            if self._dir and os.path.exists(self._file(key)):
                df = self._pd.read_json(self._file(key), orient="records",
                                        lines=True)
                self._frames[key] = df
                return df
        raise fferr.ResourceNotFoundError("source table", name, variant)

    # --------------------------------------------------------- datasets

    def register_primary(self, name: str, variant: str, location: Any) -> None:
        pd = self._pd
        if isinstance(location, dict) and "rows" in location:
            self.write_rows(name, variant, location["rows"])
        elif isinstance(location, dict) and "csv" in location:
            self._put(_safe("src", name, variant), pd.read_csv(location["csv"]))
        elif isinstance(location, dict) and "parquet" in location:
            self._put(
                _safe("src", name, variant), pd.read_parquet(location["parquet"])
            )
        else:
            raise fferr.InvalidResourceError(
                f"unsupported primary location: {location!r}"
            )

    def write_rows(self, name: str, variant: str, rows: list[dict]) -> None:
        if not rows:
            raise fferr.InvalidResourceError("cannot register empty primary data")
        self._put(_safe("src", name, variant), self._pd.DataFrame(rows))

    def table_rows(self, name: str, variant: str) -> list[dict]:
        df = self._get(_safe("src", name, variant), name, variant)
        return df.to_dict(orient="records")

    # --------------------------------------------------- transformations

    def create_transformation(
        self, name: str, variant: str, transformation: dict, inputs: list
    ) -> None:
        pd = self._pd
        if "sql" in transformation:
            con = sqlite3.connect(":memory:")
            try:
                query = transformation["sql"]
                seen = set(inputs)
                for m in re.finditer(r"\{\{\s*([\w-]+)\.([\w-]+)\s*\}\}", query):
                    seen.add((m.group(1), m.group(2)))
                for n, v in seen:
                    df = self._get(_safe("src", n, v), n, v)
                    df.to_sql(_safe("src", n, v), con, index=False)
                    query = re.sub(
                        r"\{\{\s*" + re.escape(f"{n}.{v}") + r"\s*\}\}",
                        _safe("src", n, v),
                        query,
                    )
                try:
                    out = pd.read_sql_query(query, con)
                except Exception as e:  # bad SQL is a user error
                    raise fferr.InvalidResourceError(
                        f"sql transformation failed: {e}"
                    )
            finally:
                con.close()
            # empty results are legal (a filter may match nothing) —
            # the sqlite engine's CREATE TABLE AS accepts them too
            self._put(_safe("src", name, variant), out)
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

    # ----------------------------------------------------- materialization

    def materialize(
        self, name, variant, entity_column, value_column, timestamp_column=""
    ) -> base.Materialization:
        df = self._get(_safe("src", name, variant), name, variant)
        if entity_column not in df.columns or value_column not in df.columns:
            raise fferr.InvalidResourceError(
                f"materialization columns missing: have {list(df.columns)}, "
                f"want {entity_column}/{value_column}"
            )
        if timestamp_column and timestamp_column in df.columns:
            # stable sort => for ts ties the LAST written row wins,
            # matching the sqlite engine's >= update rule
            df = df.sort_values(timestamp_column, kind="stable")
        latest = df.groupby(df[entity_column].astype(str), sort=False).tail(1)
        mat_rows = [
            (str(e), v)
            for e, v in zip(latest[entity_column], latest[value_column])
        ]
        return base.Materialization(f"{name}.{variant}", mat_rows)

    # ------------------------------------------------------- trainingsets

    def create_training_set(self, ts_name, ts_variant, label, features) -> None:
        pd = self._pd
        lab = self._get(
            _safe("src", label["source"][0], label["source"][1]),
            *label["source"],
        )
        out = []
        # Pre-group each feature frame by (stringified) entity once —
        # the per-label-row scan was O(labels x features x rows) with a
        # full-column astype per lookup
        feat_groups = []
        for f in features:
            fdf = self._get(
                _safe("src", f["source"][0], f["source"][1]), *f["source"]
            )
            ecol, tcol = f["entity_column"], f.get("timestamp_column") or ""
            if tcol and tcol in fdf.columns:
                fdf = fdf.sort_values(tcol, kind="stable")
            groups = dict(tuple(fdf.groupby(fdf[ecol].astype(str), sort=False)))
            feat_groups.append((f, groups, tcol if tcol in fdf.columns else ""))
        for lr in lab.to_dict(orient="records"):
            entity = str(lr[label["entity_column"]])
            lab_ts = lr.get(label.get("timestamp_column") or "", None)
            fvals = []
            for f, groups, tcol in feat_groups:
                rows = groups.get(entity)
                # lagged features shift the cutoff back by lag seconds
                cutoff = base.lag_cutoff(lab_ts, f.get("lag"))
                if rows is not None and tcol and cutoff is not None:
                    rows = rows[rows[tcol] <= cutoff]  # no future features
                if rows is not None and len(rows):
                    fvals.append(rows.iloc[-1][f["value_column"]])
                else:
                    fvals.append(None)
            out.append({
                "features": json.dumps([_plain(v) for v in fvals]),
                "label": _plain(lr[label["value_column"]]),
            })
        self._put(_safe("src", f"ts__{ts_name}", ts_variant), pd.DataFrame(out))

    def training_set_rows(self, ts_name, ts_variant) -> Iterator[tuple[list, Any]]:
        df = self._get(
            _safe("src", f"ts__{ts_name}", ts_variant), f"ts__{ts_name}",
            ts_variant,
        )
        for r in df.to_dict(orient="records"):
            feats = r["features"]
            if isinstance(feats, str):
                feats = json.loads(feats)
            yield feats, r["label"]


def _plain(v):
    """numpy scalars -> python scalars so json/proto encoding stays clean."""
    return v.item() if hasattr(v, "item") else v


base.register_factory("PANDAS_OFFLINE", lambda cfg: PandasOfflineStore(cfg))
