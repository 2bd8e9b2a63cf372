"""Provider abstraction.

Rebuild of reference ``provider/provider.go`` (factory registry +
``AsOnlineStore``/``AsOfflineStore``), ``provider/online.go`` (online
tables, ``VectorStore``/``VectorStoreTable`` at ``online.go:55-64``) and
the materialization/training-set parts of ``provider/offline.go``
(``OfflineStore`` at ``offline.go:509-546``, chunked
``Materialization`` at ``offline.go:589-608``).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator

from embeddinghub_tpu_torch.featurestore import fferr

_FACTORIES: dict[str, Callable[[dict], "Provider"]] = {}
_INSTANCES: dict[str, "Provider"] = {}


def register_factory(ptype: str, factory: Callable[[dict], "Provider"]) -> None:
    _FACTORIES[ptype] = factory


def get_provider(ptype: str, config: dict, cache_key: str | None = None) -> "Provider":
    """Instantiate (and cache) a provider from its serialized config —
    the reference's ``provider.Get`` (``provider.go:92-105``)."""
    if cache_key is not None and cache_key in _INSTANCES:
        return _INSTANCES[cache_key]
    if ptype not in _FACTORIES:
        raise fferr.ProviderError(f"unknown provider type: {ptype}")
    p = _FACTORIES[ptype](config)
    if cache_key is not None:
        _INSTANCES[cache_key] = p
    return p


def reset_provider_cache() -> None:
    _INSTANCES.clear()


class Provider:
    ptype: str = "BASE"

    def as_online_store(self) -> "OnlineStore":
        raise fferr.ProviderTypeError(self.ptype, "OnlineStore")

    def as_offline_store(self) -> "OfflineStore":
        raise fferr.ProviderTypeError(self.ptype, "OfflineStore")

    def check_health(self) -> bool:
        return True


# ------------------------------------------------------------------- online


class OnlineStoreTable:
    def set(self, entity: str, value: Any) -> None:
        raise NotImplementedError

    def get(self, entity: str) -> Any:
        raise NotImplementedError

    def batch_set(self, items: Iterable[tuple[str, Any]]) -> None:
        for entity, value in items:
            self.set(entity, value)


class OnlineStore(Provider):
    def get_table(self, feature: str, variant: str) -> OnlineStoreTable:
        raise NotImplementedError

    def create_table(
        self, feature: str, variant: str, value_type: str
    ) -> OnlineStoreTable:
        raise NotImplementedError

    def delete_table(self, feature: str, variant: str) -> None:
        raise NotImplementedError


class VectorStoreTable(OnlineStoreTable):
    def nearest(self, feature: str, variant: str, vector, k: int) -> list[str]:
        raise NotImplementedError


class VectorStore(OnlineStore):
    """Adds ANN index management (reference online.go:55-64; the Redis
    impl created an HNSW index via FT.CREATE, redis.go:245-262)."""

    def create_index(self, feature: str, variant: str, dims: int) -> VectorStoreTable:
        raise NotImplementedError

    def delete_index(self, feature: str, variant: str) -> None:
        raise NotImplementedError


# ------------------------------------------------------------------ offline


def lag_cutoff(lab_ts, lag_s):
    """Label timestamp shifted back by ``lag_s`` seconds, in the
    timestamp's own domain: numerics subtract seconds, datetime-likes
    (datetime / pandas.Timestamp / numpy.datetime64) subtract a
    timedelta, ISO-format strings round-trip through datetime (ISO
    string order is chronological, so the string cutoff compares
    correctly against string columns)."""
    if not lag_s or lab_ts is None:
        return lab_ts
    import datetime as _dt

    if isinstance(lab_ts, bool):
        raise TypeError("boolean label timestamp")
    if isinstance(lab_ts, (int, float)):
        return lab_ts - lag_s
    if isinstance(lab_ts, str):
        try:
            return str(float(lab_ts) - lag_s)
        except ValueError:
            sep = lab_ts[10] if len(lab_ts) > 10 else "T"
            shifted = _dt.datetime.fromisoformat(lab_ts) - _dt.timedelta(
                seconds=lag_s)
            return shifted.isoformat(sep=sep)
    if hasattr(lab_ts, "item"):
        v = lab_ts.item()  # numpy scalar -> python scalar/datetime
        if not type(v) is type(lab_ts):
            return lag_cutoff(v, lag_s)
    try:  # datetime / pandas.Timestamp
        return lab_ts - _dt.timedelta(seconds=lag_s)
    except TypeError:
        raise TypeError(
            f"cannot lag timestamp of type {type(lab_ts).__name__}")


class Materialization:
    """A chunk-iterable snapshot of (entity, value) pairs — reference
    ``offline.go:589-608``."""

    def __init__(self, mat_id: str, rows: list[tuple[str, Any]], chunk_size: int = 4096):
        self.id = mat_id
        self._rows = rows
        self._chunk = max(1, chunk_size)

    def __len__(self) -> int:
        return len(self._rows)

    def num_chunks(self) -> int:
        return -(-len(self._rows) // self._chunk) if self._rows else 0

    def iterate_chunk(self, idx: int) -> Iterator[tuple[str, Any]]:
        start = idx * self._chunk
        yield from self._rows[start : start + self._chunk]

    def rows(self) -> Iterator[tuple[str, Any]]:
        yield from self._rows


class OfflineStore(Provider):
    """Core + Dataset + Materialization + TrainingSet (offline.go:509)."""

    # --- datasets / sources
    def register_primary(self, name: str, variant: str, location: Any) -> None:
        raise NotImplementedError

    def create_transformation(
        self, name: str, variant: str, transformation: dict, inputs: list
    ) -> None:
        raise NotImplementedError

    def table_rows(self, name: str, variant: str) -> list[dict]:
        raise NotImplementedError

    def write_rows(self, name: str, variant: str, rows: list[dict]) -> None:
        raise NotImplementedError

    def append_rows(self, name: str, variant: str, rows: list[dict]) -> None:
        """Append to a source table (streaming writes — reference
        ``offlineTable.Write``, api/api.go:1212-1219).  Default is
        read-extend-rewrite; providers may override with a native
        append."""
        from embeddinghub_tpu_torch.featurestore import fferr

        try:
            existing = list(self.table_rows(name, variant))
        except fferr.FFError:
            existing = []
        self.write_rows(name, variant, existing + list(rows))

    # --- materialization
    def materialize(
        self,
        name: str,
        variant: str,
        entity_column: str,
        value_column: str,
        timestamp_column: str = "",
    ) -> Materialization:
        raise NotImplementedError

    # --- training sets
    #
    # Feature specs may carry a "lag" (seconds): the join then takes
    # the feature's value as of (label ts - lag) instead of the label
    # ts itself (reference provider/k8s.go:63-75 shifts by LagDelta).
    # ``lag_cutoff`` computes that shifted cutoff in the timestamp's
    # own domain so providers compare like with like.
    def create_training_set(
        self,
        ts_name: str,
        ts_variant: str,
        label: dict,
        features: list[dict],
    ) -> None:
        raise NotImplementedError

    def training_set_rows(
        self, ts_name: str, ts_variant: str
    ) -> Iterator[tuple[list, Any]]:
        raise NotImplementedError
