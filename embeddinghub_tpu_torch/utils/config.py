"""Environment-driven configuration of the port's server: the fields of the
JAX package's ``utils/config.py`` that the port reads, under the same
environment variables, so one deployment configures both packages alike.
The JAX package's other knobs (compute dtype, initial capacity, mesh)
belong to modules that are not ported yet.

Mirrors the reference's env-var config style (reference:
``main/main.go:59-66`` / ``config/config.go``) with typed accessors.
The engine itself has a single required knob — the listen address — like
the reference binary (``embeddinghub/embeddingstore/main.cc:8``).
"""

from __future__ import annotations

import dataclasses
import os


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


@dataclasses.dataclass
class Config:
    """Process-wide configuration, resolved from environment variables."""

    # Service surface (reference default port: main.cc:8 -> 0.0.0.0:7462)
    host: str = "0.0.0.0"
    port: int = 7462
    data_dir: str = "embedding_store.dat"

    # Engine knobs
    engine: str = "flat"                # "flat" | "flat-bf16" | "flat-int8" |
                                        # "flat-int8x2" | "hnsw" | "sharded" |
                                        # "sharded-int8" | "sharded-int8x2" |
                                        # "hnsw-sharded" (store/hub.py)
    default_metric: str = "l2"          # "l2" | "cosine" | "ip"
    query_batch_window_ms: float = 2.0  # server-side batching window
    max_query_batch: int = 1024

    # HNSW defaults: hnswlib's (reference index.cc:10-15: M=16,
    # efConstruction=200, ef=10).  hnsw_seed_probes > 0 routes searches by
    # k-means centroids past hnsw_route_min rows (HNSWIndex.build_route).
    hnsw_m: int = 16
    hnsw_ef_construction: int = 200
    hnsw_ef_search: int = 10
    hnsw_seed_probes: int = 0
    hnsw_route_min: int = 1 << 20

    # The measured quantization audit (FlatIndex.audit_and_escalate):
    # "freeze" runs it when a version is made immutable, escalating a
    # quantized arena's dtype until device recall against an exact host
    # oracle reaches quant_audit_bar.
    quant_audit: str = "off"            # "off" | "freeze"
    quant_audit_bar: float = 0.95

    @staticmethod
    def from_env() -> "Config":
        return Config(
            host=_env("EMBEDDINGHUB_HOST", "0.0.0.0"),
            port=_env_int("EMBEDDINGHUB_PORT", 7462),
            data_dir=_env("EMBEDDINGHUB_DATA_DIR", "embedding_store.dat"),
            engine=_env("EMBEDDINGHUB_ENGINE", "flat"),
            default_metric=_env("EMBEDDINGHUB_METRIC", "l2"),
            query_batch_window_ms=float(_env("EMBEDDINGHUB_BATCH_WINDOW_MS", "2.0")),
            max_query_batch=_env_int("EMBEDDINGHUB_MAX_BATCH", 1024),
            hnsw_m=_env_int("EMBEDDINGHUB_HNSW_M", 16),
            hnsw_ef_construction=_env_int("EMBEDDINGHUB_HNSW_EFC", 200),
            hnsw_ef_search=_env_int("EMBEDDINGHUB_HNSW_EF", 10),
            hnsw_seed_probes=_env_int("EMBEDDINGHUB_HNSW_SEED_PROBES", 0),
            hnsw_route_min=_env_int("EMBEDDINGHUB_HNSW_ROUTE_MIN", 1 << 20),
            quant_audit=_env("EMBEDDINGHUB_QUANT_AUDIT", "off"),
            quant_audit_bar=float(_env("EMBEDDINGHUB_QUANT_AUDIT_BAR", "0.95")),
        )


_config: Config | None = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config.from_env()
    return _config
