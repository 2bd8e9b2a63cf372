"""Environment-driven configuration of the port's server: the fields of the
JAX package's ``utils/config.py`` that the port reads, under the same
environment variables, so one deployment configures both packages alike.
The JAX package's other knobs (HNSW, quantization audit, compute dtype,
initial capacity, mesh) belong to modules that are not ported yet.

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
    engine: str = "flat"                # only "flat" is ported (store/hub.py)
    default_metric: str = "l2"          # "l2" | "cosine" | "ip"
    query_batch_window_ms: float = 2.0  # server-side batching window
    max_query_batch: int = 1024

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
        )


_config: Config | None = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config.from_env()
    return _config
