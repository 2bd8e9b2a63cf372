"""Redis-protocol online + vector store.

Speaks raw RESP2 over a socket (the image ships no redis-py) and issues
the SAME command shapes as the reference's rueidis-based provider
(``provider/redis.go``):

  * table key     = JSON ``{"Prefix","Feature","Variant"}`` (redis.go:27-34)
  * scalar writes = ``HSET <tablekey> <entity> <value>`` (redis.go:303-309)
  * vector writes = per-entity hash key JSON ``{Prefix,Feature,Variant,
    Entity}`` with a base64-named vector field holding little-endian f32
    bytes (redis.go:377-431, rueidis.VectorString32)
  * index create  = ``FT.CREATE <idx> SCHEMA <field> VECTOR HNSW 6 TYPE
    FLOAT32 DIM d DISTANCE_METRIC COSINE`` (redis.go:245-262)
  * nearest       = ``FT.SEARCH <idx> *=>[KNN $K @field $BLOB] SORTBY
    __field_score PARAMS 4 K k BLOB <bytes> DIALECT 2`` (redis.go:480-493)

Works against a real Redis/RediSearch endpoint when one is reachable;
the JAX package's tests run its twin against an in-process RESP fake
(``providers/redis_fake.py`` there; this package has no copy of it yet),
the reference's ``unit_test_store.go`` pattern applied to the wire.
"""

from __future__ import annotations

import base64
import json
import socket
import struct
import threading
from typing import Any, Iterable

from embeddinghub_tpu_torch.featurestore import fferr
from embeddinghub_tpu_torch.featurestore.providers import base

DEFAULT_PREFIX = "Featureform_table__"


class RespError(Exception):
    pass


class RespClient:
    """Minimal RESP2 client (inline pipelining not needed here)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 timeout: float = 5.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._buf = b""
        self._lock = threading.Lock()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    # --- encoding ---

    @staticmethod
    def _encode(args: list) -> bytes:
        out = [b"*%d\r\n" % len(args)]
        for a in args:
            if isinstance(a, str):
                a = a.encode()
            elif isinstance(a, (int, float)):
                a = str(a).encode()
            out.append(b"$%d\r\n%s\r\n" % (len(a), a))
        return b"".join(out)

    # --- decoding ---

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise RespError("connection closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n + 2:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise RespError("connection closed")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n + 2 :]
        return data

    def _read_reply(self):
        line = self._read_line()
        t, rest = line[:1], line[1:]
        if t == b"+":
            return rest.decode()
        if t == b"-":
            raise RespError(rest.decode())
        if t == b":":
            return int(rest)
        if t == b"$":
            n = int(rest)
            if n == -1:
                return None
            return self._read_exact(n)
        if t == b"*":
            n = int(rest)
            if n == -1:
                return None
            return [self._read_reply() for _ in range(n)]
        raise RespError(f"bad RESP type byte {t!r}")

    def command(self, *args):
        with self._lock:
            self._sock.sendall(self._encode(list(args)))
            return self._read_reply()


def _vector_bytes(vec) -> bytes:
    import numpy as np

    v = np.asarray(vec, dtype="<f4").ravel()
    return v.tobytes()


def _vector_from_bytes(raw: bytes):
    return list(struct.unpack(f"<{len(raw) // 4}f", raw))


def _table_key(prefix: str, feature: str, variant: str) -> str:
    return json.dumps(
        {"Prefix": prefix, "Feature": feature, "Variant": variant},
        separators=(",", ":"),
    )


def _index_key(prefix: str, feature: str, variant: str, entity: str = "") -> str:
    return json.dumps(
        {"Prefix": prefix, "Feature": feature, "Variant": variant,
         "Entity": entity},
        separators=(",", ":"),
    )


def _vector_field(feature: str, variant: str) -> str:
    encoded = base64.b64encode(f"{feature}_{variant}".encode()).decode()
    return "vector_field_" + encoded.rstrip("=")  # Raw encoding, no pad


class RedisOnlineTable(base.OnlineStoreTable):
    def __init__(self, client: RespClient, prefix: str, feature: str,
                 variant: str, value_type: str = "string"):
        self._c = client
        self._key = _table_key(prefix, feature, variant)
        self._feature, self._variant = feature, variant
        self._vt = value_type

    def set(self, entity: str, value: Any) -> None:
        if isinstance(value, (list, tuple)):
            raw: Any = _vector_bytes(value)
        elif isinstance(value, bool):
            raw = "1" if value else "0"
        else:
            raw = str(value)
        self._c.command("HSET", self._key, str(entity), raw)

    def batch_set(self, items: Iterable[tuple[str, Any]]) -> None:
        for entity, value in items:
            self.set(entity, value)

    def get(self, entity: str) -> Any:
        raw = self._c.command("HGET", self._key, str(entity))
        if raw is None:
            raise fferr.EntityNotFoundError(
                self._feature, self._variant, str(entity)
            )
        if self._vt in ("embedding", "vector", "float32_vector"):
            return _vector_from_bytes(raw)
        text = raw.decode() if isinstance(raw, bytes) else raw
        if self._vt in ("int", "int32", "int64"):
            return int(text)
        if self._vt in ("float32", "float64"):
            return float(text)
        if self._vt == "bool":
            return text in ("1", "true", "True")
        return text


class RedisVectorTable(base.VectorStoreTable):
    def __init__(self, client: RespClient, prefix: str, feature: str,
                 variant: str, dims: int):
        self._c = client
        self._prefix = prefix
        self._feature, self._variant = feature, variant
        self._dims = dims
        self._field = _vector_field(feature, variant)
        self._idx = _index_key(prefix, feature, variant)

    def set(self, entity: str, value: Any) -> None:
        key = _index_key(self._prefix, self._feature, self._variant,
                         str(entity))
        self._c.command("HSET", key, self._field, _vector_bytes(value))

    def get(self, entity: str) -> Any:
        key = _index_key(self._prefix, self._feature, self._variant,
                         str(entity))
        raw = self._c.command("HGET", key, self._field)
        if raw is None:
            raise fferr.EntityNotFoundError(
                self._feature, self._variant, str(entity)
            )
        return _vector_from_bytes(raw)

    def nearest(self, feature: str, variant: str, vector, k: int) -> list[str]:
        reply = self._c.command(
            "FT.SEARCH",
            self._idx,
            f"*=>[KNN $K @{self._field} $BLOB]",
            "SORTBY", f"__{self._field}_score",
            # RediSearch defaults to LIMIT 0 10: without an explicit
            # LIMIT any k > 10 silently truncates (reference passes
            # Limit(0, k), redis.go:480-493)
            "LIMIT", "0", str(int(k)),
            "PARAMS", "4",
            "K", str(int(k)),
            "BLOB", _vector_bytes(vector),
            "DIALECT", "2",
        )
        # RESP: [count, key1, fields1, key2, fields2, ...]
        entities = []
        for item in reply[1::2]:
            key = item.decode() if isinstance(item, bytes) else item
            try:
                entities.append(json.loads(key)["Entity"])
            except (ValueError, KeyError):
                entities.append(key)
        return entities


class RedisOnlineStore(base.VectorStore):
    """Reference-faithful Redis online/vector store (type REDIS_ONLINE)."""

    ptype = "REDIS_ONLINE"

    def __init__(self, config: dict | None = None):
        config = config or {}
        self._prefix = config.get("prefix") or DEFAULT_PREFIX
        host = config.get("host", "127.0.0.1")
        port = int(config.get("port", 6379))
        try:
            self._c = RespClient(host, port)
        except OSError as e:
            raise fferr.ProviderError(
                f"cannot reach redis at {host}:{port}: {e}"
            )
        if config.get("password"):
            self._c.command("AUTH", config["password"])
        self._types: dict[tuple[str, str], str] = {}
        self._dims: dict[tuple[str, str], int] = {}

    def as_online_store(self):
        return self

    def check_health(self) -> bool:
        try:
            return self._c.command("PING") == "PONG"
        except (RespError, OSError):
            return False

    # ---- OnlineStore ----

    def create_table(self, feature, variant, value_type="string"):
        self._types[(feature, variant)] = value_type
        return RedisOnlineTable(
            self._c, self._prefix, feature, variant, value_type
        )

    def get_table(self, feature, variant):
        vt = self._types.get((feature, variant))
        if vt is None:
            key = _table_key(self._prefix, feature, variant)
            if not self._c.command("EXISTS", key) and (
                (feature, variant) not in self._dims
            ):
                raise fferr.ResourceNotFoundError(
                    "online table", feature, variant
                )
            vt = "string"
        if (feature, variant) in self._dims:
            return RedisVectorTable(
                self._c, self._prefix, feature, variant,
                self._dims[(feature, variant)],
            )
        return RedisOnlineTable(self._c, self._prefix, feature, variant, vt)

    def delete_table(self, feature, variant):
        self._c.command("DEL", _table_key(self._prefix, feature, variant))
        self._types.pop((feature, variant), None)

    # ---- VectorStore ----

    def create_index(self, feature, variant, dims):
        idx = _index_key(self._prefix, feature, variant)
        field = _vector_field(feature, variant)
        try:
            self._c.command(
                "FT.CREATE", idx, "SCHEMA", field, "VECTOR", "HNSW", "6",
                "TYPE", "FLOAT32", "DIM", str(int(dims)),
                "DISTANCE_METRIC", "COSINE",
            )
        except RespError as e:
            if "exists" not in str(e).lower():
                raise fferr.ProviderError(f"FT.CREATE failed: {e}")
        self._dims[(feature, variant)] = int(dims)
        return RedisVectorTable(self._c, self._prefix, feature, variant, dims)

    def delete_index(self, feature, variant):
        # reference DeleteIndex is a TODO no-op (redis.go:240-243)
        self._dims.pop((feature, variant), None)


base.register_factory("REDIS_ONLINE", lambda cfg: RedisOnlineStore(cfg))
