"""Structured logging with request-id propagation.

Rebuild of reference ``logging/`` (zap SugaredLogger wrapper with
request-id context propagation, ``logging.go:27,338``, and redaction):
stdlib logging with a contextvar request id, ``WithResource``-style
field binding, and value redaction for secret-ish keys.
"""

from __future__ import annotations

import contextvars
import json
import logging
import sys
import time
import uuid

_request_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "request_id", default=""
)

REDACTED_KEYS = {"password", "secret", "token", "api_key", "credentials"}


def new_request_id() -> str:
    rid = uuid.uuid4().hex[:16]
    _request_id.set(rid)
    return rid


def request_id() -> str:
    return _request_id.get()


def set_request_id(rid: str) -> None:
    """Bind an externally-supplied request id (e.g. forwarded over gRPC
    metadata by the api gateway) to the logging context."""
    _request_id.set(rid)


def redact(fields: dict) -> dict:
    return {
        k: ("<redacted>" if k.lower() in REDACTED_KEYS else v)
        for k, v in fields.items()
    }


class _StderrProxy:
    """Resolve sys.stderr at write time (keeps logs visible under
    stream-capturing test harnesses and daemonized redirects)."""

    def write(self, data):
        return sys.stderr.write(data)

    def flush(self):
        return sys.stderr.flush()


class Logger:
    def __init__(self, name: str = "embeddinghub_tpu", **fields):
        self._log = logging.getLogger(name)
        if not self._log.handlers:
            handler = logging.StreamHandler(_StderrProxy())
            handler.setFormatter(logging.Formatter("%(message)s"))
            self._log.addHandler(handler)
            self._log.setLevel(logging.INFO)
        self._fields = fields

    def with_fields(self, **fields) -> "Logger":
        child = Logger.__new__(Logger)
        child._log = self._log
        child._fields = {**self._fields, **fields}
        return child

    def with_resource(self, rtype: str, name: str, variant: str = "") -> "Logger":
        return self.with_fields(
            resource_type=rtype, resource_name=name, resource_variant=variant
        )

    def _emit(self, level: int, msg: str, **fields) -> None:
        record = {
            "ts": time.time(),
            "level": logging.getLevelName(level),
            "msg": msg,
            **redact(self._fields),
            **redact(fields),
        }
        rid = request_id()
        if rid:
            record["request_id"] = rid
        self._log.log(level, json.dumps(record, default=str))

    def info(self, msg: str, **fields) -> None:
        self._emit(logging.INFO, msg, **fields)

    def warning(self, msg: str, **fields) -> None:
        self._emit(logging.WARNING, msg, **fields)

    def error(self, msg: str, **fields) -> None:
        self._emit(logging.ERROR, msg, **fields)

    def debug(self, msg: str, **fields) -> None:
        self._emit(logging.DEBUG, msg, **fields)


LOGGER = Logger()
