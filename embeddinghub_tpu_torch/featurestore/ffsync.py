"""Distributed locks + ordered id generation.

Rebuild of reference ``ffsync/`` (``locker.go:110-114`` Locker
interface, memory + Postgres implementations, ``ordered_id.go``).
Ships a memory locker (in-process) and a file locker (cross-process on
one host); both honor lease expiry so a dead owner's lock lapses and
the coordinator re-runs the task (``executor.go:87-94`` semantics).
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from dataclasses import dataclass

from embeddinghub_tpu_torch.featurestore import fferr

DEFAULT_LEASE_S = 60.0


@dataclass
class Key:
    id: str
    key: str


class Locker:
    def lock(self, key: str, wait: bool = False) -> Key:
        raise NotImplementedError

    def unlock(self, key: Key) -> None:
        raise NotImplementedError


class MemoryLocker(Locker):
    def __init__(self, lease_s: float = DEFAULT_LEASE_S):
        self._locks: dict[str, tuple[str, float]] = {}
        self._mutex = threading.Lock()
        self._lease_s = lease_s

    def lock(self, key: str, wait: bool = False) -> Key:
        if not key:
            raise fferr.LockEmptyKeyError()
        deadline = time.monotonic() + (30.0 if wait else 0.0)
        while True:
            with self._mutex:
                now = time.monotonic()
                holder = self._locks.get(key)
                if holder is None or holder[1] < now:
                    kid = uuid.uuid4().hex
                    self._locks[key] = (kid, now + self._lease_s)
                    return Key(kid, key)
            if time.monotonic() >= deadline:
                raise fferr.KeyAlreadyLockedError(key)
            time.sleep(0.02)

    def unlock(self, key: Key) -> None:
        with self._mutex:
            holder = self._locks.get(key.key)
            if holder and holder[0] == key.id:
                del self._locks[key.key]


class FileLocker(Locker):
    """Lease files in a shared directory — the single-host stand-in for
    the reference's Postgres advisory locks."""

    def __init__(self, dir_path: str, lease_s: float = DEFAULT_LEASE_S):
        self._dir = dir_path
        os.makedirs(dir_path, exist_ok=True)
        self._lease_s = lease_s

    def _path(self, key: str) -> str:
        safe = key.replace("/", "_").replace(" ", "_")
        return os.path.join(self._dir, safe + ".lock")

    def lock(self, key: str, wait: bool = False) -> Key:
        if not key:
            raise fferr.LockEmptyKeyError()
        path = self._path(key)
        deadline = time.monotonic() + (30.0 if wait else 0.0)
        kid = uuid.uuid4().hex
        while True:
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, f"{kid} {time.time() + self._lease_s}".encode())
                os.close(fd)
                return Key(kid, key)
            except FileExistsError:
                try:
                    content = open(path).read().split()
                    expiry = float(content[1])
                    if expiry < time.time():
                        os.unlink(path)  # lapsed lease
                        continue
                except (OSError, IndexError, ValueError):
                    continue
            if time.monotonic() >= deadline:
                raise fferr.KeyAlreadyLockedError(key)
            time.sleep(0.05)

    def unlock(self, key: Key) -> None:
        path = self._path(key.key)
        try:
            content = open(path).read().split()
            if content and content[0] == key.id:
                os.unlink(path)
        except OSError:
            pass


class OrderedIdGenerator:
    """Monotonic ids (reference ffsync/ordered_id.go:24-138)."""

    def __init__(self):
        self._next = 0
        self._lock = threading.Lock()

    def next_id(self, namespace: str = "") -> int:
        with self._lock:
            self._next += 1
            return self._next
