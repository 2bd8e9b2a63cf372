"""Persistence: snapshots + write-ahead log.

The twin of ``embeddinghub_tpu/store/persistence.py``, in the same on-disk
format, so a WAL or a data directory written by either package opens in
the other:

  * **snapshot**: the index's state arrays as ``.npy`` files in a fresh
    ``index-NNNNNN`` directory, plus ``meta.json`` (dims, metric,
    immutability, index type, keymap), replaced atomically;
  * **WAL**: an append-only record log of every write since the last
    snapshot.  Recovery = load the snapshot, replay the WAL tail.

WAL record format (little-endian):
    u8  tag  (1=set, 2=delete, 3=freeze)
    set:    u32 key_len, key utf8, u32 dims, dims * f32
    delete: u32 key_len, key utf8
    freeze: (nothing)

Replay applies runs of consecutive ``set`` records as one batched
``multiset`` (:func:`_replay_into`).  For a flat index the result is
exactly that of applying them one by one, as the reference does.  A graph
index takes each run whole: a run into an empty graph is the bulk build of
the rows that were written, a run into a built graph goes in by waves.  A
graph replayed so is not the graph that record-by-record replay would give
(the reference's, whose graph is not its own build's either): the contract
is that every acknowledged write comes back and recall holds.  A reopen
from a snapshot alone gives the saved graph exactly.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
from pathlib import Path

import numpy as np

from embeddinghub_tpu_torch.index.flat import FlatIndex
from embeddinghub_tpu_torch.index.hnsw import HNSWIndex
from embeddinghub_tpu_torch.store import errors
from embeddinghub_tpu_torch.store.keymap import KeyMap
from embeddinghub_tpu_torch.store.version import Version
from embeddinghub_tpu_torch.utils.device import DEFAULT as DEFAULT_DEVICE

_TAG_SET = 1
_TAG_DELETE = 2
_TAG_FREEZE = 3

# set records applied per batched multiset during replay
REPLAY_BATCH = 4096

# snapshot index type -> the ROADMAP.md queue 1 item that ports it
_NOT_PORTED = {
    "ShardedFlatIndex": "multi-device",
    "ShardedHNSWIndex": "multi-device",
}


class VersionWal:
    """Append-only write log for one version.

    Durability: by default every append is flushed to the OS page cache
    before it returns, which survives a process crash (SIGKILL) but not
    power loss.  ``fsync=True`` adds an ``os.fsync`` per append batch
    (power-loss durable, slower).
    """

    def __init__(self, path: str | Path, fsync: bool = False):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "ab")
        self._fsync = bool(fsync)

    def _commit(self) -> None:
        self._f.flush()
        if self._fsync:
            os.fsync(self._f.fileno())

    def append_many(self, keys: list[str], vecs: np.ndarray) -> None:
        parts = []
        dims = vecs.shape[1]
        for key, vec in zip(keys, vecs):
            kb = key.encode("utf-8")
            parts.append(struct.pack("<BI", _TAG_SET, len(kb)))
            parts.append(kb)
            parts.append(struct.pack("<I", dims))
            parts.append(np.ascontiguousarray(vec, dtype="<f4").tobytes())
        self._f.write(b"".join(parts))
        self._commit()

    def append_delete(self, key: str) -> None:
        kb = key.encode("utf-8")
        self._f.write(struct.pack("<BI", _TAG_DELETE, len(kb)) + kb)
        self._commit()

    def append_freeze(self) -> None:
        self._f.write(struct.pack("<B", _TAG_FREEZE))
        self._commit()

    def close(self) -> None:
        self._f.close()

    def truncate(self) -> None:
        """Called after a snapshot subsumes the log."""
        self._f.close()
        self._f = open(self.path, "wb")

    @staticmethod
    def replay(path: str | Path):
        """Yield ``('set', key, vec)`` | ``('delete', key)`` | ``('freeze',)``
        records.  Stops cleanly at a torn tail (a partial final record)."""
        p = Path(path)
        if not p.exists():
            return
        data = p.read_bytes()
        off, n = 0, len(data)
        while off < n:
            tag = data[off]
            off += 1
            try:
                if tag == _TAG_SET:
                    (klen,) = struct.unpack_from("<I", data, off)
                    off += 4
                    if off + klen > n:
                        return  # torn tail inside the key bytes
                    key = data[off:off + klen].decode("utf-8")
                    off += klen
                    (dims,) = struct.unpack_from("<I", data, off)
                    off += 4
                    if off + 4 * dims > n:
                        return  # torn tail inside the vector bytes
                    vec = np.frombuffer(data, dtype="<f4", count=dims, offset=off)
                    off += 4 * dims
                    yield ("set", key, np.array(vec))
                elif tag == _TAG_DELETE:
                    (klen,) = struct.unpack_from("<I", data, off)
                    off += 4
                    if off + klen > n:
                        return
                    key = data[off:off + klen].decode("utf-8")
                    off += klen
                    yield ("delete", key)
                elif tag == _TAG_FREEZE:
                    yield ("freeze",)
                else:
                    return  # corrupt tail
            except (struct.error, ValueError, UnicodeDecodeError):
                return  # torn tail


# ---------------------------------------------------------------- snapshots


def _index_class(name: str):
    """The index class a snapshot's ``index_type`` names."""
    if name == "FlatIndex":
        return FlatIndex
    if name == "HNSWIndex":
        return HNSWIndex
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"snapshot index type {name!r} is not ported yet; see ROADMAP.md "
            f"queue 1, {_NOT_PORTED[name]}")
    raise ValueError(f"unknown snapshot index type {name!r}")


def save_version(vdir: str | Path, version) -> None:
    """Snapshot into a fresh ``index-NNNNNN`` directory, then atomically
    repoint ``meta.json`` at it: a crash mid-save leaves meta pointing at
    the previous complete snapshot.  Holds ``version.lock`` from the array
    dump to the WAL truncate, so no write lands between the two and is
    truncated away."""
    vdir = Path(vdir)
    vdir.mkdir(parents=True, exist_ok=True)
    existing = sorted(vdir.glob("index-*"))
    gen = 1 + max(
        (int(p.name.split("-")[1]) for p in existing if p.name.split("-")[1].isdigit()),
        default=-1,
    )
    snap = vdir / f"index-{gen:06d}"
    snap.mkdir()
    with version.lock:
        meta = {
            "space": version.space,
            "name": version.name,
            "dims": version.dims,
            "metric": version.metric,
            "immutable": version.immutable,
            "index_type": type(version.index).__name__,
            "index_dir": snap.name,
            "keymap": version.keymap.to_state(),
        }
        for arr_name, arr in version.index.state_arrays().items():
            np.save(snap / f"{arr_name}.npy", arr)
        tmp = vdir / "meta.json.tmp"
        tmp.write_text(json.dumps(meta))
        os.replace(tmp, vdir / "meta.json")
        if version._wal is not None:
            version._wal.truncate()
    # Older snapshot directories (and the legacy flat index/ one) are garbage.
    for p in existing + [vdir / "index"]:
        if p != snap and p.is_dir():
            shutil.rmtree(p, ignore_errors=True)


def load_version(vdir: str | Path, wal_path: str | Path | None = None,
                 device=DEFAULT_DEVICE):
    """Open a snapshot (copy-on-write mmaps of its arrays) on ``device``,
    then replay the WAL at ``wal_path`` and keep appending to it."""
    vdir = Path(vdir)
    meta = json.loads((vdir / "meta.json").read_text())
    snap = vdir / meta.get("index_dir", "index")
    arrays = {p.stem: np.load(p, mmap_mode="c") for p in sorted(snap.glob("*.npy"))}
    index = _index_class(meta["index_type"]).from_state(
        meta["dims"], meta["metric"], arrays, device=device)
    version = Version(meta["space"], meta["name"], meta["dims"], meta["metric"],
                      index=index, device=device)
    version.keymap = KeyMap.from_state(meta["keymap"])
    version.immutable = meta["immutable"]
    if wal_path is not None:
        _replay_into(version, wal_path)
        version._wal = VersionWal(wal_path)
    return version


def _replay_into(version, wal_path) -> None:
    """Apply a WAL to ``version`` (which must have no WAL of its own yet).

    Consecutive ``set`` records go in runs of up to ``REPLAY_BATCH`` as one
    ``multiset``; a ``delete`` or ``freeze`` closes the run.  Within a run a
    key takes its row at its first record and keeps its last vector, which
    is what record-by-record replay gives: ``multiset``'s own keep-last
    dedup would order rows by last appearance instead, so the run is
    deduplicated here first.  A graph index takes each run whole, one
    ``multiset`` (a bulk build into an empty graph, waves into a built one;
    see the module docstring)."""
    run: dict[str, np.ndarray] = {}  # insertion order = first appearance
    n_run = 0
    batch = None if isinstance(version.index, HNSWIndex) else REPLAY_BATCH

    def flush():
        nonlocal n_run
        if run:
            version.immutable = False  # replay must be able to write
            version.multiset(run.items())
            run.clear()
        n_run = 0

    for rec in VersionWal.replay(wal_path):
        if rec[0] == "set":
            run[rec[1]] = rec[2]
            n_run += 1
            if batch is not None and n_run >= batch:
                flush()
            continue
        flush()
        if rec[0] == "delete":
            version.immutable = False
            try:
                version.delete(rec[1])
            except errors.KeyNotFoundError:
                pass  # the reference's replay skips it too
        elif rec[0] == "freeze":
            version.immutable = True
    flush()
