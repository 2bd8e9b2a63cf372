"""Persistence of the port against the JAX package's, on the CPU.

The on-disk format is shared: both packages write byte-identical WAL
records, each replays the other's WAL (torn tails included), and a data
directory written by either opens in the other with equal keys, vectors,
keymap state and immutability.  Exact-search ids must be equal off
near-ties of 1e-5 (f32 scans on both sides, different summation order).
"""

import threading

import numpy as np
import pytest

from embeddinghub_tpu.store import persistence as jax_persistence
from embeddinghub_tpu.store.hub import EmbeddingHub as JaxHub
from embeddinghub_tpu.store.version import Version as JaxVersion
from embeddinghub_tpu_torch.store import persistence
from embeddinghub_tpu_torch.store.hub import EmbeddingHub
from embeddinghub_tpu_torch.store.version import Version
from _torch_parity import assert_ids_equal_off_ties

D = 12
TAIL_KEY = "tail-key"


def _vecs(seed, n, d=D):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _write_wal(wal_cls, path):
    """The same record sequence through either package's VersionWal."""
    wal = wal_cls(path)
    wal.append_many(["a", "b", "ключ", "a"], _vecs(0, 4))
    wal.append_delete("b")
    wal.append_many(["c"], _vecs(1, 1))
    wal.append_freeze()
    wal.append_many(["after-freeze", TAIL_KEY], _vecs(2, 2))
    wal.close()


def _records(replay, path):
    return [r[:2] + tuple(v.tolist() for v in r[2:]) for r in replay(path)]


def test_wal_records_byte_identical(tmp_path):
    _write_wal(persistence.VersionWal, tmp_path / "port.bin")
    _write_wal(jax_persistence.VersionWal, tmp_path / "jax.bin")
    port, ref = (tmp_path / "port.bin").read_bytes(), (tmp_path / "jax.bin").read_bytes()
    assert port == ref and len(port) > 0


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("tear", [None, "key", "vector"])
def test_replay_other_packages_wal(tmp_path, writer, tear):
    """Each package replays the WAL the other wrote; a torn final record
    (cut inside its key bytes or inside its vector bytes) is dropped, and
    everything before it is kept."""
    wal_cls = (jax_persistence if writer == "jax" else persistence).VersionWal
    path = tmp_path / "wal.bin"
    _write_wal(wal_cls, path)
    full = path.read_bytes()
    n_full = len(_records(persistence.VersionWal.replay, path))
    if tear is not None:
        # the last record: tag, key length, key, dims, D floats
        head = 1 + 4 + len(TAIL_KEY) + 4
        start = len(full) - head - 4 * D
        cut = start + (5 + 3 if tear == "key" else head + 7)
        path.write_bytes(full[:cut])
    port = _records(persistence.VersionWal.replay, path)
    ref = _records(jax_persistence.VersionWal.replay, path)
    assert port == ref
    assert len(port) == (n_full if tear is None else n_full - 1)


def _on_cpu(hub_cls) -> dict:
    """The port's hub takes ``device="cpu"`` here; the JAX package's has no
    such argument."""
    return {"device": "cpu"} if hub_cls is EmbeddingHub else {}


def _fill(hub_cls, base, seed):
    """Snapshot + WAL tail + a delete + a freeze in space "a" (l2); space
    "b" (cosine) has a WAL and no snapshot."""
    hub = hub_cls.load_or_create(base, **_on_cpu(hub_cls))
    va = hub.create_space("a", D, "l2").default_version()
    va.multiset((f"k{i}", v) for i, v in enumerate(_vecs(seed, 300)))
    va.delete("k7")
    hub.save()
    tail = _vecs(seed + 1, 40)
    va.multiset([(f"k{i}", tail[i]) for i in range(0, 20)])          # overwrites
    va.multiset([(f"t{i}", tail[i]) for i in range(20, 40)])         # new, one reuses row 7
    va.delete("k11")
    va.make_immutable()
    vb = hub.create_space("b", D, "cosine").default_version()
    vb.multiset((f"b{i}", v) for i, v in enumerate(_vecs(seed + 2, 150)))
    vb.delete("b3")
    vb.set("b3", _vecs(seed + 3, 1)[0])
    return hub


def _assert_versions_equal(port, ref, queries):
    assert port.keymap.to_state() == ref.keymap.to_state()
    assert port.immutable == ref.immutable
    assert (port.dims, port.metric) == (ref.dims, ref.metric)
    ps, rs = port.index.state_arrays(), ref.index.state_arrays()
    np.testing.assert_array_equal(ps["x"], np.asarray(rs["x"]))
    np.testing.assert_array_equal(ps["valid"], np.asarray(rs["valid"]))
    pd, pi = port.index.search(queries, 9, mode="exact")
    jd, ji = ref.index.search(queries, 9, mode="exact")
    np.testing.assert_allclose(pd, jd, rtol=1e-5, atol=1e-5)
    assert_ids_equal_off_ties(pi, ji, jd, 1e-5)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_data_dir_opens_in_the_other_package(tmp_path, writer):
    w_cls, r_cls = (JaxHub, EmbeddingHub) if writer == "jax" else (EmbeddingHub, JaxHub)
    written = _fill(w_cls, tmp_path / "store", seed=10)
    opened = r_cls.load_or_create(tmp_path / "store", **_on_cpu(r_cls))
    assert sorted(opened.spaces()) == ["a", "b"]
    queries = _vecs(20, 7)
    for name in ("a", "b"):
        w, o = written.get_version(name), opened.get_version(name)
        port, ref = (o, w) if writer == "jax" else (w, o)
        _assert_versions_equal(port, ref, queries)
    assert opened.get_version("a").immutable and not opened.get_version("b").immutable
    # the opened store keeps writing to the same WAL
    vb = opened.get_version("b")
    vb.set("late", _vecs(21, 1)[0])
    again = EmbeddingHub.load_or_create(tmp_path / "store", device="cpu")
    np.testing.assert_array_equal(again.get_version("b").get("late"), _vecs(21, 1)[0])


def _replay_wal(path):
    """A WAL with repeated keys inside runs, deletes that free rows for
    reuse, a freeze followed by more sets, and a delete of a missing key."""
    wal = persistence.VersionWal(path)
    v = _vecs(30, 200)
    wal.append_many([f"k{i % 13}" for i in range(40)], v[:40])      # repeats in a run
    wal.append_delete("k3")
    wal.append_delete("k5")
    wal.append_delete("never-set")
    wal.append_many(["n1", "k3", "n2", "n1", "k9"], v[40:45])       # reuse freed rows
    wal.append_freeze()
    wal.append_many([f"m{i % 7}" for i in range(30)], v[45:75])
    for i in range(10):
        wal.append_many([f"s{i}", "k0"], v[75 + 2 * i:77 + 2 * i])  # runs across appends
    wal.append_delete("m2")
    wal.append_freeze()
    wal.close()


@pytest.mark.parametrize("batch", [4096, 7, 1])
def test_batched_replay_equals_record_by_record(tmp_path, monkeypatch, batch):
    path = tmp_path / "wal.bin"
    _replay_wal(path)
    monkeypatch.setattr(persistence, "REPLAY_BATCH", batch)
    port = Version("s", "initial", D, "l2", device="cpu")
    ref = JaxVersion("s", "initial", D, "l2")
    persistence._replay_into(port, path)
    jax_persistence._replay_into(ref, path)
    assert port.size == ref.size > 0
    _assert_versions_equal(port, ref, _vecs(31, 5))


def test_save_under_concurrent_writer_loses_no_acknowledged_write(tmp_path):
    """Writes acknowledged while ``save`` runs are either in the snapshot
    or in the WAL after it: the snapshot holds the version's lock from its
    array dump to the WAL truncate."""
    hub = EmbeddingHub.load_or_create(tmp_path / "store", device="cpu")
    version = hub.create_space("w", D).default_version()
    acked: dict[str, np.ndarray] = {}
    stop = threading.Event()
    errors = []

    def writer():
        try:
            i = 0
            while not stop.is_set():
                batch = _vecs(100 + i, 8)
                keys = [f"w{i}-{j}" for j in range(8)]
                version.multiset(zip(keys, batch))
                acked.update(zip(keys, batch))
                i += 1
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    t = threading.Thread(target=writer)
    t.start()
    try:
        for _ in range(15):
            hub.save()
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and not errors
    assert len(acked) > 0
    got = EmbeddingHub.load_or_create(tmp_path / "store", device="cpu").get_version("w")
    assert got.size == len(acked)
    for key, vec in acked.items():
        np.testing.assert_array_equal(got.get(key), vec)


def test_hub_on_disk_semantics(tmp_path):
    hub = EmbeddingHub.load_or_create(tmp_path / "store", device="cpu")
    hub.create_space("a", D)
    hub.create_space("gone", D).default_version().set("x", _vecs(40, 1)[0])
    assert (tmp_path / "store" / "gone" / "initial" / "wal.bin").exists()
    hub.delete_space("gone")
    assert not (tmp_path / "store" / "gone").exists()
    hub.save()
    snaps = sorted(p.name for p in (tmp_path / "store" / "a" / "initial").glob("index-*"))
    hub.save()
    snaps2 = sorted(p.name for p in (tmp_path / "store" / "a" / "initial").glob("index-*"))
    assert snaps == ["index-000000"] and snaps2 == ["index-000001"]
    again = EmbeddingHub.load_or_create(tmp_path / "store", device="cpu")
    assert again.spaces() == ["a"] and again.get_version("a").index.device.type == "cpu"
    assert EmbeddingHub.in_memory(device="cpu").base_path is None


def test_unported_snapshot_types_raise(tmp_path):
    """Every snapshot type of the reference reopens (a ShardedHNSWIndex
    here, on the hub's one-device CPU mesh); an unknown one raises."""
    hub = EmbeddingHub.load_or_create(tmp_path / "store", engine="hnsw-sharded", device="cpu")
    x = _vecs(41, 40)
    hub.create_space("a", D).default_version().multiset((f"k{j}", v) for j, v in enumerate(x))
    hub.save()
    back = EmbeddingHub.load_or_create(tmp_path / "store", device="cpu").get_version("a")
    assert type(back.index).__name__ == "ShardedHNSWIndex" and back.index.n_shards == 1
    assert back.nearest(1, vector=x[7]) == ["k7"]
    meta_path = tmp_path / "store" / "a" / "initial" / "meta.json"
    meta_path.write_text(meta_path.read_text().replace('"ShardedHNSWIndex"', '"NopeIndex"'))
    with pytest.raises(ValueError, match="NopeIndex"):
        EmbeddingHub.load_or_create(tmp_path / "store", device="cpu")
