"""The port's graph writes against the JAX package's, on the CPU, on the same
inputs (numpy seeds, Gaussian rows: no ties): the wave pools
(``_masked_scan_topk``, ``_member_scan_topk``), ``_reciprocal_commit`` and one
``make_wave_commit`` call; ``HNSWIndex`` sequences of bulk builds, waves,
cold adds, re-sets, removes, ``refine`` and ``from_state`` both ways, held
to the JAX index's ``state_arrays()``; and the store: WAL replay of several
runs, a failed wave, the walk arenas after a write, and a wire MultiSet of
several flushes into an ``hnsw`` space.

Tolerances: ids, links and every state array exactly equal; the pools as
sets.

On the CPU ``jnp.asarray`` of a numpy array may share its buffer (when the
buffer happens to be aligned), and the JAX index keeps device arrays made so
from host arrays it later writes in place: whether those writes reach its
device state then depends on the allocation.  Here the JAX index's
``asarray`` copies first, which is the semantics its code is written for.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import embeddinghub_tpu.index.hnsw as jax_hnsw
from embeddinghub_tpu.index.hnsw import HNSWIndex as JaxHNSW
from embeddinghub_tpu.ops import wave_insert as jwave
from embeddinghub_tpu_torch.index.hnsw import HNSWIndex
from embeddinghub_tpu_torch.ops import wave_insert as twave
from embeddinghub_tpu_torch.store.hub import EmbeddingHub
from embeddinghub_tpu_torch.utils.config import Config

D, M, EFC = 16, 8, 60
EF0 = 60  # min(max(efC, 16), 1024)
METRICS = ["l2", "cosine"]
STATE = ("x", "x_sq", "valid", "levels", "nb0", "ustack", "members", "mcount")


class _CopyingJnp:
    """``jax.numpy`` whose ``asarray`` copies a numpy array first."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(a, *args, **kw):
        return jnp.asarray(a.copy() if isinstance(a, np.ndarray) else a, *args, **kw)


@pytest.fixture(autouse=True)
def _jax_index_copies(monkeypatch):
    monkeypatch.setattr(jax_hnsw, "jnp", _CopyingJnp())


def _data(seed, n, d=D):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _pair(metric, capacity=1024):
    return (JaxHNSW(D, metric, m=M, ef_construction=EFC, capacity=capacity),
            HNSWIndex(D, metric, m=M, ef_construction=EFC, capacity=capacity,
                      device="cpu"))


def assert_same_graph(jidx, tidx):
    want, got = jidx.state_arrays(), tidx.state_arrays()
    assert got.keys() == want.keys()
    for name, arr in want.items():
        np.testing.assert_array_equal(got[name], arr, err_msg=name)


def _recall(ids, oracle):
    return np.mean([len(set(a) & set(b)) / oracle.shape[1] for a, b in zip(ids, oracle)])


def _oracle(x, q, k=10):
    return np.argsort(((q[:, None] - x[None]) ** 2).sum(-1), axis=1)[:, :k]


# ------------------------------------------------------------ the wave ops


def _arena(seed, cap, live):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((cap, D)).astype(np.float32)
    valid = (np.arange(cap) < live) & (rng.random(cap) > 0.1)
    q = rng.standard_normal((300, D)).astype(np.float32)
    return x, (x * x).sum(1).astype(np.float32), valid, q


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("hi", [None, 5000])
def test_masked_scan_topk_sets(metric, hi):
    """Four chunks of 2,048 in the JAX scan; with ``hi`` it scans three of
    them, the port the prefix ``x[:hi]``: the same pools (every live row
    lies below ``hi``)."""
    x, x_sq, valid, q = _arena(1, 8192, 5000)
    want = np.asarray(jwave._masked_scan_topk(
        *_j(q, x, valid, x_sq), kk=EF0, metric=metric, chunk=2048,
        hi=None if hi is None else jnp.int32(hi)))
    got = twave._masked_scan_topk(*_t(q, x, valid, x_sq), kk=EF0, metric=metric,
                                  hi=hi).numpy()
    assert got.shape == want.shape == (300, EF0) and (got >= 0).all()
    assert all(set(a) == set(b) for a, b in zip(got, want))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_member_scan_topk_sets(metric):
    """A member list with stale entries (dead rows, rows whose level fell
    below the layer) and fewer live members than the pool is wide."""
    x, x_sq, valid, q = _arena(2, 4096, 4096)
    rng = np.random.default_rng(3)
    levels = rng.integers(-1, 3, 4096).astype(np.int32)
    members = np.full(4096, -1, np.int32)
    ids = rng.permutation(4096)[:150].astype(np.int32)
    members[:150] = ids
    for layer, count in ((1, 150), (2, 40)):
        want = np.asarray(jwave._member_scan_topk(
            *_j(q, x, x_sq, valid, levels), layer, *_j(members, np.int32(count)),
            kk=4 * M, metric=metric))
        got = twave._member_scan_topk(
            *_t(q, x, x_sq, valid, levels), layer, *_t(members), count,
            kk=4 * M, metric=metric).numpy()
        assert got.shape == want.shape
        assert all(set(a) == set(b) for a, b in zip(got, want))
        assert (got[got >= 0] != -1).all() and (levels[got[got >= 0]] >= layer).all()


@pytest.mark.parametrize("mmax", [2 * M, M])
def test_reciprocal_commit_identical(mmax):
    """Hubs take more incoming edges than fit (the heuristic re-prunes them)
    and more than ``min(mmax, 32)`` in one wave (the rest drop); masked
    edges and holes (-1) in the current lists are left as the reference
    leaves them."""
    rng = np.random.default_rng(mmax)
    cap, w = 3000, 400
    x = rng.standard_normal((cap, D)).astype(np.float32)
    x_sq = (x * x).sum(1).astype(np.float32)
    table = rng.integers(0, cap, (cap, mmax)).astype(np.int32)
    table[rng.random((cap, mmax)) < 0.4] = -1
    src = np.repeat(rng.choice(cap, w, replace=False).astype(np.int32), M)
    dst = rng.integers(0, cap, w * M).astype(np.int32)
    dst[: 4 * M] = rng.integers(0, 3, 4 * M)  # hubs
    ev = (rng.random(w * M) > 0.15) & (dst != src)
    # the dump row: no real edge targets it
    dump = int(src[0])
    ev &= dst != dump
    want = np.asarray(jwave._reciprocal_commit(
        *_j(table, x, x_sq, src, dst, ev), jnp.int32(dump), mmax=mmax, metric="l2"))
    got = twave._reciprocal_commit(*_t(table, x, x_sq, src, dst, ev), mmax=mmax,
                                   metric="l2").numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, table)


@pytest.mark.parametrize("metric", METRICS)
def test_wave_commit_identical(metric):
    """One ``make_wave_commit`` call of both packages on the JAX index's
    device state after a bulk build, with a wave that raises the stack: the
    eight tables come out identical."""
    x = _data(4, 3000)
    jidx = JaxHNSW(D, metric, m=M, ef_construction=EFC, capacity=4096)
    jidx.add(np.arange(2048), x[:2048])
    state = {k: np.asarray(v) for k, v in jidx._device_arrays().items()}
    rows = np.arange(2048, 2548)
    vecs = jidx._prep(x[2048:2548])
    levels = np.asarray([jidx._assign_level() for _ in rows], np.int32)
    levels[:3] = jidx._max_level + 1  # members of every layer
    link_top = np.minimum(levels, jidx._max_level)
    args = [state[k] for k in STATE] + [
        rows.astype(np.int32), vecs, np.einsum("wd,wd->w", vecs, vecs), levels,
        link_top]
    kw = dict(metric=metric, m=M, m0=2 * M, ef_construction=EFC)
    want = jwave.make_wave_commit(**kw)(*_j(*args, np.ones(len(rows), bool)),
                                        jnp.int32(2048))
    got = twave.make_wave_commit(**kw)(*_t(*args), 2048)
    for name, a, b in zip(STATE, want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert not np.array_equal(got[4].numpy(), state["nb0"])


# ------------------------------------------------------------ index sequences


@pytest.mark.parametrize("metric", METRICS)
def test_bulk_build_then_waves(metric):
    x = _data(10, 5048)
    jidx, tidx = _pair(metric)
    for idx in (jidx, tidx):
        idx.add(np.arange(2048), x[:2048])
    assert_same_graph(jidx, tidx)
    for s in (2048, 3048, 4048):
        for idx in (jidx, tidx):
            idx.add(np.arange(s, s + 1000), x[s:s + 1000])
        assert_same_graph(jidx, tidx)
    assert tidx.waves == 3 and tidx.wave_seconds["pool0"] > 0
    q = x[:32] + 0.05
    np.testing.assert_array_equal(tidx.search(q, 10, ef=64)[1],
                                  jidx.search(q, 10, ef=64)[1])


@pytest.mark.parametrize("metric", METRICS)
def test_cold_add_host_then_fused_waves(metric):
    """1,500 rows into an empty graph: host waves of 8, 8, 16, ... rows
    while the graph has at most max(4 efC, 512) nodes, then a fused wave;
    then 100 more rows."""
    x = _data(11, 1600)
    jidx, tidx = _pair(metric)
    for idx in (jidx, tidx):
        idx.add(np.arange(1500), x[:1500])
    assert tidx.waves == 9
    assert_same_graph(jidx, tidx)
    for idx in (jidx, tidx):
        idx.add(np.arange(1500, 1600), x[1500:])
    assert_same_graph(jidx, tidx)


def _built(metric, seed, n=2048, capacity=4096):
    x = _data(seed, n + 1000)
    jidx, tidx = _pair(metric, capacity)
    for idx in (jidx, tidx):
        idx.add(np.arange(n), x[:n])
    return x, jidx, tidx


@pytest.mark.parametrize("metric", METRICS)
def test_resets(metric):
    """50 rows set again with new vectors: unlinked, then inserted by a
    wave; the new vectors come back."""
    x, jidx, tidx = _built(metric, 12)
    rows = np.arange(3, 2048, 41)[:50]
    for idx in (jidx, tidx):
        idx.add(rows, x[2048:2098])
    assert_same_graph(jidx, tidx)
    assert tidx.size == 2048
    np.testing.assert_array_equal(tidx.vectors(rows), x[2048:2098])


@pytest.mark.parametrize("metric", METRICS)
def test_remove(metric):
    x, jidx, tidx = _built(metric, 13)
    gone = np.arange(7, 2048, 20)[:100]
    for idx in (jidx, tidx):
        idx.remove(gone)
    assert_same_graph(jidx, tidx)
    assert tidx.size == 1948
    q = x[gone] + 0.01
    found = [idx.search(q, 10, ef=64) for idx in (jidx, tidx)]
    np.testing.assert_array_equal(found[1][1], found[0][1])
    assert not np.isin(found[1][1], gone).any() and (found[1][1] >= 0).all()
    # and rows go in again after the removes
    for idx in (jidx, tidx):
        idx.add(np.arange(2048, 2548), x[2048:2548])
    assert_same_graph(jidx, tidx)


@pytest.mark.parametrize("metric", METRICS)
def test_refine(metric):
    x, jidx, tidx = _built(metric, 14)
    for idx in (jidx, tidx):
        idx.add(np.arange(2048, 2848), x[2048:2848])
        idx.remove(np.arange(0, 200, 3))
        idx.refine()
    assert_same_graph(jidx, tidx)
    for idx in (jidx, tidx):
        idx.refine(np.arange(2048, 2448))
    assert_same_graph(jidx, tidx)


@pytest.mark.parametrize("metric", METRICS)
def test_from_state_then_waves_both_ways(metric):
    """A graph one package built, carried across by ``from_state``, takes
    the same waves in both: each ``from_state`` index draws its levels from
    a fresh generator."""
    x, jidx, tidx = _built(metric, 15)
    for src in (jidx, tidx):
        state = src.state_arrays()
        j2 = JaxHNSW.from_state(D, metric, state)
        t2 = HNSWIndex.from_state(D, metric, state, device="cpu")
        for idx in (j2, t2):
            idx.add(np.arange(2048, 2848), x[2048:2848])
        assert_same_graph(j2, t2)


# ------------------------------------------------------------ the store


def _multiset(version, x, prefix="k", start=0):
    version.multiset((f"{prefix}{start + j}", v) for j, v in enumerate(x))


def test_wal_of_several_runs_reopens(tmp_path):
    """set / delete / set / freeze: reopened from the WAL alone (every run
    of sets is one multiset: a bulk build, then waves), then from a
    snapshot and a WAL tail: every acknowledged key with its vector, no
    deleted key, recall held."""
    x = _data(20, 3400)
    hub = EmbeddingHub.load_or_create(tmp_path, engine="hnsw", device="cpu")
    version = hub.create_space("g", D, "l2").default_version()
    _multiset(version, x[:2100])
    for j in range(0, 60, 3):
        version.delete(f"k{j}")
    _multiset(version, x[2100:2700], start=2100)
    _multiset(version, x[:10] + 1.0, start=0)  # re-sets of 3 deleted keys
    version.make_immutable()
    want = {f"k{j}": version.get(f"k{j}") for j in range(2700)
            if f"k{j}" in version}
    assert len(want) == 2700 - 20 + 4
    del hub, version

    def check(v, n_keys):
        assert v.immutable and v.size == n_keys
        for key, vec in want.items():
            np.testing.assert_array_equal(v.get(key), vec)
        assert "k3" in v and "k12" not in v
        q = x[100:164] + 0.01
        live = np.asarray([row for _, row in v.keymap.items()])
        oracle = live[_oracle(v.index.vectors(live), q)]
        assert _recall(v.index.search(q, 10, ef=100)[1], oracle) >= 0.95

    again = EmbeddingHub.load_or_create(tmp_path, engine="hnsw", device="cpu")
    v = again.get_version("g")
    check(v, len(want))
    again.save()
    v.immutable = False
    _multiset(v, x[2700:3400], start=2700)  # the WAL tail after the save
    v.delete("k2701")
    for j in range(2700, 3400):
        if j != 2701:
            want[f"k{j}"] = x[j]
    v.make_immutable()
    del again, v
    third = EmbeddingHub.load_or_create(tmp_path, engine="hnsw", device="cpu")
    check(third.get_version("g"), len(want))
    assert "k2701" not in third.get_version("g")


def test_failed_wave_leaves_the_store_unchanged(monkeypatch):
    """A wave that raises part way (the third of four, after two fused
    waves wrote the device state) leaves the graph, its search results,
    the keys and the level draws as they were; a retry gives the graph a
    first try would have."""
    x = _data(21, 2048 + 1800)
    hub = EmbeddingHub.in_memory(engine="hnsw", device="cpu")
    version = hub.create_space("g", D, "l2").default_version()
    version.index.max_wave = 512
    _multiset(version, x[:2048])
    _multiset(version, x[2048:2548], start=2048)  # the device's tables lead
    idx = version.index
    before = {k: v.copy() for k, v in idx.state_arrays().items()}
    q = x[:16] + 0.05
    found = idx.search(q, 10, ef=64)
    real = twave.make_wave_commit
    calls = []

    def failing(**kw):
        commit = real(**kw)

        def wave(*args, **kwargs):
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError("out of device memory")
            return commit(*args, **kwargs)
        return wave

    idx._wave_fn = None
    monkeypatch.setattr(twave, "make_wave_commit", failing)
    with pytest.raises(RuntimeError, match="out of device memory"):
        _multiset(version, x[2548:], start=2548)
    assert len(calls) == 3
    assert version.size == 2548 and "k2600" not in version
    after = idx.state_arrays()
    for name, arr in before.items():
        np.testing.assert_array_equal(after[name], arr, err_msg=name)
    for got, want in zip(idx.search(q, 10, ef=64), found):
        np.testing.assert_array_equal(got, want)
    monkeypatch.undo()
    idx._wave_fn = None
    _multiset(version, x[2548:], start=2548)
    fresh = HNSWIndex(D, "l2", device="cpu")
    fresh.max_wave = 512
    for s, e in ((0, 2048), (2048, 2548), (2548, len(x))):
        fresh.add(np.arange(s, e), x[s:e])
    assert version.size == len(x) and version.keymap.row("k3000") == 3000
    want = fresh.state_arrays()
    for name, arr in idx.state_arrays().items():
        np.testing.assert_array_equal(arr, want[name], err_msg=name)


@pytest.mark.parametrize("walk", ["bf16", "packed"])
def test_walk_arenas_see_later_writes(walk):
    """The bf16 walk and the packed walk cache arenas built from the graph;
    a row inserted after ``pack_walk`` (and after a search built the bf16
    arena) is found by its own vector, and a removed one is not."""
    x = _data(22, 2600)
    idx = HNSWIndex(D, "l2", m=M, ef_construction=EFC, device="cpu")
    idx.add(np.arange(2048), x[:2048])
    if walk == "packed":
        idx.pack_walk()
    idx.search(x[:4], 5, ef=32)
    idx.add(np.arange(2048, 2600), x[2048:])
    _, ids = idx.search(x[2048:2600], 1, ef=64)
    assert np.mean(ids[:, 0] == np.arange(2048, 2600)) >= 0.99
    idx.remove(np.arange(2048, 2100))
    _, ids = idx.search(x[2048:2100], 5, ef=64)
    assert not np.isin(ids, np.arange(2048, 2100)).any()


def test_wire_multiset_into_hnsw_space():
    """A MultiSet of 10,000 rows flushes three times (4,096 rows each, then
    the rest): a bulk build, then waves."""
    pytest.importorskip("grpc")
    import grpc

    from embeddinghub_tpu_torch.service.server import build_server, pb, pb_grpc

    x = _data(23, 10_000)
    config = Config(engine="hnsw", hnsw_m=M, hnsw_ef_construction=EFC)
    server, service, port = build_server("127.0.0.1:0", "cpu", config=config)
    server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        stub = pb_grpc.EmbeddingHubStub(channel)
        stub.CreateSpace(pb.CreateSpaceRequest(name="g", dims=D))

        def requests():
            for j in range(len(x)):
                req = pb.MultiSetRequest(space="g", key=f"k{j}")
                req.embedding.values[:] = x[j].tolist()
                yield req

        stub.MultiSet(requests())
        version = service._store.get_version("g")
        assert isinstance(version.index, HNSWIndex) and version.size == len(x)
        assert version.index.waves == 2
        got = stub.Get(pb.GetRequest(space="g", key="k9999"))
        np.testing.assert_array_equal(np.asarray(got.embedding.values, np.float32), x[-1])
        q = x[::100] + 0.05
        _, ids = version.index.search(q, 10, ef=100)
        assert _recall(ids, _oracle(x, q)) >= 0.95
    finally:
        channel.close()
        server.stop(0).wait()
        service.stop()


# ------------------------------------------------------------ on the card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_card_wave_pools_match_plain(metric):
    """Both wave pools on the card (K1, bf16 operands) against their plain
    versions on the same tensors: equal sets on 99 % of rows."""
    dev = _cuda()
    x, x_sq, valid, q = _arena(30, 1 << 16, 50_000)
    members = np.random.default_rng(31).permutation(50_000)[:6000].astype(np.int32)
    levels = np.ones(1 << 16, np.int32)
    cpu = _t(q, x, valid, x_sq, levels, members)
    q_d, x_d, valid_d, x_sq_d, levels_d, members_d = (t.to(dev) for t in cpu)
    x_d = twave.fused_topk.arena_f32(x_d)
    for want, got in (
        (twave._masked_scan_topk(*cpu[:4], kk=200, metric=metric, hi=50_000),
         twave._masked_scan_topk(q_d, x_d, valid_d, x_sq_d, kk=200, metric=metric,
                                 hi=50_000)),
        (twave._member_scan_topk(cpu[0], cpu[1], cpu[3], cpu[2], cpu[4], 1, cpu[5],
                                 6000, kk=64, metric=metric),
         twave._member_scan_topk(q_d, x_d, x_sq_d, valid_d, levels_d, 1, members_d,
                                 6000, kk=64, metric=metric)),
    ):
        same = [set(a) == set(b) for a, b in zip(got.cpu().numpy(), want.numpy())]
        assert np.mean(same) >= 0.99


@pytest.mark.cuda
def test_card_waves_are_deterministic():
    """The same insert sequence twice on the card: identical ``nb0`` and
    upper stack (every scatter of a wave writes unique rows)."""
    dev = _cuda()
    x = _data(32, 12_096)
    tables = []
    for _ in range(2):
        idx = HNSWIndex(D, "l2", m=M, ef_construction=EFC, device=dev)
        idx.add(np.arange(4096), x[:4096])
        for s in range(4096, 12_000, 2000):
            idx.add(np.arange(s, s + 2000), x[s:s + 2000])
        idx.remove(np.arange(0, 300, 7))
        idx.add(np.arange(0, 300, 7), x[:43] + 0.5)
        state = idx._device_arrays()
        tables.append((state["nb0"].cpu().numpy(), state["ustack"].cpu().numpy()))
    for a, b in zip(*tables):
        np.testing.assert_array_equal(a, b)
