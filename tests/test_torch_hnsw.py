"""The port's graph engine against the JAX package's, on the CPU, on the same
inputs (numpy seeds): the build's kernels (``heuristic_prune``,
``gather_reciprocal``, ``pooled_topk_ids``), the exact bulk build, search
over a graph carried across by ``from_state``, snapshots both ways, the
``hnsw`` store engine and its server, and the paths not ported yet
(``tests/test_torch_hnsw_writes.py`` holds the writes into a built graph).

Tolerances: the prune and the reciprocal gather give identical ids (on
integer-valued rows, where every f32 product is exact, and on Gaussian
rows); the pools equal sets on at least 99 % of rows (bf16-rounded
operands, f32 sums in another order); a bulk build has identical levels,
entry and max level, ``nb0`` and every upper list identical on at least
99 % of rows, and recall@10 at ef=64 within 0.01 of the JAX graph's;
searches as ``tests/test_torch_beam.py`` holds walks.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from embeddinghub_tpu.index.hnsw import HNSWIndex as JaxHNSW
from embeddinghub_tpu.ops import nn_descent as jnnd
from embeddinghub_tpu.ops import topk as jtopk
from embeddinghub_tpu.store import persistence as jax_persistence
from embeddinghub_tpu.store.version import Version as JaxVersion
from embeddinghub_tpu_torch.index.hnsw import HNSWIndex
from embeddinghub_tpu_torch.ops import nn_descent as tnnd
from embeddinghub_tpu_torch.ops import topk as ttopk
from embeddinghub_tpu_torch.store import persistence
from embeddinghub_tpu_torch.store.hub import EmbeddingHub
from embeddinghub_tpu_torch.store.version import Version
from embeddinghub_tpu_torch.utils.config import Config
from _torch_parity import assert_walks_match, walk_terms

DIM, M, EFC = 32, 8, 64
ITEM5 = "construction and mutation"
# (metric, rows): 5,000 and 6,000 rows pad the arena (l2 far-offset rows,
# cosine unit rows from their own generator); 4,096 does not
BUILDS = {"l2": 5000, "ip": 4096, "cosine": 6000}


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _data(seed, n, d=DIM):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _prep(x, metric):
    if metric == "cosine":
        return x / np.linalg.norm(x, axis=1, keepdims=True)
    return x


def _recall(ids, oracle):
    return np.mean([len(set(a) & set(b)) / oracle.shape[1] for a, b in zip(ids, oracle)])


def _oracle(x, q, metric, k=10):
    xp, qp = _prep(x, metric), _prep(q, metric)
    d = ((qp[:, None] - xp[None]) ** 2).sum(-1) if metric == "l2" else -(qp @ xp.T)
    return np.argsort(d, axis=1)[:, :k]


def assert_search_match(jd, ji, td, ti, q, x, metric):
    assert_walks_match(jd, ji, td, ti, walk_terms(q, x, metric))


# ------------------------------------------------------------ the kernels


def _pools(seed, n, b, c, integer):
    rng = np.random.default_rng(seed)
    x = (rng.integers(-3, 4, (n, DIM)) if integer else rng.standard_normal((n, DIM)))
    x = x.astype(np.float32)
    nb = rng.integers(0, n, (b, c)).astype(np.int32)
    nb[rng.random((b, c)) < 0.1] = -1
    nb[nb == np.arange(b)[:, None]] = -1  # no self: its distance is round-off
    q = x[rng.integers(0, n, b)] + (0 if integer else 0.1 * rng.standard_normal((b, DIM)))
    return x, (x * x).sum(1).astype(np.float32), nb, q.astype(np.float32)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("integer", [True, False], ids=["integer", "gaussian"])
@pytest.mark.parametrize("with_q", [True, False])
def test_heuristic_prune_identical(metric, integer, with_q):
    """Integer rows make every product exact, so equal distances are real
    ties and the first-of-equals rules decide them."""
    x, x_sq, nb, q = _pools(1, 3000, 1024 if with_q else 3000, 96, integer)
    kw = dict(m_keep=16, metric=metric, cand_k=64)
    if with_q:
        qsq = (q * q).sum(1).astype(np.float32)
        want = jnnd.heuristic_prune(*_j(x, x_sq, nb), q=jnp.asarray(q),
                                    q_sq=jnp.asarray(qsq), **kw)
        got = tnnd.heuristic_prune(*_t(x, x_sq, nb), q=torch.from_numpy(q),
                                   q_sq=torch.from_numpy(qsq), **kw)
    else:
        want = jnnd.heuristic_prune(*_j(x, x_sq, nb), **kw)
        got = tnnd.heuristic_prune(*_t(x, x_sq, nb), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("width", [8, 16])
def test_gather_reciprocal_identical(width):
    rng = np.random.default_rng(width)
    p = 3000
    fwd = rng.integers(0, p, (p, width)).astype(np.int32)
    fwd[:, :3] = rng.integers(0, 40, (p, 3))  # hubs: rows past cap_in incoming
    fwd[rng.random((p, width)) < 0.2] = -1
    valid = rng.random(p) > 0.1
    jc, jf = jnnd.gather_reciprocal(*_j(fwd, valid), cap_in=3 * width)
    tc, tf = tnnd.gather_reciprocal(*_t(fwd, valid), cap_in=3 * width)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert not tf.all() and tf.any()


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("cap,chunk", [(4096, 1 << 16), (8192, 2048)])
def test_pooled_topk_ids_sets(metric, cap, chunk):
    """One chunk and four: JAX's ``approx_max_k`` is an exact top-k on the
    CPU, so its pools are the plain version's on at least 99 % of rows."""
    rng = np.random.default_rng(cap)
    x = rng.standard_normal((cap, DIM)).astype(np.float32)
    valid = rng.random(cap) > 0.05
    q = x[:512] + 0.1 * rng.standard_normal((512, DIM)).astype(np.float32)
    x_sq = (x * x).sum(1).astype(np.float32)
    want = np.asarray(jtopk.pooled_topk_ids(*_j(q, x, valid, x_sq), metric=metric,
                                            k=64, chunk=chunk))
    got = ttopk.pooled_topk_ids(*_t(q, x, valid, x_sq), metric=metric, k=64,
                                chunk=chunk).numpy()
    assert (got >= 0).all() and valid[got].all()
    same = np.mean([set(a) == set(b) for a, b in zip(got, want)])
    assert same >= 0.99, same


@pytest.mark.parametrize("width", [300, 5000])
def test_smallest_k_breaks_ties_by_column(width):
    """Both of its ways (one stable sort; a top-k, its boundary ties settled
    by column) give numpy's stable argsort."""
    d = np.random.default_rng(width).integers(0, 20, (16, width)).astype(np.float32)
    d[:, ::7] = np.inf
    v, i = ttopk.smallest_k(torch.from_numpy(d), 40)
    want = np.argsort(d, axis=1, kind="stable")[:, :40]
    np.testing.assert_array_equal(i.numpy(), want)
    np.testing.assert_array_equal(v.numpy(), np.take_along_axis(d, want, 1))


# ------------------------------------------------------------ the build


@pytest.fixture(scope="module")
def builds():
    """Both packages' bulk builds of the same rows, by metric."""
    out = {}
    for seed, (metric, n) in enumerate(BUILDS.items()):
        x = _data(seed, n)
        jidx = JaxHNSW(DIM, metric, m=M, ef_construction=EFC, capacity=n)
        jidx.add(np.arange(n), x)
        tidx = HNSWIndex(DIM, metric, m=M, ef_construction=EFC, capacity=n,
                         device="cpu")
        tidx.add(np.arange(n), x)
        q = x[:64] + 0.05 * np.random.default_rng(99).standard_normal(
            (64, DIM)).astype(np.float32)
        out[metric] = (x, q, jidx, tidx)
    return out


@pytest.mark.parametrize("metric", list(BUILDS))
def test_bulk_build_matches(builds, metric):
    x, q, jidx, tidx = builds[metric]
    np.testing.assert_array_equal(tidx._levels, jidx._levels)
    assert (tidx._entry, tidx._max_level) == (jidx._entry, jidx._max_level)
    assert tidx._max_level >= 2
    assert np.mean((tidx._nb0 == jidx._nb0).all(1)) >= 0.99
    for layer, nodes in jidx._upper.items():
        mine = tidx._upper[layer]
        assert mine.keys() == nodes.keys()
        assert np.mean([mine[k] == v for k, v in nodes.items()]) >= 0.99
    assert set(tidx.build_seconds) == {"pools", "prune", "symmetrize", "upper", "host"}
    oracle = _oracle(x, q, metric)
    rj = _recall(jidx.search(q, 10, ef=64)[1], oracle)
    rt = _recall(tidx.search(q, 10, ef=64)[1], oracle)
    assert rt >= 0.9 and abs(rt - rj) <= 0.01, (rt, rj)


# ------------------------------------------------------------ search


def _set_walk(idx, walk):
    idx.walk_dtype, idx.walk_packed, idx.spec, idx.exit_k = {
        "bf16": ("bfloat16", False, 1, 0),
        "off": ("off", False, 1, 0),
        "packed": ("bfloat16", True, 1, 0),
        "spec2-exit": ("bfloat16", False, 2, 16),
    }[walk]


WALKS = [("l2", w) for w in ("bf16", "off", "packed", "spec2-exit")] + [
    (m, w) for m in ("ip", "cosine") for w in ("bf16", "off")]


@pytest.mark.parametrize("metric,walk", WALKS)
def test_search_jax_graph_from_state(builds, metric, walk):
    """A graph the JAX package built, carried across by ``from_state``,
    searches to the JAX package's ids.  Batches of 20 are padded to 64."""
    x, q, jidx, _ = builds[metric]
    jidx = JaxHNSW.from_state(DIM, metric, jidx.state_arrays())
    tidx = HNSWIndex.from_state(DIM, metric, jidx.state_arrays(), device="cpu")
    for idx in (jidx, tidx):
        _set_walk(idx, walk)
    for b, k, ef in ((64, 10, 64), (20, 5, 40)):
        jd, ji = jidx.search(q[:b], k, ef=ef)
        td, ti = tidx.search(q[:b], k, ef=ef)
        assert tidx.last_hops > 0
        assert_search_match(jd, ji, td, ti, q[:b], x, metric)


def test_routed_snapshot_searches_alike(builds):
    """A JAX graph with a k-means route (the shape of
    ``tests/test_hnsw.py::test_routed_search_snapshot_roundtrip``): the
    port seeds its beams from the snapshot's centroids and medoids."""
    x, q, jidx, _ = builds["l2"]
    jidx = JaxHNSW.from_state(DIM, "l2", jidx.state_arrays())
    jidx.build_route(seed_probes=4)
    state = jidx.state_arrays()
    assert "route_cent" in state
    tidx = HNSWIndex.from_state(DIM, "l2", state, device="cpu")
    assert tidx.seed_probes == 4
    jd, ji = jidx.search(q, 5, ef=40)
    td, ti = tidx.search(q, 5, ef=40)
    assert_search_match(jd, ji, td, ti, q, x, "l2")
    np.testing.assert_array_equal(tidx.state_arrays()["route_medoids"],
                                  state["route_medoids"])


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_state_arrays_both_ways(builds, metric):
    """Port-built graph -> JAX ``from_state`` and back: equal arrays, and
    the JAX package searches the port's graph as the port does."""
    x, q, _, tidx = builds[metric]
    state = tidx.state_arrays()
    jidx = JaxHNSW.from_state(DIM, metric, state)
    back = HNSWIndex.from_state(DIM, metric, jidx.state_arrays(), device="cpu")
    for name, arr in state.items():
        np.testing.assert_array_equal(back.state_arrays()[name], arr)
    jd, ji = jidx.search(q, 10, ef=64)
    td, ti = back.search(q, 10, ef=64)
    assert_search_match(jd, ji, td, ti, q, x, metric)


def _multiset(version, x, prefix="k"):
    version.multiset((f"{prefix}{j}", v) for j, v in enumerate(x))


def test_snapshot_both_ways(builds, tmp_path):
    """A version snapshot of either package's graph opens in the other and
    answers ``nearest_batch`` with the same keys."""
    x, q, jidx, tidx = builds["l2"]
    keys = [f"k{j}" for j in range(len(x))]
    # the port writes, the JAX package reads
    tv = Version("s", "initial", DIM, "l2", index=tidx, device="cpu")
    tv.keymap.assign_many(keys)
    persistence.save_version(tmp_path / "port", tv)
    jver = jax_persistence.load_version(tmp_path / "port")
    assert type(jver.index).__name__ == "HNSWIndex"
    assert jver.nearest_batch(q, 10) == tv.nearest_batch(q, 10)
    # the JAX package writes, the port reads
    jv = JaxVersion("s", "initial", DIM, "l2",
                    index=JaxHNSW.from_state(DIM, "l2", jidx.state_arrays()))
    jv.keymap.assign_many(keys)
    jax_persistence.save_version(tmp_path / "jax", jv)
    back = persistence.load_version(tmp_path / "jax", device="cpu")
    assert isinstance(back.index, HNSWIndex) and back.size == len(x)
    assert back.nearest_batch(q, 10) == jv.nearest_batch(q, 10)


def test_hub_reopens_graph_from_snapshot_and_wal(tmp_path):
    """``engine="hnsw"``: reopened from its snapshot, and from its WAL
    alone (one run of sets: one bulk build of the same rows), the store
    gives the lists it gave before; a WAL with a second run of sets after a
    freeze reopens with that run's rows too (waves into the built graph)."""
    x = _data(8, 2500)
    q = x[:16] + 0.05
    hub = EmbeddingHub.load_or_create(tmp_path / "a", engine="hnsw", device="cpu")
    version = hub.create_space("g", DIM, "ip").default_version()
    _multiset(version, x)
    want = version.nearest_batch(q, 10)
    nb0 = version.index._nb0.copy()
    del hub, version
    again = EmbeddingHub.load_or_create(tmp_path / "a", engine="hnsw", device="cpu")
    v = again.get_version("g")
    assert isinstance(v.index, HNSWIndex)
    np.testing.assert_array_equal(v.index._nb0, nb0)
    assert v.nearest_batch(q, 10) == want
    again.save()
    reopened = EmbeddingHub.load_or_create(tmp_path / "a", device="cpu")
    assert reopened.get_version("g").nearest_batch(q, 10) == want

    hub = EmbeddingHub.load_or_create(tmp_path / "b", engine="hnsw", device="cpu")
    version = hub.create_space("g", DIM, "l2").default_version()
    _multiset(version, x)
    version.make_immutable()
    late = _data(18, 300)
    version._wal.append_many([f"late{j}" for j in range(300)], late)  # a second run
    del hub, version
    v = EmbeddingHub.load_or_create(tmp_path / "b", engine="hnsw", device="cpu").get_version("g")
    assert v.size == 2800 and v.index.size == 2800 and not v.immutable
    np.testing.assert_array_equal(v.get("late7"), late[7])
    np.testing.assert_array_equal(v.get("k7"), x[7])
    assert "late0" in v.nearest(10, vector=late[0])
    _, ids = v.index.search(late[:32] + 0.01, 1, ef=64)
    assert np.mean(ids[:, 0] == [v.keymap.row(f"late{j}") for j in range(32)]) >= 0.95


def test_hub_serves_graph_over_grpc():
    pytest.importorskip("grpc")
    from embeddinghub_tpu_torch.service.server import build_server, pb, pb_grpc
    import grpc

    x = _data(9, 2500)
    # knobs unlike the environment's defaults: the hub builds with the
    # server's own config
    config = Config(engine="hnsw", hnsw_m=12, hnsw_ef_search=32)
    server, service, port = build_server("127.0.0.1:0", "cpu", config=config)
    server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        stub = pb_grpc.EmbeddingHubStub(channel)
        stub.CreateSpace(pb.CreateSpaceRequest(name="g", dims=DIM))
        version = service._store.get_version("g")
        _multiset(version, x)
        assert isinstance(version.index, HNSWIndex)
        assert (version.index.m, version.index.ef_search) == (12, 32)
        q = x[:12] + 0.05
        req = pb.BatchNearestNeighborRequest(space="g", num=10)
        for v in q:
            req.embeddings.add().values[:] = v.tolist()
        got = [list(r.keys) for r in stub.BatchNearestNeighbor(req).results]
        assert got == version.nearest_batch(q, 10)
        oracle = _oracle(x, q, "l2")
        assert _recall([[int(k[1:]) for k in r] for r in got], oracle) >= 0.95
        resp = stub.NearestNeighbor(pb.NearestNeighborRequest(space="g", key="k5", num=10))
        assert list(resp.keys) == version.nearest(10, key="k5")
        assert "k5" not in resp.keys and len(resp.keys) == 10
    finally:
        channel.close()
        server.stop(0).wait()
        service.stop()


# --------------------------------------------------- not ported yet (item 5)


def test_item5_paths_raise(builds):
    """What is still not ported raises and leaves the graph as it was: the
    route (k-means), a cold add past ``exact_build_max`` (the
    cluster-routed build) and a hub that asks for seed probes."""
    x, q, _, built = builds["l2"]
    big = HNSWIndex(DIM, device="cpu")
    big.exact_build_max = 3000
    calls = {
        "build_route": lambda: built.build_route(4),
        "past exact_build_max": lambda: big.add(np.arange(4000), x[:4000]),
        # the hub refuses a routed configuration when it starts, not at search
        "hnsw_seed_probes": lambda: EmbeddingHub.in_memory(
            engine="hnsw", device="cpu", config=Config(engine="hnsw", hnsw_seed_probes=4)),
    }
    for what, call in calls.items():
        with pytest.raises(NotImplementedError, match=ITEM5):
            call()
    assert big.size == 0 and built.size == 5000 and big._graph_size() == 0


def test_refused_writes_leave_the_store_unchanged():
    """A cold multiset past ``exact_build_max`` is refused and leaves no key
    behind; the writes the store once refused now go through: a first
    multiset of 10 rows (host waves), more rows into the built graph, a
    set, a re-set and a delete."""
    hub = EmbeddingHub.in_memory(engine="hnsw", device="cpu")
    version = hub.create_space("g", DIM, "l2").default_version()
    version.index.exact_build_max = 3000
    with pytest.raises(NotImplementedError, match=ITEM5):
        _multiset(version, _data(10, 3500), prefix="big")
    assert version.size == 0 and "big3" not in version
    assert version.keymap.assign("first") == 0
    version.keymap.release("first")
    _multiset(version, _data(10, 10), prefix="small")
    _multiset(version, _data(11, 2100))
    new = _data(12, 2)
    version.set("new", new[0])
    version.set("k5", new[1])
    version.delete("k3")
    assert version.size == 2110 and version.index.size == 2110
    assert "new" in version and "k3" not in version and "small3" in version
    np.testing.assert_array_equal(version.get("k5"), new[1])
    assert version.nearest(1, vector=new[0]) == ["new"]
    assert "k3" not in version.nearest(10, vector=_data(11, 4)[3])


def test_failed_build_leaves_the_store_unchanged(monkeypatch):
    """A build that fails part way (here after layer 0, as a device error
    could) leaves no key, row or edge behind, and a retry of the same rows
    builds the graph a first try would have."""
    x = _data(13, 2100)
    hub = EmbeddingHub.in_memory(engine="hnsw", device="cpu")
    version = hub.create_space("g", DIM, "l2").default_version()

    def fail(*args):
        raise RuntimeError("out of device memory")

    monkeypatch.setattr(HNSWIndex, "_build_upper_layers", fail)
    with pytest.raises(RuntimeError, match="out of device memory"):
        _multiset(version, x)
    idx = version.index
    assert version.size == 0 and "k0" not in version and idx.size == 0
    assert not idx._hvalid.any() and (idx._levels == -1).all() and (idx._nb0 == -1).all()
    assert idx.search(x[:4], 5)[1].tolist() == [[-1] * 5] * 4
    monkeypatch.undo()
    _multiset(version, x)
    fresh = HNSWIndex(DIM, "l2", device="cpu")
    fresh.add(np.arange(len(x)), x)
    assert version.size == idx.size == len(x) and version.keymap.row("k7") == 7
    for name, arr in fresh.state_arrays().items():
        np.testing.assert_array_equal(idx.state_arrays()[name], arr)


# ------------------------------------------------------------ on the card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_card_pools_match_plain(metric):
    """``pooled_topk_ids`` on the card (K1, bf16 operands) against its plain
    version at the build's pool width: equal sets on 99 % of rows."""
    dev = _cuda()
    rng = np.random.default_rng(5)
    cap, dim = 1 << 16, 128
    x = rng.standard_normal((cap, dim)).astype(np.float32)
    valid = np.arange(cap) < 62_165
    q = x[:1024] + 0.1 * rng.standard_normal((1024, dim)).astype(np.float32)
    x_sq = (x * x).sum(1).astype(np.float32)
    want = ttopk.pooled_topk_ids(*_t(q, x, valid, x_sq), metric=metric, k=256).numpy()
    got = ttopk.pooled_topk_ids(*(t.to(dev) for t in _t(q, x, valid, x_sq)),
                                metric=metric, k=256).cpu().numpy()
    assert valid[got].all()
    assert np.mean([set(a) == set(b) for a, b in zip(got, want)]) >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_card_graph_matches_cpu(metric):
    """The bulk build on the card against the same on the CPU: identical
    levels and entry, ``nb0`` rows identical on 99 %, recall@10 within
    0.01; and the card-built graph walked on the card and, carried across
    by ``from_state``, on the CPU: matched as the JAX package's walks are."""
    dev = _cuda()
    x = _data(21, 6000)
    q = x[:64] + 0.05 * np.random.default_rng(22).standard_normal(
        (64, DIM)).astype(np.float32)
    cpu = HNSWIndex(DIM, metric, m=M, ef_construction=EFC, device="cpu")
    card = HNSWIndex(DIM, metric, m=M, ef_construction=EFC, device=dev)
    for idx in (cpu, card):
        idx.add(np.arange(len(x)), x)
    np.testing.assert_array_equal(card._levels, cpu._levels)
    assert card._entry == cpu._entry
    assert np.mean((card._nb0 == cpu._nb0).all(1)) >= 0.99
    oracle = _oracle(x, q, metric)
    rc, rg = (_recall(i.search(q, 10, ef=64)[1], oracle) for i in (cpu, card))
    assert abs(rc - rg) <= 0.01, (rc, rg)
    walked = HNSWIndex.from_state(DIM, metric, card.state_arrays(), device="cpu")
    for walk in ("bf16", "off", "packed"):
        _set_walk(walked, walk)
        _set_walk(card, walk)
        cd, ci = walked.search(q, 10, ef=64)
        gd, gi = card.search(q, 10, ef=64)
        assert card.last_hops == walked.last_hops
        assert_search_match(cd, ci, gd, gi, q, x, metric)
