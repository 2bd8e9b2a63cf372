"""The port's graph build past ``exact_build_max`` against the JAX package's,
on the CPU, on the same numpy inputs: the cluster-routed build (k-means
route, routed pools, boundary repair), its truncated regime (an own cluster
larger than the candidate arena), the centroid route (``build_route``, the
hub's automatic route), NN-descent and the hybrid stream, a rollback of a
build that fails part way, and snapshots of a cluster-built, routed graph.

Tolerances.  The route's k-means, its assignment and probe lists, the
plan's counts (``_cluster_stats``), levels, entry and liveness are equal.
The boundary rows are equal as sets: their margins carry f32 sums in
another order, which may swap two rows of equal margin in the ranking (and
``refine`` of a set of rows does not depend on their order).  The graphs are
held as the exact build's are (``tests/test_torch_hnsw.py``): at least 99 %
of layer-0 lists and of upper lists identical, and recall@10 at ef=64
within 0.01 of the JAX graph's.  Whole ``state_arrays()`` do not hold:
where two candidates lie at distances equal to f32 rounding from a row, the
two packages' sums (bf16-operand pools, f32 heuristic distances) may order
them either way, and that reorders a list (one list in several thousand in
these builds).  NN-descent, fed the JAX package's own initial draw, gives a
kNN graph with at least 99 % of rows identical and recall within 0.01.

The JAX index's ``jnp.asarray`` copies a numpy array first, as in
``tests/test_torch_hnsw_writes.py`` (on the CPU it may alias a host array
the index writes in place).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import embeddinghub_tpu.index.hnsw as jax_hnsw
from embeddinghub_tpu.index.hnsw import HNSWIndex as JaxHNSW
from embeddinghub_tpu.ops import nn_descent as jnnd
from embeddinghub_tpu_torch.index.hnsw import HNSWIndex
from embeddinghub_tpu_torch.ops import fused_topk
from embeddinghub_tpu_torch.ops import nn_descent as tnnd
from embeddinghub_tpu_torch.store.hub import EmbeddingHub
from embeddinghub_tpu_torch.utils.config import Config
from _torch_parity import assert_walks_match, walk_terms

D, M, EFC = 16, 8, 64
N = 6000
# the cluster-routed build at this size: k = 16 clusters of about 512 rows,
# pools over 4 probed clusters (an arena of S = 2048 rows)
KNOBS = dict(exact_build_max=3000, cluster_target=512, cluster_probes=4)


class _CopyingJnp:
    """``jax.numpy`` whose ``asarray`` copies a numpy array first."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(a, *args, **kw):
        return jnp.asarray(a.copy() if isinstance(a, np.ndarray) else a, *args, **kw)


@pytest.fixture(scope="module", autouse=True)
def _jax_index_copies():
    patch = pytest.MonkeyPatch()
    patch.setattr(jax_hnsw, "jnp", _CopyingJnp())
    yield
    patch.undo()


def _data(seed, n, d=D):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _pair(metric, n, **knobs):
    jidx = JaxHNSW(D, metric, m=M, ef_construction=EFC, capacity=n)
    tidx = HNSWIndex(D, metric, m=M, ef_construction=EFC, capacity=n, device="cpu")
    for idx in (jidx, tidx):
        for name, value in knobs.items():
            setattr(idx, name, value)
    return jidx, tidx


def _recall(ids, oracle):
    return np.mean([len(set(a) & set(b)) / oracle.shape[1] for a, b in zip(ids, oracle)])


def _oracle(x, q, metric, k=10):
    if metric == "cosine":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
        return np.argsort(-(q @ x.T), axis=1)[:, :k]
    return np.argsort(((q[:, None] - x[None]) ** 2).sum(-1), axis=1)[:, :k]


def _queries(x, seed=99):
    return x[:64] + 0.05 * _data(seed, 64, x.shape[1])


def assert_same_build(jidx, tidx, x, metric, q=None, refined=False):
    """The route, the plan and the graph, as the module docstring says
    (recall over ``q``, perturbed copies of the first rows by default)."""
    jr, tr = jidx._cluster_route, tidx._cluster_route
    np.testing.assert_array_equal(tr["assign"], jr["assign"])
    np.testing.assert_array_equal(tr["probes"], jr["probes"])
    np.testing.assert_array_equal(tr["rows"], jr["rows"])
    np.testing.assert_allclose(tr["cent"], jr["cent"], atol=1e-4, rtol=0)
    assert "fresh" not in tr and "fresh" not in jr
    assert tidx._cluster_stats == jidx._cluster_stats
    jb, tb = jidx.cluster_boundary_rows(), tidx.cluster_boundary_rows()
    assert tb.size == jb.size == int(N * tidx.cluster_repair_frac)
    np.testing.assert_array_equal(np.sort(tb), np.sort(jb))
    assert tidx.boundary_rows == tb.size
    want, got = jidx.state_arrays(), tidx.state_arrays()
    assert got.keys() == want.keys()
    for name in ("x", "valid", "levels", "meta"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert np.mean((got["nb0"] == want["nb0"]).all(1)) >= 0.99
    for layer, nodes in jidx._upper.items():
        mine = tidx._upper[layer]
        assert mine.keys() == nodes.keys()
        assert np.mean([mine[k] == v for k, v in nodes.items()]) >= 0.99
    assert set(tidx.build_seconds) == {
        "kmeans", "plan", "routed_pools", "prune", "symmetrize", "upper", "host",
        "boundary_repair"} | ({"refine"} if refined else set())
    q = _queries(x) if q is None else q
    oracle = _oracle(x, q, metric)
    rj = _recall(jidx.search(q, 10, ef=64)[1], oracle)
    rt = _recall(tidx.search(q, 10, ef=64)[1], oracle)
    assert rt >= 0.85 and abs(rt - rj) <= 0.01, (rt, rj)


# ------------------------------------------------------- the routed build


@pytest.fixture(scope="module")
def cluster_builds():
    """Both packages' cluster-routed builds of the same rows, by metric and
    ``cluster_refine_rounds``, each made at its first use."""
    cache = {}

    def build(metric, rounds=0):
        if (metric, rounds) not in cache:
            x = _data(10 + ("l2", "cosine").index(metric), N)
            jidx, tidx = _pair(metric, N, cluster_refine_rounds=rounds, **KNOBS)
            jidx.add(np.arange(N), x)
            tidx.add(np.arange(N), x)
            cache[(metric, rounds)] = (x, jidx, tidx)
        return cache[(metric, rounds)]

    return build


@pytest.mark.parametrize("metric,rounds", [
    pytest.param("l2", 0, id="l2"), pytest.param("cosine", 0, id="cosine"),
    pytest.param("l2", 1, id="l2-refine1")])
def test_cluster_routed_build_matches(cluster_builds, metric, rounds):
    """The routed build, and with ``cluster_refine_rounds=1`` the routed
    build followed by a graph-walk refinement round (``_bulk_refine``)."""
    x, jidx, tidx = cluster_builds(metric, rounds)
    assert tidx._cluster_stats["clusters"] == 16
    assert_same_build(jidx, tidx, x, metric, refined=bool(rounds))


def _skewed():
    """6,000 rows of which 3,000 form a tight blob far from the rest, none
    of them a row k-means starts from (the draws of ``fit_kmeans`` with
    seed 11): the whole blob falls to one centroid, a cluster larger than
    the 2,048-row candidate arena.  Returns the rows and the blob's rows."""
    rng = np.random.default_rng(5)
    starts = np.random.default_rng(11).choice(N, size=16, replace=False)
    others = np.setdiff1d(np.arange(N), starts)
    blob = rng.choice(others, size=3000, replace=False)
    x = rng.standard_normal((N, D)).astype(np.float32)
    c0 = np.full(D, 20.0 / np.sqrt(D), np.float32)
    x[blob] = c0 + 0.3 * rng.standard_normal((blob.size, D)).astype(np.float32)
    return x, blob


def test_truncated_regime_matches():
    """An own cluster larger than S: its arena keeps a spread of its own
    rows (``own_truncated``), the rest of the probe list fills the arena."""
    x, blob = _skewed()
    jidx, tidx = _pair("l2", N, **KNOBS)
    jidx.add(np.arange(N), x)
    tidx.add(np.arange(N), x)
    stats = tidx._cluster_stats
    assert stats["own_truncated"] >= 1 and stats["truncated"] >= 1, stats
    assert stats["dropped_cands"] > 0
    bulk = np.setdiff1d(np.arange(N), blob)[:64]
    assert_same_build(jidx, tidx, x, "l2", q=x[bulk] + 0.05 * _data(12, 64))


def test_routed_pool_leaves_out_the_own_row():
    """``_routed_pool`` asks the scan for ``pool_k + 1`` and drops the
    query's own row, or the last column where it is absent: the reference's
    pool, a top-``pool_k`` with the (query, own row) pair masked."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3000, D)).astype(np.float32)
    x_sq = (x * x).sum(1).astype(np.float32)
    cids = rng.permutation(3000)[:1024]
    cids[-100:] = -1                            # a padded arena
    qids = np.concatenate([cids[:200], rng.permutation(3000)[:56]])  # some absent
    idx = HNSWIndex(D, device="cpu")
    got = idx._routed_pool(*(torch.from_numpy(a) for a in (x, x_sq, qids, cids)),
                           64, "l2").numpy()
    assert got.shape == (256, 64)
    live = cids[cids >= 0]
    # the pool's scores: bf16-rounded operands, f32 sums
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).to(torch.float32).numpy()
    d = x_sq[live][None, :] - 2.0 * (bf(x[qids]) @ bf(x[live]).T)
    d[qids[:, None] == live[None, :]] = np.inf
    want = live[np.argsort(d, axis=1, kind="stable")[:, :64]]
    assert not (got == qids[:, None]).any()
    same = np.mean([set(a) == set(b) for a, b in zip(got, want)])
    assert same >= 0.99, same


# --------------------------------------------------------------- the route


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_build_route_matches(cluster_builds, metric):
    """After a cluster-routed build the route is the build's: the same
    medoids, and routed searches equal the JAX index's."""
    x, jidx, tidx = cluster_builds(metric)
    jidx.build_route(seed_probes=4)
    tidx.build_route(seed_probes=4)
    tr, jr = tidx._cluster_route, jidx._cluster_route
    np.testing.assert_array_equal(tr["medoids"], jr["medoids"])
    assert tr["built_size"] == jr["built_size"] == N and tidx.seed_probes == 4
    q = _queries(x, 7)
    for ef in (16, 64):
        jd, ji = jidx.search(q, 10, ef=ef)
        td, ti = tidx.search(q, 10, ef=ef)
        assert_walks_match(jd, ji, td, ti, walk_terms(q, x, metric))


def test_build_route_fitted_on_its_own_matches():
    """Over an exact build (no route yet) build_route fits one on a sample
    of the live rows: the same centroids' assignment and medoids."""
    x = _data(20, 2500)
    jidx, tidx = _pair("l2", 2500, cluster_target=256)
    for idx in (jidx, tidx):
        idx.add(np.arange(2500), x)
        idx.build_route(seed_probes=4)
    np.testing.assert_array_equal(tidx._cluster_route["assign"][:2500],
                                  jidx._cluster_route["assign"][:2500])
    np.testing.assert_array_equal(tidx._cluster_route["medoids"],
                                  jidx._cluster_route["medoids"])
    q = _queries(x, 8)
    jd, ji = jidx.search(q, 10, ef=32)
    td, ti = tidx.search(q, 10, ef=32)
    assert_walks_match(jd, ji, td, ti, walk_terms(q, x, "l2"))


def test_hub_with_seed_probes_routes_its_searches():
    """A hub with ``hnsw_seed_probes=4`` starts; past ``hnsw_route_min``
    rows its graph's first search fits the route, and the route is refitted
    once the graph has doubled."""
    config = Config(engine="hnsw", hnsw_m=M, hnsw_ef_construction=EFC,
                    hnsw_seed_probes=4, hnsw_route_min=2000)
    hub = EmbeddingHub.in_memory(engine="hnsw", device="cpu", config=config)
    version = hub.create_space("g", D, "l2").default_version()
    idx = version.index
    assert (idx.auto_seed_probes, idx.auto_route_min) == (4, 2000)
    x = _data(21, 5000)
    version.multiset((f"k{j}", x[j]) for j in range(1500))
    version.nearest(5, vector=x[0])
    assert idx._cluster_route is None and idx.seed_probes == 0  # below the min
    version.multiset((f"k{j}", x[j]) for j in range(1500, 2100))
    near = version.nearest(5, vector=x[1700])
    route = idx._cluster_route
    assert idx.seed_probes == 4 and route["built_size"] == 2100 and near[0] == "k1700"
    version.multiset((f"k{j}", x[j]) for j in range(2100, 4200))
    version.nearest(5, vector=x[0])
    assert idx._cluster_route is not route and idx._cluster_route["built_size"] == 4200


# ---------------------------------------------- NN-descent, the hybrid stream


def _jax_draw(n, m, seed=0):
    """The initial graph the reference's nn_descent draws."""
    return np.array(jax.random.randint(jax.random.PRNGKey(seed), (n, m), 0, n,
                                       dtype=jnp.int32))


def test_nn_descent_matches_with_the_same_draw():
    x = _data(30, 4096)
    x_sq = (x * x).sum(1).astype(np.float32)
    kw = dict(m=16, iters=4, block=1024, metric="l2")
    want = np.asarray(jnnd.nn_descent(jnp.asarray(x), jnp.asarray(x_sq), **kw))
    got = tnnd.nn_descent(torch.from_numpy(x), torch.from_numpy(x_sq),
                          init=torch.from_numpy(_jax_draw(4096, 16)), **kw).numpy()
    assert got.shape == want.shape == (4096, 16)
    assert np.mean((got == want).all(1)) >= 0.99
    truth = np.argsort(((x[:512, None] - x[None]) ** 2).sum(-1), axis=1)[:, 1:11]
    rj, rt = _recall(want[:512, :10], truth), _recall(got[:512, :10], truth)
    assert rt >= 0.8 and abs(rt - rj) <= 0.01, (rt, rj)


def test_reverse_sample_keeps_the_largest_source():
    nb = torch.tensor([[1, 2], [2, 2], [1, -1], [0, 1]])
    np.testing.assert_array_equal(tnnd.reverse_sample(nb).numpy(),
                                  [[3, -1], [2, 3], [1, 1], [-1, -1]])


@pytest.mark.parametrize("stream_refine", [False, True])
def test_hybrid_stream_over_nn_descent_matches(monkeypatch, stream_refine):
    """Past ``exact_full_max`` a 2,048-row core is bulk-built (past
    ``cluster_build_max``: NN-descent, the port fed the reference's own
    initial draw, then two graph-walk refinement rounds) and the other
    1,952 rows stream in by waves; ``stream_refine`` refines the whole graph
    after.  Recall@10 within 0.01 of the JAX graph's."""
    n = 4000
    knobs = dict(exact_build_max=500, cluster_build_max=1000, exact_full_max=3000,
                 stream_base=2048, stream_refine=stream_refine, refine_rounds=2)
    x = _data(31, n)
    jidx, tidx = _pair("l2", n, **knobs)
    draws, real = [], tnnd.nn_descent

    def fed(x_, x_sq, *, m, generator=None, init=None, **kw):
        draws.append(x_.shape[0])
        return real(x_, x_sq, m=m, init=torch.from_numpy(_jax_draw(x_.shape[0], m)), **kw)

    monkeypatch.setattr(tnnd, "nn_descent", fed)
    jidx.add(np.arange(n), x)
    tidx.add(np.arange(n), x)
    assert draws == [2048] and tidx.size == n and tidx.waves >= 1
    assert set(tidx.build_seconds) >= {"nn_descent", "prune", "refine", "upper"}
    np.testing.assert_array_equal(tidx._levels, jidx._levels)
    q = _queries(x, 9)
    oracle = _oracle(x, q, "l2")
    rj = _recall(jidx.search(q, 10, ef=64)[1], oracle)
    rt = _recall(tidx.search(q, 10, ef=64)[1], oracle)
    assert rt >= 0.85 and abs(rt - rj) <= 0.01, (rt, rj)


# ------------------------------------------------------- rollback, snapshots


@pytest.mark.parametrize("where", ["routed scan", "boundary repair"])
def test_failed_cluster_build_leaves_the_store_unchanged(monkeypatch, where):
    """A cold multiset past ``exact_build_max`` into a graph whose rows were
    all deleted (so it still holds the route fitted before) fails part way:
    the keys, the graph, the route and the level draws are as they were,
    and a retry builds the graph a first try would have."""
    hub = EmbeddingHub.in_memory(engine="hnsw", device="cpu",
                                 config=Config(engine="hnsw", hnsw_m=M,
                                               hnsw_ef_construction=EFC))
    version = hub.create_space("g", D, "l2").default_version()
    idx = version.index
    x = _data(40, 4000)
    version.multiset((f"a{j}", x[j]) for j in range(2100))
    idx.build_route(seed_probes=4)
    route, medoids = idx._cluster_route, idx._cluster_route["medoids"].copy()
    for j in range(2100):
        version.delete(f"a{j}")
    for name, value in KNOBS.items():
        setattr(idx, name, value)
    rng_state = idx._rng.bit_generator.state
    calls = []
    real_pool, real_refine = HNSWIndex._routed_pool, HNSWIndex.refine

    def failing_pool(self, *args):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("device fault")
        return real_pool(self, *args)

    def failing_refine(self, rows=None):
        raise RuntimeError("device fault")

    if where == "routed scan":
        monkeypatch.setattr(HNSWIndex, "_routed_pool", failing_pool)
    else:
        monkeypatch.setattr(HNSWIndex, "refine", failing_refine)
    with pytest.raises(RuntimeError, match="device fault"):
        version.multiset((f"b{j}", x[j]) for j in range(4000))
    assert version.size == 0 and "b3" not in version and idx.size == 0
    assert idx._graph_size() == 0 and not idx._hvalid.any()
    assert idx._cluster_route is route and route.keys() >= {"medoids", "_dev"}
    np.testing.assert_array_equal(route["medoids"], medoids)
    assert "rows" not in route and idx.seed_probes == 4
    assert idx._rng.bit_generator.state == rng_state
    monkeypatch.setattr(HNSWIndex, "_routed_pool", real_pool)
    monkeypatch.setattr(HNSWIndex, "refine", real_refine)
    version.multiset((f"b{j}", x[j]) for j in range(4000))
    fresh = HNSWIndex(D, "l2", m=M, ef_construction=EFC, capacity=idx._cap, device="cpu")
    for name, value in KNOBS.items():
        setattr(fresh, name, value)
    fresh._rng.bit_generator.state = rng_state
    fresh.add(np.asarray([version.keymap.row(f"b{j}") for j in range(4000)]), x)
    np.testing.assert_array_equal(idx._nb0, fresh._nb0)
    np.testing.assert_array_equal(idx._levels, fresh._levels)
    assert idx._cluster_stats == fresh._cluster_stats


def test_routed_graph_reopens_from_a_snapshot(tmp_path, cluster_builds):
    """A cluster-built graph with a fitted route: its snapshot reopens (in
    this package and in the JAX package) with the route, and routed
    searches give the same results."""
    x, _, built = cluster_builds("l2")
    config = Config(engine="hnsw", hnsw_m=M, hnsw_ef_construction=EFC)
    hub = EmbeddingHub.load_or_create(tmp_path / "store", engine="hnsw", device="cpu",
                                      config=config)
    version = hub.create_space("g", D, "l2").default_version()
    for name, value in KNOBS.items():
        setattr(version.index, name, value)
    version.multiset((f"k{j}", x[j]) for j in range(N))
    idx = version.index
    np.testing.assert_array_equal(idx._nb0, built._nb0)
    idx.build_route(seed_probes=4)
    q = _queries(x, 11)
    want = version.nearest_batch(q, 10)
    wd, wi = idx.search(q, 10, ef=48)
    hub.save()
    del hub, version
    hub = EmbeddingHub.load_or_create(tmp_path / "store", engine="hnsw", device="cpu",
                                      config=config)
    version = hub.get_version("g")
    again = version.index
    assert again.seed_probes == 4
    np.testing.assert_array_equal(again._cluster_route["medoids"],
                                  idx._cluster_route["medoids"])
    assert version.nearest_batch(q, 10) == want
    jidx = JaxHNSW.from_state(D, "l2", again.state_arrays())
    assert jidx.seed_probes == 4
    jd, ji = jidx.search(q, 10, ef=48)
    assert_walks_match(jd, ji, wd, wi, walk_terms(q, x, "l2"))


# ------------------------------------------------------------ on the card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
    return torch.device("cuda")


def _bf16_scores(x, x_sq, q, ids, metric):
    """The routed pool's scores of rows ``ids [B, j]`` for queries ``q``:
    bf16-rounded operands, products summed in f64."""
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).to(torch.float64).numpy()
    dots = np.einsum("bd,bjd->bj", bf(q), bf(x[ids]))
    return x_sq[ids] - 2.0 * dots if metric == "l2" else -dots


@pytest.mark.cuda
@pytest.mark.parametrize("metric,b,rows", [
    pytest.param("l2", 4096, 32_268, id="l2"),
    pytest.param("cosine", 4096, 32_268, id="cosine"),
    pytest.param("l2", 1145, 20_000, id="l2-B1145"),
    pytest.param("cosine", 1145, 20_000, id="cosine-B1145"),
    pytest.param("l2", 37, 9_000, id="l2-B37")])
def test_card_routed_pool_matches_plain(metric, b, rows):
    """K1 at the routed scan's shapes (a block of 4,096 rows, a cluster's
    last block of 1,145 rows, one narrower than a 128-query tile; k = 257
    over a 32,768-row gathered arena whose tail past ``rows`` is -1
    padding, bf16 operands) with the own-row rule, against the plain
    version on the same tensors.  Every row's pool is the plain version's
    set, but for rows that differ only at a near-tie of the pool's last
    place: each row in one pool and not the other scores within 1e-3 plus
    1e-5 of the last place's score (bf16 operands, f32 sums in either
    order); and, in blocks of 100 rows or more, at least 99 % of rows are
    equal sets."""
    dev = _cuda()
    rng = np.random.default_rng(50)
    x = rng.standard_normal((200_000, 128)).astype(np.float32)
    if metric == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    x_sq = (x * x).sum(1).astype(np.float32)
    cids = rng.permutation(200_000)[:32_768]
    cids[rows:] = -1
    qids = cids[:b]
    pool_metric = "l2" if metric == "l2" else "ip"
    idx = HNSWIndex(128, metric, device="cpu")
    want = idx._routed_pool(*(torch.from_numpy(a) for a in (x, x_sq, qids, cids)),
                            256, pool_metric).numpy()
    xd = fused_topk.arena_f32(torch.from_numpy(x).to(dev))
    got = idx._routed_pool(xd, torch.from_numpy(x_sq).to(dev),
                           torch.from_numpy(qids).to(dev), torch.from_numpy(cids).to(dev),
                           256, pool_metric).cpu().numpy()
    assert got.shape == want.shape == (b, 256)
    assert not (got == qids[:, None]).any() and (got >= 0).all()
    same = np.array([set(a) == set(c) for a, c in zip(got, want)])
    assert same.mean() >= 0.99 or b < 100, same.mean()
    last = _bf16_scores(x, x_sq, x[qids], want, pool_metric).max(1)
    for r in np.flatnonzero(~same):
        odd = np.array(sorted(set(got[r]) ^ set(want[r])))
        s = _bf16_scores(x, x_sq, x[qids[r]][None], odd[None], pool_metric)[0]
        assert (np.abs(s - last[r]) <= 1e-3 + 1e-5 * abs(last[r])).all(), (r, s, last[r])


@pytest.mark.cuda
def test_card_nn_descent_draws_on_the_device():
    """NN-descent with its initial graph drawn by a generator on the card:
    a kNN graph as good as the CPU's (recall@10 within 0.01 of the graph
    the CPU builds from its own draw), and the reverse sample of a graph
    with duplicate targets equal on both devices (the largest source
    wins)."""
    dev = _cuda()
    x = _data(30, 4096)
    x_sq = (x * x).sum(1).astype(np.float32)
    kw = dict(m=16, iters=4, block=1024, metric="l2")
    cpu = tnnd.nn_descent(torch.from_numpy(x), torch.from_numpy(x_sq),
                          generator=torch.Generator().manual_seed(0), **kw).numpy()
    card = tnnd.nn_descent(torch.from_numpy(x).to(dev), torch.from_numpy(x_sq).to(dev),
                           generator=torch.Generator(device=dev).manual_seed(0),
                           **kw).cpu().numpy()
    assert card.shape == (4096, 16)
    assert ((card >= 0) & (card < 4096)).all()
    assert not (card == np.arange(4096)[:, None]).any()
    truth = np.argsort(((x[:512, None] - x[None]) ** 2).sum(-1), axis=1)[:, 1:11]
    rc, rd = _recall(cpu[:512, :10], truth), _recall(card[:512, :10], truth)
    assert rd >= 0.8 and abs(rd - rc) <= 0.01, (rd, rc)
    nb = torch.from_numpy(card)
    np.testing.assert_array_equal(tnnd.reverse_sample(nb.to(dev)).cpu().numpy(),
                                  tnnd.reverse_sample(nb).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("stream_refine", [False, True])
def test_card_hybrid_stream_over_nn_descent_matches(monkeypatch, stream_refine):
    """The 4,000-row hybrid stream of
    ``test_hybrid_stream_over_nn_descent_matches`` built on the card and on
    the CPU, both fed the same initial NN-descent draw: NN-descent, two
    graph-walk refinement rounds (``_bulk_refine``), the waves and
    ``stream_refine`` run on the card, and its graph's recall@10 is within
    0.01 of the CPU graph's."""
    dev = _cuda()
    n = 4000
    knobs = dict(exact_build_max=500, cluster_build_max=1000, exact_full_max=3000,
                 stream_base=2048, stream_refine=stream_refine, refine_rounds=2)
    x = _data(31, n)
    real = tnnd.nn_descent

    def fed(x_, x_sq, *, m, generator=None, init=None, **kw):
        draw = np.random.default_rng(32).integers(0, x_.shape[0], (x_.shape[0], m))
        return real(x_, x_sq, m=m, init=torch.from_numpy(draw).to(x_.device), **kw)

    monkeypatch.setattr(tnnd, "nn_descent", fed)
    built = []
    for device in ("cpu", dev):
        idx = HNSWIndex(D, "l2", m=M, ef_construction=EFC, capacity=n, device=device)
        for name, value in knobs.items():
            setattr(idx, name, value)
        idx.add(np.arange(n), x)
        assert idx.size == n and idx.waves >= 1 and "refine" in idx.build_seconds
        built.append(idx)
    np.testing.assert_array_equal(built[1]._levels, built[0]._levels)
    q = _queries(x, 9)
    oracle = _oracle(x, q, "l2")
    rc = _recall(built[0].search(q, 10, ef=64)[1], oracle)
    rd = _recall(built[1].search(q, 10, ef=64)[1], oracle)
    assert rd >= 0.85 and abs(rd - rc) <= 0.01, (rd, rc)
