"""The port's sharded indexes (``embeddinghub_tpu_torch/parallel``) against
the JAX package's, on the CPU: the JAX side on ``default_mesh(S)`` over the
8 virtual CPU devices of ``tests/conftest.py``, the port on ``Mesh(["cpu"]
* S)``, for S in {2, 8}, on the same inputs (numpy seeds).

``ShardedFlatIndex`` for l2 and cosine and each storage (f32, int8,
int8x2): the lists, writes (growth, remove, the scatter after a sync),
the quantization guard and the deep path past the shard threshold
(patched small in both packages).  ``ShardedHNSWIndex``: every shard's
``state_arrays()`` after a bulk add, streamed adds and a remove, and the
walks.  Then the store: data directories of the sharded engines in both
directions, WAL replay into a sharded graph, the server with
``EMBEDDINGHUB_ENGINE=sharded`` and the in-process dry run.  The ``cuda``
tests hold two shards of one card against one ``FlatIndex`` on it.

Tolerances: f32 lists equal off near-ties (1e-4) and distances within
rtol 1e-4, atol 1e-4.  Quantized lists: where no route differs by design,
ids equal off near-ties except for queries whose lists a plane element
off by one may change (the port quantizes cosine rows with PyTorch), and
on those queries recall@k against an exact numpy oracle no lower than the
JAX index's; where the port takes K2's pool (one winner per 32 rows)
where the JAX index takes ``approx_max_k`` (exact on the CPU), recall no
lower than JAX's less 0.01, as ``tests/test_torch_quantized.py`` holds
the single-device searches.  Graph states exactly equal; walks as
``_torch_parity.assert_walks_match``.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import embeddinghub_tpu.index.hnsw as jax_hnsw
import embeddinghub_tpu.parallel.sharded_flat as jsf
from embeddinghub_tpu.ops import topk as jtopk
from embeddinghub_tpu.parallel import ShardedFlatIndex as JaxSFlat
from embeddinghub_tpu.parallel import ShardedHNSWIndex as JaxSHNSW
from embeddinghub_tpu.parallel import default_mesh as jax_mesh
from embeddinghub_tpu_torch.ops import fused_topk as F
from embeddinghub_tpu_torch.parallel import Mesh, ShardedFlatIndex, ShardedHNSWIndex
from embeddinghub_tpu_torch.parallel import default_mesh, shard_axis
from embeddinghub_tpu_torch.parallel import sharded_flat as tsf
from embeddinghub_tpu_torch.parallel.dryrun import dryrun_multichip
from embeddinghub_tpu_torch.store.hub import EmbeddingHub
from embeddinghub_tpu_torch.utils.config import Config
from _torch_parity import assert_ids_equal_off_ties, assert_walks_match, walk_terms

SHARDS = [2, 8]
METRICS = ["l2", "cosine"]
STORAGE = ["float32", "int8", "int8x2"]
D, K = 32, 10


class _CopyingJnp:
    """``jax.numpy`` whose ``asarray`` copies a numpy array first (see
    ``tests/test_torch_hnsw_writes.py``: the JAX graph index may otherwise
    alias host arrays it later writes in place)."""

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


def _pair(s, **kw):
    """(JAX index, port index) of ``ShardedFlatIndex`` on S shards."""
    return (JaxSFlat(mesh=jax_mesh(s), **kw),
            ShardedFlatIndex(mesh=Mesh(["cpu"] * s), **kw))


def _oracle(x, valid, q, k, metric):
    if metric == "cosine":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
        s = q @ x.T
    else:
        s = 2.0 * (q @ x.T) - (x * x).sum(1)
    s = np.where(valid[None, :], s, -np.inf)
    return np.argsort(-s, axis=1)[:, :k]


def _recall(ids, true):
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / true.shape[1]
                          for a, b in zip(np.asarray(ids), true)]))


def _assert_lists(storage, got, want, x, valid, q, metric):
    """The port's ``(dist, ids)`` against the JAX index's, as the module
    docstring states."""
    (td, ti), (jd, ji) = got, want
    assert ti.shape == ji.shape and ti.dtype == np.int64
    if storage == "float32":
        assert_ids_equal_off_ties(ti, ji, jd, 1e-4)
        np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-4)
        return
    with np.errstate(invalid="ignore"):
        tie = np.abs(np.diff(jd, axis=1)) <= 1e-4
    near = np.zeros(ji.shape, bool)
    near[:, 1:] |= tie
    near[:, :-1] |= tie
    off = ((ti != ji) & ~near).any(axis=1)
    if off.any():
        true = _oracle(x, valid, q[off], ti.shape[1], metric)
        assert _recall(ti[off], true) >= _recall(ji[off], true), (off.sum(), ti[off], ji[off])


# ------------------------------------------------------------------ mesh


def test_mesh_of_repeated_devices():
    mesh = Mesh(["cpu"] * 4)
    assert mesh.size == 4 and mesh.devices == (torch.device("cpu"),) * 4
    assert shard_axis() == "shard"
    assert default_mesh(devices=["cpu"] * 3).size == 3
    with pytest.raises(ValueError):
        Mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            default_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            Mesh(["cuda:0"] * 2)
        with pytest.raises(RuntimeError, match="CUDA"):
            ShardedFlatIndex(D)


# ------------------------------------------------------------ the flat arena


@pytest.mark.parametrize("storage", STORAGE)
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("s", SHARDS)
def test_sharded_flat_matches_jax(s, metric, storage):
    """3,000 rows, 17 queries: the lists; then 40 removed rows, scattered
    after the sync, and the lists again."""
    x, q = _data(1, 3000), _data(2, 17)
    jidx, tidx = _pair(s, dims=D, metric=metric, storage_dtype=storage)
    valid = np.ones(len(x), bool)
    for idx in (jidx, tidx):
        idx.add(np.arange(len(x)), x)
    _assert_lists(storage, tidx.search(q, K), jidx.search(q, K), x, valid, q, metric)
    gone = np.arange(5, 3000, 73)
    valid[gone] = False
    for idx in (jidx, tidx):
        idx.remove(gone)
    assert tidx.size == jidx.size == 3000 - gone.size
    assert not tidx._dirty and len(tidx._dirty_rows) == gone.size
    got = tidx.search(q, K)
    assert not tidx._dirty_rows and not np.isin(got[1], gone).any()
    _assert_lists(storage, got, jidx.search(q, K), x, valid, q, metric)
    assert tidx.total_capacity == jidx.total_capacity
    assert tidx.state_arrays().keys() == jidx.state_arrays().keys()
    for name, arr in jidx.state_arrays().items():
        np.testing.assert_array_equal(tidx.state_arrays()[name], arr, err_msg=name)


def _exact_lists(x, valid, q, k, metric):
    """``(dist, ids)`` of the ``k`` nearest live rows in float64: l2 squared
    distances, or 1 - cos."""
    x, q = x.astype(np.float64), q.astype(np.float64)
    if metric == "cosine":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
        d = 1.0 - q @ x.T
    else:
        d = (q * q).sum(1)[:, None] - 2.0 * (q @ x.T) + (x * x).sum(1)[None, :]
    d = np.where(valid[None, :], d, np.inf)
    ids = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, ids, axis=1), ids


@pytest.mark.parametrize("storage", STORAGE)
@pytest.mark.parametrize("metric", METRICS)
def test_sharded_flat_k_past_shard_capacity(metric, storage):
    """400 rows on 4 shards of 128 rows: k=100 (at most a shard's capacity)
    gives the JAX index's lists; k=300 gives 300 columns (the JAX index
    stops at 128: the port departs from it on purpose): for f32 the exact
    lists up to ties, for the int8 kinds distinct live ids at recall 0.95
    against the exact oracle."""
    x, q = _data(20, 400), _data(21, 6)
    jidx, tidx = _pair(4, dims=D, metric=metric, storage_dtype=storage, capacity=400,
                       quant_guard=False)
    assert tidx._cap_local == 128
    valid = np.ones(len(x), bool)
    for idx in (jidx, tidx):
        idx.add(np.arange(len(x)), x)
    _assert_lists(storage, tidx.search(q, 100), jidx.search(q, 100), x, valid, q, metric)
    assert jidx.search(q, 300)[1].shape == (6, 128)
    td, ti = tidx.search(q, 300)
    assert td.shape == ti.shape == (6, 300)
    assert ((ti >= 0) & (ti < len(x))).all() and np.isfinite(td).all()
    assert all(len(set(r.tolist())) == 300 for r in ti)
    wd, wi = _exact_lists(x, valid, q, 300, metric)
    if storage == "float32":
        assert_ids_equal_off_ties(ti, wi, wd, 1e-4)
        np.testing.assert_allclose(td, wd, rtol=1e-4, atol=1e-4)
    else:
        assert _recall(ti, wi) >= 0.95
    # past the rows held: every live row, then empty slots
    td, ti = tidx.search(q, 450)
    assert ti.shape == (6, 450) and (ti[:, 400:] == -1).all()
    assert np.isinf(td[:, 400:]).all() and all(set(r[:400].tolist()) == set(range(400))
                                               for r in ti)


@pytest.mark.parametrize("engine", ["sharded", "sharded-int8", "sharded-int8x2"])
def test_sharded_store_nearest_batch_past_shard_capacity(engine):
    """A ``sharded`` store of 400 rows on 4 shards of 256 rows answers
    ``nearest_batch`` with 300 keys, those of the exact lists (f32 up to
    ties; the int8 kinds at recall 0.95)."""
    x, q = _data(22, 400), _data(23, 5)
    keys = [f"k{j}" for j in range(len(x))]
    hub = EmbeddingHub(engine=engine, mesh=Mesh(["cpu"] * 4))
    version = hub.create_space("s", D).default_version()
    version.multiset(zip(keys, x))
    assert version.index._cap_local < 300
    got = version.nearest_batch(q, 300)
    wd, wi = _exact_lists(x, np.ones(len(x), bool), q, 300, "l2")
    assert [len(g) for g in got] == [300] * len(q)
    rows = np.asarray([[int(k[1:]) for k in g] for g in got])
    if engine == "sharded":
        assert_ids_equal_off_ties(rows, wi, wd, 1e-4)
    else:
        assert all(len(set(g)) == 300 for g in got)
        assert _recall(rows, wi) >= 0.95


def _pool_calls(monkeypatch):
    calls = []
    plain = F.pool_candidates_reference
    monkeypatch.setattr(F, "pool_candidates_reference",
                        lambda *a, **kw: calls.append((kw["k"], kw.get("seg"))) or plain(*a, **kw))
    return calls


@pytest.mark.parametrize("storage", ["int8", "int8x2"])
@pytest.mark.parametrize("metric", METRICS)
def test_sharded_pool_route_recall(monkeypatch, metric, storage):
    """Shards of 8,192 rows at k=4: the pool of ``kk * over`` candidates
    fits a quarter of the bins, so each shard takes K2's int8 pool (its
    plain version here) where the JAX shards take ``approx_max_k``."""
    x, q = _data(3, 16384, 16), _data(4, 64, 16)
    jidx, tidx = _pair(2, dims=16, metric=metric, storage_dtype=storage, quant_guard=False)
    for idx in (jidx, tidx):
        idx.add(np.arange(len(x)), x)
    calls = _pool_calls(monkeypatch)
    _, ti = tidx.search(q, 4)
    over = 16 if storage == "int8x2" else 8
    assert calls == [(4 * over, None)] * 2
    true = _oracle(x, np.ones(len(x), bool), q, 4, metric)
    assert _recall(ti, true) >= _recall(jidx.search(q, 4)[1], true) - 0.01


def _deep(monkeypatch, thresh, chunk):
    """Both packages' deep path for shards past ``thresh`` local rows, in
    chunks of ``chunk`` rows: the port's constants, and in the JAX module
    (whose threshold and chunk are literals of ``_build_search``) a
    ``topk_ops`` whose shallow search is the deep one at that chunk."""
    monkeypatch.setattr(tsf, "_DEEP_CAP_THRESHOLD", thresh)
    monkeypatch.setattr(tsf, "_DEEP_CHUNK", chunk)

    def deep(*args, metric, k, oversample):
        return jtopk.quantized_chunked_exact(*args, metric=metric, k=k,
                                             oversample=oversample, chunk=chunk)
    shim = types.SimpleNamespace(**{n: getattr(jtopk, n) for n in dir(jtopk)
                                    if not n.startswith("__")})
    shim.int8_oversample_search = deep
    monkeypatch.setattr(jsf, "topk_ops", shim)


@pytest.mark.parametrize("storage", ["int8", "int8x2"])
def test_deep_shards_match_jax(monkeypatch, storage):
    """Shards of 16,384 local rows past a threshold patched to 4,096, in
    chunks of 4,096 rows: K2's pool a chunk (segments of 4,096 rows), the
    rerank, the merge; then a scatter."""
    _deep(monkeypatch, 4096, 4096)
    x, q = _data(5, 32768, 16), _data(6, 40, 16)
    jidx, tidx = _pair(2, dims=16, metric="cosine", storage_dtype=storage,
                       quant_guard=False, capacity=32768)
    for idx in (jidx, tidx):
        idx.add(np.arange(len(x)), x)
    calls = _pool_calls(monkeypatch)
    _, ti = tidx.search(q, 2)
    assert calls and all(seg == 4096 for _, seg in calls)
    valid = np.ones(len(x), bool)
    true = _oracle(x, valid, q, 2, "cosine")
    assert _recall(ti, true) >= _recall(jidx.search(q, 2)[1], true) - 0.01
    new = _data(7, 8, 16) * 3.0
    for idx in (jidx, tidx):
        idx.add(np.arange(8), new)
    assert not tidx._dirty
    for idx in (jidx, tidx):
        assert (idx.search(new, 2)[1][:, 0] == np.arange(8)).all()


@pytest.mark.parametrize("s", SHARDS)
def test_sharded_flat_writes_match_jax(s):
    """The JAX tests' cases (tests/test_sharded.py): growth after a sync,
    an empty index, k past the live rows, the scatter after a sync and an
    update that streams."""
    x = _data(8, 600)
    jidx, tidx = _pair(s, dims=D)
    empty = tidx.search(np.zeros((3, D), np.float32), 5)
    assert (empty[1] == -1).all() and np.isinf(empty[0]).all()
    for idx in (jidx, tidx):
        idx.add(np.arange(3), x[:3])
    got, want = tidx.search(x[:2], 8), jidx.search(x[:2], 8)
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[1][:, 3:] == -1).all()
    for idx in (jidx, tidx):
        idx.add(np.arange(3, 100), x[3:100])
        idx.search(x[:1], 1)
        idx.add(np.arange(100, 400), x[100:400])  # growth: a full sync
    assert tidx._dirty and tidx.total_capacity == jidx.total_capacity
    q = x[:20] + 0.01
    _assert_lists("float32", tidx.search(q, K), jidx.search(q, K), None, None, q, "l2")
    jidx, tidx = _pair(s, dims=D, capacity=2048)
    for idx in (jidx, tidx):
        idx.add(np.arange(500), x[:500])
        idx.search(x[:1], 1)
        idx.add(np.arange(500, 520), x[500:520])
        idx.add([7], x[7:8] + 100.0)
    assert not tidx._dirty and len(tidx._dirty_rows) == 21
    got = tidx.search(x[500:520], K)
    assert not tidx._dirty_rows and (got[1][:, 0] == np.arange(500, 520)).all()
    _assert_lists("float32", got, jidx.search(x[500:520], K), None, None, None, "l2")
    # the moved row's distances are differences of terms near 3e5
    for idx in (jidx, tidx):
        assert idx.search(x[7:8] + 100.0, 1)[1][0, 0] == 7


def _clustered(n=8192, d=D, centers=8, spread=2e-2, seed=0):
    """tests/test_quant_guard.py's near-duplicate clusters: score gaps below
    int8 resolution, above int8x2's."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    return (c[np.arange(n) % centers]
            + spread * rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)


@pytest.mark.parametrize("storage", ["int8", "int8x2"])
def test_guard_escalates_like_jax(storage):
    """A near-duplicate int8 arena escalates at its first sync to the dtype
    the JAX index picks, with the same sampled recalls; the snapshot keeps
    it.  (The guard's int8x2 sample clears these clusters, so an int8x2
    arena stays.)"""
    x = _clustered()
    jidx, tidx = _pair(2, dims=D, metric="l2", storage_dtype=storage)
    q = x[:32] + 1e-5
    for idx in (jidx, tidx):
        idx.add(np.arange(len(x)), x)
        idx.search(q, K)
    assert tidx.storage_dtype == jidx.storage_dtype == "int8x2"
    assert set(tidx.guard_recalls) == ({"int8", "int8x2"} if storage == "int8" else {"int8x2"})
    state = tidx.state_arrays()
    assert int(state["sflat_meta"][0]) == 3
    back = ShardedFlatIndex.from_state(D, "l2", state, mesh=Mesh(["cpu"] * 3))
    assert back.storage_dtype == "int8x2" and back.n_shards == 3
    true = _oracle(x, np.ones(len(x), bool), q, K, "l2")
    assert _recall(back.search(q, K)[1], true) >= 0.95


def test_guard_without_a_bf16_plane_goes_to_f32(monkeypatch):
    """An int8x2 arena whose sample fails escalates to float32 (a sharded
    arena has no bf16 plane), as in the reference."""
    import embeddinghub_tpu.index.flat as jflat
    import embeddinghub_tpu_torch.index.flat as tflat

    for mod in (jflat, tflat):
        monkeypatch.setattr(mod, "_GUARD_RECALL", 1.01)
    x = _data(9, 4096)
    jidx, tidx = _pair(2, dims=D, storage_dtype="int8x2")
    for idx in (jidx, tidx):
        idx.add(np.arange(len(x)), x)
        idx.search(x[:4], K)
    assert tidx.storage_dtype == jidx.storage_dtype == "float32"


# ------------------------------------------------------------------ graph


def _graph_pair(s, metric, **kw):
    kw = dict(dims=D, metric=metric, m=8, ef_construction=40, **kw)
    return (JaxSHNSW(mesh=jax_mesh(s), **kw),
            ShardedHNSWIndex(mesh=Mesh(["cpu"] * s), **kw))


def _assert_same_graphs(jidx, tidx):
    want, got = jidx.state_arrays(), tidx.state_arrays()
    assert got.keys() == want.keys()
    for name, arr in want.items():
        np.testing.assert_array_equal(got[name], arr, err_msg=name)


def _assert_walks(jidx, tidx, q, x, metric, k=K):
    for ef in (32, 64):
        jd, ji = jidx.search(q, k, ef=ef)
        td, ti = tidx.search(q, k, ef=ef)
        assert_walks_match(jd, ji, td, ti, walk_terms(q, x, metric))


@pytest.mark.parametrize("s,metric", [(2, "l2"), (8, "cosine")])
def test_sharded_graph_matches_jax(s, metric):
    """4,096 rows in one add (S=2: a bulk build of 2,048 a shard; S=8: host
    waves, then fused ones), then 300 rows in uneven batches, then a
    remove: every shard's state equal to the JAX index's after each, and
    the walks at ef 32 and 64."""
    x, q = _data(10, 4396), _data(11, 24)
    jidx, tidx = _graph_pair(s, metric, capacity=4096)
    for idx in (jidx, tidx):
        idx.add(np.arange(4096), x[:4096])
    _assert_same_graphs(jidx, tidx)
    for lo, hi in ((4096, 4296), (4296, 4396)):
        for idx in (jidx, tidx):
            idx.add(np.arange(lo, hi), x[lo:hi])
    assert tidx.size == 4396
    _assert_same_graphs(jidx, tidx)
    gone = np.arange(3, 4396, 29)
    for idx in (jidx, tidx):
        idx.remove(gone)
    _assert_same_graphs(jidx, tidx)
    _assert_walks(jidx, tidx, q, x, metric)
    assert not np.isin(tidx.search(x[gone[:8]] + 1e-5, K, ef=64)[1], gone).any()
    np.testing.assert_array_equal(tidx.vectors([0, 4395]), x[[0, 4395]])


def test_sharded_graph_empty_and_snapshot_shards():
    jidx, tidx = _graph_pair(2, "l2")
    d, i = tidx.search(np.zeros((5, D), np.float32), 3)
    assert i.shape == (5, 3) and (i == -1).all() and np.isinf(d).all()
    x = _data(12, 300)
    tidx.add(np.arange(300), x)
    jidx.add(np.arange(300), x)
    state = tidx.state_arrays()
    assert int(state["nshards"][0]) == 2
    back = ShardedHNSWIndex.from_state(D, "l2", state, mesh=Mesh(["cpu"] * 2))
    np.testing.assert_array_equal(back.search(x[:8], 5)[1], tidx.search(x[:8], 5)[1])
    with pytest.raises(ValueError, match="2 shards"):
        ShardedHNSWIndex.from_state(D, "l2", state, mesh=Mesh(["cpu"] * 3))
    with pytest.raises(ValueError, match="2 shards"):
        JaxSHNSW.from_state(D, "l2", state, mesh=jax_mesh(3))
    jback = JaxSHNSW.from_state(D, "l2", state, mesh=jax_mesh(2))
    _assert_same_graphs(jback, tidx)


# ------------------------------------------------------------------ store

_CFG = dict(hnsw_m=8, hnsw_ef_construction=40, hnsw_ef_search=32)


@pytest.fixture
def jax_hnsw_knobs(monkeypatch):
    """The JAX hub's hnsw knobs (its ``get_config()``) set to ``_CFG``."""
    from embeddinghub_tpu.utils import config as jcfg

    monkeypatch.setenv("EMBEDDINGHUB_HNSW_M", str(_CFG["hnsw_m"]))
    monkeypatch.setenv("EMBEDDINGHUB_HNSW_EFC", str(_CFG["hnsw_ef_construction"]))
    monkeypatch.setenv("EMBEDDINGHUB_HNSW_EF", str(_CFG["hnsw_ef_search"]))
    monkeypatch.setattr(jcfg, "_config", None)
    yield
    jcfg._config = None


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("engine", ["sharded-int8x2", "hnsw-sharded"])
def test_data_directories_across_packages(tmp_path, jax_hnsw_knobs, engine, direction):
    """A data directory one package's hub wrote with a sharded engine (8
    shards: the JAX hub reopens on its default mesh, the 8 virtual
    devices) opens in the other with the same index type, storage and
    lists."""
    from embeddinghub_tpu.store.hub import EmbeddingHub as JaxHub

    x = _data(13, 3000)
    keys = [f"k{j}" for j in range(len(x))]
    q = x[:16] + 0.01

    def port_hub():
        return EmbeddingHub.load_or_create(tmp_path / "d", engine=engine,
                                           mesh=Mesh(["cpu"] * 8), config=Config(**_CFG))

    def jax_hub():
        return JaxHub.load_or_create(tmp_path / "d", engine=engine, mesh=jax_mesh(8))

    write, read = (jax_hub, port_hub) if direction == "jax_to_port" else (port_hub, jax_hub)
    hub = write()
    version = hub.create_space("s", D, "cosine").default_version()
    version.multiset(zip(keys, x))
    want = version.nearest_batch(q, 5)
    hub.save()
    other = read().get_version("s")
    assert type(other.index).__name__ == type(version.index).__name__
    if engine == "sharded-int8x2":
        assert other.index.storage_dtype == "int8x2"
    assert other.index.n_shards == 8
    assert other.nearest_batch(q, 5) == want
    assert [r[0] for r in want] == keys[:16]


def test_port_store_reopens_on_its_mesh(tmp_path):
    """A four-shard store reopens onto the hub's mesh: a flat one on any
    shard count, a graph one on four shards only (the reference's
    ``ValueError`` otherwise); and a store with no mesh named on the CPU
    is one shard."""
    x = _data(14, 2500)
    keys = [f"k{j}" for j in range(len(x))]
    for engine in ("sharded", "hnsw-sharded"):
        base = tmp_path / engine
        hub = EmbeddingHub.load_or_create(base, engine=engine, mesh=Mesh(["cpu"] * 4),
                                          config=Config(**_CFG))
        version = hub.create_space("s", D).default_version()
        version.multiset(zip(keys, x))
        want = version.nearest_batch(x[:8] + 0.01, 5)
        hub.save()
        again = EmbeddingHub.load_or_create(base, engine=engine, mesh=Mesh(["cpu"] * 4),
                                            config=Config(**_CFG)).get_version("s")
        assert again.index.mesh.size == 4 and again.nearest_batch(x[:8] + 0.01, 5) == want
        if engine == "sharded":
            two = EmbeddingHub.load_or_create(base, engine=engine, mesh=Mesh(["cpu"] * 2))
            assert two.get_version("s").nearest_batch(x[:8] + 0.01, 5) == want
            one = EmbeddingHub.load_or_create(base, device="cpu")
            assert one.mesh.size == 1 and one.get_version("s").index.n_shards == 1
        else:
            with pytest.raises(ValueError, match="4 shards"):
                EmbeddingHub.load_or_create(base, engine=engine, mesh=Mesh(["cpu"] * 2))


def test_wal_replays_runs_into_a_sharded_graph(tmp_path, monkeypatch):
    """Replay hands a sharded graph each run of sets whole: a WAL-only
    reopen (one add: each shard's bulk build), then a snapshot plus a WAL
    tail; every acknowledged key comes back and finds itself."""
    import embeddinghub_tpu_torch.index.hnsw as thnsw

    x = _data(15, 4600)
    keys = [f"k{j}" for j in range(len(x))]

    def open_hub():
        return EmbeddingHub.load_or_create(tmp_path / "w", engine="hnsw-sharded",
                                           mesh=Mesh(["cpu"] * 2), config=Config(**_CFG))

    version = open_hub().create_space("s", D).default_version()
    for lo in range(0, 4096, 512):
        version.multiset(zip(keys[lo:lo + 512], x[lo:lo + 512]))
    version.delete("k3")
    adds = []
    plain = thnsw.HNSWIndex.add
    monkeypatch.setattr(thnsw.HNSWIndex, "add",
                        lambda self, rows, vecs: adds.append(len(rows)) or plain(self, rows, vecs))
    hub = open_hub()
    back = hub.get_version("s")
    assert adds == [2048, 2048]  # one run: each shard's rows at once
    assert "k3" not in back and back.size == 4095
    for key in ("k0", "k100", "k4095"):
        np.testing.assert_array_equal(back.get(key), x[int(key[1:])])
    hub.save()
    back.multiset(zip(keys[4096:], x[4096:]))  # the WAL tail after the snapshot
    last = open_hub().get_version("s")
    assert last.size == 4599 and "k3" not in last
    np.testing.assert_array_equal(last.get("k4599"), x[4599])
    hits = last.nearest_batch(x[4096:4160] + 1e-5, 1)
    assert np.mean([h[0] == keys[4096 + j] for j, h in enumerate(hits)]) >= 0.95


def test_server_serves_sharded_engine():
    """The port's server with ``EMBEDDINGHUB_ENGINE=sharded`` on the CPU
    answers the reference's client as its store does."""
    pytest.importorskip("grpc")
    from embeddinghub_tpu.sdk.client import EmbeddingHubClient as JaxClient
    from embeddinghub_tpu_torch.service.server import build_server

    x = _data(16, 2000)
    server, service, port = build_server("127.0.0.1:0", "cpu", config=Config(engine="sharded"))
    server.start()
    client = JaxClient(host="127.0.0.1", port=port)
    try:
        client.create_space("s", D)
        client.multiset("s", {f"k{j}": v.tolist() for j, v in enumerate(x)})
        version = service._store.get_version("s")
        assert type(version.index).__name__ == "ShardedFlatIndex"
        assert version.index.mesh.devices == (torch.device("cpu"),)
        q = x[:6] + 0.01
        got = client.nearest_neighbor_batch("s", 5, embeddings=q.tolist())
        assert [list(r) for r in got] == version.nearest_batch(q, 5)
        assert [r[0] for r in got] == [f"k{j}" for j in range(6)]
        assert list(client.nearest_neighbor("s", 4, key="k9")) == version.nearest(4, key="k9")
    finally:
        client.close()
        server.stop(0).wait()
        service.stop()


def test_dryrun_multichip_on_the_cpu():
    out = dryrun_multichip(8, device="cpu")
    assert out["shards"] == 8 and out["graph_self_found"] >= 0.9


# ------------------------------------------------------------ on the card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["float32", "int8x2"])
def test_card_two_shards_match_one_flat_index(storage):
    """Two shards of ``cuda:0`` against one ``FlatIndex`` on the card: f32
    lists equal to its exact search off near-ties (K1 on both sides);
    int8x2 recall@10 within 0.01 of the single arena's (K2's int8 pool on
    both sides, with the sharded routing's pools)."""
    from embeddinghub_tpu_torch.index.flat import FlatIndex

    _cuda()
    x, q = _data(20, 200_000, 96), _data(21, 256, 96)
    sharded = ShardedFlatIndex(96, "cosine", mesh=Mesh(["cuda:0"] * 2), storage_dtype=storage,
                               quant_guard=False)
    flat = FlatIndex(96, "cosine", storage_dtype=storage, quant_guard=False, device="cuda:0")
    for idx in (sharded, flat):
        idx.add(np.arange(len(x)), x)
    F.reset_launches()
    sd, si = sharded.search(q, K)
    launched = dict(F.LAUNCHES)
    fd, fi = flat.search(q, K, mode="exact")
    if storage == "float32":
        assert launched["fused_topk_search"] == 2
        assert_ids_equal_off_ties(si, fi, fd, 1e-5)
        np.testing.assert_allclose(sd, fd, rtol=1e-5, atol=1e-5)
    else:
        assert launched["fused_topk_search_v2_int8"] == 2
        true = _oracle(x, np.ones(len(x), bool), q, K, "cosine")
        assert _recall(si, true) >= _recall(fi, true) - 0.01
