"""The provider contract of ``tests/test_provider_contract.py`` over the
port's providers (``embeddinghub_tpu_torch.featurestore.providers``):
MEMORY_ONLINE, SQLITE_ONLINE, EMBEDDINGHUB_TPU (the engine vector store on
the CPU, and on the card where there is one), SQLITE_OFFLINE and
PANDAS_OFFLINE; then the engine vector store's path and device handling.
REDIS_ONLINE's contract runs against the JAX package's RESP fake, which the
port has no copy of yet.
"""

import numpy as np
import pytest
import torch

import embeddinghub_tpu_torch.featurestore as ff_port
from embeddinghub_tpu_torch.featurestore import fferr
from embeddinghub_tpu_torch.featurestore.providers import get_provider
from embeddinghub_tpu_torch.featurestore.providers.engine_vector import (
    EngineVectorStore,
)


@pytest.fixture(params=["MEMORY_ONLINE", "SQLITE_ONLINE"])
def online_store(request):
    return get_provider(request.param, {}).as_online_store()


_VECTOR = [
    pytest.param("cpu", id="EMBEDDINGHUB_TPU-cpu"),
    pytest.param("cuda", id="EMBEDDINGHUB_TPU-cuda", marks=pytest.mark.cuda),
]


@pytest.fixture(params=_VECTOR)
def vector_store(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the engine's CUDA kernels have no CPU mode")
    return get_provider("EMBEDDINGHUB_TPU", {"metric": "cosine",
                                             "device": request.param})


_N = [0]


def _fresh(prefix):
    _N[0] += 1
    return f"{prefix}{_N[0]}", "v1"


class TestPortOnlineContract:
    def test_set_get_roundtrip(self, online_store):
        f, v = _fresh("feat")
        t = online_store.create_table(f, v, value_type="string")
        t.set("e1", "hello")
        assert t.get("e1") == "hello"

    def test_overwrite_latest_wins(self, online_store):
        f, v = _fresh("feat")
        t = online_store.create_table(f, v, value_type="int")
        t.set("e", 1)
        t.set("e", 2)
        assert int(t.get("e")) == 2

    def test_missing_entity_raises(self, online_store):
        f, v = _fresh("feat")
        t = online_store.create_table(f, v, value_type="string")
        with pytest.raises(fferr.FFError):
            t.get("nope")

    def test_batch_set(self, online_store):
        f, v = _fresh("feat")
        t = online_store.create_table(f, v, value_type="int")
        t.batch_set([(f"e{i}", i) for i in range(20)])
        assert int(t.get("e7")) == 7

    def test_get_table_after_create(self, online_store):
        f, v = _fresh("feat")
        online_store.create_table(f, v, value_type="string").set("a", "x")
        assert online_store.get_table(f, v).get("a") == "x"

    def test_missing_table_raises(self, online_store):
        with pytest.raises(fferr.FFError):
            online_store.get_table("never_created", "v0")

    def test_typed_values(self, online_store):
        f, v = _fresh("feat")
        t = online_store.create_table(f, v, value_type="float32")
        t.set("e", 2.5)
        assert float(t.get("e")) == 2.5

    def test_health(self, online_store):
        assert online_store.check_health() in (True, False)


class TestPortVectorContract:
    def test_index_set_nearest(self, vector_store):
        f, v = _fresh("emb")
        tbl = vector_store.create_index(f, v, dims=8)
        rng = np.random.default_rng(3)
        base_vecs = {}
        for i in range(32):
            vec = rng.standard_normal(8).astype(np.float32)
            base_vecs[f"e{i}"] = vec
            tbl.set(f"e{i}", [float(x) for x in vec])
        got = tbl.nearest(f, v, [float(x) for x in base_vecs["e5"] + 1e-4], 3)
        assert got[0] == "e5"
        assert len(got) == 3

    def test_vector_get_roundtrip(self, vector_store):
        f, v = _fresh("emb")
        tbl = vector_store.create_index(f, v, dims=4)
        tbl.set("a", [1.0, 2.0, 3.0, 4.0])
        got = np.asarray(tbl.get("a"), dtype=np.float32)
        want = np.asarray([1, 2, 3, 4.0])
        assert np.allclose(got / np.linalg.norm(got), want / np.linalg.norm(want),
                           atol=1e-5)

    def test_missing_entity_raises(self, vector_store):
        f, v = _fresh("emb")
        tbl = vector_store.create_index(f, v, dims=4)
        with pytest.raises(fferr.FFError):
            tbl.get("absent")

    def test_nearest_scoped_to_index(self, vector_store):
        f1, v1 = _fresh("emb")
        f2, v2 = _fresh("emb")
        t1 = vector_store.create_index(f1, v1, dims=4)
        t2 = vector_store.create_index(f2, v2, dims=4)
        t1.set("in_first", [1.0, 0.0, 0.0, 0.0])
        t2.set("in_second", [1.0, 0.0, 0.0, 0.0])
        assert "in_second" not in t1.nearest(f1, v1, [1.0, 0.0, 0.0, 0.0], 5)

    def test_entities_and_table_reopen(self, vector_store):
        f, v = _fresh("emb")
        vector_store.create_index(f, v, dims=4).batch_set(
            [(f"e{i}", [float(i), 1.0, 0.0, 0.0]) for i in range(6)])
        assert sorted(vector_store.get_table(f, v).entities()) == [
            f"e{i}" for i in range(6)]
        vector_store.delete_table(f, v)
        with pytest.raises(fferr.FFError):
            vector_store.get_table(f, v)


@pytest.fixture(params=["SQLITE_OFFLINE", "PANDAS_OFFLINE"])
def offline_store(request, tmp_path):
    if request.param == "PANDAS_OFFLINE":
        p = get_provider(request.param, {"path": str(tmp_path / "pands")},
                         cache_key=str(tmp_path))
    else:
        p = get_provider(request.param, {"path": str(tmp_path / "off.db")})
    return p.as_offline_store()


class TestPortOfflineContract:
    def test_primary_write_read(self, offline_store):
        rows = [{"user": f"u{i}", "clicks": i, "ts": i} for i in range(10)]
        offline_store.register_primary("src", "v1", {"rows": rows})
        back = offline_store.table_rows("src", "v1")
        assert {r["user"] for r in back} == {f"u{i}" for i in range(10)}

    def test_materialize_latest_per_entity(self, offline_store):
        offline_store.register_primary("src2", "v1", {"rows": [
            {"user": "u1", "clicks": 1, "ts": 1},
            {"user": "u1", "clicks": 9, "ts": 5},
            {"user": "u2", "clicks": 3, "ts": 2},
        ]})
        mat = offline_store.materialize("src2", "v1", "user", "clicks", "ts")
        assert dict(mat.rows()) == {"u1": 9, "u2": 3}
        assert set(dict(mat.iterate_chunk(0))) <= {"u1", "u2"}

    def test_sql_transformation(self, offline_store):
        offline_store.register_primary("ev", "v1", {"rows": [
            {"user": "a", "n": 2}, {"user": "a", "n": 3}, {"user": "b", "n": 5}]})
        offline_store.create_transformation(
            "agg", "v1",
            {"sql": "SELECT user, SUM(n) AS total FROM {{ ev.v1 }} GROUP BY user"},
            inputs=[("ev", "v1")])
        rows = {r["user"]: r["total"] for r in offline_store.table_rows("agg", "v1")}
        assert rows == {"a": 5, "b": 5}


# ------------------------------------------------ the engine vector store

def test_engine_store_path_save_and_reopen(tmp_path):
    """A path-backed store: ``save()``, a new store on the same path, the
    same rows and the same ``nearest`` keys."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    cfg = {"path": str(tmp_path / "hub"), "metric": "cosine", "device": "cpu"}
    s1 = EngineVectorStore(cfg)
    t1 = s1.create_index("emb", "v", dims=16)
    t1.batch_set([(f"k{i}", x[i]) for i in range(300)])
    queries = x[:8] + 0.01 * rng.standard_normal((8, 16)).astype(np.float32)
    before = [t1.nearest("emb", "v", q, 5) for q in queries]
    s1.save()
    t2 = EngineVectorStore(cfg).get_table("emb", "v")
    assert [t2.nearest("emb", "v", q, 5) for q in queries] == before
    assert sorted(t2.entities()) == sorted(f"k{i}" for i in range(300))
    np.testing.assert_allclose(t2.get("k7"), x[7], rtol=1e-6)


def test_engine_store_device():
    """The device comes from the config and defaults to ``"cuda"``: on a
    host without CUDA that raises, never moves to the CPU; the registrar
    passes its ``device`` through."""
    reg = ff_port.Registrar()
    prov = reg.register_engine_vector_store("v", device="cpu")
    assert prov.config["device"] == "cpu"
    assert ff_port.Registrar().register_engine_vector_store("w").config[
        "device"] == "cuda"
    store = EngineVectorStore({"device": "cpu"})
    assert store._hub.device.type == "cpu"
    if torch.cuda.is_available():
        assert EngineVectorStore({})._hub.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            EngineVectorStore({})
