"""Store and server of the port against the JAX package's, on the CPU.

The store tests hold ``Version`` and its neighbours to the reference's
semantics.  The slice test drives the port's gRPC server (device "cpu",
in process) with the reference's own SDK client and requires the same
answers as the JAX server gives on the same data.  Nearest-neighbour keys
must be equal: the data is random, so exact f32 scans leave no ties.
"""

import socket

import grpc
import numpy as np
import pytest
import torch

from embeddinghub_tpu.sdk.client import EmbeddingHubClient
from embeddinghub_tpu.service import server as jax_server
from embeddinghub_tpu.store import errors as jax_errors
from embeddinghub_tpu.store.keymap import KeyMap as JaxKeyMap
from embeddinghub_tpu.store.version import Version as JaxVersion
from embeddinghub_tpu_torch.service import server as port_server
from embeddinghub_tpu_torch.store import errors
from embeddinghub_tpu_torch.store.hub import EmbeddingHub
from embeddinghub_tpu_torch.store.keymap import KeyMap
from embeddinghub_tpu_torch.store.space import Space
from embeddinghub_tpu_torch.store.version import Version

D = 16


def _vecs(seed, n):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)


def _pair(metric="l2"):
    return Version("s", "initial", D, metric, device="cpu"), JaxVersion("s", "initial", D, metric)


def test_error_classes_match():
    for name in ("EmbeddingHubError", "SpaceNotFoundError", "VersionNotFoundError",
                 "SpaceAlreadyExistsError", "KeyNotFoundError", "ImmutableVersionError",
                 "DimensionMismatchError", "InvalidArgumentError"):
        assert getattr(errors, name).grpc_code == getattr(jax_errors, name).grpc_code


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_version_semantics_match(metric):
    port, ref = _pair(metric)
    pairs = [(f"k{i}", v) for i, v in enumerate(_vecs(0, 200))]
    pairs.append(("k3", _vecs(1, 1)[0]))  # keep-last dedup inside one batch
    for v in (port, ref):
        v.multiset(pairs)
        v.delete("k10")
        v.set("late", _vecs(2, 1)[0])
    assert port.size == ref.size == 200
    np.testing.assert_array_equal(port.get("k3"), ref.get("k3"))
    assert dict((k, v.tolist()) for k, v in port.iterator()) == \
        dict((k, v.tolist()) for k, v in ref.iterator())
    queries = _vecs(3, 9)
    assert port.nearest_batch(queries, 6) == ref.nearest_batch(queries, 6)
    got = port.nearest(5, key="k7")
    assert got == ref.nearest(5, key="k7") and "k7" not in got and len(got) == 5
    assert port.nearest(4, vector=queries[0]) == ref.nearest(4, vector=queries[0])
    assert "k10" not in port and port.nearest(3, vector=port.get("k11")) == \
        ref.nearest(3, vector=ref.get("k11"))


def test_version_errors_match():
    port, ref = _pair()
    for v, errs in ((port, errors), (ref, jax_errors)):
        v.set("a", np.zeros(D))
        with pytest.raises(errs.DimensionMismatchError):
            v.set("b", np.zeros(D + 1))
        with pytest.raises(errs.DimensionMismatchError):
            v.nearest_batch(np.zeros((2, D - 1), np.float32), 1)
        with pytest.raises(errs.InvalidArgumentError):
            v.nearest(1, key="a", vector=np.zeros(D))
        with pytest.raises(errs.InvalidArgumentError):
            v.nearest(1)
        with pytest.raises(errs.KeyNotFoundError):
            v.get("missing")
        v.make_immutable()
        with pytest.raises(errs.ImmutableVersionError):
            v.set("a", np.ones(D))
        with pytest.raises(errs.ImmutableVersionError):
            v.delete("a")
    assert port.nearest(1, vector=np.zeros(D)) == ["a"]


def test_keymap_from_jax_state():
    ref = JaxKeyMap()
    ref.assign_many([f"k{i}" for i in range(10)])
    ref.release("k4")
    ref.assign("new")
    ref.release("k7")
    port = KeyMap.from_state(ref.to_state())
    assert port.to_state() == ref.to_state()
    assert port.assign("x") == ref.assign("x")
    assert port.keys_for_rows(np.arange(12)) == ref.keys_for_rows(np.arange(12))


def test_hub_semantics():
    hub = EmbeddingHub.in_memory(device="cpu")
    s = hub.create_space("a", D, "cosine")
    assert hub.create_space("a", D * 2) is s  # idempotent
    assert hub.get_version("a").dims == D and hub.get_version("a").metric == "cosine"
    assert hub.get_version("a").index.device.type == "cpu"
    hub.create_space("b", 3)
    assert sorted(hub.spaces()) == ["a", "b"]
    hub.delete_space("a")
    assert hub.get_space("a") is None and hub.get_version("a") is None
    # the engines over a mesh of shards: on a CPU hub its one device
    for engine, kind, storage in (("sharded", "ShardedFlatIndex", "float32"),
                                  ("sharded-int8", "ShardedFlatIndex", "int8"),
                                  ("sharded-int8x2", "ShardedFlatIndex", "int8x2"),
                                  ("hnsw-sharded", "ShardedHNSWIndex", None)):
        sharded = EmbeddingHub.in_memory(engine=engine, device="cpu")
        index = sharded.create_space("s", D).default_version().index
        assert type(index).__name__ == kind and index.mesh.size == 1
        assert index.mesh.devices[0].type == "cpu" and sharded.mesh is index.mesh
        assert getattr(index, "storage_dtype", None) == storage
        if not torch.cuda.is_available():  # "cuda" by default: no card, no store
            with pytest.raises(RuntimeError, match="CUDA"):
                EmbeddingHub.in_memory(engine=engine)
    quant = EmbeddingHub.in_memory(engine="flat-int8", device="cpu").create_space("q", D)
    index = quant.default_version().index
    assert type(index).__name__ == "FlatIndex" and index.storage_dtype == "int8"
    assert index.quant_guard and index.device.type == "cpu"
    graph = EmbeddingHub.in_memory(engine="hnsw", device="cpu").create_space("g", D)
    assert type(graph.default_version().index).__name__ == "HNSWIndex"
    with pytest.raises(ValueError):
        EmbeddingHub.in_memory(engine="nope")
    assert Space("p", device="cpu").path is None and hub.base_path is None


# ----------------------------------------------------------------- the slice


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def clients():
    """(port client, port service, JAX client): both servers in process."""
    p_server, p_service, p_port = port_server.build_server("127.0.0.1:0", "cpu")
    jport = _free_port()
    j_server, j_service = jax_server.build_server(f"127.0.0.1:{jport}", data_dir=None)
    p_server.start()
    j_server.start()
    pc = EmbeddingHubClient(host="127.0.0.1", port=p_port)
    jc = EmbeddingHubClient(host="127.0.0.1", port=jport)
    try:
        yield pc, p_service, jc
    finally:
        pc.close()
        jc.close()
        p_server.stop(0)
        j_server.stop(0)
        p_service.stop()
        j_service.stop()


def test_reference_client_against_port_server(clients):
    pc, p_service, jc = clients
    base = _vecs(7, 300)
    queries = _vecs(8, 4)
    answers = []
    for c in (pc, jc):
        c.create_space("s", D)
        c.set("s", "one", base[0].tolist())
        c.multiset("s", {f"k{i}": base[i].tolist() for i in range(1, 300)})
        got = [
            list(c.get("s", "one")),
            list(c.get("s", "k5")),
            sorted((k, list(v)) for k, v in c.download("s")),
            [list(c.nearest_neighbor("s", 5, embedding=q.tolist())) for q in queries],
            list(c.nearest_neighbor("s", 4, key="k9")),
            c.nearest_neighbor_batch("s", 3, embeddings=queries.tolist()),
            c.nearest_neighbor_batch("s", 3, keys=["k1", "k2"]),
            list(c.multiget("s", ["k3", "one"])),
        ]
        answers.append(got)
        with pytest.raises(grpc.RpcError) as e:
            c.nearest_neighbor("s", 1, key="k1", embedding=base[1].tolist())
        assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        with pytest.raises(grpc.RpcError) as e:
            c.get("nope", "k1")
        assert e.value.code() == grpc.StatusCode.NOT_FOUND
        c.freeze_space("s")
        with pytest.raises(TypeError):
            c.set("s", "after", base[0].tolist())
    assert answers[0] == answers[1]
    assert "k9" not in answers[0][4] and len(answers[0][4]) == 4
    assert [list(map(float, v)) for v in answers[0][7]] == [base[3].tolist(), base[0].tolist()]
    # the answers came from the port's store on its torch device
    version = p_service._store.get_version("s")
    assert version.size == 300 and version.index.device.type == "cpu"


def test_server_main_refuses_missing_cuda(monkeypatch):
    """``--device cuda`` without a card is an error, never a CPU fallback."""
    monkeypatch.setattr(port_server.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_server.main(["127.0.0.1:0", "--device", "cuda"])


@pytest.mark.parametrize("args, want", [
    (["127.0.0.1:0", "--device", "cpu"], None),
    (["127.0.0.1:0", "pos_dir", "--device", "cpu"], "pos_dir"),
    (["127.0.0.1:0", "pos_dir", "--data-dir", "flag_dir", "--device", "cpu"], "flag_dir"),
])
def test_server_main_data_dir(monkeypatch, args, want):
    """The data directory comes from --data-dir, else the positional
    argument, else the config's default, as in the reference's main."""
    seen = []
    monkeypatch.setattr(port_server, "run_server", lambda *a: seen.append(a))
    port_server.main(args)
    assert seen == [("127.0.0.1:0", port_server.torch.device("cpu"),
                     want or port_server.get_config().data_dir)]
