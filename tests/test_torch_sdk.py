"""The port's SDK against the JAX package's, on the CPU.

  * the jax-free ``EmbeddingHubClient`` gives the reference client's
    answers against both servers, ``wait=False`` futures included;
  * ``NearestNeighbor`` with ``num`` past K1's limit returns the JAX
    server's keys (ids equal off near-ties of 1e-4 in f32 squared-L2
    distances around 30), and no fetch up to the arena's capacity raises;
  * the offline ``Index`` answers as the JAX ``Index``;
  * the REPL runs a stdin script against the port's server.
"""

import os
import socket
import subprocess
import sys

import grpc
import numpy as np
import pytest

from embeddinghub_tpu.sdk.client import EmbeddingHubClient as JaxClient
from embeddinghub_tpu.sdk.offline import Index as JaxIndex
from embeddinghub_tpu.service import server as jax_server
from embeddinghub_tpu_torch.sdk import EmbeddingHubClient, Index
from embeddinghub_tpu_torch.service import server as port_server
from _torch_parity import assert_ids_equal_off_ties

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 16


def _vecs(seed, n, d=D):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def ports():
    """(port server's port, JAX server's port), both in process, in memory."""
    p_server, p_service, p_port = port_server.build_server("127.0.0.1:0", "cpu")
    jport = _free_port()
    j_server, j_service = jax_server.build_server(f"127.0.0.1:{jport}", data_dir=None)
    p_server.start()
    j_server.start()
    try:
        yield p_port, jport
    finally:
        p_server.stop(0)
        j_server.stop(0)
        p_service.stop()
        j_service.stop()


def _flow(c, s):
    """The reference client's flows of tests/test_torch_store_server.py,
    plus the future forms, in space ``s``."""
    base = _vecs(7, 300)
    queries = _vecs(8, 4)
    c.create_space(s, D)
    c.set(s, "one", base[0].tolist())
    c.multiset(s, {f"k{i}": base[i].tolist() for i in range(1, 300)})
    c.set(s, "two", base[1].tolist(), wait=False).result(timeout=30)
    done = []
    fut = c.get(s, "two", wait=False)
    fut.add_done_callback(lambda f: done.append(list(f.result())))
    got = [
        list(c.get(s, "one")),
        list(fut.result(timeout=30)),
        list(c.get(s, "k5")),
        sorted((k, list(v)) for k, v in c.download(s)),
        [list(c.nearest_neighbor(s, 5, embedding=q.tolist())) for q in queries],
        list(c.nearest_neighbor(s, 4, key="k9")),
        list(c.nearest_neighbor(s, 3, key="k2", wait=False).result(timeout=30)),
        c.nearest_neighbor_batch(s, 3, embeddings=queries.tolist()),
        c.nearest_neighbor_batch(s, 3, keys=["k1", "k2"]),
        list(c.multiget(s, ["k3", "one"])),
    ]
    with pytest.raises(grpc.RpcError) as e:
        c.nearest_neighbor(s, 1, key="k1", embedding=base[1].tolist())
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    with pytest.raises(grpc.RpcError) as e:
        c.get("nope", "k1")
    assert e.value.code() == grpc.StatusCode.NOT_FOUND
    c.freeze_space(s)
    with pytest.raises(TypeError):
        c.set(s, "after", base[0].tolist())
    with pytest.raises(TypeError):
        c.multiset(s, {"after": base[0].tolist()})
    c.create_space(s + "-gone", D)
    c.delete_space(s + "-gone")
    with pytest.raises(grpc.RpcError) as e:
        c.get(s + "-gone", "x")
    assert e.value.code() == grpc.StatusCode.NOT_FOUND
    assert done == [got[1]]
    return got


def test_port_client_matches_reference_client(ports):
    p_port, jport = ports
    answers = []
    for space, (cls, port) in enumerate(((EmbeddingHubClient, p_port),
                                         (EmbeddingHubClient, jport), (JaxClient, jport))):
        c = cls(host="127.0.0.1", port=port)
        try:
            answers.append(_flow(c, f"s{space}"))
        finally:
            c.close()
    assert answers[0] == answers[1] == answers[2]
    assert "k9" not in answers[0][5] and len(answers[0][5]) == 4


def test_nearest_neighbor_past_k1_limit(ports):
    """num=1500 (and num+1 for a keyed query) rounds up to a 2048-wide
    fetch, which the port serves with the chunked scan."""
    p_port, jport = ports
    base = _vecs(9, 4096)
    q = _vecs(10, 1)[0]
    results = []
    for port in (p_port, jport):
        c = EmbeddingHubClient(host="127.0.0.1", port=port)
        try:
            c.create_space("big", D)
            c.multiset("big", {f"k{i}": base[i].tolist() for i in range(4096)})
            results.append((list(c.nearest_neighbor("big", 1500, embedding=q.tolist())),
                            list(c.nearest_neighbor("big", 1500, key="k17"))))
            if port == p_port:
                for num in (1, 1023, 1024, 2000, 4095, 4096):
                    assert len(c.nearest_neighbor("big", num, embedding=q.tolist())) == num
                    assert len(c.nearest_neighbor("big", num, key="k3")) == min(num, 4095)
        finally:
            c.close()
    (p_emb, p_key), (j_emb, j_key) = results
    for got, want, query in ((p_emb, j_emb, q), (p_key, j_key, base[17])):
        assert len(got) == len(want) == 1500 and "k17" not in p_key
        got_i = np.asarray([int(k[1:]) for k in got])[None, :]
        want_i = np.asarray([int(k[1:]) for k in want])[None, :]
        want_d = ((base[want_i[0]].astype(np.float64) - query) ** 2).sum(1)[None, :]
        assert_ids_equal_off_ties(got_i, want_i, want_d, 1e-4)


def _offline_ops(idx, vecs):
    out = [idx.size()]
    idx.set("extra", vecs[0] * 2)
    idx.set("k1", vecs[2])  # overwrite does not grow
    out += [idx.size(), idx.get("k1").tolist(),
            [v.tolist() for v in idx.multiget(["k2", "extra"])],
            idx.nearest_neighbor(5, key="k4"),
            idx.nearest_neighbor(3, embedding=vecs[9]),
            idx.nearest_neighbor_batch(4, vecs[:6])]
    with pytest.raises(KeyError):
        idx.get("missing")
    return out


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_offline_index_matches_jax(metric):
    vecs = _vecs(11, 3000)  # grows past the initial capacity of 1024
    pairs = [(f"k{i}", v) for i, v in enumerate(vecs)]
    port = Index(pairs, D, metric=metric, device="cpu")
    ref = JaxIndex(pairs, D, metric=metric)
    assert port._idx.device.type == "cpu"
    assert _offline_ops(port, vecs) == _offline_ops(ref, vecs)
    assert (Index({"a": [1, 2, 3]}, 3, device="cpu").size()
            == Index([], 3, device="cpu").size() + 1)


def test_repl_runs_a_stdin_script():
    server, service, port = port_server.build_server("127.0.0.1:0", "cpu")
    server.start()
    script = "\n".join([
        "create r 3", "set r a 1 0 0", "set r b 0 1 0", "set r c 0 0 5",
        "get r a", "nn r a 1", "bogus", "get r missing", "quit", "set r late 1 1 1",
    ]) + "\n"
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "embeddinghub_tpu_torch.sdk.repl", "127.0.0.1", str(port)],
            input=script, capture_output=True, text=True, timeout=120, cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", "")),
        )
        version = service._store.get_version("r")
        assert "late" not in version and version.size == 3
    finally:
        server.stop(0)
        service.stop()
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert out.count("ok") == 4
    assert "[1.0, 0.0, 0.0]" in out and "['b']" in out
    assert "unknown command: bogus" in out and "error:" in out
