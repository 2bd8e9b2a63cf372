"""The sharded engines on a mesh that spans processes
(``embeddinghub_tpu_torch/parallel/multihost.py``), on the CPU: two ranks
of two CPU shards each, joined by ``torch.distributed`` over gloo.

One module fixture runs every scenario of ``_torch_multihost_scenarios.py``
on the two ranks once (the launcher, a free port, a 120 s bound), after
the JAX package's graph scenario, whose snapshot the ranks also load.
Each rank writes its lists to ``rank<r>.npz``.  The tests hold them:

  * the two ranks' lists identical;
  * bit-equal to the port's in-process ``Mesh(["cpu"] * 4)`` on the same
    seeds, graph states and walks included;
  * against the JAX package's ``default_mesh(4)`` over the 8 virtual CPU
    devices of ``tests/conftest.py`` with ``tests/test_torch_sharded.py``'s
    tolerances: f32 ids equal off near-ties (1e-4) and distances within
    rtol 1e-4, atol 1e-4; quantized lists as that file holds them
    (``_assert_lists``); every graph shard's ``state_arrays()`` exactly
    equal; walks as ``_torch_parity.assert_walks_match``.

Then the launcher itself: the reference's dry run (its three PASS lines),
a rank that raises and ranks whose guards disagree, each of which must
end the launcher non-zero well inside its bound.
"""

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import embeddinghub_tpu.index.hnsw as jax_hnsw
from embeddinghub_tpu.parallel import ShardedFlatIndex as JaxSFlat
from embeddinghub_tpu.parallel import ShardedHNSWIndex as JaxSHNSW
from embeddinghub_tpu.parallel import default_mesh as jax_mesh
from embeddinghub_tpu_torch.parallel import Mesh, ShardedFlatIndex, ShardedHNSWIndex
from embeddinghub_tpu_torch.parallel.mesh import process_mesh
import _torch_multihost_scenarios as S
from _torch_parity import assert_walks_match, walk_terms
from test_torch_sharded import _assert_lists, _CopyingJnp

REPO = Path(__file__).resolve().parent.parent
TESTS = Path(__file__).resolve().parent
LAUNCH_TIMEOUT = 120  # the ranks' bound; the fixture's own is a little longer
CASES = S.FLAT_CASES + ["guard", "graph"]


def _launch(out, entry=None, timeout=LAUNCH_TIMEOUT, extra=()):
    """The launcher as a subprocess: two ranks of two CPU shards on gloo."""
    cmd = [sys.executable, "-m", "embeddinghub_tpu_torch.parallel.multihost",
           "--procs", "2", "--local-shards", "2", "--device", "cpu", "--backend", "gloo",
           "--timeout", str(timeout), *extra]
    if out is not None:
        cmd += ["--out", str(out)]
    if entry:
        cmd += ["--entry", f"_torch_multihost_scenarios:{entry}"]
    # two threads a rank: the ranks share the host with the other test workers
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), str(TESTS)]),
               OMP_NUM_THREADS="2")
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout + 30)
    return proc, time.monotonic() - t0


def _summary(stdout):
    lines = [ln for ln in stdout.splitlines() if ln.startswith("multihost ")]
    assert len(lines) == 1, stdout[-2000:]
    return json.loads(lines[0][len("multihost "):])


def _jax_graph():
    """The graph scenario on the JAX mesh (its index's ``jnp.asarray``
    copying, as ``tests/test_torch_sharded.py`` patches it)."""
    plain = jax_hnsw.jnp
    jax_hnsw.jnp = _CopyingJnp()
    try:
        return S.graph_scenario(lambda **kw: JaxSHNSW(mesh=jax_mesh(S.SHARDS), **kw))
    finally:
        jax_hnsw.jnp = plain


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("multihost")
    jax_graph = _jax_graph()
    np.savez(out / "jax_graph.npz", **S.stage_state(jax_graph, "removed"))
    proc, _ = _launch(out, "run")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lists = []
    for r in range(2):
        with np.load(out / f"rank{r}.npz") as f:
            lists.append({name: f[name] for name in f.files})
    return {"lists": lists, "summary": _summary(proc.stdout), "jax_graph": jax_graph}


def _case(lists, case):
    pre = f"{case}/"
    return {name[len(pre):]: arr for name, arr in lists.items() if name.startswith(pre)}


def _in_process(case):
    mesh = Mesh(["cpu"] * S.SHARDS)
    if case == "guard":
        return S.guard_scenario(lambda **kw: ShardedFlatIndex(mesh=mesh, **kw))
    if case == "graph":
        return S.graph_scenario(lambda **kw: ShardedHNSWIndex(mesh=mesh, **kw))
    return S.flat_scenario(lambda **kw: ShardedFlatIndex(mesh=mesh, **kw), case)[0]


# ------------------------------------------------------------------ lists


@pytest.mark.parametrize("case", CASES)
def test_ranks_hold_the_same_lists(ranks, case):
    a, b = (_case(lists, case) for lists in ranks["lists"])
    assert a and a.keys() == b.keys()
    for name, arr in a.items():
        np.testing.assert_array_equal(b[name], arr, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_lists_equal_the_in_process_mesh(ranks, case):
    """Bit-equal: the same shards' searches and the same merge, the lists
    gathered from two processes instead of copied within one."""
    got = _case(ranks["lists"][0], case)
    want = _in_process(case)
    assert set(want) <= set(got)
    for name, arr in want.items():
        np.testing.assert_array_equal(got[name], arr, err_msg=name)


@pytest.mark.parametrize("case", S.FLAT_CASES)
def test_flat_lists_match_jax(ranks, case):
    got = _case(ranks["lists"][0], case)
    want = S.flat_scenario(lambda **kw: JaxSFlat(mesh=jax_mesh(S.SHARDS), **kw), case)[0]
    metric, storage = case.split("-")
    x, q = S.data(1, 4500), S.flat_queries()
    valid = np.zeros(len(x), bool)
    for stage, live in zip(S.FLAT_STAGES, (3000, 3000, 4500, 4500)):
        valid[:live] = True
        if stage == "removed":
            valid[np.arange(5, 3000, 73)] = False
        if stage == "rewritten":
            x = x.copy()
            x[100:120] = x[200:220] * 1.5
        _assert_lists(storage, (got[f"{stage}.d"], got[f"{stage}.i"]),
                      (want[f"{stage}.d"], want[f"{stage}.i"]), x, valid, q, metric)
    np.testing.assert_array_equal(got["layout"], want["layout"])


@pytest.mark.parametrize("case", S.FLAT_CASES)
def test_restored_shard_files_give_the_same_ids(ranks, case):
    """Each rank wrote its own shards' files and read them back into an
    index rebuilt from the host arrays: the same ids as the live index."""
    for lists in ranks["lists"]:
        got = _case(lists, case)
        np.testing.assert_array_equal(got["restored.i"], got["rewritten.i"])


def test_guard_decides_alike_on_every_rank_and_as_jax(ranks):
    """The near-duplicate int8 arena escalates to int8x2 on both ranks, with
    the in-process index's sampled recalls, as the JAX index escalates."""
    want = S.guard_scenario(lambda **kw: JaxSFlat(mesh=jax_mesh(S.SHARDS), **kw))
    for lists in ranks["lists"]:
        got = _case(lists, "guard")
        assert str(got["storage"]) == str(want["storage"]) == "int8x2"
        assert (got["recalls"] >= 0).all()
    x = S.clustered()
    _assert_lists("int8x2", (got["d"], got["i"]), (want["d"], want["i"]), x,
                  np.ones(len(x), bool), x[:32] + 1e-5, "l2")


# ------------------------------------------------------------------ graph


@pytest.mark.parametrize("stage", S.GRAPH_STAGES)
def test_graph_states_equal_jax(ranks, stage):
    got = S.stage_state(_case(ranks["lists"][0], "graph"), stage)
    want = S.stage_state(ranks["jax_graph"], stage)
    assert got.keys() == want.keys() and int(got["nshards"][0]) == S.SHARDS
    for name, arr in want.items():
        np.testing.assert_array_equal(got[name], arr, err_msg=name)


def test_graph_walks_size_and_vectors_match_jax(ranks):
    got, want = _case(ranks["lists"][0], "graph"), ranks["jax_graph"]
    x, q = S.graph_data()
    for ef in S.GRAPH_EFS:
        assert_walks_match(want[f"walk{ef}.d"], want[f"walk{ef}.i"], got[f"walk{ef}.d"],
                           got[f"walk{ef}.i"], walk_terms(q, x, "l2"))
    np.testing.assert_array_equal(got["size"], want["size"])
    np.testing.assert_array_equal(got["vectors"], x[[0, 8491, 8190]])


def test_jax_snapshot_walks_on_the_process_mesh(ranks):
    """The JAX index's ``state_arrays()`` after the remove, loaded by each
    rank's ``from_state`` (its own shards' graphs, the others' rows): the
    JAX index's walks."""
    want = ranks["jax_graph"]
    x, q = S.graph_data()
    for lists in ranks["lists"]:
        got = _case(lists, "from_jax")
        for ef in S.GRAPH_EFS:
            assert_walks_match(want[f"walk{ef}.d"], want[f"walk{ef}.i"], got[f"walk{ef}.d"],
                               got[f"walk{ef}.i"], walk_terms(q, x, "l2"))


def test_process_mesh_snapshot_loads_into_jax(ranks):
    """The state a process mesh gathered loads with the JAX package's
    ``from_state`` on four devices and walks as the ranks walked."""
    got = _case(ranks["lists"][1], "graph")
    plain = jax_hnsw.jnp
    jax_hnsw.jnp = _CopyingJnp()
    try:
        back = JaxSHNSW.from_state(S.D, "l2", S.stage_state(got, "removed"),
                                   mesh=jax_mesh(S.SHARDS))
        walked = S.walks(back, S.graph_data()[1])
    finally:
        jax_hnsw.jnp = plain
    x, q = S.graph_data()
    for ef in S.GRAPH_EFS:
        assert_walks_match(walked[f"walk{ef}.d"], walked[f"walk{ef}.i"], got[f"walk{ef}.d"],
                           got[f"walk{ef}.i"], walk_terms(q, x, "l2"))


def test_four_shard_snapshot_onto_two_ranks_of_one_raises(ranks):
    for rank in ranks["summary"]["ranks"]:
        assert rank["legs"]["one_shard_a_rank"] == "snapshot has 4 shards, mesh has 2"


# ------------------------------------------------------------------ mesh


def test_process_mesh_layout(ranks):
    """Shard ``s`` belongs to rank ``s // 2``; a CUDA process mesh raises
    on a host without CUDA; the in-process mesh is rank 0 of 1."""
    for r, rank in enumerate(ranks["summary"]["ranks"]):
        assert rank["rank"] == r and rank["shards"] == [2 * r, 2 * r + 1]
        assert rank["legs"]["layout"] == {"rank": r, "world": 2, "size": 4,
                                          "shards": [2 * r, 2 * r + 1],
                                          "owns": [2 * r, 2 * r + 1]}
        if not torch.cuda.is_available():
            assert "CUDA is not available" in rank["legs"]["cuda"]
    mesh = Mesh(["cpu"] * 3)
    assert (mesh.rank, mesh.world, mesh.size, list(mesh.shards)) == (0, 1, 3, [0, 1, 2])
    assert mesh.owns(2) and not mesh.owns(3)
    d, i = torch.zeros((2, 3)), torch.zeros((2, 3), dtype=torch.int64)
    got = mesh.all_gather_lists(d, i)
    assert got[0] is d and got[1] is i and mesh.gather_objects(7) == [7]


def test_process_mesh_needs_an_initialized_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        process_mesh(2, "cpu")


# ------------------------------------------------------------------ launcher


def test_dryrun_prints_the_pass_lines(tmp_path):
    """The twin of ``tests/test_multihost.py``: the reference's three legs,
    two ranks of two shards."""
    proc, _ = _launch(None)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    for line in ("PASS multihost 2x2 float32", "PASS multihost 2x2 int8",
                 "PASS multihost snapshot/restore", "PASS multihost graph 2x2"):
        assert line in proc.stdout, proc.stdout[-2000:]
    summary = _summary(proc.stdout)
    assert [r["rank"] for r in summary["ranks"]] == [0, 1]
    assert summary["launches"].keys() == summary["ranks"][0]["launches"].keys()


def test_a_failing_rank_stops_the_launcher(tmp_path):
    """Rank 1 raises while rank 0 waits in a barrier it never leaves: the
    launcher kills rank 0 and exits non-zero long before the bound."""
    proc, took = _launch(tmp_path, "rank_one_raises", timeout=LAUNCH_TIMEOUT)
    assert proc.returncode != 0
    assert "a planted failure of rank 1" in proc.stderr
    # rank 0 may see its peer's socket close and exit first
    assert re.search(r"rank [01] exited", proc.stderr) and took < LAUNCH_TIMEOUT / 2, took


def test_ranks_whose_guards_disagree_fail_together(tmp_path):
    proc, took = _launch(tmp_path, "guards_disagree", timeout=LAUNCH_TIMEOUT)
    assert proc.returncode != 0 and took < LAUNCH_TIMEOUT / 2, took
    assert "the ranks' quantization guards disagree: ['int8x2', 'float32']" in proc.stderr


def test_launcher_bound_stops_hung_ranks(tmp_path):
    """Ranks that outlast ``--timeout`` are killed at the bound."""
    proc, took = _launch(tmp_path, "ranks_hang", timeout=10)
    assert proc.returncode != 0 and "ran past 10 s" in proc.stderr
    assert took < 35, took
