"""K2's candidate pools over an arena's live rows, on the CPU.

The pools take ``rows``, a bound that every live row lies below (the
arena's high-water mark): on the card the kernel scans and selects only the
tiles below it and leaves the segments past it empty.  These tests hold
that this changes no result: the plain pool over the arena trimmed to the
live tiles equals the plain pool over the whole arena, segment for
segment, and the whole arena's segments past the trimmed one's are empty.
Then the callers: ``FlatIndex`` and every shard of ``ShardedFlatIndex``
pass the rows they hold, and their searches keep the JAX package's recall
on the same inputs.

Tolerances: int8 pools exactly (integer sums); bf16 pools' scores within
1e-6 relative (the plain product's blocking follows the arena's width) and
their ids equal off such near-ties; searches as
``tests/test_torch_quantized.py``: recall no lower than the JAX index's
less 0.01.
"""

import numpy as np
import pytest
import torch

from embeddinghub_tpu.index import flat as jflat
from embeddinghub_tpu.parallel import ShardedFlatIndex as JaxSFlat
from embeddinghub_tpu.parallel import default_mesh as jax_mesh
from embeddinghub_tpu_torch.index import flat as tflat
from embeddinghub_tpu_torch.ops import distance as D
from embeddinghub_tpu_torch.ops import fused_topk as F
from embeddinghub_tpu_torch.parallel import Mesh, ShardedFlatIndex
from _torch_parity import assert_ids_equal_off_ties


def _arena(cap, dims, rows, dtype, metric, seed):
    """A plane of ``cap`` rows whose rows at and past ``rows`` are dead
    (never written: zeros), with a tenth of the rows below it dead too."""
    rng = np.random.default_rng(seed)
    x = np.zeros((cap, dims), np.float32)
    x[:rows] = rng.standard_normal((rows, dims)) * (1 + 3 * rng.random((rows, 1)))
    valid = np.zeros(cap, bool)
    valid[:rows] = rng.random(rows) > 0.1
    p = tflat.quantize_planes(torch.from_numpy(x), metric, dtype)
    plane = p["hi"] if dtype == "int8" else F.arena_bf16(p["hi"].float())
    q = D.preprocess_vectors(torch.from_numpy(
        rng.standard_normal((7, dims)).astype(np.float32)), metric)
    return q, plane, torch.from_numpy(valid), p["sq"], p["sc"]


CASES = [  # (capacity, segment rows or None, live rows)
    (3000, 512, 1337),    # mid-tile, mid-segment, three segments past it
    (4096, 1024, 2048),   # on a segment's end, two segments past it
    (2000, None, 1999),   # one segment, mid-tile
    (2048, 512, 640),     # on a tile's end
    (2048, 512, 0),       # nothing live: every segment empty
]


@pytest.mark.parametrize("cap,seg,rows", CASES)
@pytest.mark.parametrize("metric", ["l2", "cosine", "ip"])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_plain_pool_over_live_rows_equals_whole_arena(dtype, metric, cap, seg, rows):
    q, plane, valid, sq, sc = _arena(cap, 24, rows, dtype, metric, cap + rows)
    kw = dict(k=9, metric=metric, seg=seg)
    ws, wi = F.pool_candidates_reference(q, plane, valid, sq,
                                         sc if dtype == "int8" else None, **kw)
    assert ws.shape == wi.shape == (7, -(-cap // (seg or cap)), 9)
    t = -(-rows // 128) * 128  # the live tiles' rows
    n = 0  # the trimmed arena's segments
    if t:
        s, i = F.pool_candidates_reference(q, plane[:t], valid[:t], sq[:t],
                                           sc[:t] if dtype == "int8" else None, **kw)
        n = s.shape[1]
        assert n == -(-t // (seg or t))
        if dtype == "int8":
            assert torch.equal(s, ws[:, :n]) and torch.equal(i, wi[:, :n])
        else:
            assert torch.equal(torch.isfinite(s), torch.isfinite(ws[:, :n]))
            np.testing.assert_allclose(s.numpy(), ws[:, :n].numpy(), rtol=1e-6, atol=1e-6)
            for g in range(n):
                assert_ids_equal_off_ties(i[:, g].numpy(), wi[:, g].numpy(),
                                          ws[:, g].numpy(), 1e-6)
    # the segments past the live tiles hold no candidate
    assert (wi[:, n:] == -1).all() and torch.isinf(ws[:, n:]).all()
    assert (wi < max(rows, 1)).all()


def _rows_seen(monkeypatch):
    """The ``rows`` each pool call gets."""
    seen = []
    pool = F.pool_candidates
    monkeypatch.setattr(F, "pool_candidates",
                        lambda *a, **kw: seen.append(kw["rows"]) or pool(*a, **kw))
    return seen


def _data(seed, n, d):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _recall(ids, true):
    ids = np.asarray(ids)
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / true.shape[1]
                          for a, b in zip(ids, true)]))


def _oracle(x, valid, q, k, metric):
    if metric == "cosine":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
        s = q @ x.T
    else:
        s = 2.0 * (q @ x.T) - (x * x).sum(1)
    return np.argsort(-np.where(valid[None, :], s, -np.inf), axis=1)[:, :k]


@pytest.mark.parametrize("deep", [False, True])
@pytest.mark.parametrize("dtype", ["int8", "int8x2"])
def test_flat_index_passes_its_high_water_mark(monkeypatch, dtype, deep):
    """A quantized ``FlatIndex`` of 16,384 rows' capacity holding 10,001:
    its pool gets 10,001, which removes do not lower, a later write past it
    raises, and a restore recomputes from the live rows; its searches keep
    the JAX index's recall."""
    if deep:  # the chunked pool past a threshold shrunk in both packages
        for mod in (tflat, jflat):
            monkeypatch.setattr(mod, "_DEEP_CAP_THRESHOLD", 1024)
            monkeypatch.setattr(mod, "_DEEP_CAP_BLOCK", 8192)
        monkeypatch.setattr(jflat, "_STAGE_BLOCK_ROWS", 1024)
    x, q = _data(1, 10001, 32), _data(2, 64, 32)
    kw = dict(capacity=16384, storage_dtype=dtype, quant_guard=False)
    port = tflat.FlatIndex(32, "cosine", device="cpu", **kw)
    ref = jflat.FlatIndex(32, "cosine", **kw)
    for idx in (port, ref):
        idx.add(np.arange(10001), x)
        idx.remove(np.arange(9000, 10001, 3))
    seen = _rows_seen(monkeypatch)
    td, ti = port.search(q, 4)
    assert seen and set(seen) == {10001}
    valid = np.ones(10001, bool)
    valid[9000::3] = False
    true = _oracle(x, valid, q, 4, "cosine")
    assert _recall(ti, true) >= _recall(ref.search(q, 4)[1], true) - 0.01
    port.add([12000], x[:1] * 2.0)
    assert port._high_water == 12001
    seen.clear()
    assert port.search(x[:1], 1)[1][0, 0] in (0, 12000) and set(seen) == {12001}
    back = tflat.FlatIndex.from_state(32, "cosine", port.state_arrays(), device="cpu")
    assert back._high_water == 12001


@pytest.mark.parametrize("s", [2, 4])
def test_sharded_shards_pass_their_high_water_marks(monkeypatch, s):
    """Host row r is local row r // S of shard r % S: with 20,001 rows
    written, shard i's pool gets ceil((20,001 - i) / S) local rows (of
    its 16,384 or 8,192); the search keeps the JAX shards' recall."""
    x, q = _data(3, 20001, 16), _data(4, 32, 16)
    kw = dict(dims=16, metric="l2", storage_dtype="int8", quant_guard=False, capacity=32768)
    jidx = JaxSFlat(mesh=jax_mesh(s), **kw)
    tidx = ShardedFlatIndex(mesh=Mesh(["cpu"] * s), **kw)
    for idx in (jidx, tidx):
        idx.add(np.arange(len(x)), x)
    seen = _rows_seen(monkeypatch)
    _, ti = tidx.search(q, 4)
    assert seen == [-(-(20001 - i) // s) for i in range(s)]
    true = _oracle(x, np.ones(len(x), bool), q, 4, "l2")
    assert _recall(ti, true) >= _recall(jidx.search(q, 4)[1], true) - 0.01
    back = ShardedFlatIndex.from_state(16, "l2", tidx.state_arrays(),
                                       mesh=Mesh(["cpu"] * s))
    assert back._high_water == 20001
