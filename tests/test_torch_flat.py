"""FlatIndex of the port against the JAX package's FlatIndex, on the CPU.

Tolerances: distances 1e-5 (f32 exact scans on both sides, different
summation order); ids equal except at near-ties of that size.
"""

import numpy as np
import pytest
import torch

from embeddinghub_tpu.index.flat import FlatIndex as JaxFlat
from embeddinghub_tpu_torch.index.flat import FlatIndex
from _torch_parity import assert_ids_equal_off_ties

D = 24


def _vecs(seed, n):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)


def _assert_same(port, ref, queries, k, **kw):
    pd, pi = port.search(queries, k, **kw)
    jd, ji = ref.search(queries, k, **kw)
    assert pi.dtype == np.int64 and pd.shape == jd.shape
    np.testing.assert_allclose(pd, jd, rtol=1e-5, atol=1e-5)
    assert_ids_equal_off_ties(pi, ji, jd, 1e-5)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_exact_search_through_adds_overwrites_removes(metric):
    port, ref = FlatIndex(D, metric), JaxFlat(D, metric)
    queries = _vecs(1, 13)
    base = _vecs(0, 700)  # grows capacity 128 -> 1024
    for idx in (port, ref):
        idx.add(np.arange(700), base)
    assert port.capacity == ref.capacity and port.size == ref.size == 700
    _assert_same(port, ref, queries, 10, mode="exact")
    # small dirty sets take the scatter path: overwrites, removes, new rows
    for idx in (port, ref):
        idx.add(np.arange(0, 60, 3), _vecs(2, 20))
        idx.remove(np.arange(100, 140))
        idx.add(np.asarray([701, 750]), _vecs(3, 2))
    assert port.size == ref.size
    _assert_same(port, ref, queries, 10, mode="exact")
    _assert_same(port, ref, np.concatenate([queries, base[:5]]), 1)
    # churn past 25 % of capacity forces a full re-upload
    for idx in (port, ref):
        idx.remove(np.arange(200, 600))
    _assert_same(port, ref, queries, 16, mode="exact")


@pytest.mark.parametrize("metric", ["ip", "l2", "cosine"])
@pytest.mark.parametrize("qd", ["bfloat16", "int8", "float32"])
def test_query_dtype_numerics_match(metric, qd):
    """The port rounds queries on the host to what the reference's narrow
    upload delivers.  For ip the answers match at 1e-5.  For l2 and cosine
    the reference also squares or normalizes the bf16 query in bf16, so
    there distances match to bf16 resolution (rtol 1e-2) and ids exactly
    off near-ties: a per-query scale or offset does not change the order."""
    port, ref = FlatIndex(D, metric), JaxFlat(D, metric)
    for idx in (port, ref):
        idx.add(np.arange(300), _vecs(4, 300))
    queries = _vecs(5, 9)
    if metric == "ip" or qd == "float32":
        _assert_same(port, ref, queries, 8, mode="exact", query_dtype=qd)
        return
    pd, pi = port.search(queries, 8, mode="exact", query_dtype=qd)
    jd, ji = ref.search(queries, 8, mode="exact", query_dtype=qd)
    np.testing.assert_allclose(pd, jd, rtol=1e-2, atol=1e-2)
    assert_ids_equal_off_ties(pi, ji, jd, 1e-5)


def test_unknown_query_dtype_raises():
    port = FlatIndex(D)
    port.add(np.arange(3), _vecs(4, 3))
    with pytest.raises(ValueError):
        port.search(_vecs(5, 2), 2, query_dtype="bf16")


def test_empty_index_odd_batch():
    port = FlatIndex(D)
    d, i = port.search(_vecs(6, 13), 5)
    assert d.shape == i.shape == (13, 5)
    assert (i == -1).all() and np.isinf(d).all()
    assert port.search_async(_vecs(6, 13), 5).shape == (13, 5)


def test_wrong_dims_raise():
    port = FlatIndex(D)
    with pytest.raises(ValueError):
        port.add(np.arange(2), np.zeros((2, D + 1), np.float32))
    port.add(np.arange(2), np.zeros((2, D), np.float32))
    with pytest.raises(ValueError):
        port.search(np.zeros((3, D - 1), np.float32), 1)
    with pytest.raises(ValueError):
        port.add(np.arange(3), np.zeros((2, D), np.float32))
    with pytest.raises(ValueError):
        FlatIndex(D, metric="hamming")
    with pytest.raises(ValueError):
        port.search(np.zeros((1, D), np.float32), 1, mode="fast")


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_from_jax_state(metric):
    ref = JaxFlat(D, metric)
    ref.add(np.arange(500), _vecs(7, 500))
    ref.remove(np.arange(0, 500, 11))
    port = FlatIndex.from_state(D, metric, ref.state_arrays())
    assert port.size == ref.size and port.capacity == ref.capacity
    np.testing.assert_array_equal(port.vectors(np.arange(5)), ref.vectors(np.arange(5)))
    _assert_same(port, ref, _vecs(8, 11), 7)
    again = FlatIndex.from_state(D, metric, port.state_arrays())
    np.testing.assert_array_equal(again.search(_vecs(8, 11), 7)[1],
                                  port.search(_vecs(8, 11), 7)[1])


def test_unported_arenas_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FlatIndex(D, storage_dtype="int8")
    state = JaxFlat(D).state_arrays()
    state["flat_meta"] = np.asarray([2, 1], np.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FlatIndex.from_state(D, "l2", state)


def test_approx_mode_and_async():
    """mode="approx" runs plain K2 + rerank on the CPU: perturbed copies of
    stored rows find those rows first.  search_async returns device ids."""
    port = FlatIndex(D, "cosine")
    base = _vecs(9, 4096)
    port.add(np.arange(4096), base)
    queries = base[:16] + 0.01 * _vecs(10, 16)
    d, i = port.search(queries, 2, mode="approx")
    assert (i[:, 0] == np.arange(16)).all()
    assert np.all(np.diff(d, axis=1) >= 0)
    ids = port.search_async(queries, 2, query_dtype=None)
    assert isinstance(ids, torch.Tensor)
    np.testing.assert_array_equal(ids.cpu().numpy(), port.search(queries, 2)[1])
    # auto on a CPU device is exact, as in the reference
    np.testing.assert_array_equal(port.search(queries, 5)[1],
                                  port.search(queries, 5, mode="exact")[1])
