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
    port, ref = FlatIndex(D, metric, device="cpu"), JaxFlat(D, metric)
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
    port, ref = FlatIndex(D, metric, device="cpu"), JaxFlat(D, metric)
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
    port = FlatIndex(D, device="cpu")
    port.add(np.arange(3), _vecs(4, 3))
    with pytest.raises(ValueError):
        port.search(_vecs(5, 2), 2, query_dtype="bf16")


def test_empty_index_odd_batch():
    port = FlatIndex(D, device="cpu")
    d, i = port.search(_vecs(6, 13), 5)
    assert d.shape == i.shape == (13, 5)
    assert (i == -1).all() and np.isinf(d).all()
    assert port.search_async(_vecs(6, 13), 5).shape == (13, 5)


def test_wrong_dims_raise():
    port = FlatIndex(D, device="cpu")
    with pytest.raises(ValueError):
        port.add(np.arange(2), np.zeros((2, D + 1), np.float32))
    port.add(np.arange(2), np.zeros((2, D), np.float32))
    with pytest.raises(ValueError):
        port.search(np.zeros((3, D - 1), np.float32), 1)
    with pytest.raises(ValueError):
        port.add(np.arange(3), np.zeros((2, D), np.float32))
    with pytest.raises(ValueError):
        FlatIndex(D, metric="hamming", device="cpu")
    with pytest.raises(ValueError):
        port.search(np.zeros((1, D), np.float32), 1, mode="fast")


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_from_jax_state(metric):
    ref = JaxFlat(D, metric)
    ref.add(np.arange(500), _vecs(7, 500))
    ref.remove(np.arange(0, 500, 11))
    port = FlatIndex.from_state(D, metric, ref.state_arrays(), device="cpu")
    assert port.size == ref.size and port.capacity == ref.capacity
    np.testing.assert_array_equal(port.vectors(np.arange(5)), ref.vectors(np.arange(5)))
    _assert_same(port, ref, _vecs(8, 11), 7)
    again = FlatIndex.from_state(D, metric, port.state_arrays(), device="cpu")
    np.testing.assert_array_equal(again.search(_vecs(8, 11), 7)[1],
                                  port.search(_vecs(8, 11), 7)[1])


def test_unported_arenas_raise():
    """Every storage dtype of the reference builds (the quantized arenas
    are ported); an unknown dtype and an unknown snapshot code raise."""
    for dtype in ("bfloat16", "int8", "int8x2"):
        assert FlatIndex(D, storage_dtype=dtype, device="cpu").storage_dtype == dtype
        state = JaxFlat(D, storage_dtype=dtype).state_arrays()
        assert FlatIndex.from_state(D, "l2", state, device="cpu").storage_dtype == dtype
    with pytest.raises(ValueError, match="storage_dtype"):
        FlatIndex(D, storage_dtype="int4", device="cpu")
    state = JaxFlat(D).state_arrays()
    state["flat_meta"] = np.asarray([7, 1], np.int32)
    with pytest.raises(ValueError, match="storage code"):
        FlatIndex.from_state(D, "l2", state, device="cpu")


def test_approx_mode_and_async():
    """mode="approx" runs plain K2 + rerank on the CPU: perturbed copies of
    stored rows find those rows first.  search_async returns device ids."""
    port = FlatIndex(D, "cosine", device="cpu")
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


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("mode", ["exact", "auto"])
def test_search_past_k1_limit_matches_jax(metric, mode):
    """k=1500 rounds up to a 2048-wide fetch, past the 1024 of K1's running
    lists: the port takes K1's large-k route (its plain version on the
    CPU), the reference its XLA scan."""
    from embeddinghub_tpu_torch.ops import fused_topk

    port, ref = FlatIndex(D, metric, device="cpu"), JaxFlat(D, metric)
    base = _vecs(11, 4096)
    for idx in (port, ref):
        idx.add(np.arange(4096), base)
        idx.remove(np.arange(0, 4096, 97))
    calls = []
    plain = fused_topk.fused_topk_search_large_k_reference
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused_topk, "fused_topk_search_large_k_reference",
                   lambda *a, **kw: calls.append(kw["k"]) or plain(*a, **kw))
        _assert_same(port, ref, _vecs(12, 5), 1500, mode=mode)
    assert calls == [2048]
    # a fetch as wide as the capacity, and one wider, return the live rows
    d, i = port.search(_vecs(12, 2), 5000, mode=mode)
    assert i.shape == (2, 4096) and (i[:, :port.size] >= 0).all()
    assert (i[:, port.size:] == -1).all() and np.isinf(d[:, port.size:]).all()


def _assert_mirror(idx):
    """``_dxb`` is ``_dx`` rounded to bf16, the padding columns zero; the
    rows of ``_dx`` lie a multiple of 16 bytes apart (K1's TMA loads)."""
    from embeddinghub_tpu_torch.ops import fused_topk

    idx._sync()
    dims = idx.dims
    assert idx._dx.shape == (idx.capacity, dims)
    assert idx._dx.stride(1) == 1 and idx._dx.stride(0) % 4 == 0
    assert idx._dxb.dtype == torch.bfloat16
    assert idx._dxb.shape == (idx.capacity, fused_topk.mirror_dims(dims))
    assert torch.equal(idx._dxb[:, :dims], idx._dx.to(torch.bfloat16))
    assert not idx._dxb[:, dims:].any()


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("dims", [7, 100])
def test_bf16_mirror_follows_the_arena(metric, dims):
    """After every kind of write and sync: a first full upload, a scatter
    of overwrites, removes and new rows, a capacity growth (full upload), a
    rewrite of most rows (full upload), and a rebuild from state."""
    rng = np.random.default_rng(dims)

    def vecs(n):
        return rng.standard_normal((n, dims)).astype(np.float32)

    idx = FlatIndex(dims, metric, device="cpu")
    idx.add(np.arange(100), vecs(100))
    _assert_mirror(idx)
    idx.add(np.array([3, 50, 127]), vecs(3))          # scatter: overwrites, a new row
    idx.remove(np.array([4, 9]))
    assert idx._dirty_rows and not idx._needs_full_sync
    _assert_mirror(idx)
    idx.add(np.arange(100, 300), vecs(200))           # grows 128 -> 512: full upload
    assert idx._needs_full_sync
    _assert_mirror(idx)
    idx.add(np.arange(0, 300, 2), vecs(150))          # past the scatter limit
    assert idx._needs_full_sync
    _assert_mirror(idx)
    again = FlatIndex.from_state(dims, metric, idx.state_arrays(), device="cpu")
    _assert_mirror(again)
    assert torch.equal(again._dxb, idx._dxb)


@pytest.mark.parametrize("make", ["FlatIndex", "EmbeddingHub", "Index"])
def test_entry_points_default_to_cuda(make):
    """Without ``device`` every entry point puts its store on CUDA: with a
    card it runs there, without one it raises and names the argument,
    never carrying on on the CPU."""
    from embeddinghub_tpu_torch.sdk.offline import Index
    from embeddinghub_tpu_torch.store.hub import EmbeddingHub

    build = {
        "FlatIndex": lambda: FlatIndex(D),
        "EmbeddingHub": lambda: EmbeddingHub.in_memory().create_space(
            "s", D).default_version().index,
        "Index": lambda: Index([("a", _vecs(0, 1)[0])], D)._idx,
    }[make]
    if torch.cuda.is_available():
        assert build().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device="):
            build()
