"""ops/topk.py of the port against the JAX package's, on the CPU.

Tolerances: exact paths 1e-5 (f32 on both sides, different summation
order); ids equal except at near-ties of that size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embeddinghub_tpu.ops import pallas_topk as jp
from embeddinghub_tpu.ops import topk as jt
from embeddinghub_tpu_torch.ops import topk as tt
from _torch_parity import assert_ids_equal_off_ties


def _arena(seed, n=1024, d=16, b=9, metric="l2"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    if metric == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    valid = rng.random(n) > 0.2
    return q, x, valid, (x * x).sum(1)


def _j(*a):
    return [jnp.asarray(v) for v in a]


def _t(*a):
    return [torch.from_numpy(np.ascontiguousarray(v)) for v in a]


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_chunked_topk_search(metric, k):
    q, x, valid, xsq = _arena(0, metric=metric)
    jd, ji = jt.chunked_topk_search(*_j(q, x, valid, xsq), metric=metric, k=k, chunk=256)
    td, ti = tt.chunked_topk_search(*_t(q, x, valid, xsq), metric=metric, k=k, chunk=256)
    jd, ji = np.asarray(jd), np.asarray(ji)
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-5, atol=1e-5)
    assert_ids_equal_off_ties(ti.numpy(), ji, jd, 1e-5)


def test_chunked_topk_search_contract():
    q, x, valid, xsq = _arena(1, n=300)
    with pytest.raises(ValueError):
        tt.chunked_topk_search(*_t(q, x, valid, xsq), k=4, chunk=256)


def test_chunked_topk_search_empty_slots():
    """Fewer live rows than k: the port marks empty slots id -1 / +inf (the
    JAX scan leaves arbitrary ids behind +inf, which FlatIndex then maps to
    -1)."""
    q, x, valid, xsq = _arena(2, n=256)
    valid[:] = False
    valid[[5, 77]] = True
    jd, _ = jt.chunked_topk_search(*_j(q, x, valid, xsq), k=4, chunk=128)
    td, ti = tt.chunked_topk_search(*_t(q, x, valid, xsq), k=4, chunk=128)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    assert set(ti.numpy()[:, :2].ravel()) == {5, 77}
    assert (ti.numpy()[:, 2:] == -1).all()


def test_merge_and_masked_topk():
    rng = np.random.default_rng(3)
    d1, d2 = (np.sort(rng.random((4, 6)).astype(np.float32), 1) for _ in range(2))
    i1, i2 = (rng.integers(0, 1000, (4, 6)).astype(np.int32) for _ in range(2))
    jd, ji = jt.merge_topk(*_j(d1, i1, d2, i2), 5)
    td, ti = tt.merge_topk(*_t(d1, i1, d2, i2), 5)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))

    dists = rng.random((3, 50)).astype(np.float32)
    valid = rng.random(50) > 0.5
    jd, ji = jt.masked_topk(*_j(dists, valid), 7)
    td, ti = tt.masked_topk(*_t(dists, valid), 7)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_approx_oversample_search(metric):
    """Plain K2 + rerank.  Its candidates equal the JAX K2 kernel's on the
    same arena (bf16 scores, 1e-3), and its output equals a numpy f32 rerank
    of those candidates (1e-5)."""
    k, over = 2, 8
    q, x, valid, xsq = _arena(4, n=4096, d=32, b=16, metric=metric)
    jd, jc = jp.fused_topk_search_v2(*_j(q, x.T, valid, xsq), k=k * over,
                                     metric=metric, chunk=1024, block_b=16,
                                     interpret=True)
    jc = np.asarray(jc)
    from embeddinghub_tpu_torch.ops import fused_topk
    tq, tx, tv, tsq = _t(q, x, valid, xsq)
    xb = fused_topk.arena_bf16(tx)
    _, tc = fused_topk.approx_candidates(tq, xb, tv, tsq, k=k * over, metric=metric)
    assert_ids_equal_off_ties(tc.numpy(), jc, np.asarray(jd), 1e-3)

    td, ti = tt.approx_oversample_search(tq, tx, xb, tv, tsq, metric=metric,
                                         k=k, oversample=over)
    # numpy rerank of the JAX candidates
    qn = q / np.linalg.norm(q, axis=1, keepdims=True) if metric == "cosine" else q
    cx = x[np.maximum(jc, 0)].astype(np.float64)
    dots = np.einsum("bkd,bd->bk", cx, qn.astype(np.float64))
    if metric == "l2":
        dist = (qn.astype(np.float64) ** 2).sum(1)[:, None] - 2 * dots + xsq[np.maximum(jc, 0)]
    else:
        dist = 1 - dots
    dist[jc < 0] = np.inf
    order = np.argsort(dist, axis=1, kind="stable")[:, :k]
    want_d = np.take_along_axis(dist, order, 1)
    want_i = np.take_along_axis(jc, order, 1)
    np.testing.assert_allclose(td.numpy(), want_d, rtol=1e-5, atol=1e-5)
    assert_ids_equal_off_ties(ti.numpy(), want_i, want_d, 1e-5)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("score_bytes", [1 << 29, 9 * 4 * 200])
def test_chunked_topk_search_past_k1_limit(metric, score_bytes, monkeypatch):
    """k above MAX_K_EXACT goes to K1's large-k route, before any launch;
    its plain version, with a small score bound, takes many chunks and
    gives the same answer as the reference's XLA scan."""
    from embeddinghub_tpu_torch.ops import fused_topk

    monkeypatch.setattr(fused_topk, "SCAN_SCORE_BYTES", score_bytes)
    monkeypatch.setattr(fused_topk, "exact_topk", None)  # K1's lists must not be called
    calls = []
    plain = fused_topk.fused_topk_search_large_k_reference
    monkeypatch.setattr(fused_topk, "fused_topk_search_large_k_reference",
                        lambda *a, **kw: calls.append(kw["k"]) or plain(*a, **kw))
    q, x, valid, xsq = _arena(5, n=2048, metric=metric)
    jd, ji = jt.chunked_topk_search(*_j(q, x, valid, xsq), metric=metric, k=1500, chunk=1024)
    td, ti = tt.chunked_topk_search(*_t(q, x, valid, xsq), metric=metric, k=1500, chunk=1024)
    assert calls == [1500]
    jd = np.asarray(jd)
    fin = np.isfinite(jd)
    np.testing.assert_allclose(td.numpy()[fin], jd[fin], rtol=1e-5, atol=1e-5)
    assert (ti.numpy()[~fin] == -1).all() and np.isinf(td.numpy()[~fin]).all()
    ji = np.where(fin, np.asarray(ji), -1)
    assert_ids_equal_off_ties(ti.numpy(), ji, jd, 1e-5)
