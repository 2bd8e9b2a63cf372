"""The quantized flat arenas of the port (bf16, int8, int8x2) against the
JAX package's, on the CPU: K2's candidate pool (its plain version) against
a brute-force oracle of the same binning, the quantized searches of
``ops/topk.py`` against their JAX twins, ``FlatIndex`` writes and snapshots,
the quantization guard and the measured audit, and the ``flat-*`` engines
of the hub.  The ``cuda`` tests hold the pool's kernel against its plain
version on the card.

Tolerances: a search's recall@k against the exact oracle no lower than the
JAX function's less 0.01 (the port keeps one candidate per 32 rows where
``approx_max_k`` on the CPU is exact); a rerank of the same candidates:
ids equal off near-ties and distances within 1e-5 relative to the larger of
the distance and the terms an l2 distance is the difference of (|q|^2 +
|x|^2: f32 sums in another order).  The planes: equal on l2 arenas; on cosine ones the port's
normalized rows may differ from numpy's in the last bit, so an element may
differ by one in at most 1e-4 of them.
"""

import logging

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from embeddinghub_tpu.index import flat as jflat
from embeddinghub_tpu.ops import topk as jtopk
from embeddinghub_tpu_torch.index import flat as tflat
from embeddinghub_tpu_torch.index.base import quantize_rows
from embeddinghub_tpu_torch.ops import distance as D
from embeddinghub_tpu_torch.ops import fused_topk as F
from embeddinghub_tpu_torch.ops import topk as T
from _torch_parity import assert_ids_equal_off_ties, walk_terms


def clustered(n=8192, d=32, centers=8, spread=2e-2, seed=0):
    """Near-duplicate clusters (``tests/test_quant_guard.py``'s): true
    neighbour gaps below int8 resolution, above int8x2's."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    x = c[np.arange(n) % centers] + spread * rng.standard_normal((n, d)).astype(np.float32)
    return x.astype(np.float32)


def separable(n=8192, d=32, seed=1):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def near_dup(n, d=96, nq=64, seed=0):
    """benchmarks/capacity.py's rows at a small scale: 1,024 centers, noise
    0.35; then queries of the same draw."""
    rng = np.random.default_rng(seed)
    centers = (3.0 * rng.standard_normal((1024, d))).astype(np.float32)

    def draw(count):
        a = rng.integers(0, 1024, count)
        return (centers[a] + 0.35 * rng.standard_normal((count, d)).astype(np.float32)
                ).astype(np.float32)
    return draw(n), draw(nq)


def outlier_scaled(n=4096, d=32, gap=5e-2, outlier=50.0, seed=3):
    """``tests/test_quant_guard.py``'s pool-containment regime: one
    outlier dimension sets every row's int8 scale."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(d).astype(np.float32)
    u /= np.linalg.norm(u)
    x = u[None, :] + gap * rng.standard_normal((n, d)).astype(np.float32)
    x[:, -1] = outlier * rng.choice([-1.0, 1.0], n)
    return x.astype(np.float32)


def prep(x, metric):
    if metric == "cosine":
        x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)
    return x.astype(np.float32)


def oracle(x, q, valid, k, metric):
    xp, qp = prep(x, metric), prep(q, metric)
    s = qp @ xp.T if metric != "l2" else 2.0 * (q @ x.T) - np.einsum("nd,nd->n", x, x)
    s = np.where(valid[None, :], s, -np.inf)
    return np.argsort(-s, axis=1)[:, :k]


def recall(ids, true):
    ids = np.asarray(ids)
    return float(np.mean([len(set(ids[i].tolist()) & set(true[i].tolist())) / true.shape[1]
                          for i in range(len(true))]))


def planes(x, metric, dtype):
    """(hi, scales, lo, x_sq) of ``x`` as the reference's index makes them."""
    xp = prep(x, metric)
    sq = np.einsum("nd,nd->n", xp, xp).astype(np.float32)
    if dtype == "bfloat16":
        return xp.astype(ml_dtypes.bfloat16), None, None, sq
    hi, sc, lo = quantize_rows(xp, residual=dtype == "int8x2")
    return hi, sc, lo, sq


def both(x, q, valid, metric, dtype):
    """The same inputs for the JAX function and the port's."""
    hi, sc, lo, sq = planes(x, metric, dtype)
    jx = (jnp.asarray(q), jnp.asarray(hi), None if sc is None else jnp.asarray(sc),
          jnp.asarray(valid), jnp.asarray(sq))
    th = (torch.from_numpy(hi.view(np.uint16)).view(torch.bfloat16)
          if dtype == "bfloat16" else torch.from_numpy(hi))
    tx = (torch.from_numpy(q), th, None if sc is None else torch.from_numpy(sc),
          torch.from_numpy(valid), torch.from_numpy(sq))
    return jx, tx, (None if lo is None else jnp.asarray(lo),
                    None if lo is None else torch.from_numpy(lo))


def pool_calls(monkeypatch):
    """Counts the plain pool's calls (the route through K2's pool)."""
    calls = []
    plain = F.pool_candidates_reference
    monkeypatch.setattr(F, "pool_candidates_reference",
                        lambda *a, **kw: calls.append(kw["k"]) or plain(*a, **kw))
    return calls


# ------------------------------------------------------ the pool's binning


def brute_force_pool(qf, hi, sc, valid, sq, metric, k, seg):
    """The pool's definition, row by row in numpy: the int8 score in the
    kernel's order of operations, bin id ``4 * (r // 128) + (r % 8) // 2``,
    each bin's (min score, first row), each segment's k smallest keys."""
    b, dims = qf.shape
    qscale = np.abs(qf).max(axis=1) / np.float32(127.0)
    qq = np.clip(np.round(qf / np.maximum(qscale, np.float32(1e-30))[:, None]), -127, 127)
    qs = qscale * np.float32(2.0) if metric == "l2" else qscale
    acc = (qq.astype(np.int64) @ hi.astype(np.int64).T).astype(np.float32)
    bias = np.where(valid, sq if metric == "l2" else np.float32(0), np.float32(np.inf))
    score = bias[None, :] - (qs[:, None] * sc[None, :]) * acc
    rows = np.arange(hi.shape[0])
    bin_of = 4 * (rows // 128) + (rows % 8) // 2
    n_bins = 4 * -(-hi.shape[0] // 128)
    seg_bins = n_bins if seg is None else seg // 32
    n_seg = -(-n_bins // seg_bins)
    out_s = np.full((b, n_seg, k), np.inf, np.float32)
    out_i = np.full((b, n_seg, k), -1, np.int64)
    for qi in range(b):
        win = {}
        for r in rows:  # rows ascending: a later row wins only strictly
            key = (score[qi, r], r)
            if bin_of[r] not in win or key[0] < win[bin_of[r]][0]:
                win[bin_of[r]] = key
        for sgm in range(n_seg):
            keys = sorted(win[bn] for bn in win if bn // seg_bins == sgm)[:k]
            for j, (s, r) in enumerate(keys):
                if np.isfinite(s):
                    out_s[qi, sgm, j], out_i[qi, sgm, j] = s, r
    return out_s, out_i


@pytest.mark.parametrize("metric", ["l2", "cosine", "ip"])
@pytest.mark.parametrize("cap,seg,k", [(1000, None, 7), (2048, 512, 9), (1536, 1024, 40)])
def test_plain_int8_pool_matches_brute_force(metric, cap, seg, k):
    """Plain K2 int8 pool against the binning done row by row: the same
    ids and scores, a ragged last tile, dead rows, a ragged last segment,
    and segments with fewer live bins than ``k``."""
    rng = np.random.default_rng(cap + k)
    x = rng.standard_normal((cap, 24)).astype(np.float32)
    x[::5] *= 3.0  # scales that differ by row
    valid = rng.random(cap) > 0.2
    valid[1024:1400] = False
    qf = prep(rng.standard_normal((5, 24)).astype(np.float32), metric)
    hi, sc, _, sq = planes(x, metric, "int8")
    s, i = F.pool_candidates(torch.from_numpy(qf), torch.from_numpy(hi),
                             torch.from_numpy(valid), torch.from_numpy(sq),
                             torch.from_numpy(sc), k=k, metric=metric, seg=seg)
    ws, wi = brute_force_pool(qf, hi, sc, valid, sq, metric, k, seg)
    np.testing.assert_array_equal(i.numpy(), wi)
    np.testing.assert_array_equal(s.numpy(), ws)
    assert valid[i.numpy()[i.numpy() >= 0]].all()


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_plain_bf16_pool_keeps_k2_scores(metric):
    """The bf16 pool scores as K2 does (bf16-rounded operands, f32 sums):
    its winners' scores are K2's group scores of the same rows, and over
    128-row groups the best bin winner is K2's group winner."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3000, 40)).astype(np.float32)
    valid = rng.random(3000) > 0.1
    qf = torch.from_numpy(prep(rng.standard_normal((6, 40)).astype(np.float32), metric))
    xp = torch.from_numpy(prep(x, metric))
    xb, sq, v = F.arena_bf16(xp), D.sqnorms(xp), torch.from_numpy(valid)
    s, i = F.pool_candidates(qf, xb, v, sq, k=64, metric=metric)
    m = "ip" if metric == "cosine" else metric
    d_k2, i_k2 = F.fused_topk_search_v2_reference(qf, xb, v, sq, k=8, metric=m)
    # K2's best group winners are the pool's best bin winners
    np.testing.assert_array_equal(i[:, 0, :1].numpy(), i_k2[:, :1].numpy())
    rows = i[:, 0].long()
    dots = (D.round_bf16(xp)[rows] * D.round_bf16(qf)[:, None, :]).sum(2)
    want = sq[rows] - 2 * dots if metric == "l2" else -dots
    np.testing.assert_allclose(s[:, 0].numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_pool_decodes_kernel_keys():
    """The pool's slots as K2's select decodes its 64-bit keys (k2_scan.cu
    ``pack``, ``TO_DECODE``), here in the plain pool: each segment's (score,
    row) ascending by score, then row; a bin with no live row and the
    padding past a segment's bins as empty slots (+inf, -1).  The kernel's
    own decode is held to the plain pool by
    ``test_card_pool_decodes_empty_bins``."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((640, 8)).astype(np.float32)
    x[3] = x[1]  # a tie in score, broken by the lower row
    valid = np.ones(640, bool)
    valid[256:] = False  # the third segment holds no live row
    valid[128:256:2] = False
    hi, sc, _, sq = planes(x, "l2", "int8")
    qf = torch.from_numpy(x[1:2].copy())
    s, i = F.pool_candidates(qf, torch.from_numpy(hi), torch.from_numpy(valid),
                             torch.from_numpy(sq), torch.from_numpy(sc), k=12, metric="l2",
                             seg=128)
    assert s.shape == i.shape == (1, 5, 12)
    fin = torch.isfinite(s)  # a segment of 128 rows holds 4 bins
    assert fin[0, :2, :4].all() and not fin[0, :2, 4:].any() and not fin[0, 2:].any()
    assert (i[~fin] == -1).all()
    assert (torch.diff(s[0, :2, :4], dim=1) >= 0).all()
    assert i[0, 0, :2].tolist() == [1, 3] and s[0, 0, 0] == s[0, 0, 1]  # a tie: lower row first
    assert valid[i[fin].numpy()].all()


# ------------------------------------------------- the searches against JAX


# clustered: the near-duplicate generator of benchmarks/capacity.py (1,024
# clusters).  Far fewer, larger clusters cost the pool recall: a true
# neighbour is lost where a cluster mate that outscores it shares its bin of
# 32 rows (ROADMAP queue 1, item 6).
DATA = {"clustered": lambda: near_dup(16384, d=32, nq=24),
        "separable": lambda: (separable(n=16384, d=32), separable(n=24, d=32, seed=8))}


@pytest.mark.parametrize("data", ["clustered", "separable"])
@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("dtype", ["int8", "int8x2"])
def test_int8_oversample_search_recall(monkeypatch, data, metric, dtype):
    x, q = DATA[data]()
    valid = np.ones(len(x), bool)
    valid[::37] = False
    true = oracle(x, q, valid, 8, metric)
    jx, tx, (jlo, tlo) = both(x, q, valid, metric, dtype)
    kw = dict(metric=metric, k=8, oversample=16 if dtype == "int8x2" else 8)
    _, ji = jtopk.int8_oversample_search(*jx, jlo, **kw)
    calls = pool_calls(monkeypatch)
    td, ti = T.int8_oversample_search(*tx, tlo, **kw)
    assert calls == [kw["k"] * kw["oversample"]]  # K2's pool, not every row
    assert recall(ti, true) >= recall(ji, true) - 0.01, (recall(ti, true), recall(ji, true))
    assert valid[ti.numpy()[ti.numpy() >= 0]].all()
    assert (np.diff(td.numpy(), axis=1) >= 0).all()


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("fn,dtype", [(fn, dtype) for fn in ("exact", "search", "ids")
                                      for dtype in ("int8", "int8x2", "bfloat16")
                                      if (fn, dtype) != ("ids", "int8x2")])
def test_chunked_searches_recall(monkeypatch, metric, dtype, fn):
    """quantized_chunked_exact / _search / _ids over two chunks of 8,192
    rows, one segment of K2's pool each (``_ids`` takes no residual
    plane)."""
    x, q = DATA["clustered"]()
    valid = np.ones(len(x), bool)
    valid[-64:] = False
    true = oracle(x, q, valid, 8, metric)
    jx, tx, (jlo, tlo) = both(x, q, valid, metric, dtype)
    kw = dict(metric=metric, k=8, oversample=8, chunk=8192)
    calls = pool_calls(monkeypatch)
    if fn == "exact":
        ji = jtopk.quantized_chunked_exact(*jx, jlo, **kw)[1]
        ti = T.quantized_chunked_exact(*tx, tlo, **kw)[1]
    elif fn == "search":
        ji = jtopk.quantized_chunked_search(*jx, jlo, **kw)[1]
        ti = T.quantized_chunked_search(*tx, tlo, **kw)[1]
    else:
        ji = jtopk.quantized_chunked_ids(*jx, **kw)
        ti = T.quantized_chunked_ids(*tx, **kw)
        assert ti.shape == (len(q), 64)
        # a pool of 64 holds the oracle's top 8 as well as JAX's does
    assert calls == [64]
    assert recall(ti, true) >= recall(np.asarray(ji), true) - 0.01
    assert not np.isin(ti.numpy(), np.arange(len(x) - 64, len(x))).any()


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("dtype", ["int8", "int8x2"])
def test_tiny_arena_reranks_every_row(monkeypatch, metric, dtype):
    """A pool as wide as the bins (tiny arenas, chunks the pool covers)
    routes, by shape, to an exact rerank of every row: no worse than the
    reference's pool, and K2's pool is not called."""
    x, q = clustered(n=900, d=16, centers=4), clustered(n=12, d=16, centers=4, seed=5)
    valid = np.ones(900, bool)
    true = oracle(x, q, valid, 10, metric)
    jx, tx, (jlo, tlo) = both(x, q, valid, metric, dtype)
    calls = pool_calls(monkeypatch)
    _, ji = jtopk.int8_oversample_search(*jx, jlo, metric=metric, k=10, oversample=8)
    _, ti = T.int8_oversample_search(*tx, tlo, metric=metric, k=10, oversample=8)
    assert recall(ti, true) >= recall(ji, true) - 1e-9
    _, ci = T.quantized_chunked_exact(*tx, tlo, metric=metric, k=10, oversample=8,
                                      chunk=300)
    assert recall(ci, true) >= recall(ji, true) - 1e-9
    assert calls == []


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("dtype", ["int8", "int8x2", "bfloat16"])
def test_reranks_match_jax_on_the_same_pool(metric, dtype):
    """quantized_pool_rerank and host_rerank of the candidates JAX pooled:
    ids equal off near-ties, distances within 1e-5 relative."""
    x, q = DATA["clustered"]()
    valid = np.ones(len(x), bool)
    valid[::101] = False
    jx, tx, (jlo, tlo) = both(x, q, valid, metric, dtype)
    cand = np.asarray(jtopk.quantized_chunked_ids(*jx, metric=metric, k=10, oversample=8,
                                                  chunk=4096))
    jd, ji = jtopk.quantized_pool_rerank(jx[0], jx[1], jx[2], jx[4], jlo,
                                         jnp.asarray(cand), metric=metric, k=10)
    td, ti = T.quantized_pool_rerank(tx[0], tx[1], tx[2], tx[4], tlo,
                                     torch.from_numpy(cand.copy()), metric=metric, k=10)
    jd = np.asarray(jd)
    # an l2 distance is a difference of terms of |q|^2 + |x|^2 in size
    terms = walk_terms(q, prep(x, metric), metric)
    assert (np.abs(td.numpy() - jd) <= 1e-5 * np.maximum(np.abs(jd), terms) + 1e-6).all()
    assert_ids_equal_off_ties(ti.numpy(), np.asarray(ji), jd, 1e-5 * terms.max())
    xp = prep(x, metric)
    hd, hi = jtopk.host_rerank(xp, valid, q, cand, 10, metric)
    pd, pi = T.host_rerank(xp, valid, q, cand, 10, metric)
    np.testing.assert_array_equal(pi, hi)
    np.testing.assert_array_equal(pd, hd)


# ------------------------------------------------------- the index vs JAX


def _pair(dtype, metric, cap=128, guard=False):
    return (tflat.FlatIndex(32, metric, capacity=cap, storage_dtype=dtype, device="cpu",
                            quant_guard=guard),
            jflat.FlatIndex(32, metric, capacity=cap, storage_dtype=dtype, quant_guard=guard))


def _assert_same_state(port, ref, metric):
    ps, rs = port.state_arrays(), ref.state_arrays()
    assert sorted(ps) == sorted(rs)
    for name in ("x", "valid", "flat_meta"):
        np.testing.assert_array_equal(ps[name], rs[name])
    for name in ("q_hi", "q_lo"):
        if name in rs:
            diff = ps[name].astype(np.int16) - rs[name].astype(np.int16)
            if metric == "l2":
                assert not diff.any(), name
            else:
                assert np.abs(diff).max() <= 1 and (diff != 0).mean() <= 1e-4, name
    for name in ("q_sq", "q_sc"):
        if name in rs:
            np.testing.assert_allclose(ps[name], rs[name], rtol=1e-6, atol=1e-30)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("dtype", ["int8", "int8x2", "bfloat16"])
def test_index_writes_and_snapshots_match_jax(metric, dtype):
    """The same adds, removes and re-adds in both packages: the same
    snapshot arrays (the cached planes after full syncs, scatters and
    writes pending a full sync), searches at the same recall, and each
    package's snapshot opens in the other."""
    port, ref = _pair(dtype, metric)
    x = clustered(n=6000, d=32, centers=16, spread=0.1)
    q = x[:16] + 1e-3
    steps = [("add", np.arange(3000), x[:3000]),           # grows: full sync
             ("search",), ("add", np.arange(3000, 3100), x[3000:3100]),  # scatter
             ("remove", np.arange(0, 3000, 7)), ("search",),
             ("add", np.arange(0, 300, 7), x[5000:5043]),    # re-add removed rows
             ("add", np.arange(3100, 6000), x[3100:6000]),   # grows again
             ("add", np.arange(10, 20), x[5500:5510]),       # pending a full sync
             ("search",), ("remove", np.arange(5000, 5040)), ("search",)]
    for step in steps:
        for idx in (port, ref):
            if step[0] == "add":
                idx.add(step[1], step[2])
            elif step[0] == "remove":
                idx.remove(step[1])
            else:
                idx.search(q, 10)
        if step[0] == "search":
            _assert_same_state(port, ref, metric)
    assert port.size == ref.size and port.capacity == ref.capacity
    if dtype != "bfloat16":
        assert "q_hi" in port.state_arrays()
    live = port._hvalid.copy()
    true = oracle(port._hx, q, live, 10, metric)
    _, pi = port.search(q, 10)
    _, ri = ref.search(q, 10)
    assert recall(pi, true) >= recall(ri, true) - 0.01
    # snapshots both ways
    back = tflat.FlatIndex.from_state(32, metric, ref.state_arrays(), device="cpu")
    assert back.storage_dtype == dtype and (back._pending is not None) == (dtype != "bfloat16")
    np.testing.assert_array_equal(back.search(q, 10)[1], pi)
    there = jflat.FlatIndex.from_state(32, metric, port.state_arrays())
    assert there.storage_dtype == dtype
    assert recall(there.search(q, 10)[1], true) >= recall(ri, true) - 1e-9


def test_restore_uploads_cached_planes_without_quantizing(monkeypatch):
    """A snapshot with q_* planes restores them: the first sync uploads
    them as they are, and quantizes nothing."""
    ref = jflat.FlatIndex(32, "cosine", storage_dtype="int8x2", quant_guard=False)
    x = separable(n=2000, d=32)
    ref.add(np.arange(2000), x)
    ref.search(x[:4], 5)
    state = ref.state_arrays()
    port = tflat.FlatIndex.from_state(32, "cosine", state, device="cpu")
    monkeypatch.setattr(tflat, "quantize_planes", lambda *a, **k: pytest.fail("quantized"))
    port._sync()
    np.testing.assert_array_equal(port._dx.numpy(), state["q_hi"])
    np.testing.assert_array_equal(port._dx_lo.numpy(), state["q_lo"])
    np.testing.assert_array_equal(port._dscales.numpy(), state["q_sc"])
    assert port.search(x[:4], 1)[1][:, 0].tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_rows_written_after_a_restore_are_scattered(metric):
    """A WAL tail replayed into a restored int8x2 index before its first
    search: the snapshot's planes are uploaded as they are and the rows
    written since scattered after them, so both packages hold the same
    planes (the reference updates its cached planes row by row)."""
    x = separable(n=3000, d=32)
    src = jflat.FlatIndex(32, metric, storage_dtype="int8x2", quant_guard=False)
    src.add(np.arange(2000), x[:2000])
    src.search(x[:4], 5)
    state = src.state_arrays()
    port = tflat.FlatIndex.from_state(32, metric, state, device="cpu")
    ref = jflat.FlatIndex.from_state(32, metric, state)
    assert port._pending is not None and "q_hi" in port.state_arrays()
    for idx in (port, ref):
        idx.add(np.arange(1500, 2000), x[2000:2500])  # overwrites
        idx.add(np.arange(2000, 2100), x[2500:2600])  # new rows
        idx.remove(np.arange(0, 100, 3))
    assert port._dirty_rows and "q_hi" not in port.state_arrays()
    got = port.search(x[2000:2010], 1)[1][:, 0]
    assert got.tolist() == list(range(1500, 1510))
    assert not port._dirty_rows and port._pending is None
    ref.search(x[:4], 5)
    _assert_same_state(port, ref, metric)


@pytest.mark.parametrize("dtype", ["int8", "int8x2", "bfloat16"])
def test_device_planes_equal_host_quantization(dtype):
    """The planes quantized by PyTorch equal ``quantize_rows`` in numpy on
    the same rows (l2: no normalization, every operation exact IEEE)."""
    x = separable(n=700, d=24) * 3.0
    idx = tflat.FlatIndex(24, "l2", storage_dtype=dtype, device="cpu")
    idx.add(np.arange(700), x)
    idx._sync()
    hi, sc, lo, sq = planes(x, "l2", dtype)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(idx._dxb[:700, :24].view(torch.int16).numpy(),
                                      hi.view(np.int16))
        assert idx._dx is None and not idx._dxb[:, 24:].any()
        return
    np.testing.assert_array_equal(idx._dx[:700].numpy(), hi)
    np.testing.assert_array_equal(idx._dscales[:700].numpy(), sc)
    if lo is not None:
        np.testing.assert_array_equal(idx._dx_lo[:700].numpy(), lo)
    assert idx._dx.stride(0) % 16 == 0


def test_search_async_quantized_storage():
    """search_async on int8/int8x2 takes the quantized path (the
    counterpart of tests/test_flat_index.py:193): recall 0.95 against the
    exact oracle, and the same ids as search."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4096, 32)).astype(np.float32)
    q = rng.standard_normal((16, 32)).astype(np.float32)
    true = oracle(x, q, np.ones(4096, bool), 10, "cosine")
    for storage in ("int8", "int8x2"):
        idx = tflat.FlatIndex(32, "cosine", storage_dtype=storage, capacity=4096,
                              device="cpu")
        idx.add(np.arange(4096), x)
        got = idx.search_async(q, 10)
        assert isinstance(got, torch.Tensor)
        assert recall(got.numpy(), true) >= 0.95
        np.testing.assert_array_equal(  # search_async's queries: bf16 values
            got.numpy(), idx.search(q, 10, mode="exact", query_dtype="bfloat16")[1])


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_shallow_bf16_modes(metric):
    """A shallow bf16 arena: "exact" is exact over the bf16-valued rows
    with f32 queries (the reference's chunked scan on a bf16 arena),
    "approx" K2 + the rerank of the bf16 values; both against JAX."""
    x = separable(n=5000, d=32)
    q = separable(n=9, d=32, seed=3)
    port, ref = _pair("bfloat16", metric)
    for idx in (port, ref):
        idx.add(np.arange(5000), x)
    pd, pi = port.search(q, 10, mode="exact")
    jd, ji = ref.search(q, 10, mode="exact")
    np.testing.assert_allclose(pd, jd, rtol=1e-5, atol=1e-5)
    assert_ids_equal_off_ties(pi, ji, jd, 1e-5)
    _, ai = port.search(q, 4, mode="approx")
    assert recall(ai, ji[:, :4]) >= 0.95


# ---------------------------------------------------- the guard and the audit


GUARD_CASES = {
    "clustered": (lambda: clustered(), "l2", True),
    "separable": (lambda: separable(), "l2", True),
    "below_min_rows": (lambda: clustered(n=1024), "l2", True),
    "disabled": (lambda: clustered(), "l2", False),
    "cosine": (lambda: clustered(), "cosine", True),
}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_guard_decides_as_jax(case, caplog):
    """The cases of tests/test_quant_guard.py:57-129: the same escalation
    (or none) in both packages, logged the same way, and recall 0.95 after
    an escalation."""
    make, metric, guard = GUARD_CASES[case]
    x = make()
    port = tflat.FlatIndex(32, metric, storage_dtype="int8", device="cpu", quant_guard=guard)
    ref = jflat.FlatIndex(32, metric, storage_dtype="int8", quant_guard=guard)
    q = x[:32] + 1e-5
    with caplog.at_level(logging.WARNING, logger="embeddinghub_tpu_torch.index"):
        for idx in (port, ref):
            idx.add(np.arange(len(x)), x)
        _, ids = port.search(q, 10)
        ref.search(q, 10)
    assert port.storage_dtype == ref.storage_dtype
    escalated = port.storage_dtype != "int8"
    assert escalated == (case in ("clustered", "cosine"))
    assert escalated == any("escalating storage" in r.message for r in caplog.records
                            if r.name == "embeddinghub_tpu_torch.index")
    if escalated:
        assert recall(ids, oracle(x, q, np.ones(len(x), bool), 10, metric)) >= 0.95
        state = port.state_arrays()
        assert tflat.FlatIndex.from_state(32, metric, state, device="cpu"
                                          ).storage_dtype == port.storage_dtype


def test_guard_simulation_is_the_references():
    x = prep(clustered(n=4096), "cosine")
    sq = np.einsum("nd,nd->n", x, x, dtype=np.float32)
    for dtype in ("int8", "int8x2"):
        assert tflat._simulate_quant_recall(x, sq, "cosine", dtype) == \
            jflat._simulate_quant_recall(x, sq, "cosine", dtype)


def _shrink_deep(monkeypatch, thresh=1024, block=2048):
    for mod in (tflat, jflat):
        monkeypatch.setattr(mod, "_DEEP_CAP_THRESHOLD", thresh)
        monkeypatch.setattr(mod, "_DEEP_CAP_BLOCK", block)
    monkeypatch.setattr(jflat, "_STAGE_BLOCK_ROWS", 1024)


def test_deep_audit_ladder_matches_jax(monkeypatch):
    """tests/test_quant_guard.py:245-300 in both packages: on a deep
    arena the audit widens the pool before any dtype (boost 2, 4, 8), and
    both packages pull the same levers in the same order."""
    _shrink_deep(monkeypatch)
    x = outlier_scaled(n=30720, d=32)
    reports = []
    for mod, kw in ((tflat, {"device": "cpu"}), (jflat, {})):
        idx = mod.FlatIndex(32, "l2", storage_dtype="int8x2", capacity=30720,
                            quant_guard=False, **kw)
        idx.add(np.arange(30720), x)
        assert idx.capacity % 2048 == 0 and idx.capacity > 1024
        reports.append(idx.audit_and_escalate(bar=0.95, nq=24, k=10))
    port, ref = reports
    assert port["boosted"] == ref["boosted"] and port["escalated"] == ref["escalated"]
    assert port["audited"][0]["boost"] == 1
    assert port["audited"][1] == {"storage": "int8x2", "boost": 2,
                                  "recall": port["audited"][1]["recall"]}
    assert port["audited"][-1]["recall"] >= 0.9
    for a in port["audited"]:
        if a["storage"] != "int8x2":
            break
        last = a
    assert last["boost"] == tflat.FlatIndex._MAX_POOL_BOOST


@pytest.mark.parametrize("dtype", ["int8x2", "bfloat16"])
def test_deep_path_and_scatter(monkeypatch, dtype):
    """A deep arena (past the shrunk threshold) searches by the chunked
    pool, in both packages at the same recall; a streamed row finds itself
    through the dirty-row scatter."""
    _shrink_deep(monkeypatch, thresh=1024, block=8192)
    x = clustered(n=16000, d=32, centers=32, spread=5e-2)
    q = x[:24] + 1e-3
    port, ref = (tflat.FlatIndex(32, "cosine", capacity=16000, storage_dtype=dtype,
                                 device="cpu"),
                 jflat.FlatIndex(32, "cosine", capacity=16000, storage_dtype=dtype))
    for idx in (port, ref):
        idx.add(np.arange(16000), x)
    assert port.capacity == ref.capacity == 16384
    calls = pool_calls(monkeypatch)
    # k=4: a pool of 64 (int8x2) or 32 candidates a chunk of 256 bins
    true = oracle(x, q, np.ones(16000, bool), 4, "cosine")
    _, pi = port.search(q, 4)
    _, ri = ref.search(q, 4)
    assert calls and recall(pi, true) >= recall(ri, true) - 0.01
    new = separable(n=1, d=32, seed=12)
    port.add([16100], new)
    assert port._dirty_rows and not port._needs_full_sync
    assert port.search(new, 1)[1][0, 0] == 16100
    assert port.state_arrays()["flat_meta"].tolist() == ref.state_arrays()["flat_meta"].tolist()


def test_audit_passes_clean_data(monkeypatch):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2048, 24)).astype(np.float32)
    idx = tflat.FlatIndex(24, "cosine", storage_dtype="int8", capacity=2048,
                          quant_guard=False, device="cpu")
    idx.add(np.arange(2048), x)
    report = idx.audit_and_escalate(bar=0.95, nq=32, k=10)
    assert not report["escalated"] and idx.storage_dtype == "int8"
    assert report["audited"][0]["recall"] >= 0.95


def test_audit_is_blocked_by_device_memory(monkeypatch):
    """A wider arena that would not fit the card is not built: the audit
    reports it and serving stays on the dtype it has."""
    x = outlier_scaled()
    idx = tflat.FlatIndex(32, "l2", storage_dtype="int8", capacity=4096,
                          quant_guard=False, device="cpu")
    idx.add(np.arange(4096), x)
    monkeypatch.setattr(idx, "_device_memory_limit", lambda: 4096 * 40)
    report = idx.audit_and_escalate(bar=0.95, nq=16, k=10)
    assert report["fit_blocked"] == "int8x2" and idx.storage_dtype == "int8"


# ------------------------------------------------------------ the store


@pytest.mark.parametrize("engine,dtype", [("flat-bf16", "bfloat16"),
                                          ("flat-int8", "int8"),
                                          ("flat-int8x2", "int8x2")])
def test_flat_engines_save_and_reopen_across_packages(tmp_path, engine, dtype):
    """The flat-* engines through each package's hub: a data directory
    written by one opens in the other with the same storage dtype and
    lists."""
    from embeddinghub_tpu.store.hub import EmbeddingHub as JaxHub
    from embeddinghub_tpu_torch.store.hub import EmbeddingHub

    x = separable(n=3000, d=32)
    keys = [f"k{j}" for j in range(3000)]
    port = EmbeddingHub.load_or_create(tmp_path / "p", engine=engine, device="cpu")
    pv = port.create_space("s", 32, "cosine").default_version()
    pv.multiset(zip(keys, x))
    assert pv.index.storage_dtype == dtype
    want = pv.nearest_batch(x[:8], 5)
    assert [r[0] for r in want] == keys[:8]
    port.save()
    jv = JaxHub.load_or_create(tmp_path / "p", engine=engine).get_version("s")
    assert jv.index.storage_dtype == dtype
    assert [r[0] for r in jv.nearest_batch(x[:8], 5)] == keys[:8]
    ref = JaxHub.load_or_create(tmp_path / "j", engine=engine)
    ref.create_space("s", 32, "cosine").default_version().multiset(zip(keys, x))
    ref.get_version("s").nearest_batch(x[:2], 5)
    ref.save()
    back = EmbeddingHub.load_or_create(tmp_path / "j", engine=engine, device="cpu")
    bv = back.get_version("s")
    assert bv.index.storage_dtype == dtype
    assert bv.nearest_batch(x[:8], 5) == pv.nearest_batch(x[:8], 5)


ENGINE_DTYPES = {"flat-bf16": "bfloat16", "flat-int8": "int8", "flat-int8x2": "int8x2"}


@pytest.mark.parametrize("engine", sorted(ENGINE_DTYPES))
def test_server_serves_flat_engines(engine):
    """The port's gRPC server with EMBEDDINGHUB_ENGINE set to a flat-*
    engine: MultiSet over the wire, a quantized index behind it, and
    BatchNearestNeighbor / NearestNeighbor answering as the store does."""
    pytest.importorskip("grpc")
    import grpc

    from embeddinghub_tpu_torch.service.server import build_server, pb, pb_grpc
    from embeddinghub_tpu_torch.utils.config import Config

    x = separable(n=3000, d=32, seed=21)
    server, service, port = build_server("127.0.0.1:0", "cpu", config=Config(engine=engine))
    server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        stub = pb_grpc.EmbeddingHubStub(channel)
        stub.CreateSpace(pb.CreateSpaceRequest(name="q", dims=32))
        reqs = []
        for j, v in enumerate(x):
            r = pb.MultiSetRequest(space="q", key=f"k{j}")
            r.embedding.values[:] = v.tolist()
            reqs.append(r)
        stub.MultiSet(iter(reqs))
        version = service._store.get_version("q")
        assert version.index.storage_dtype == ENGINE_DTYPES[engine]
        q = x[:12] + 0.01
        breq = pb.BatchNearestNeighborRequest(space="q", num=5)
        for v in q:
            breq.embeddings.add().values[:] = v.tolist()
        got = [list(r.keys) for r in stub.BatchNearestNeighbor(breq).results]
        assert got == version.nearest_batch(q, 5)
        assert [r[0] for r in got] == [f"k{j}" for j in range(12)]
        resp = stub.NearestNeighbor(pb.NearestNeighborRequest(space="q", key="k5", num=5))
        assert list(resp.keys) == version.nearest(5, key="k5") and "k5" not in resp.keys
    finally:
        channel.close()
        server.stop(0).wait()
        service.stop()


def test_make_immutable_runs_the_audit(monkeypatch):
    """EMBEDDINGHUB_QUANT_AUDIT=freeze: freezing a quantized version runs
    the measured audit, which escalates the containment regime."""
    from embeddinghub_tpu_torch.store.hub import EmbeddingHub
    from embeddinghub_tpu_torch.utils import config

    monkeypatch.setenv("EMBEDDINGHUB_QUANT_AUDIT", "freeze")
    monkeypatch.setenv("EMBEDDINGHUB_QUANT_AUDIT_BAR", "0.95")
    monkeypatch.setattr(config, "_config", None)
    assert config.get_config().quant_audit == "freeze"
    x = outlier_scaled()
    hub = EmbeddingHub.in_memory(engine="flat-int8x2", device="cpu")
    version = hub.create_space("s", 32, "l2").default_version()
    version.index.quant_guard = False
    version.multiset((f"k{j}", v) for j, v in enumerate(x))
    version.make_immutable()
    assert version.immutable and version.index.storage_dtype in ("bfloat16", "float32")
    flat = EmbeddingHub.in_memory(device="cpu").create_space("f", 32, "l2").default_version()
    assert flat.audit_quantization() == {"audited": [], "escalated": [],
                                         "fit_blocked": None}


# ---------------------------------------------------------- on the card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    D.full_f32()
    return torch.device("cuda")


def _card_pool_against_plain(i8, metric, b, cap, dims, k, seg, dead=0.0, rows=None,
                             empty_bins=False):
    """K2's pool on the card against its plain version on the same card
    inputs: the same ids and scores except between tied scores (int8: exact
    integer sums, the same order of operations; bf16: f32 sums in another
    order, ties 1e-3 wide).  ``rows``: the kernel scans only the live
    prefix below it (the rows past it dead, as never written; with none
    live it launches nothing), the plain version the whole arena.
    ``empty_bins``: every tile's second bin (rows 8j + 2 + h) dead."""
    dev = _cuda()
    g = torch.Generator(device="cpu").manual_seed(cap + b + k)
    x = torch.randn(cap, dims, generator=g) * (1 + 3 * torch.rand(cap, 1, generator=g))
    q = torch.randn(b, dims, generator=g)
    valid = torch.rand(cap, generator=g) >= dead
    if rows is not None:
        valid[rows:] = False
    if empty_bins:
        valid &= torch.arange(cap) % 8 // 2 != 1
    qf = D.normalize(q) if metric == "cosine" else q
    if i8:
        p = tflat.quantize_planes(x, metric, "int8")
        plane, sc = F.plane_i8(p["hi"].to(dev)), p["sc"].to(dev)
    else:
        p = tflat.quantize_planes(x, metric, "bfloat16")
        plane, sc = F.arena_bf16(p["hi"].float().to(dev)), None
    args = (qf.to(dev), plane, valid.to(dev), p["sq"].to(dev), sc)
    name = "fused_topk_search_v2_int8" if i8 else "fused_topk_search_v2"
    before = F.LAUNCHES[name]
    s, i = F.pool_candidates(*args, k=k, metric=metric, seg=seg, rows=rows)
    assert F.LAUNCHES[name] == before + (rows != 0)
    rs, ri = F.pool_candidates_reference(*args, k=k, metric=metric, seg=seg)
    torch.cuda.synchronize()
    s, i, rs, ri = (t.cpu() for t in (s, i, rs, ri))
    fin = torch.isfinite(rs)
    assert torch.equal(torch.isfinite(s), fin) and torch.equal(i >= 0, fin)
    tol = 0.0 if i8 else 1e-3
    np.testing.assert_allclose(s[fin].numpy(), rs[fin].numpy(), rtol=tol, atol=tol)
    ids = i.long()
    assert valid[ids[fin]].all()
    seg_of = torch.arange(s.shape[1])[None, :, None]
    assert ((ids // (seg or cap) == seg_of) | ~fin).all()
    bins = torch.where(fin, (ids // 128) * 4 + (ids % 8) // 2, -1).sort(dim=2).values
    assert not ((bins[..., 1:] == bins[..., :-1]) & (bins[..., 1:] >= 0)).any()
    # where an id differs, the plain formula scores that row as the plain
    # version scored its slot: ids differ only between tied scores
    swapped = (i != ri) & fin
    qb, rows = swapped.nonzero()[:, 0], ids[swapped]
    xs, x_sq = args[1].cpu()[rows, :dims].float(), p["sq"][rows]
    bias = x_sq if metric == "l2" else torch.zeros_like(x_sq)
    if i8:
        qq, qs = F.quantize_queries(qf, metric)
        score = bias - (qs[qb] * p["sc"][rows]) * (qq[qb, :dims].float() * xs).sum(1)
    else:
        dots = (qf[qb].bfloat16().float() * xs).sum(1)
        score = bias - 2.0 * dots if metric == "l2" else bias - dots
    assert ((score - rs[swapped]).abs() <= tol * torch.clamp(rs[swapped].abs(), min=1)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "cosine", "ip"])
@pytest.mark.parametrize("b", [1, 77, 300])
@pytest.mark.parametrize("cap,seg,k", [(50_001, None, 80), (65_536, 8192, 64),
                                       (300_000, None, 2048), (262_144, 65_536, 256)])
def test_card_int8_pool_matches_plain(metric, b, cap, seg, k):
    _card_pool_against_plain(True, metric, b, cap, 96, k, seg, dead=0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [8, 96, 128, 200, 300])
def test_card_int8_pool_widths(dims):
    _card_pool_against_plain(True, "l2", 130, 20_000, dims, 64, None)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("cap,seg,k", [(50_001, None, 80), (262_144, 65_536, 256)])
def test_card_bf16_pool_matches_plain(metric, cap, seg, k):
    _card_pool_against_plain(False, metric, 300, cap, 96, k, seg, dead=0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [96, 128, 200])
@pytest.mark.parametrize("b", [1, 8, 64, 65, 4096])
def test_card_int8_pool_live_prefix(b, dims):
    """The int8 pool over a live prefix of 30,001 of 65,536 rows: it ends
    mid-tile and mid-segment (segments of 8,192 rows), four segments lie
    wholly past it, and a tenth of the rows below it are dead; one box
    (D = 96, 128) and two (D = 200) a tile."""
    _card_pool_against_plain(True, "l2", b, 65_536, dims, 64, 8192, dead=0.1, rows=30_001)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [0, 127, 4_736, 30_001, 65_472])
@pytest.mark.parametrize("i8", [True, False])
def test_card_pool_live_rows(i8, rows):
    """Both pools at live prefixes of none, part of one tile, 37 tiles (on
    a tile's end, an odd count and not a multiple of the four tiles whose
    keys one TMA store writes), mid-segment and mid-way through the last
    tile, at B = 300 and 75 segments' worth of splits."""
    _card_pool_against_plain(i8, "cosine", 300, 65_536, 96, 80, 8192, dead=0.1, rows=rows)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [None, 30_001])
@pytest.mark.parametrize("i8", [True, False])
def test_card_pool_decodes_empty_bins(i8, rows):
    """The select's decode of a bin with no live row (a +inf key with a
    row) and of padding past a segment's bins: segments of 1,024 rows hold
    32 bins, 8 of them empty, and k = 40 takes all of them, so a wholly
    live segment's slots are 24 candidates, then 16 empty (+inf, -1)."""
    _card_pool_against_plain(i8, "l2", 65, 65_536, 96, 40, 1024, rows=rows, empty_bins=True)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2400, 4096])
@pytest.mark.parametrize("i8", [True, False])
def test_card_pool_three_select_passes(i8, k):
    """A capacity of 2**20 rows, 100,000 of them live, one segment: the
    select takes three passes (4 chunks, then 2, then 1), and the second
    writes more keys a query (4,800 or 8,192) than the live tiles have
    (3,128), into the key buffer sized for both."""
    _card_pool_against_plain(i8, "l2", 64, 1 << 20, 96, k, None, rows=100_000)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "int8x2", "bfloat16"])
def test_card_index_matches_cpu(dtype):
    """The same index on the card and on the CPU: the same guard decision,
    recall within 0.01, the deep path included."""
    _cuda()
    x = clustered(n=20000, d=96, centers=64, spread=5e-2)
    q = x[:64] + 1e-3
    true = oracle(x, q, np.ones(20000, bool), 10, "cosine")
    got = []
    for dev in ("cuda", "cpu"):
        idx = tflat.FlatIndex(96, "cosine", storage_dtype=dtype, device=dev)
        idx.add(np.arange(20000), x)
        got.append((idx.storage_dtype, recall(idx.search(q, 10)[1], true)))
    assert got[0][0] == got[1][0] and got[0][1] >= got[1][1] - 0.01, got
