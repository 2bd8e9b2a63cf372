"""The plain versions of K1/K2 (ops/fused_topk.py of the port) against the
JAX package's Pallas kernels in interpret mode, on the CPU, and each CUDA
kernel against its plain version on the card (marked ``cuda``).

Tolerances: K1 distances 1e-5 (f32 on both sides, different summation
order); K2 scores 1e-3 (bf16-rounded operands on both sides, f32 sums in
different orders).  Ids must be equal except at near-ties of the same size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embeddinghub_tpu.ops import pallas_topk as jp
from embeddinghub_tpu_torch.ops import _build
from embeddinghub_tpu_torch.ops import distance as D
from embeddinghub_tpu_torch.ops import fused_topk as F
from _torch_parity import assert_ids_equal_off_ties


def _arena(seed, n, d, b, metric, dead_every=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    if metric == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    valid = np.ones(n, bool)
    valid[::dead_every] = False
    return q, x, valid, (x * x).sum(1)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _mirrored(q, x, valid, xsq):
    """K2's inputs: the arena as its bf16 mirror."""
    return [q, F.arena_bf16(x), valid, xsq]


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("exact", [True, False])
def test_k1_plain_matches_pallas(metric, exact):
    q, x, valid, xsq = _arena(0, 512, 32, 16, metric)
    jd, ji = jp.fused_topk_search(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid), jnp.asarray(xsq),
        k=8, metric=metric, chunk=128, block_b=16, interpret=True, exact=exact)
    td, ti = F.fused_topk_search(*_t(q, x, valid, xsq), k=8, metric=metric,
                                 chunk=128, block_b=16, exact=exact)
    tol = 1e-5 if exact else 1e-3
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=tol, atol=tol)
    assert_ids_equal_off_ties(ti.numpy(), np.asarray(ji), np.asarray(jd), tol)
    assert ti.dtype == torch.int32 and td.dtype == torch.float32
    assert not np.isin(ti.numpy(), np.flatnonzero(~valid)).any()


def test_k1_k_exceeds_live_rows():
    q, x, valid, xsq = _arena(1, 128, 8, 8, "l2")
    valid[:] = False
    valid[:3] = True
    jd, ji = jp.fused_topk_search(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid), jnp.asarray(xsq),
        k=8, metric="l2", chunk=128, block_b=8, interpret=True)
    td, ti = F.fused_topk_search(*_t(q, x, valid, xsq), k=8, chunk=128, block_b=8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    assert (ti.numpy()[:, 3:] == -1).all() and np.isinf(td.numpy()[:, 3:]).all()


@pytest.mark.parametrize("fn,kw", [
    (F.fused_topk_search, dict(chunk=64, block_b=8)),          # cap % chunk
    (F.fused_topk_search, dict(chunk=50, block_b=16)),         # B % block_b
    (F.fused_topk_search_v2, dict(chunk=100, block_b=8)),      # chunk % 128
    (F.fused_topk_search_v2, dict(chunk=256, block_b=8)),      # cap % chunk
])
def test_alignment_contract(fn, kw):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((100, 8)).astype(np.float32))
    arena = x.T if fn is F.fused_topk_search_v2 else x
    with pytest.raises(ValueError):
        fn(x[:8], arena, torch.ones(100, dtype=torch.bool), torch.zeros(100), k=4, **kw)


@pytest.mark.parametrize("fn,limit", [(F.exact_topk, F.MAX_K_EXACT),
                                      (F.approx_candidates, F.MAX_K_APPROX)])
def test_k_limit(fn, limit):
    """K1 serves k up to 1024 (a server ``num`` can be large) and K2 up to
    256; beyond that the wrapper raises before any dispatch."""
    q, x, valid, xsq = _arena(3, 2048, 4, 2, "l2")
    args = _t(q, x, valid, xsq)
    if fn is F.approx_candidates:
        args = _mirrored(*args)
    d, i = fn(*args, k=limit, metric="l2")
    assert d.shape == (2, limit)
    for bad in (0, limit + 1):
        with pytest.raises(ValueError):
            fn(*args, k=bad, metric="l2")


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_k2_plain_matches_pallas(metric):
    q, x, valid, xsq = _arena(4, 1024, 32, 16, metric)
    jd, ji = jp.fused_topk_search_v2(
        jnp.asarray(q), jnp.asarray(x.T), jnp.asarray(valid), jnp.asarray(xsq),
        k=8, metric=metric, chunk=256, block_b=16, interpret=True)
    td, ti = F.fused_topk_search_v2(*_t(q, x.T, valid, xsq), k=8, metric=metric,
                                    chunk=256, block_b=16)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-3, atol=1e-3)
    assert_ids_equal_off_ties(ti.numpy(), np.asarray(ji), np.asarray(jd), 1e-3)
    assert not np.isin(ti.numpy(), np.flatnonzero(~valid)).any()
    # one candidate per 128-row group
    ids = ti.numpy()
    for row in ids:
        live = row[row >= 0]
        assert len(set(live // F.GROUP)) == len(live)


def test_k2_plain_bf16_arena_matches_pallas():
    rng = np.random.default_rng(5)
    n, d, b, k = 512, 16, 8, 4
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = x[:b] + 0.01 * rng.standard_normal((b, d)).astype(np.float32)
    xsq = (x * x).sum(1)
    jd, ji = jp.fused_topk_search_v2(
        jnp.asarray(q), jnp.asarray(x.T).astype(jnp.bfloat16), jnp.ones(n, bool),
        jnp.asarray(xsq), k=k, metric="l2", chunk=128, block_b=8, interpret=True)
    xt = torch.from_numpy(np.ascontiguousarray(x.T)).to(torch.bfloat16)
    td, ti = F.fused_topk_search_v2(torch.from_numpy(q), xt, torch.ones(n, dtype=torch.bool),
                                    torch.from_numpy(xsq), k=k, metric="l2",
                                    chunk=128, block_b=8)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-3, atol=1e-3)
    assert_ids_equal_off_ties(ti.numpy(), np.asarray(ji), np.asarray(jd), 1e-3)
    assert (ti.numpy()[:, 0] == np.arange(b)).all()


def test_plain_versions_mask_ragged_edges():
    """The index entries take any cap and B: rows past a ragged 128-group
    edge are masked, not read.  Chunked and unchunked runs agree."""
    q, x, valid, xsq = _arena(6, 300, 8, 5, "l2")
    args = _t(q, x, valid, xsq)
    for fn, a in ((F.fused_topk_search_reference, args),
                  (F.fused_topk_search_v2_reference, _mirrored(*args))):
        d1, i1 = fn(*a, k=6, metric="l2", chunk=128)
        d2, i2 = fn(*a, k=6, metric="l2", chunk=4096)
        np.testing.assert_array_equal(i1.numpy(), i2.numpy())
        np.testing.assert_allclose(d1.numpy(), d2.numpy(), rtol=1e-5, atol=1e-5)
        assert (i1.numpy() < 300).all()


def test_cpu_tensors_never_launch():
    F.reset_launches()
    q, x, valid, xsq = _arena(7, 256, 8, 4, "ip")
    F.exact_topk(*_t(q, x, valid, xsq), k=4, metric="ip")
    F.approx_candidates(*_mirrored(*_t(q, x, valid, xsq)), k=2, metric="ip")
    F.exact_topk_large_k(*_t(q, x, valid, xsq), k=200, metric="ip")
    assert F.LAUNCHES == {"fused_topk_search": 0, "fused_topk_search_v2": 0,
                          "fused_topk_search_large_k": 0}


def test_mirror_pads_to_whole_boxes():
    """The bf16 mirror: rows rounded to nearest even, widths to whole
    64-column TMA boxes, the padding zero."""
    x = torch.from_numpy(np.random.default_rng(15).standard_normal((5, 100)).astype(np.float32))
    xb = F.arena_bf16(x)
    assert xb.dtype == torch.bfloat16 and xb.shape == (5, 128) == (5, F.mirror_dims(100))
    assert torch.equal(xb[:, :100], x.to(torch.bfloat16)) and not xb[:, 100:].any()
    assert [F.mirror_dims(d) for d in (1, 64, 65, 128, 600)] == [64, 64, 128, 128, 640]


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_large_k_plain_matches_pallas(metric):
    """K1's large-k route has the Pallas K1 for its reference, which has no
    k limit; k is past the live rows, so the tail is empty."""
    q, x, valid, xsq = _arena(10, 512, 16, 8, metric)
    jd, ji = jp.fused_topk_search(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid), jnp.asarray(xsq),
        k=500, metric=metric, chunk=256, block_b=8, interpret=True)
    td, ti = F.exact_topk_large_k(*_t(q, x, valid, xsq), k=500, metric=metric)
    jd, ji = np.asarray(jd), np.asarray(ji)
    fin = np.isfinite(jd)
    np.testing.assert_allclose(td.numpy()[fin], jd[fin], rtol=1e-5, atol=1e-5)
    assert_ids_equal_off_ties(ti.numpy(), np.where(fin, ji, -1), jd, 1e-5)
    live = int(valid.sum())
    assert (ti.numpy()[:, live:] == -1).all() and np.isinf(td.numpy()[:, live:]).all()
    with pytest.raises(ValueError):
        F.exact_topk_large_k(*_t(q, x, valid, xsq), k=513, metric=metric)


# ------------------------------------------------------------ on the card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    D.full_f32()  # the plain versions' products in full f32
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("k", [1, 16, 1024])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("b", [1, 300])
def test_k1_kernel_matches_plain(metric, k, exact, b):
    """Ragged shapes (cap not a multiple of 128, D not of 32, B not of 64).
    ``exact=False`` runs the bf16-operand instantiation: 1e-3, as K2."""
    dev = _cuda()
    q, x, valid, xsq = (t.to(dev) for t in _t(*_arena(8, 50_001, 100, b, metric)))
    before = F.LAUNCHES["fused_topk_search"]
    d, i = F.exact_topk(q, x, valid, xsq, k=k, metric=metric, exact=exact)
    assert F.LAUNCHES["fused_topk_search"] == before + 1
    rd, ri = F.fused_topk_search_reference(q, x, valid, xsq, k=k, metric=metric,
                                           exact=exact)
    torch.cuda.synchronize()
    rtol, atol = (1e-5, 1e-4) if exact else (1e-3, 1e-3)
    np.testing.assert_allclose(d.cpu().numpy(), rd.cpu().numpy(), rtol=rtol, atol=atol)
    assert_ids_equal_off_ties(i.cpu().numpy(), ri.cpu().numpy(), rd.cpu().numpy(), atol)


def _k2_scores(q, xb, xsq, ids, metric):
    """The plain version's distance of each named row (bf16 operands, f32
    sums), +inf where no row is named."""
    q = F._prep_query(q, metric)
    rows = xb[ids.clamp(min=0).long(), :q.shape[1]].float()
    dots = torch.einsum("bkd,bd->bk", rows, D.round_bf16(q))
    if metric == "l2":
        d = torch.clamp(xsq[ids.clamp(min=0).long()] - 2 * dots
                        + D.sqnorms(q)[:, None], min=0)
    else:
        d = 1 - dots
    return torch.where(ids >= 0, d, float("inf"))


def _k2_against_plain(q, x, valid, xsq, k, metric):
    """K2 on the card against its plain version: distances within 1e-3;
    ids equal, or where they differ (two rows of one group, or the last
    slot and the next candidate, that tie within the sums' rounding), the
    kernel's row scores within the 1e-3 tie gap of the plain version's at
    that position, plus f32's own 1e-5 of the distance."""
    dev = _cuda()
    q, xb, valid, xsq = (t.to(dev) for t in _mirrored(*_t(q, x, valid, xsq)))
    before = F.LAUNCHES["fused_topk_search_v2"]
    d, i = F.approx_candidates(q, xb, valid, xsq, k=k, metric=metric)
    assert F.LAUNCHES["fused_topk_search_v2"] == before + 1
    rd, ri = F.fused_topk_search_v2_reference(q, xb, valid, xsq, k=k, metric=metric)
    torch.cuda.synchronize()
    np.testing.assert_allclose(d.cpu().numpy(), rd.cpu().numpy(), rtol=1e-3, atol=1e-3)
    swaps = i != ri
    off = (_k2_scores(q, xb, xsq, i, metric) - rd).abs() - 1e-5 * rd.abs()
    assert bool((off[swaps] <= 1e-3).all()), (
        f"{int(swaps.sum())} ids differ, worst gap {float(off[swaps].max())}")
    i = i.cpu().numpy()
    live = i[i >= 0]
    assert valid.cpu().numpy()[live].all()
    for row in i:  # one candidate per group
        assert len(set(row[row >= 0] // F.GROUP)) == (row >= 0).sum()
    return d.cpu().numpy(), i


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("k", [1, 16, 128, 256])
@pytest.mark.parametrize("b", [1, 63, 300, 4096])
@pytest.mark.parametrize("cap", [50_001, 131_072])
@pytest.mark.parametrize("dims", [100, 128])
def test_k2_kernel_matches_plain(metric, k, b, cap, dims):
    """Ragged and whole shapes: cap not a multiple of 128, D not of 64
    (the mirror's padding), B not of 64 or 128; k up to K2's limit."""
    _k2_against_plain(*_arena(9, cap, dims, b, metric), k, metric)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [7, 150, 300, 600])
def test_k2_kernel_narrow_and_wide_rows(dims):
    """Every kind of scan: queries in registers one box wide (D=7) and
    three (D=150); both operands from shared memory (D=300, 5 boxes); and
    a width whose query tile does not fit beside the ring and streams with
    each box (D=600, a tile of 10 boxes through a ring of 6 stages)."""
    _k2_against_plain(*_arena(12, 20_000, dims, 200, "l2"), 64, "l2")


@pytest.mark.cuda
def test_k2_kernel_dead_groups():
    """Groups with no live row give no candidate: an arena whose every row
    is dead comes back all empty, and one with every third group dead
    never names a row of those groups."""
    q, x, valid, xsq = _arena(13, 50_001, 128, 70, "cosine")
    valid[:] = False
    d, i = _k2_against_plain(q, x, valid, xsq, 16, "cosine")
    assert (i == -1).all() and np.isinf(d).all()
    valid[:] = True
    dead = (np.arange(len(valid)) // F.GROUP) % 3 == 0
    valid[dead] = False
    d, i = _k2_against_plain(q, x, valid, xsq, 256, "cosine")
    assert (i >= 0).all() and not dead[i].any()


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("k", [1025, 4096, 50_001])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("b", [1, 300])
def test_large_k_kernel_matches_plain(metric, k, exact, b):
    """K1's large-k route on ragged shapes, up to k = cap (past the live
    rows: the tail is empty)."""
    dev = _cuda()
    q, x, valid, xsq = (t.to(dev) for t in _t(*_arena(8, 50_001, 100, b, metric)))
    before = F.LAUNCHES["fused_topk_search_large_k"]
    d, i = F.exact_topk_large_k(q, x, valid, xsq, k=k, metric=metric, exact=exact)
    assert F.LAUNCHES["fused_topk_search_large_k"] == before + 1
    rd, ri = F.fused_topk_search_large_k_reference(q, x, valid, xsq, k=k, metric=metric,
                                                   exact=exact)
    torch.cuda.synchronize()
    rtol, atol = (1e-5, 1e-4) if exact else (1e-3, 1e-3)
    rd, ri = rd.cpu().numpy(), ri.cpu().numpy()
    np.testing.assert_allclose(d.cpu().numpy(), rd, rtol=rtol, atol=atol)
    assert_ids_equal_off_ties(i.cpu().numpy(), ri, rd, atol)


@pytest.mark.cuda
def test_large_k_kernel_breaks_score_ties_by_row():
    """Every row duplicated 4 times: the k-th score ties, the row digits
    decide, and the lower rows come first, in order."""
    dev = _cuda()
    q, x, valid, xsq = _arena(11, 2500, 20, 3, "l2")
    x = np.repeat(x[:625], 4, axis=0)
    xsq = (x * x).sum(1)
    args = [t.to(dev) for t in _t(q, x, valid, xsq)]
    d, i = F.exact_topk_large_k(*args, k=1030, metric="l2")
    rd, _ = F.fused_topk_search_large_k_reference(*args, k=1030, metric="l2")
    d, i = d.cpu().numpy(), i.cpu().numpy()
    np.testing.assert_allclose(d, rd.cpu().numpy(), rtol=1e-5, atol=1e-4)
    for row_d, row_i in zip(d, i):
        order = np.lexsort((row_i, row_d))
        np.testing.assert_array_equal(order, np.arange(len(row_i)))
        assert valid[row_i].all() and len(set(row_i)) == len(row_i)


def test_other_devices_raise_instead_of_falling_back():
    """Only CPU tensors take the plain versions; any other device must
    launch a kernel or raise."""
    args = [torch.empty((2, 8), device="meta"), torch.empty((128, 8), device="meta"),
            torch.empty(128, dtype=torch.bool, device="meta"),
            torch.empty(128, device="meta")]
    for fn in (F.exact_topk, F.approx_candidates, F.exact_topk_large_k):
        with pytest.raises(RuntimeError, match="expected cpu or cuda"):
            fn(*args, k=4, metric="l2")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """The kernel library is built from the checkout's sources at first
    use; without nvcc that is an error, never a silent plain path."""
    assert _build.library_path().parent.name == "_build"
    assert _build.library_path() == _build.library_path()  # keyed by content
    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / "lib.so")
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not list(tmp_path.glob("*.so"))
