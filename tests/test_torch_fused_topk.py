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


def _tile_d128(b):
    """k1_scan.cu pick_nq at D = 128: the narrowest of 8 .. 128 that holds
    B (a query tile of 128 fits beside the ring with both operand types)."""
    return min(128, max(8, 1 << (b - 1).bit_length()))


def test_k1_route_by_shape():
    """``exact_topk``'s route on the card, from the shape: running lists up
    to ``MAX_K_LISTS`` (past k = 32 in query tiles of 64 or 128 only), the
    large-k route past it, below such tiles, and past ``LARGE_K_FROM`` over
    at most ``LARGE_K_ROWS`` rows a k whose ``[B, cap]`` scores fit its
    buffer.  Of ``chip_smoke.py``'s K1 shapes (D = 128), the routed pools
    (k=257 over 32,768 rows: B=4096 and both remainders) and a sharded
    graph's build pool (k=256 over a shard's 65,536 rows) take the large-k
    route; the graph, wave, refine and repair pools (k=200 and 256 over
    250,000 to 4M rows), a graph shard's wave pool (k=200 over 66,560
    rows), the upper-layer pools (k=64) and every k=16 shape keep lists."""
    import chip_smoke as C

    routes = {(b, k, cap): F.k1_route(k, b, cap, _tile_d128(b))
              for name, _, b, k, _, cap, _ in C.KERNEL_CASES if name == "fused_topk_search"}
    large = {(C.FLUSH, C.ROUTED_K, C.ROUTED_S),
             *((b, C.ROUTED_K, C.ROUTED_S) for b, _ in C.ROUTED_TAILS),
             (C.GRAPH_POOL_B, C.GRAPH_POOL_K, C.SHARD_GRAPH_CAP)}
    assert large <= set(routes)
    assert {s for s, r in routes.items() if r == "large_k"} == large
    assert [F.k1_route(k, 64, 1000, 64) for k in (1, 32, 33, 128, 129, 512, 513, 1024)] == (
        ["lists"] * 4 + ["large_k"] * 4)
    # past LARGE_K_ROWS rows a k, or scores past the buffer: lists up to MAX_K_LISTS
    many = F.LARGE_K_ROWS * 200 + 1
    assert [F.k1_route(200, b, many, 128) for b in (64, 4096)] == ["lists"] * 2
    assert [F.k1_route(k, 2 ** 16, 2 ** 15, 128) for k in (129, 512, 513)] == ["lists"] * 2 + [
        "large_k"]
    # query tiles under 64 (B <= 32, or rows too wide): lists for k <= 32 only
    assert [F.k1_route(k, 32, many, nq) for k, nq in ((32, 32), (33, 32), (33, 8), (33, 64))] == [
        "lists", "large_k", "large_k", "lists"]
    assert F.MAX_K_LISTS < F.MAX_K_EXACT


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
    # K2's candidate pools: the int8 instantiation and the bf16 scan
    qt, xt, vt, st = _t(q, x, valid, xsq)
    hi = torch.clamp(torch.round(xt * 20), -127, 127).to(torch.int8)
    F.pool_candidates(qt, hi, vt, st, torch.full_like(st, 0.05), k=3, metric="ip")
    F.pool_candidates(qt, F.arena_bf16(xt), vt, st, k=3, metric="ip")
    assert F.LAUNCHES == {"fused_topk_search": 0, "fused_topk_search_v2": 0,
                          "fused_topk_search_large_k": 0, "fused_topk_search_v2_int8": 0}


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


# ------------------------------------------- the compensated TF32 product


def split_tf32(v):
    """``(big, small)`` of f32 ``v`` as K1's kernel splits it: ``big`` is
    ``v`` rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero: ``cvt.rna.tf32.f32``) and ``small`` the rest rounded the same way,
    both f32 with 13 zero low bits.  ``big + small`` keeps 22 bits of ``v``."""
    def rna(a):
        return ((a.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    big = rna(v.to(torch.float32))
    return big, rna(v - big)


def tf32x3_product(q, x):
    """``q @ x.T`` as K1's kernel takes it, emulated in f32: each operand
    split by :func:`split_tf32`, ``big.small + small.big + big.big`` with
    the small terms first.  Every factor is exact in TF32, so this shows
    what the split drops (not how the tensor cores sum)."""
    qb, qs = split_tf32(q)
    xb, xs = split_tf32(x)
    return (qb @ xs.T + qs @ xb.T) + qb @ xb.T


def test_split_tf32_keeps_22_bits():
    """big + small is within 2^-21 |v| of v, and both parts have 13 zero
    low mantissa bits: normal, tiny, negative and zero values."""
    rng = np.random.default_rng(20)
    v = np.concatenate([
        rng.standard_normal(4096), rng.standard_normal(1024) * 1e-30,
        -np.abs(rng.standard_normal(1024)) * 1e4, rng.standard_normal(1024) * 1e20,
        [0.0, -0.0, 1.0, -1.0, 1.0 + 2.0 ** -11, 3.0 - 2.0 ** -22]]).astype(np.float32)
    big, small = split_tf32(torch.from_numpy(v))
    for part in (big, small):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = (big.double() + small.double() - torch.from_numpy(v).double()).abs()
    assert bool((err <= 2.0 ** -21 * torch.from_numpy(np.abs(v)).double()).all())
    assert bool((big[v == 0] == 0).all() and (small[v == 0] == 0).all())
    # to nearest: big is within half a TF32 step of v
    assert bool(((big.double() - torch.from_numpy(v).double()).abs()
                 <= 2.0 ** -11 * torch.from_numpy(np.abs(v)).double()).all())


@pytest.mark.parametrize("dims", [7, 128, 600])
@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_tf32x3_product_is_f32_grade(dims, metric):
    """The three-pass product against a float64 product on N(0, 1) data
    (unit rows and queries for cosine): at most 4x the error of the f32
    ``torch.matmul``, and its scores inside rtol 1e-5, atol 1e-4 of the f32
    ones; one TF32 pass alone is far outside."""
    q, x, _, xsq = _t(*_arena(21, 20_000, dims, 256, metric))
    if metric == "cosine":
        q = D.normalize(q)
    truth = q.double() @ x.double().T
    f32 = q @ x.T
    three = tf32x3_product(q, x)
    err_f32 = float((f32.double() - truth).abs().max())
    err_three = float((three.double() - truth).abs().max())
    assert err_three <= 4 * err_f32, (err_three, err_f32)
    one = split_tf32(q)[0] @ split_tf32(x)[0].T
    assert float((one.double() - truth).abs().max()) > 20 * err_three

    def scores(dots):
        return xsq[None, :] - 2.0 * dots if metric == "l2" else -dots
    np.testing.assert_allclose(scores(three).numpy(), scores(f32).numpy(),
                               rtol=1e-5, atol=1e-4)


def test_tf32_one_pass_is_exact_for_bf16_operands():
    """A bf16 value is exact in TF32: its small part is zero, so
    ``exact=False`` is one pass, equal to the f32 product of the rounded
    operands up to summation order."""
    q, x, _, _ = _t(*_arena(22, 4096, 128, 64, "l2"))
    qr, xr = D.round_bf16(q), D.round_bf16(x)
    (qb, qs), (xb, xs) = split_tf32(qr), split_tf32(xr)
    assert torch.equal(qb, qr) and torch.equal(xb, xr)
    assert not qs.any() and not xs.any()
    np.testing.assert_allclose((qb @ xb.T).numpy(), (qr @ xr.T).numpy(), rtol=1e-6,
                               atol=1e-6 * float((qr @ xr.T).abs().max()))


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_k1_through_tf32x3_matches_pallas(metric):
    """K1 with the emulated three-pass product names the rows the Pallas K1
    (HIGHEST) names, on the parity data of test_k1_plain_matches_pallas."""
    q, x, valid, xsq = _arena(0, 512, 32, 16, metric)
    jd, ji = jp.fused_topk_search(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid), jnp.asarray(xsq),
        k=8, metric=metric, chunk=128, block_b=16, interpret=True, exact=True)
    tq, tx, tvalid, txsq = _t(q, x, valid, xsq)
    tq = F._prep_query(tq, metric)
    dots = tf32x3_product(tq, tx)
    scores = txsq[None, :] - 2.0 * dots if metric == "l2" else -dots
    best_s, best_i = torch.topk(torch.where(tvalid[None, :], scores, F.INF), 8, dim=1,
                                largest=False)
    td, ti = F._epilogue(best_s, best_i, tq, metric)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    assert_ids_equal_off_ties(ti.numpy(), np.asarray(ji), np.asarray(jd), 1e-5)


def test_arena_f32_pads_rows_to_16_bytes():
    """K1's arena on the card: rows a multiple of 4 floats apart; an arena
    that already is comes back as it is, any other as a view of a padded
    buffer with the same values."""
    rng = np.random.default_rng(23)
    for dims, stride in ((7, 8), (150, 152), (128, 128), (100, 100)):
        x = torch.from_numpy(rng.standard_normal((9, dims)).astype(np.float32))
        a = F.arena_f32(x)
        assert a.shape == x.shape and a.stride() == (stride, 1) and torch.equal(a, x)
        assert (a is x) == (dims % 4 == 0)
        assert F.arena_f32(a) is a


# ------------------------------------------------------------ on the card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    D.full_f32()  # the plain versions' products in full f32
    return torch.device("cuda")


_CARD_ARENA = {}


def _card_arena(cap, dims, metric):
    """The card's copy of a seeded arena with 4096 queries, the last one
    made kept (the grids below vary the arena slowest): f32 rows as
    ``arena_f32`` leaves them."""
    key = (cap, dims, metric)
    if key not in _CARD_ARENA:
        _CARD_ARENA.clear()
        q, x, valid, xsq = (t.to("cuda") for t in _t(*_arena(8, cap, dims, 4096, metric)))
        _CARD_ARENA[key] = (q, F.arena_f32(x), valid, xsq)
    return _CARD_ARENA[key]


def _k1_scores(q, x, xsq, qi, rows, metric, bf16):
    """The plain version's distance of row ``rows[j]`` from query
    ``qi[j]``."""
    q = F._prep_query(q, metric)
    xr, qc = x[rows], q[qi]
    if bf16:
        qc, xr = D.round_bf16(qc), D.round_bf16(xr)
    dots = (xr * qc).sum(1)
    if metric == "l2":
        return torch.clamp(xsq[rows] - 2 * dots + D.sqnorms(q)[qi], min=0)
    return 1 - dots


# What f32 resolves: an l2 distance d is a sum of three f32 terms of about
# its size (the row's and the query's squared norm and the product), each
# rounded to a step of 2^-23 d or half of it, and a product q.x is a sum of
# terms that add up to |q||x| in size, far above an ip distance itself at
# D = 600.  The kernel and the plain version take these roundings at
# different low bits.  Two rows closer than a few steps of the larger of
# the two sizes are a tie to f32 however the product is summed.
_F32_STEPS = 4 * 2.0 ** -23


def _k1_against_plain(route, q, x, valid, xsq, k, metric, exact, strict=False):
    """K1 (or its large-k route) on the card against its plain version:
    f32 operands 1e-5 of the distance + 1e-4, bf16 operands 1e-3, as K2.
    Ids: where they differ, the kernel's row must score (in the plain
    version's arithmetic) within the tie gap (1e-4, bf16 operands 1e-3) of
    the plain version's row at that position, plus ``_F32_STEPS`` of the
    distance or of |q||x|.  ``strict``: moreover ids equal wherever the
    plain version's distance is not within the tie gap of a neighbour's,
    with no term for any size."""
    name, fn, plain = {
        "k1": ("fused_topk_search", F.exact_topk, F.fused_topk_search_reference),
        "large_k": ("fused_topk_search_large_k", F.exact_topk_large_k,
                    F.fused_topk_search_large_k_reference)}[route]
    b, dims = q.shape
    if route == "k1" and F.k1_route(k, b, x.shape[0], F.k1_tile(b, dims, exact)) == "large_k":
        name = "fused_topk_search_large_k"  # exact_topk's route for this shape
    before = F.LAUNCHES[name]
    d, i = fn(q, x, valid, xsq, k=k, metric=metric, exact=exact)
    assert F.LAUNCHES[name] == before + 1
    rd, ri = plain(q, x, valid, xsq, k=k, metric=metric, exact=exact)
    torch.cuda.synchronize()
    rtol, atol = (1e-5, 1e-4) if exact else (1e-3, 1e-3)
    assert torch.equal(torch.isfinite(d), torch.isfinite(rd))
    swaps = i != ri
    if swaps.any():
        qi = swaps.nonzero()[:, 0]
        want = rd[swaps]
        rows = i[swaps].long()
        got = _k1_scores(q, x, xsq, qi, rows, metric, not exact)
        size = torch.maximum(want.abs(),
                             F._prep_query(q, metric).norm(dim=1)[qi] * xsq[rows].sqrt())
        off = (got - want).abs() - _F32_STEPS * size
        assert bool((off <= atol).all()), (
            f"{int(swaps.sum())} ids differ, worst gap {float(off.max())}")
    d, i, rd, ri = (t.cpu().numpy() for t in (d, i, rd, ri))
    np.testing.assert_allclose(d, rd, rtol=rtol, atol=atol)
    if strict:
        assert_ids_equal_off_ties(i, ri, rd, atol)
    assert valid.cpu().numpy()[i[i >= 0]].all()
    return d, i


def _strict(dims, cap, b):
    """The shapes held to ids equal off near-ties of the tie gap alone."""
    return dims == 100 and cap == 50_001 and b in (1, 300)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 9, 63, 300, 4096])
@pytest.mark.parametrize("k", [1, 16, 1024])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("cap", [50_001, 131_072])
@pytest.mark.parametrize("dims", [7, 100, 128, 150, 300, 600])
def test_k1_kernel_matches_plain(metric, k, exact, b, cap, dims):
    """Ragged and whole shapes: cap not a multiple of 128, D not of 32 nor
    of 4 (padded rows), every query-tile width (B = 1 .. 4096) and rows wide
    enough to narrow it; ``exact=False`` runs the one-pass bf16-operand
    instantiation."""
    _cuda()
    q, x, valid, xsq = _card_arena(cap, dims, metric)
    _k1_against_plain("k1", q[:b], x, valid, xsq, k, metric, exact,
                      strict=_strict(dims, cap, b))


@pytest.mark.cuda
def test_k1_kernel_dead_tiles_and_few_live_rows():
    """Whole 128-row tiles of dead rows never give a candidate, and k above
    the live rows leaves the tail empty."""
    dev = _cuda()
    q, x, valid, xsq = _arena(13, 50_001, 128, 70, "cosine")
    dead = (np.arange(len(valid)) // 128) % 3 == 0
    valid[dead] = False
    args = [t.to(dev) for t in _t(q, x, valid, xsq)]
    d, i = _k1_against_plain("k1", *args, 64, "cosine", True)
    assert (i >= 0).all() and not dead[i].any()
    valid[:] = False
    valid[[5, 700, 40_000]] = True
    args = [t.to(dev) for t in _t(q, x, valid, xsq)]
    d, i = _k1_against_plain("k1", *args, 16, "cosine", True)
    assert (np.sort(i[:, :3], axis=1) == [5, 700, 40_000]).all()
    assert (i[:, 3:] == -1).all() and np.isinf(d[:, 3:]).all()
    valid[:] = False
    args = [t.to(dev) for t in _t(q, x, valid, xsq)]
    d, i = _k1_against_plain("k1", *args, 16, "cosine", True)
    assert (i == -1).all() and np.isinf(d).all()


@pytest.mark.cuda
@pytest.mark.parametrize("route,k", [("k1", 16), ("large_k", 1100)])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("dims", [2_400, 3_072, 4_096, 5_000])
def test_k1_kernel_widest_rows(dims, exact, route, k):
    """Rows too wide for the scan block's shared memory even at 8 queries a
    block are walked in chunks: any width is served.  2,400 still fits whole
    with f32 operands, 3,072 and 4,096 take two chunks and 5,000 (not a
    multiple of 32, an odd count of boxes) three; with bf16 operands all
    fit whole but the large-k route's 5,000, which takes two."""
    dev = _cuda()
    q, x, valid, xsq = (t.to(dev) for t in _t(*_arena(15, 3_000, dims, 20, "l2")))
    _k1_against_plain(route, q, x, valid, xsq, k, "l2", exact)


@pytest.mark.cuda
def test_k1_kernel_asks_for_padded_rows():
    """An arena whose rows are not a multiple of 16 bytes apart raises on
    the card, through the index entry and the public one alike: no entry
    makes a second copy of the arena."""
    dev = _cuda()
    q, x, valid, xsq = (t.to(dev) for t in _t(*_arena(16, 2_048, 150, 16, "l2")))
    with pytest.raises(ValueError, match="arena_f32"):
        F.exact_topk(q, x, valid, xsq, k=8, metric="l2")
    with pytest.raises(ValueError, match="arena_f32"):
        F.fused_topk_search(q, x, valid, xsq, k=8, metric="l2", chunk=2_048, block_b=16)
    d, i = F.fused_topk_search(q, F.arena_f32(x), valid, xsq, k=8, metric="l2",
                               chunk=2_048, block_b=16)
    rd, ri = F.fused_topk_search_reference(q, x, valid, xsq, k=8, metric="l2")
    np.testing.assert_allclose(d.cpu().numpy(), rd.cpu().numpy(), rtol=1e-5, atol=1e-4)
    assert_ids_equal_off_ties(i.cpu().numpy(), ri.cpu().numpy(), rd.cpu().numpy(), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4, 6, 16])
def test_k1_kernel_breaks_score_ties_by_row(k):
    """64 rows copied eight times over: equal scores across four tiles and
    across both halves of each, and the lower row always wins."""
    dev = _cuda()
    q, x, valid, xsq = _arena(14, 512, 24, 40, "l2")
    valid[:] = True
    for c in range(1, 8):
        x[64 * c:64 * (c + 1)] = x[:64]
    xsq = (x * x).sum(1)
    args = [t.to(dev) for t in _t(q, x, valid, xsq)]
    d, i = F.exact_topk(*args, k=k, metric="l2")
    rd, ri = F.fused_topk_search_reference(*args, k=k, metric="l2")
    d, i = d.cpu().numpy(), i.cpu().numpy()
    np.testing.assert_allclose(d, rd.cpu().numpy(), rtol=1e-5, atol=1e-4)
    # copies of one row score bit for bit the same: the order is (score, row)
    for row_d, row_i in zip(d, i):
        np.testing.assert_array_equal(np.lexsort((row_i, row_d)), np.arange(k))
        assert len(set(row_i)) == k
    # the copies of the nearest row r < 64 are r, r + 64, r + 128, .. in order
    near = i[:, :min(k, 8)]
    assert (near == near[:, :1] + 64 * np.arange(near.shape[1])).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [37, 1024, 4096])
@pytest.mark.parametrize("k", [64, 200, 256, 257])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("live", ["all", "tail", "few"])
@pytest.mark.parametrize("route", ["lists", "by_shape"])
def test_k1_kernel_long_lists_match_plain(monkeypatch, route, live, exact, k, b):
    """K1's sorted long lists (k > 32) at the graph pools' widths and at a
    batch narrower than a query tile, over 32,768 l2 rows: every row live;
    a live prefix of 20,000 and a dead tail (the routed pools' -1 rows);
    and fewer live rows than k, which leaves the tail of every list
    empty.  ``lists`` keeps the lists at every k here (these scores would
    fit the large-k route's buffer); ``by_shape`` takes ``k1_route``'s
    route."""
    dev = _cuda()
    if route == "lists":
        monkeypatch.setattr(F, "LARGE_K_FROM", F.MAX_K_LISTS)
    q, x, valid, xsq = _arena(17, 32_768, 128, b, "l2")
    valid[:] = {"all": True, "tail": np.arange(len(valid)) < 20_000,
                "few": np.arange(len(valid)) % 331 == 7}[live]
    args = [t.to(dev) for t in _t(q, x, valid, xsq)]
    d, i = _k1_against_plain("k1", *args, k, "l2", exact)
    n_live = int(valid.sum())
    assert (i[:, :min(k, n_live)] >= 0).all()
    if n_live < k:
        assert (i[:, n_live:] == -1).all() and np.isinf(d[:, n_live:]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 200, 256, 257])
@pytest.mark.parametrize("route", ["lists", "by_shape"])
def test_k1_kernel_long_lists_break_score_ties_by_row(monkeypatch, route, k):
    """64 rows copied 40 times over 2,560 rows: equal scores in every tile,
    and the long lists keep the lower row first, whatever order the
    candidates reach a list in (``route`` as in
    ``test_k1_kernel_long_lists_match_plain``)."""
    dev = _cuda()
    if route == "lists":
        monkeypatch.setattr(F, "LARGE_K_FROM", F.MAX_K_LISTS)
    q, x, valid, xsq = _arena(18, 2_560, 24, 300, "l2")
    valid[:] = True
    for c in range(1, 40):
        x[64 * c:64 * (c + 1)] = x[:64]
    xsq = (x * x).sum(1)
    args = [t.to(dev) for t in _t(q, x, valid, xsq)]
    for exact in (True, False):
        d, i = F.exact_topk(*args, k=k, metric="l2", exact=exact)
        rd, ri = F.fused_topk_search_reference(*args, k=k, metric="l2", exact=exact)
        d, i = d.cpu().numpy(), i.cpu().numpy()
        tol = 1e-5 if exact else 1e-3
        np.testing.assert_allclose(d, rd.cpu().numpy(), rtol=tol, atol=10 * tol)
        for row_d, row_i in zip(d, i):
            np.testing.assert_array_equal(np.lexsort((row_i, row_d)), np.arange(k))
            assert len(set(row_i)) == k
        # the 40 copies of the nearest row r < 64 are r, r + 64, .. in order
        near = i[:, :40]
        assert (near == near[:, :1] + 64 * np.arange(40)).all()


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
@pytest.mark.parametrize("b", [1, 9, 63, 300, 4096])
@pytest.mark.parametrize("k", [1025, 4096])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("cap", [50_001, 131_072])
@pytest.mark.parametrize("dims", [7, 100, 128, 150, 300, 600])
def test_large_k_kernel_matches_plain(metric, k, exact, b, cap, dims):
    """K1's large-k route on K1's grid of shapes."""
    _cuda()
    q, x, valid, xsq = _card_arena(cap, dims, metric)
    _k1_against_plain("large_k", q[:b], x, valid, xsq, k, metric, exact,
                      strict=_strict(dims, cap, b))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 300])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_large_k_kernel_k_up_to_capacity(metric, exact, b):
    """k = cap, past the live rows: the tail is empty."""
    _cuda()
    q, x, valid, xsq = _card_arena(50_001, 100, metric)
    d, i = _k1_against_plain("large_k", q[:b], x, valid, xsq, 50_001, metric, exact,
                             strict=True)
    live = int(valid.sum())
    assert (i[:, live:] == -1).all() and np.isinf(d[:, live:]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_large_k_kernel_dead_tiles(metric):
    """An arena whose every third tile is dead never names a row of those
    tiles."""
    _cuda()
    q, x, valid, xsq = _card_arena(50_001, 100, metric)
    dead = (torch.arange(50_001, device="cuda") // 128) % 3 == 0
    d, i = _k1_against_plain("large_k", q[:20], x, valid & ~dead, xsq, 2000, metric, True,
                             strict=True)
    assert (i >= 0).all() and not dead.cpu().numpy()[i].any()


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
