"""ops/beam.py and ops/wave_insert.make_graph_search of the port against the
JAX package's, on the CPU, on the same inputs (numpy seeds): a 12-NN graph
over 4,000 rows of 32 dims, as ``tests/test_beam.py`` builds it.

Pass condition of every walk: the same hop count; ids equal on at least
99.5 % of (query, rank) entries, the others only at near-ties (neighbouring
distances within 1e-5 relative); distances within rtol 1e-5 / atol 1e-5.
The two sides differ only in the summation order of f32 products, so
"relative" is to the larger of the distance and the terms it is summed
from (``_torch_parity.walk_terms``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embeddinghub_tpu.ops import beam as jbeam
from embeddinghub_tpu.ops import wave_insert as jwave
from embeddinghub_tpu_torch.ops import beam as tbeam
from embeddinghub_tpu_torch.ops import wave_insert as twave
from _torch_parity import assert_walks_match, walk_terms

N, DIM, M, B = 4000, 32, 12, 64


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((N, DIM)).astype(np.float32)
    full = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(full, np.inf)
    nb = np.argsort(full, axis=1)[:, :M].astype(np.int32)
    q = x[:B] + 0.01 * rng.standard_normal((B, DIM)).astype(np.float32)
    q[B // 2:] = rng.standard_normal((B - B // 2, DIM)).astype(np.float32)
    valid = rng.random(N) > 0.05
    # an upper layer: every 8th row, linked to its 8 nearest such rows
    up = np.arange(0, N, 8)
    sub = full[np.ix_(up, up)]
    upper = np.full((1, N, 8), -1, np.int32)
    upper[0, up] = up[np.argsort(sub, axis=1)[:, :8]]
    return x, nb, q, valid, upper


def _prep(x, metric):
    if metric == "cosine":
        return x / np.linalg.norm(x, axis=1, keepdims=True)
    return x


def _inputs(graph, metric):
    x, nb, q, valid, upper = graph
    x = _prep(x, metric)
    return x, (x * x).sum(1).astype(np.float32), nb, q, valid, upper


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_augment_arena(graph, metric, dtype):
    x, x_sq, _, _, valid, _ = _inputs(graph, metric)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = jbeam.augment_arena(jx, jnp.asarray(x_sq), jnp.asarray(valid), metric)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tbeam.augment_arena(tx, *_t(x_sq, valid), metric)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_pack_neighbors(graph):
    x, _, nb, _, _, _ = _inputs(graph, "l2")
    nb = nb.copy()
    nb[::7, -2:] = -1  # missing neighbors pack as zeros
    jp, js = jbeam.pack_neighbors(jnp.asarray(x), jnp.asarray(nb), chunk=1024)
    tp, ts = tbeam.pack_neighbors(*_t(x, nb), chunk=1000)
    assert tp.dtype == torch.int8 and tp.shape == (N, M * DIM)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert float(ts) == float(js)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("fused", [False, True])
def test_greedy_descend(graph, metric, fused):
    x, x_sq, _, q, valid, upper = _inputs(graph, metric)
    entry = np.full((B,), 8 * 37, np.int32)
    if fused:
        xa_j = jbeam.augment_arena(jnp.asarray(x).astype(jnp.bfloat16),
                                   jnp.asarray(x_sq), jnp.asarray(valid), metric)
        xa_t = tbeam.augment_arena(torch.from_numpy(x).to(torch.bfloat16),
                                   *_t(x_sq, valid), metric)
        jargs, targs = (xa_j, None), (xa_t, None)
    else:
        jargs, targs = _j(x, x_sq), _t(x, x_sq)
    want = jbeam.greedy_descend(*_j(q, entry, upper[0]), *jargs, metric=metric)
    got = tbeam.greedy_descend(*_t(q, entry, upper[0]), *targs, metric=metric)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (metric, mode, knobs): the walk's arena and its schedule knobs
BEAM_CASES = [
    ("l2", "classic", dict(ef=64, expand=4)),
    ("l2", "classic", dict(ef=64, expand=4, spec=2)),
    ("l2", "classic", dict(ef=96, expand=4, exit_k=10)),
    ("l2", "classic", dict(ef=48, expand=8, spec=2, exit_k=8)),
    ("l2", "seeds", dict(ef=64, expand=4)),
    ("l2", "seeds", dict(ef=64, expand=4, spec=2)),
    ("l2", "fused", dict(ef=64, expand=8)),
    ("l2", "fused32", dict(ef=64, expand=8)),
    ("l2", "packed", dict(ef=64, expand=8)),
    ("ip", "classic", dict(ef=64, expand=4)),
    ("ip", "fused", dict(ef=64, expand=8, spec=2)),
    ("cosine", "classic", dict(ef=64, expand=4)),
    ("cosine", "fused", dict(ef=64, expand=8)),
    ("cosine", "packed", dict(ef=32, expand=4, exit_k=10)),
]


def _walk_args(pkg, x, x_sq, valid, nb, metric, mode):
    """(x, x_sq, valid, extra kwargs) of one package's beam_search."""
    beam = jbeam if pkg == "jax" else tbeam
    wrap = _j if pkg == "jax" else _t
    xv, sqv, vv, nbv = wrap(x, x_sq, valid, nb)
    if mode in ("classic", "seeds"):
        return xv, sqv, vv, {}
    if pkg == "jax":
        xw = xv.astype(jnp.float32 if mode == "fused32" else jnp.bfloat16)
    else:
        xw = xv.to(torch.float32 if mode == "fused32" else torch.bfloat16)
    xa = beam.augment_arena(xw, sqv, vv, metric)
    extra = {}
    if mode == "packed":
        extra["packed"], extra["dscale"] = beam.pack_neighbors(xv, nbv)
    return xa, None, None, extra


@pytest.mark.parametrize("metric,mode,knobs", BEAM_CASES,
                         ids=[f"{m}-{mo}-{'-'.join(f'{k}{v}' for k, v in kn.items())}"
                              for m, mo, kn in BEAM_CASES])
def test_beam_search(graph, metric, mode, knobs):
    x, x_sq, nb, q, valid, _ = _inputs(graph, metric)
    if mode == "seeds":
        # 3 seeds a query: a duplicate and a -1 pad are masked
        entry = np.stack([np.full(B, 5), (np.arange(B) * 61) % N,
                          np.full(B, 5)], axis=1).astype(np.int32)
        entry[::4, 2] = -1
    else:
        entry = np.zeros((B,), np.int32)
    out = {}
    for pkg, beam, wrap in (("jax", jbeam, _j), ("torch", tbeam, _t)):
        xa, sq, vv, extra = _walk_args(pkg, x, x_sq, valid, nb, metric, mode)
        qv, ev, nbv = wrap(q, entry, nb)
        out[pkg] = beam.beam_search(qv, ev, nbv, xa, sq, vv, metric=metric,
                                    with_hops=True, **knobs, **extra)
    jd, ji, jh = out["jax"]
    td, ti, th = out["torch"]
    assert th == int(jh), (th, int(jh))
    assert_walks_match(jd, ji, td, ti, walk_terms(q, x, metric))


def _route(x):
    rng = np.random.default_rng(11)
    cent = x[rng.choice(N, 16, replace=False)] + 0.1
    medoids = rng.choice(N, 16, replace=False).astype(np.int32)
    medoids[3] = -1  # a cluster with no live medoid
    return cent.astype(np.float32), (cent * cent).sum(1).astype(np.float32), medoids


# (metric, seed_probes, rerank_k, packed, fused arena)
GRAPH_CASES = [
    ("l2", 0, 0, False, False),
    ("l2", 0, 16, False, True),
    ("l2", 4, 0, False, False),
    ("l2", 4, 16, False, True),
    ("l2", 0, 16, True, True),
    ("ip", 0, 8, False, True),
    ("cosine", 3, 16, False, True),
    ("cosine", 0, 0, False, False),
]


@pytest.mark.parametrize("metric,seeds,rerank,packed,fused", GRAPH_CASES)
def test_make_graph_search(graph, metric, seeds, rerank, packed, fused):
    x, x_sq, nb, q, valid, upper = _inputs(graph, metric)
    q = _prep(q, metric)  # HNSWIndex.search passes prepped queries
    route = _route(x) if seeds else ()
    out = {}
    for pkg, wave, wrap in (("jax", jwave, _j), ("torch", twave, _t)):
        gs = wave.make_graph_search(metric=metric, ef=64, expand=8, max_hops=192,
                                    seed_probes=seeds, rerank_k=rerank,
                                    packed=packed)
        xa, sq, vv, extra = _walk_args(pkg, x, x_sq, valid, nb, metric,
                                       "packed" if packed else
                                       "fused" if fused else "classic")
        xv, sqv, valv, qv, nbv, upv = wrap(x, x_sq, valid, q, nb, upper)
        head = (qv, 8 * 37, *wrap(*route))
        if packed:
            res = gs(*head, nbv, upv, xa, extra["packed"], extra["dscale"],
                     xv, sqv, valv)
        elif fused:
            res = gs(*head, nbv, upv, xa, None, None, xv, sqv)
        else:
            res = gs(*head, nbv, upv, xv, sqv, valv)
        out[pkg] = res
    jd, ji = out["jax"]
    td, ti, hops = out["torch"]
    assert hops > 0
    assert td.shape == (B, rerank or 64)
    assert_walks_match(jd, ji, td, ti, walk_terms(q, x, metric))
