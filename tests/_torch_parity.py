"""Helpers shared by the tests that hold the PyTorch port against the JAX
package (tests/test_torch_*.py)."""

import numpy as np


def assert_ids_equal_off_ties(got, want, want_d, gap):
    """Row ids equal position by position, except where the reference
    distance at that position is within ``gap`` of a neighbour's (a near
    tie, which the two summation orders may break either way)."""
    got, want, want_d = np.asarray(got), np.asarray(want), np.asarray(want_d)
    assert got.shape == want.shape, (got.shape, want.shape)
    with np.errstate(invalid="ignore"):
        diff = np.abs(np.diff(want_d, axis=1)) <= gap
    near = np.zeros(want.shape, bool)
    near[:, 1:] |= diff
    near[:, :-1] |= diff
    bad = (got != want) & ~near
    assert not bad.any(), (
        f"{int(bad.sum())} ids differ off near-ties, first at "
        f"{np.argwhere(bad)[0].tolist()}: {got[bad][:5]} vs {want[bad][:5]}")


def walk_terms(q, x, metric):
    """``[B, 1]``: the size of the terms a graph walk sums each query's
    distances from, |q|^2 + max |x|^2 for l2 and |q| max |x| otherwise
    (cosine: unit rows).  An l2 distance near 0 between rows of norm^2 32
    carries f32 steps of 4e-6 from both terms."""
    if metric == "cosine":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
    qn = np.linalg.norm(q, axis=1, keepdims=True)
    xn = np.linalg.norm(x, axis=1).max()
    return qn * qn + xn * xn if metric == "l2" else qn * xn


def assert_walks_match(want_d, want_i, got_d, got_i, terms):
    """Two graph walks' ``(dist, ids)`` on the same inputs: the same +inf
    slots; distances within 1e-5 of the larger of the distance and its
    ``terms`` (plus 1e-5); ids equal on at least 99.5 % of entries and
    elsewhere only at near-ties of that size."""
    jd, ji = np.asarray(want_d), np.asarray(want_i).astype(np.int64)
    td, ti = np.asarray(got_d), np.asarray(got_i).astype(np.int64)
    assert ti.shape == ji.shape, (ti.shape, ji.shape)
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td), fin)
    gap = 1e-5 * np.maximum(np.abs(np.where(fin, jd, 0)), terms)
    err = np.abs(np.where(fin, td, 0) - np.where(fin, jd, 0))
    assert (err <= gap + 1e-5).all(), (err - gap).max()
    same = ti == ji
    assert same.mean() >= 0.995, same.mean()
    with np.errstate(invalid="ignore"):
        tie = np.abs(np.diff(jd, axis=1)) <= gap[:, 1:]
    near = np.zeros(jd.shape, bool)
    near[:, 1:] |= tie
    near[:, :-1] |= tie
    assert not (~same & ~near).any(), np.argwhere(~same & ~near)[:5]
