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
