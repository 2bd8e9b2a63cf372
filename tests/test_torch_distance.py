"""ops/distance.py of the port against the JAX package's, on the CPU.

Tolerance atol/rtol 1e-5: float32 on both sides (the JAX side at
Precision.HIGHEST), summed in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embeddinghub_tpu.ops import distance as jd
from embeddinghub_tpu_torch.ops import distance as td

TOL = dict(rtol=1e-5, atol=1e-5)


def _data(seed=0, b=7, n=33, d=12):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


def test_metrics_match():
    assert td.METRICS == jd.METRICS


def test_sqnorms_and_preprocess():
    _, x = _data()
    x[3] = 0.0  # the 1e-30 norm floor keeps an all-zero row at zero
    np.testing.assert_allclose(td.sqnorms(torch.from_numpy(x)).numpy(),
                               np.array(jd.sqnorms(jnp.asarray(x))), **TOL)
    for metric in td.METRICS:
        np.testing.assert_allclose(
            td.preprocess_vectors(torch.from_numpy(x), metric).numpy(),
            np.array(jd.preprocess_vectors(jnp.asarray(x), metric)), **TOL)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_pairwise_dist(metric, compute_dtype):
    q, x = _data(seed=1)
    xp = np.array(jd.preprocess_vectors(jnp.asarray(x), metric))
    want = np.array(jd.pairwise_dist(jnp.asarray(q), jnp.asarray(xp), metric,
                                       compute_dtype=compute_dtype))
    got = td.pairwise_dist(torch.from_numpy(q), torch.from_numpy(xp), metric,
                           compute_dtype=compute_dtype).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("fn", ["pairwise_l2", "pairwise_ip", "pairwise_cosine"])
def test_pairwise_functions(fn):
    q, x = _data(seed=2)
    want = np.asarray(getattr(jd, fn)(jnp.asarray(q), jnp.asarray(x)))
    got = getattr(td, fn)(torch.from_numpy(q), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_unknown_metric_raises():
    q, x = _data()
    with pytest.raises(ValueError):
        td.pairwise_dist(torch.from_numpy(q), torch.from_numpy(x), "hamming")
