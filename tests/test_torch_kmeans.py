"""The port's k-means (``embeddinghub_tpu_torch/ops/kmeans.py``) against the
JAX package's (``embeddinghub_tpu/ops/kmeans.py``), on the CPU, on the same
numpy inputs: well-separated Gaussian blobs, so that no bf16 near-tie
decides an argmax.

Tolerances: ``fit_kmeans`` centroids within atol 1e-4 (f32 segment sums in
another order); ``assign_clusters`` and ``probe_order`` equal;
``boundary_margins`` within rtol 1e-3 (and atol 1e-3 for margins near 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from embeddinghub_tpu.ops import kmeans as jkm
from embeddinghub_tpu_torch.ops import kmeans as tkm

D, BLOBS = 16, 24


def _blobs(seed, n, d=D, blobs=BLOBS):
    rng = np.random.default_rng(seed)
    centers = 20.0 * rng.standard_normal((blobs, d))
    lab = rng.integers(0, blobs, n)
    return (centers[lab] + rng.standard_normal((n, d))).astype(np.float32)


def _fit(x, k, **kw):
    want = np.asarray(jkm.fit_kmeans(jnp.asarray(x), k, **kw))
    got = tkm.fit_kmeans(torch.from_numpy(x), k, **kw)
    return want, got


@pytest.mark.parametrize("n,k,sample,limit", [
    (3000, 16, 1 << 18, None),   # every row fits the sample
    (5000, 32, 2048, None),      # a sampled fit: the same rows drawn
    (4096, 16, 1 << 18, 3500),   # padded arena: the first `limit` rows
])
def test_fit_kmeans_centroids_match(n, k, sample, limit):
    x = _blobs(n, n)
    want, got = _fit(x, k, iters=8, seed=11, sample=sample, limit=limit)
    assert got.shape == (k, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_empty_cluster_keeps_its_centroid():
    """Two far blobs and k=4 from the same row picks: clusters that lose
    every row keep their centroid in both packages."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.standard_normal((600, D)) - 50.0,
                        rng.standard_normal((600, D)) + 50.0]).astype(np.float32)
    x[1:4] = x[0] + 1e-3 * rng.standard_normal((3, D)).astype(np.float32)
    want, got = _fit(x, 8, iters=4, seed=5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("chunk", [1 << 16, 512])
def test_assign_clusters_and_probe_order_equal(chunk):
    x = _blobs(7, 4000)
    cent = np.array(jkm.fit_kmeans(jnp.asarray(x), 32, seed=11))
    want = jkm.assign_clusters(jnp.asarray(x), jnp.asarray(cent), chunk=chunk)
    got = tkm.assign_clusters(torch.from_numpy(x), torch.from_numpy(cent), chunk=chunk)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tkm.probe_order(torch.from_numpy(cent)),
                                  jkm.probe_order(jnp.asarray(cent)))


@pytest.mark.parametrize("probes_n", [1, 4])
def test_boundary_margins_match(probes_n):
    x = _blobs(9, 3000)
    cent = np.array(jkm.fit_kmeans(jnp.asarray(x), 16, seed=11))
    assign = jkm.assign_clusters(jnp.asarray(x), jnp.asarray(cent))
    probes = jkm.probe_order(jnp.asarray(cent))[:, :probes_n]
    want = jkm.boundary_margins(jnp.asarray(x), jnp.asarray(cent), assign, probes)
    got = tkm.boundary_margins(torch.from_numpy(x), torch.from_numpy(cent), assign,
                               probes, chunk=1000)
    assert got.shape == (3000,)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    # the repair's pick: the rows of the smallest margins
    pick = lambda m: set(np.argsort(m, kind="stable")[:300].tolist())
    assert len(pick(got) & pick(want)) >= 297
