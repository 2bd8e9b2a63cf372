"""Batched pairwise distances: the twin of ``embeddinghub_tpu/ops/distance.py``.

Same conventions as the reference:

  * ``l2``     -> squared L2, ``||x||^2 - 2 q.x + ||q||^2`` clamped at 0;
  * ``ip``     -> ``1 - q.x``;
  * ``cosine`` -> ``1 - cos(q, x)``: index rows are normalized once, at
    sync (:func:`preprocess_vectors`), queries at query time.

Precision: every float32 product here runs in full f32.  On CUDA that
means TF32 off, the twin of ``_dot`` at ``Precision.HIGHEST``
(``distance.py:33-47`` of the reference), where the TPU would otherwise
truncate operands to bf16.  The switch is process-wide in PyTorch, so it is
set once, where the device is chosen: :func:`full_f32` is called by
``EmbeddingHub`` when its device is CUDA, and by scripts that call these
functions on the card without a hub.  The search path itself does not
depend on it: K1 and K2 never use TF32, and the rerank multiplies
elementwise.  ``compute_dtype="bfloat16"`` rounds both operands to bf16 and
still accumulates in f32, like the reference's native bf16 path.
"""

from __future__ import annotations

import torch

METRICS = ("l2", "ip", "cosine")


def full_f32() -> None:
    """Keep float32 matrix products in full f32 (no TF32) on CUDA.  Process
    wide; call it once, where the device is chosen."""
    torch.backends.cuda.matmul.allow_tf32 = False


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back: bf16 operand bits, f32 arithmetic."""
    return t.to(torch.bfloat16).to(torch.float32)


def is_bf16(compute_dtype) -> bool:
    return compute_dtype in ("bfloat16", torch.bfloat16)


def _dot(q: torch.Tensor, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``[B, D] @ [N, D]^T`` with f32 accumulation."""
    q, x = q.float(), x.float()
    if is_bf16(compute_dtype):
        q, x = round_bf16(q), round_bf16(x)
    return q @ x.T


def sqnorms(x: torch.Tensor) -> torch.Tensor:
    """Row squared norms ``||x_i||^2`` of an ``[N, D]`` matrix -> ``[N]``."""
    return torch.einsum("nd,nd->n", x, x)


def normalize(x: torch.Tensor) -> torch.Tensor:
    """Unit rows; an all-zero row stays zero (norm floored at 1e-30)."""
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-30)


def preprocess_vectors(x: torch.Tensor, metric: str) -> torch.Tensor:
    """Ingest-time normalization: cosine indexes store unit rows so the
    query-time kernel is a plain dot product."""
    return normalize(x) if metric == "cosine" else x


def pairwise_l2(q, x, x_sq=None, *, compute_dtype="float32") -> torch.Tensor:
    """Squared-L2 distances ``[B, N]``, including the ``||q||^2`` term."""
    if x_sq is None:
        x_sq = sqnorms(x)
    d = x_sq[None, :] - 2.0 * _dot(q, x, compute_dtype) + sqnorms(q)[:, None]
    return torch.clamp(d, min=0.0)


def pairwise_ip(q, x, *, compute_dtype="float32") -> torch.Tensor:
    """Inner-product distance ``1 - q.x`` -> ``[B, N]``."""
    return 1.0 - _dot(q, x, compute_dtype)


def pairwise_cosine(q, x_unit, *, compute_dtype="float32") -> torch.Tensor:
    """Cosine distance ``1 - cos`` against pre-normalized rows."""
    return pairwise_ip(normalize(q), x_unit, compute_dtype=compute_dtype)


def pairwise_dist(q, x, metric: str, x_sq=None, *, compute_dtype="float32"):
    """Metric-dispatching batched distance; ``x`` must already be
    preprocessed for the metric (cosine -> unit rows)."""
    if metric == "l2":
        return pairwise_l2(q, x, x_sq, compute_dtype=compute_dtype)
    if metric == "ip":
        return pairwise_ip(q, x, compute_dtype=compute_dtype)
    if metric == "cosine":
        return pairwise_cosine(q, x, compute_dtype=compute_dtype)
    raise ValueError(f"unknown metric {metric!r}; expected one of {METRICS}")
