"""Fused distance + running top-k: the counterpart of
``embeddinghub_tpu/ops/pallas_topk.py``.

Two kernels, both hand-written CUDA in ``csrc/fused_topk.cu``:

  * K1, :func:`fused_topk_search` -- exact k-NN.  The port's exact engine:
    ``chunked_topk_search`` on CUDA is K1.
  * K2, :func:`fused_topk_search_v2` -- approximate candidates, one bf16
    winner per group of 128 consecutive rows, then a running top-k over
    the winners.  The candidate stage of ``approx_oversample_search``.

Neither writes the ``[B, cap]`` score matrix to device memory, which is the
point: ``q @ x.T`` then ``torch.topk`` would write 16 GB at 1M rows and
B=4096.

The public functions keep the JAX signatures and their ``ValueError``
alignment contract, so tests compare like with like; ``chunk`` and
``block_b`` are checked, not used, because the CUDA kernels choose their own
tiling.  The index calls :func:`exact_topk` and :func:`approx_candidates`
instead: they take the row-major ``[cap, D]`` arena and any ``B`` and mask
the ragged edges themselves, so the port keeps no transposed copy of the
arena and pads nothing.

Dispatch is by device.  Tensors on the CPU go to the plain PyTorch versions
(``*_reference``), which compute the same function; tensors on a CUDA
device launch the kernel, or raise.  Nothing falls back.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from embeddinghub_tpu_torch.ops import _build
from embeddinghub_tpu_torch.ops import distance as D

INF = float("inf")
GROUP = 128            # K2's group width, the oracle's in the parity tests
MAX_K_EXACT = 1024     # K1; a server ``num`` can be large
MAX_K_APPROX = 256     # K2; the main path asks for k * 8 = 128
_MERGE_SLOTS = 16384   # splits * k entries sorted per query by the merge pass
_BQ, _BN = 64, 128     # the scan kernel's query and row tile (fused_topk.cu)
# Scan blocks to aim for, per SM.  Measured on an H100 over B = 1..4096
# (K1 k=16, K2 k=128, 1M rows), 2 was the best of 1, 2, 4 and 8, or
# within 3 % of it, at every B; tools/sweep_splits.py reruns the sweep,
# merge sizes included.
# More splits mean more list fills (k=128 takes most group winners of a
# short slice) and longer merges.
_BLOCKS_PER_SM = 2

_launch_lock = threading.Lock()
LAUNCHES = {"fused_topk_search": 0, "fused_topk_search_v2": 0}


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


# ------------------------------------------------------------- public API


def fused_topk_search(q, x, valid, x_sq, *, k=16, metric="l2", chunk=2048,
                      block_b=256, exact=True):
    """Exact k-NN (K1): ``q [B, D]``, ``x [cap, D]``, ``valid [cap]``,
    ``x_sq [cap]`` -> ``(dist [B, k] f32, ids [B, k] int32)``.  ``cap`` must
    be a ``chunk`` multiple and ``B`` a ``block_b`` multiple, as in the
    reference."""
    b, cap = q.shape[0], x.shape[0]
    if cap % chunk or b % block_b:
        raise ValueError(f"shape not aligned: cap={cap} chunk={chunk} B={b}")
    return exact_topk(q, x, valid, x_sq, k=k, metric=metric, exact=exact)


def fused_topk_search_v2(q, xt, valid, x_sq, *, k=16, metric="l2",
                         chunk=8192, block_b=1024):
    """Approximate candidates (K2) from a pre-transposed ``xt [D, cap]``
    arena, f32 or bf16.  Scores are bf16-graded; rerank downstream for
    exact distances."""
    b, cap = q.shape[0], xt.shape[1]
    if cap % chunk or b % block_b or chunk % GROUP:
        raise ValueError(f"shape not aligned: cap={cap} chunk={chunk} B={b}")
    x = xt.T.to(torch.float32).contiguous()
    return approx_candidates(q, x, valid, x_sq, k=k, metric=metric)


# -------------------------------------------------------- index entries


def exact_topk(q, x, valid, x_sq, *, k, metric, exact=True):
    """K1 over a row-major arena, any ``B`` and ``cap``."""
    _check_k(k, MAX_K_EXACT)
    if x.device.type == "cpu":
        return fused_topk_search_reference(q, x, valid, x_sq, k=k,
                                           metric=metric, exact=exact)
    return _launch("fused_topk_search", q, x, valid, x_sq, k, metric, exact)


def approx_candidates(q, x, valid, x_sq, *, k, metric):
    """K2 over a row-major arena, any ``B`` and ``cap``."""
    _check_k(k, MAX_K_APPROX)
    if x.device.type == "cpu":
        return fused_topk_search_v2_reference(q, x, valid, x_sq, k=k,
                                              metric=metric)
    return _launch("fused_topk_search_v2", q, x, valid, x_sq, k, metric, False)


def _check_k(k: int, limit: int) -> None:
    if not 1 <= k <= limit:
        raise ValueError(f"k={k} outside [1, {limit}]")


def _prep_query(q: torch.Tensor, metric: str) -> torch.Tensor:
    q = q.to(torch.float32)
    return D.normalize(q) if metric == "cosine" else q


def _epilogue(best_s, best_i, q, metric):
    """Scores -> distances, as ``pallas_topk.py:187-192``."""
    hit = torch.isfinite(best_s) & (best_i >= 0)
    if metric == "l2":
        d = torch.clamp(best_s + D.sqnorms(q)[:, None], min=0.0)
    else:
        d = 1.0 + best_s  # the score was -dot
    return (torch.where(hit, d, INF),
            torch.where(hit, best_i, -1).to(torch.int32))


# ------------------------------------------------------------ the kernels


def _launch(name, q, x, valid, x_sq, k, metric, exact):
    if metric not in D.METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    dev = x.device
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: tensors on {dev}; expected cpu or cuda")
    b, dims = q.shape
    cap = x.shape[0]
    for t, what, dtype, shape in (
        (x, "x", torch.float32, (cap, dims)),
        (valid, "valid", torch.bool, (cap,)),
        (x_sq, "x_sq", torch.float32, (cap,)),
    ):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} must be {dtype} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if q.device != dev:
        raise ValueError(f"{name}: queries on {q.device}, arena on {dev}")
    q = _prep_query(q, metric).contiguous()
    if b == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=dev),
                torch.empty((0, k), dtype=torch.int32, device=dev))

    n_tiles = -(-cap // _BN)
    q_tiles = -(-b // _BQ)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = max(1, min(-(-_BLOCKS_PER_SM * sms // q_tiles), n_tiles,
                        _MERGE_SLOTS // k))
    per_split = -(-n_tiles // splits)
    splits = -(-n_tiles // per_split)
    slots = 1 << max(0, (splits * k - 1).bit_length())

    pd = torch.empty((b, splits, k), dtype=torch.float32, device=dev)
    pi = torch.empty((b, splits, k), dtype=torch.int32, device=dev)
    od = torch.empty((b, k), dtype=torch.float32, device=dev)
    oi = torch.empty((b, k), dtype=torch.int32, device=dev)
    lib = _build.library()
    ptrs = [t.data_ptr() for t in (q, x, valid, x_sq, pd, pi, od, oi)]
    ints = [b, cap, dims, k, int(metric == "l2")]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if name == "fused_topk_search":
            err = lib.ehtorch_fused_topk(
                *ptrs, *ints, int(exact), splits, per_split, slots,
                ctypes.c_void_p(stream))
        else:
            err = lib.ehtorch_fused_topk_v2(
                *ptrs, *ints, splits, per_split, slots, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    _count(name)
    return od, oi


# ------------------------------------------------------ plain versions


def merge_topk(d1, i1, d2, i2, k):
    """Merge two (dist, idx) candidate sets rowwise into the best k."""
    d = torch.cat([d1, d2], dim=1)
    i = torch.cat([i1, i2], dim=1)
    d, pos = torch.topk(d, k, dim=1, largest=False)
    return d, torch.gather(i, 1, pos)


def fused_topk_search_reference(q, x, valid, x_sq, *, k=16, metric="l2",
                                exact=True, chunk=65536):
    """Plain PyTorch K1 over a row-major arena: chunked ``q @ x.T`` plus a
    running ``torch.topk`` merge.  Materializes ``[B, chunk]`` scores."""
    q = _prep_query(q, metric)
    qc = q if exact else D.round_bf16(q)
    b, cap = q.shape[0], x.shape[0]
    best_s = torch.full((b, k), INF, dtype=torch.float32, device=q.device)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=q.device)
    for s in range(0, cap, chunk):
        xs = x[s:s + chunk].to(torch.float32)
        dots = qc @ (xs if exact else D.round_bf16(xs)).T
        sc = x_sq[s:s + chunk][None, :] - 2.0 * dots if metric == "l2" else -dots
        sc = torch.where(valid[s:s + chunk][None, :], sc, INF)
        cs, ci = torch.topk(sc, min(k, sc.shape[1]), dim=1, largest=False)
        best_s, best_i = merge_topk(best_s, best_i, cs, ci + s, k)
    return _epilogue(best_s, best_i, q, metric)


def fused_topk_search_v2_reference(q, x, valid, x_sq, *, k=16, metric="l2",
                                   chunk=65536):
    """Plain PyTorch K2 over a row-major arena: bf16-rounded operands, f32
    sums, the (min, first argmin) of each 128-row group, then a running
    top-k over the group winners.  ``chunk`` must be a multiple of 128."""
    q = _prep_query(q, metric)
    qc = D.round_bf16(q)
    b, cap = q.shape[0], x.shape[0]
    best_s = torch.full((b, k), INF, dtype=torch.float32, device=q.device)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=q.device)
    for s in range(0, cap, chunk):
        xs = D.round_bf16(x[s:s + chunk].to(torch.float32))
        dots = qc @ xs.T
        sc = x_sq[s:s + chunk][None, :] - 2.0 * dots if metric == "l2" else -dots
        sc = torch.where(valid[s:s + chunk][None, :], sc, INF)
        ragged = -sc.shape[1] % GROUP
        if ragged:
            sc = torch.nn.functional.pad(sc, (0, ragged), value=INF)
        gm, ga = sc.view(b, -1, GROUP).min(dim=2)  # first index among ties
        gid = s + torch.arange(gm.shape[1], device=q.device) * GROUP + ga
        cs, pos = torch.topk(gm, min(k, gm.shape[1]), dim=1, largest=False)
        best_s, best_i = merge_topk(best_s, best_i, cs, torch.gather(gid, 1, pos), k)
    return _epilogue(best_s, best_i, q, metric)
