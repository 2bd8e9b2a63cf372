"""Fused distance + top-k: the counterpart of
``embeddinghub_tpu/ops/pallas_topk.py``.

Two kernels, both hand-written CUDA for sm_90a:

  * K1, :func:`fused_topk_search` -- exact k-NN, ``csrc/k1_scan.cu``.
    The port's exact engine: ``chunked_topk_search`` on CUDA is K1.  The
    f32 arena streams in by TMA in tiles of 128 rows; the product is a
    compensated TF32 one on the tensor cores (each operand split into a
    big and a small TF32 part, three wgmma passes with f32 sums: f32-grade
    results; ``exact=False`` rounds the operands to bf16 and takes one
    pass), against a tile of queries as narrow as the batch (8 to 128).
    Scores that beat a query's k-th best go through small queues in shared
    memory into its running list (past k = 32 a sorted list, merged a
    queue at a time, whose k-th best the scan blocks of one query share).
    The lists serve k up to ``MAX_K_LISTS``; :func:`exact_topk_large_k` is
    the route for any larger k up to the capacity (the same product into a
    score buffer, radix select, then a bitonic sort, with no readback
    between its launches), as the Pallas K1 has no k limit.
  * K2, :func:`fused_topk_search_v2` -- approximate candidates, one bf16
    winner per group of 128 consecutive rows, then the k best winners,
    ``csrc/k2_scan.cu``: TMA loads of a bf16 mirror of the arena and wgmma
    products, group winners as 64-bit keys into a ``[B, cap/128]`` buffer,
    then a select per query (the k-th key found by counting).  The
    candidate stage of ``approx_oversample_search``.
  * K2's candidate pools, :func:`pool_candidates` -- the phase 1 of the
    quantized arenas' searches (``ops/topk.py``), the same scan keeping one
    winner per ``POOL_BIN`` = 32 strided rows (four a 128-row tile), its
    keys selected per segment of rows (a deep arena's chunk, or the whole
    arena).  Over an int8 hi plane it is K2's int8 instantiation (int8
    wgmma with int32 sums, the queries quantized per row here, a ring of
    row scales; counted as ``fused_topk_search_v2_int8``); over a bf16
    mirror (a deep bf16 arena) its bf16 scan.  The scan and the selects
    stop at the arena's high-water mark (``rows``), and the last select
    writes the (score, row) pairs themselves.

Neither writes the ``[B, cap]`` score matrix to device memory, which is
the point: ``q @ x.T`` then ``torch.topk`` would write 16 GB at 1M rows and
B=4096.  K1's large-k route writes it for as many queries at a time as
``SCORE_BUFFER_BYTES`` holds; K2 writes one key per 128 rows.

The public functions keep the JAX signatures and their ``ValueError``
alignment contract, so tests compare like with like; ``chunk`` and
``block_b`` are checked, not used, because the CUDA kernels choose their own
tiling.  The index calls :func:`exact_topk` on its row-major ``[cap, D]``
f32 arena (:func:`arena_f32`: rows a multiple of 16 bytes apart, which TMA
asks for) and :func:`approx_candidates` on the bf16 mirror of it
(:func:`arena_bf16`); both take any ``B`` and mask the ragged edges
themselves.

Dispatch is by device.  Tensors on the CPU go to the plain PyTorch versions
(``*_reference``), which compute the same function; tensors on a CUDA
device launch the kernel, or raise.  Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from embeddinghub_tpu_torch.ops import _build
from embeddinghub_tpu_torch.ops import distance as D

INF = float("inf")
GROUP = 128            # K2's group width, the oracle's in the parity tests
MAX_K_EXACT = 1024     # K1 (exact_topk); past it, exact_topk_large_k
MAX_K_LISTS = 512      # K1's running lists (k1_scan.cu MAX_LONG_K); past it, its large-k route
LARGE_K_FROM = 128     # ... and past this k over few rows a k whose scores fit its buffer:
LARGE_K_ROWS = 256     # at most this many rows a k (k1_route)
MAX_K_APPROX = 256     # K2; the main path asks for k * 8 = 128
MIRROR_BOX = 64        # K2's TMA box width in bf16 columns (k2_scan.cu)
_MERGE_SLOTS = 16384   # K1: splits * k entries sorted per query by its merge
_BN = 128              # K1's scan tile: arena rows (k1_scan.cu TILE)
# K1's query tile is as narrow as the batch: the kernel library picks 8,
# 16, 32, 64 or 128 queries a block (k1_scan.cu pick_nq; narrower for wide
# rows, whose two query tiles must leave room for the ring).
# K1's scan blocks to aim for, per SM (one block fits an SM, so these are
# waves): slices of the arena fill the card at any B.  More splits mean
# more list fills and longer merges: on an H100 one wave was the best of 1,
# 2, 4 and 8 at every B from 1 to 4096 (k=16, 1M x 128).
# tools/sweep_splits.py sweeps it with the merge size.
_BLOCKS_PER_SM = 1
# K2: queries per scan block (two wgmma warpgroups of 64) and the waves of
# scan blocks to aim for, per SM (one block fits an SM); its slices need no
# merge, so more only cost block set-up.  8 waves are 1056 blocks, a whole
# number of waves for every power-of-two count of query tiles up to 32
# (B <= 4096); tools/sweep_splits.py sweeps it.
_K2_BQ = 128
_K2_WAVES = 8
_K2_SELECT_CHUNK = 8192  # keys a select block holds (k2_scan.cu SELECT_CHUNK)
# K1's large-k route stores the [B, cap] scores, and K2 the [B, cap/128]
# group winners, of as many queries at a time as fit in this many bytes
# (one query at least).
SCORE_BUFFER_BYTES = 1 << 30

# K2's candidate pools: one winner per POOL_BIN rows, at most MAX_K_POOL
# candidates a segment (k2_scan.cu POOL_BIN, MAX_POOL_KP).
POOL_BIN = 32
MAX_K_POOL = 4096
_TILE_BINS = GROUP // POOL_BIN

_launch_lock = threading.Lock()
LAUNCHES = {"fused_topk_search": 0, "fused_topk_search_v2": 0,
            "fused_topk_search_large_k": 0, "fused_topk_search_v2_int8": 0}
# The plain large-k version scans the arena in chunks whose step holds
# three [B, chunk] f32 temporaries (products, scores, masked scores); the
# chunk keeps them within this many bytes, down to a least chunk of GROUP
# rows (past 2**20 queries).
SCAN_SCORE_BYTES = 1 << 29


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
    arena, f32 or bf16, through its bf16 mirror.  Scores are bf16-graded;
    rerank downstream for exact distances."""
    b, cap = q.shape[0], xt.shape[1]
    if cap % chunk or b % block_b or chunk % GROUP:
        raise ValueError(f"shape not aligned: cap={cap} chunk={chunk} B={b}")
    return approx_candidates(q, arena_bf16(xt.T), valid, x_sq, k=k, metric=metric)


def mirror_dims(dims: int) -> int:
    """The bf16 mirror's width: ``dims`` rounded up to whole TMA boxes."""
    return -(-dims // MIRROR_BOX) * MIRROR_BOX


def arena_f32(x: torch.Tensor) -> torch.Tensor:
    """``x [n, D]`` f32 as K1 reads it on the card: rows a multiple of 4
    floats (16 bytes) apart, TMA's rule for a row stride.  ``x`` itself when
    it already is; else a ``[n, D]`` view of a new ``[n, ceil4(D)]`` buffer
    (the padding is never read: TMA fills columns past ``D`` with zeros)."""
    n, dims = x.shape
    if x.stride(1) == 1 and x.stride(0) % 4 == 0 and x.stride(0) >= dims:
        return x
    out = torch.empty((n, -(-dims // 4) * 4), dtype=torch.float32, device=x.device)
    out[:, :dims] = x
    return out[:, :dims]


def plane_i8(x: torch.Tensor) -> torch.Tensor:
    """An int8 plane as K2's int8 scan reads it: ``x [n, D]`` itself when
    its rows are a multiple of 16 bytes apart and 16-byte aligned (TMA's
    rule), else a ``[n, D]`` view of a zero-padded ``[n, ceil16(D)]``
    copy.  The scan reads columns past ``D`` as zeros either way."""
    n, dims = x.shape
    if (x.stride(1) == 1 and x.stride(0) % 16 == 0 and x.stride(0) >= dims
            and x.data_ptr() % 16 == 0):
        return x
    out = torch.zeros((n, -(-dims // 16) * 16), dtype=torch.int8, device=x.device)
    out[:, :dims] = x
    return out[:, :dims]


def arena_bf16(x: torch.Tensor) -> torch.Tensor:
    """The bf16 mirror K2 reads: ``x [n, D]`` rounded to bf16 (to nearest
    even), in ``[n, mirror_dims(D)]`` with the padding columns zero."""
    n, dims = x.shape
    out = torch.zeros((n, mirror_dims(dims)), dtype=torch.bfloat16, device=x.device)
    out[:, :dims] = x
    return out


# -------------------------------------------------------- index entries


def exact_topk(q, x, valid, x_sq, *, k, metric, exact=True):
    """K1 over a row-major arena, any ``B`` and ``cap``: the scan's running
    lists, or at the shapes :func:`k1_route` names its large-k route."""
    _check_k(k, MAX_K_EXACT)
    if x.device.type == "cpu":
        return fused_topk_search_reference(q, x, valid, x_sq, k=k,
                                           metric=metric, exact=exact)
    b, dims = q.shape
    if (x.device.type == "cuda" and k > 32   # k <= 32: always the lists
            and k1_route(k, b, x.shape[0], k1_tile(b, dims, exact)) == "large_k"):
        return _launch_large_k(q, x, valid, x_sq, k, metric, exact)
    return _launch(q, x, valid, x_sq, k, metric, exact)


def k1_tile(b: int, dims: int, exact: bool) -> int:
    """The queries a K1 scan block owns for this batch and width (8 to 128;
    k1_scan.cu pick_nq)."""
    return _build.library().ehtorch_k1_tile(b, dims, int(exact), 0)


def k1_route(k: int, b: int, cap: int, nq: int) -> str:
    """The route :func:`exact_topk` takes on the card, from the shape alone
    (``nq``: :func:`k1_tile`): ``"lists"`` (the scan keeps each query's
    list; past k = 32 sorted, 16 keys a lane at most, in query tiles of 64
    or 128) or ``"large_k"`` (the scores into a buffer, radix select).  The
    large-k route takes k past ``MAX_K_LISTS``; k past 32 when the query
    tile is narrower than 64 (a small batch, or rows too wide for a tile of
    64); and k past ``LARGE_K_FROM`` over at most ``LARGE_K_ROWS`` rows a k
    when the ``[b, cap]`` scores fit its buffer whole (one pass over the
    arena): there a list takes a large share of the rows, and the lists lose
    (on an H100, the routed pool, k=257 over 32,768 rows;
    tools/probe_k1_parts.py, PERF.md)."""
    if k > MAX_K_LISTS or (k > 32 and nq < 64):
        return "large_k"
    row_len = -(-cap // _BN) * _BN
    if (k > LARGE_K_FROM and cap <= LARGE_K_ROWS * k
            and b * row_len * 4 <= SCORE_BUFFER_BYTES):
        return "large_k"
    return "lists"


def approx_candidates(q, xb, valid, x_sq, *, k, metric):
    """K2 over the bf16 mirror ``xb`` (:func:`arena_bf16`) of a row-major
    arena, any ``B`` and ``cap``."""
    _check_k(k, MAX_K_APPROX)
    if xb.device.type == "cpu":
        return fused_topk_search_v2_reference(q, xb, valid, x_sq, k=k,
                                              metric=metric)
    return _launch_k2(q, xb, valid, x_sq, None, k, metric)


def quantize_queries(qf: torch.Tensor, metric: str):
    """The int8 queries of an int8 scan, as ``ops/topk.py:297-300`` of the
    reference: ``qscale = max|q| / 127``, ``qq = clip(round(q / max(qscale,
    1e-30)), -127, 127)`` (round half to even), on rows already normalized
    for cosine.  Returns ``qq`` as ``[B, ceil16(D)]`` int8, zero-padded
    (rows 16 bytes apart, for TMA), and ``qs [B]``, the multiplier of the
    int32 sums: ``2 qscale`` for l2 (the score's ``2 dots``), ``qscale``
    otherwise."""
    qf = qf.to(torch.float32)
    b, dims = qf.shape
    qscale = qf.abs().amax(dim=1) / 127.0 if dims else qf.new_zeros(b)
    qq = torch.zeros((b, -(-dims // 16) * 16), dtype=torch.int8, device=qf.device)
    qq[:, :dims] = torch.clamp(torch.round(qf / torch.clamp(qscale, min=1e-30)[:, None]),
                               -127, 127).to(torch.int8)
    return qq, qscale * 2.0 if metric == "l2" else qscale


def pool_candidates(qf, plane, valid, x_sq, scales=None, *, k, metric, seg=None,
                    rows=None):
    """Phase 1 of the quantized searches (K2's candidate pool): each
    segment's ``k`` best bin winners, one winner per ``POOL_BIN`` rows.

    ``qf [B, D]`` f32, already normalized for cosine.  ``plane``: the
    ``[cap, D]`` int8 hi plane of an int8 arena (with ``scales [cap]``; the
    queries are quantized by :func:`quantize_queries`, the score is ``bias -
    (qs * scale) * f32(qq . hi)``), or the bf16 mirror ``[cap, Dp]`` of a
    bf16 arena (:func:`arena_bf16`; bf16-rounded queries, ``bias - 2 q.x``
    or ``-q.x``).  The bias is ``x_sq`` (l2) or 0 for a live row, +inf for a
    dead one.  ``seg``: the rows of a segment, a multiple of 128 (``None``:
    the whole arena is one).  ``rows``: a bound that every live row lies
    below (the arena's high-water mark; ``None``: the capacity); the scan
    and the selects stop at it, and a segment past it comes back empty
    without either.  The result does not depend on it.  Returns ``(scores,
    ids)``, each ``[B, segments, k]``, ascending by (score, row): the scores
    in that minimized convention, empty slots +inf and -1."""
    cap = plane.shape[0]
    seg_keys = _seg_keys(cap, seg)
    _check_k(k, MAX_K_POOL)
    if plane.device.type == "cpu":  # the plain pool scores every row
        return pool_candidates_reference(qf, plane, valid, x_sq, scales, k=k,
                                         metric=metric, seg=seg)
    rows = cap if rows is None else max(0, min(cap, int(rows)))
    return _launch_k2(qf, plane, valid, x_sq, scales, k, metric, seg_keys, rows)


def _seg_keys(cap: int, seg) -> int:
    """The bin keys of a segment of ``seg`` rows (all the arena's when
    ``None``)."""
    if seg is None:
        return -(-cap // GROUP) * _TILE_BINS
    if seg % GROUP or seg <= 0:
        raise ValueError(f"segment of {seg} rows is not a multiple of {GROUP}")
    return seg // POOL_BIN


def exact_topk_large_k(q, x, valid, x_sq, *, k, metric, exact=True):
    """K1 for any ``1 <= k <= cap`` (the route past ``MAX_K_EXACT``):
    same outputs as :func:`exact_topk`, ties in score broken by the lower
    row."""
    _check_k(k, x.shape[0])
    if x.device.type == "cpu":
        return fused_topk_search_large_k_reference(q, x, valid, x_sq, k=k,
                                                   metric=metric, exact=exact)
    return _launch_large_k(q, x, valid, x_sq, k, metric, exact)


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


def _checked(name, q, x, valid, x_sq, metric, mirror=False):
    """The launch's inputs on one CUDA device and contiguous (the f32
    arena: unit column stride, rows a multiple of 4 floats apart and 16-byte
    aligned, as :func:`arena_f32` leaves it); the queries as f32,
    contiguous.  ``x`` is the f32 arena, or with ``mirror`` its bf16
    mirror."""
    if metric not in D.METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    dev = x.device
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: tensors on {dev}; expected cpu or cuda")
    dims = q.shape[1]
    cap = x.shape[0]
    arena = ((torch.bfloat16, (cap, mirror_dims(dims))) if mirror
             else (torch.float32, (cap, dims)))
    for t, what, dtype, shape in (
        (x, "x", *arena),
        (valid, "valid", torch.bool, (cap,)),
        (x_sq, "x_sq", torch.float32, (cap,)),
    ):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} must be {dtype} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if t is x and not mirror:
            if (t.stride(1) != 1 or t.stride(0) % 4 or t.stride(0) < dims
                    or t.data_ptr() % 16):
                raise ValueError(
                    f"{name}: x must have unit column stride and 16-byte aligned "
                    f"rows a multiple of 4 floats apart (arena_f32), got strides "
                    f"{t.stride()}")
        elif not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if q.device != dev:
        raise ValueError(f"{name}: queries on {q.device}, arena on {dev}")
    return q.to(torch.float32).contiguous()


@functools.cache
def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _splits(b, nq, cap, dev, most):
    """K1's scan blocks along the arena: ``(splits, tiles per split)``."""
    n_tiles = -(-cap // _BN)
    q_tiles = -(-b // nq)
    # rounded down: the blocks fill whole waves and leave no tail
    splits = max(1, min(_BLOCKS_PER_SM * _sms(dev) // q_tiles, n_tiles, most))
    per_split = -(-n_tiles // splits)
    return -(-n_tiles // per_split), per_split


def _launch(q, x, valid, x_sq, k, metric, exact):
    name = "fused_topk_search"
    q = _prep_query(_checked(name, q, x, valid, x_sq, metric), metric)
    dev = x.device
    b, dims = q.shape
    cap = x.shape[0]
    if b == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=dev),
                torch.empty((0, k), dtype=torch.int32, device=dev))

    lib = _build.library()
    nq = k1_tile(b, dims, exact)  # queries a scan block
    splits, per_split = _splits(b, nq, cap, dev, _MERGE_SLOTS // k)
    slots = 1 << max(0, (splits * k - 1).bit_length())

    bias = torch.empty((-(-cap // _BN) * _BN,), dtype=torch.float32, device=dev)
    pd = torch.empty((b, splits, k), dtype=torch.float32, device=dev)
    pi = torch.empty((b, splits, k), dtype=torch.int32, device=dev)
    bound = torch.empty((b, splits), dtype=torch.int32, device=dev)  # the splits' shared bound
    od = torch.empty((b, k), dtype=torch.float32, device=dev)
    oi = torch.empty((b, k), dtype=torch.int32, device=dev)
    ptrs = [t.data_ptr() for t in (q, x, valid, x_sq, bias, pd, pi, bound, od, oi)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ehtorch_fused_topk(
            *ptrs, b, cap, dims, x.stride(0), k, int(metric == "l2"), int(exact),
            nq, splits, per_split, slots, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    _count(name)
    return od, oi


def _k2_splits(b, cap, dev):
    """K2's arena slices: enough scan blocks for ``_K2_WAVES`` per SM."""
    q_tiles = -(-b // _K2_BQ)
    return max(1, min(-(-cap // GROUP), -(-_K2_WAVES * _sms(dev) // q_tiles)))


def _launch_k2(qf, plane, valid, x_sq, scales, k, metric, seg_keys=None, rows=None):
    """K2 on the card.  ``seg_keys=None``: the main path's candidates over
    the bf16 mirror ``plane`` (one winner per GROUP rows, the queries as
    given, the k best through the epilogue) -> ``(dist [B, k], ids [B,
    k])``.  Else a pool (:func:`pool_candidates`) over the live ``rows``:
    one winner per POOL_BIN rows, each segment of ``seg_keys`` keys' k best
    -> ``(scores, ids)``, each ``[B, segments, k]``, decoded by the select."""
    pool = seg_keys is not None
    i8 = plane.dtype == torch.int8
    name = "fused_topk_search_v2_int8" if i8 else "fused_topk_search_v2"
    dev = plane.device
    cap = plane.shape[0]
    rows = cap if rows is None else rows
    if not pool:
        qf = _checked(name, qf, plane, valid, x_sq, metric, mirror=True)
    else:
        if metric not in D.METRICS:
            raise ValueError(f"unknown metric {metric!r}")
        if i8:
            plane = plane_i8(plane)
            want = [(scales, "scales", torch.float32)]
            if plane.shape[1] != qf.shape[1]:
                raise ValueError(f"{name}: plane of {plane.shape[1]} columns for "
                                 f"{qf.shape[1]}")
        else:
            if (plane.dtype != torch.bfloat16 or plane.shape[1] != mirror_dims(qf.shape[1])
                    or not plane.is_contiguous()):
                plane = arena_bf16(plane[:, :qf.shape[1]])
            want = []
        for t, what, dtype in [(valid, "valid", torch.bool),
                               (x_sq, "x_sq", torch.float32), *want]:
            if (t is None or t.device != dev or t.dtype != dtype
                    or tuple(t.shape) != (cap,) or not t.is_contiguous()):
                raise ValueError(f"{name}: {what} must be a contiguous {dtype} ({cap},) "
                                 f"on {dev}")
        if qf.device != dev:
            raise ValueError(f"{name}: queries on {qf.device}, plane on {dev}")
    b, dims = qf.shape
    n_tiles = -(-cap // GROUP)
    live_tiles = -(-rows // GROUP)
    per_tile = _TILE_BINS if pool else 1
    seg = seg_keys if pool else n_tiles
    n_seg = -(-n_tiles * per_tile // seg)
    live_keys = live_tiles * per_tile
    live_segs = -(-live_keys // seg)
    shape = (b, n_seg, k) if pool else (b, k)
    od = torch.empty(shape, dtype=torch.float32, device=dev)
    oi = torch.empty(shape, dtype=torch.int32, device=dev)
    if pool and live_segs < n_seg:  # segments past the live rows: empty
        od[:, live_segs:] = INF
        oi[:, live_segs:] = -1
    if b == 0 or live_tiles == 0:
        return od, oi
    # Scratch: the queries (int8 with their multipliers, or bf16, which the
    # kernel rounds), each live row's bias (and int8 scale), and the
    # [queries, keys] buffer for as many queries at a time as
    # SCORE_BUFFER_BYTES holds (whole scan blocks of _K2_BQ queries, and at
    # most a select grid's y), rows of an even count (16-byte rows): the
    # live tiles' keys, and the second select pass's when a segment takes
    # three (ehtorch_k2); the first select pass's winners when a segment
    # takes several chunks.
    if i8:
        q, qs = quantize_queries(qf, metric)
        qb = None
    else:
        q, qs = qf.to(torch.float32).contiguous(), None
        qb = torch.empty((b, plane.shape[1]), dtype=torch.bfloat16, device=dev)
    bias = torch.empty((live_tiles * GROUP,), dtype=torch.float32, device=dev)
    sc = torch.empty_like(bias) if i8 else None
    parts = -(-seg // _K2_SELECT_CHUNK)
    stride = max(live_keys, live_segs * -(-parts * k // _K2_SELECT_CHUNK) * k)
    stride += stride % 2
    group = max(1, min(b, 65535, SCORE_BUFFER_BYTES // (8 * stride)))
    if group < b and group >= _K2_BQ:
        group -= group % _K2_BQ
    keys = torch.empty((group, stride), dtype=torch.int64, device=dev)
    part = (torch.empty((group, live_segs * parts * k), dtype=torch.int64, device=dev)
            if parts > 1 else None)

    def ptr(t, row=0):
        return None if t is None else t[row:].data_ptr() if t.dim() else t.data_ptr()

    lib = _build.library()
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        for g0 in range(0, b, group):
            g = min(group, b - g0)
            err = lib.ehtorch_k2(
                ptr(q, g0), ptr(qs, g0), valid.data_ptr(), x_sq.data_ptr(), ptr(scales),
                plane.data_ptr(), ptr(qb), bias.data_ptr(), ptr(sc), keys.data_ptr(),
                ptr(part), ptr(od, g0), ptr(oi, g0), g, cap, rows, dims, plane.shape[1],
                q.stride(0) if i8 else 0, plane.stride(0) if i8 else 0, stride, k, seg,
                POOL_BIN if pool else GROUP, int(metric == "l2"),
                int(metric == "cosine" and not pool), int(i8), int(not pool),
                _k2_splits(g, rows, dev), stream)
            if err != 0:
                raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    _count(name)
    return od, oi


_RADIX_BLOCKS_PER_SM = 16  # 128-thread blocks of the radix passes


def _launch_large_k(q, x, valid, x_sq, k, metric, exact):
    name = "fused_topk_search_large_k"
    q = _prep_query(_checked(name, q, x, valid, x_sq, metric), metric)
    dev = x.device
    b, dims = q.shape
    cap = x.shape[0]
    od = torch.empty((b, k), dtype=torch.float32, device=dev)
    oi = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return od, oi

    row_len = -(-cap // _BN) * _BN
    group = max(1, min(b, SCORE_BUFFER_BYTES // (4 * row_len)))
    slots = 1 << (k - 1).bit_length()
    sms = _sms(dev)
    lib = _build.library()
    bias = torch.empty((row_len,), dtype=torch.float32, device=dev)
    scores = torch.empty((group, row_len), dtype=torch.float32, device=dev)
    keys = torch.empty((group, slots), dtype=torch.int64, device=dev)
    state = torch.empty((lib.ehtorch_large_k_state_bytes(group),), dtype=torch.uint8,
                        device=dev)
    l2, row_bits = int(metric == "l2"), (cap - 1).bit_length()

    # Every launch of a group goes out in one call: the product into the
    # score buffer, the radix digits, the collect, the sort and the epilogue
    # (k1_scan.cu ehtorch_large_k).  Nothing comes back to the host between
    # them.
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        for g0 in range(0, b, group):
            g = min(group, b - g0)
            nq = lib.ehtorch_k1_tile(g, dims, int(exact), 1)
            splits, per_split = _splits(g, nq, cap, dev, cap)
            blocks_x = max(1, min(row_len // _BN // 4,
                                  -(-_RADIX_BLOCKS_PER_SM * sms // g)))
            err = lib.ehtorch_large_k(
                q[g0:].data_ptr(), x.data_ptr(), valid.data_ptr(), x_sq.data_ptr(),
                bias.data_ptr(), scores.data_ptr(), state.data_ptr(), keys.data_ptr(),
                od[g0:].data_ptr(), oi[g0:].data_ptr(), g, cap, dims, x.stride(0), k,
                l2, int(exact), nq, splits, per_split, slots, row_bits, blocks_x,
                stream)
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


def fused_topk_search_large_k_reference(q, x, valid, x_sq, *, k, metric="l2",
                                        exact=True):
    """Plain PyTorch K1 for any ``k``: the reference's XLA exact path
    (``embeddinghub_tpu/ops/topk.py`` ``chunked_topk_search``), one f32
    ``torch.matmul`` per arena chunk, its ``torch.topk`` and a merge into
    the running ``[B, k]``, in chunks sized by ``SCAN_SCORE_BYTES``."""
    cap = x.shape[0]
    _check_k(k, cap)
    chunk = max(GROUP, SCAN_SCORE_BYTES // (3 * 4 * max(q.shape[0], 1)))
    return fused_topk_search_reference(q, x, valid, x_sq, k=k, metric=metric,
                                       exact=exact, chunk=min(chunk, cap))


def fused_topk_search_v2_reference(q, xb, valid, x_sq, *, k=16, metric="l2",
                                   chunk=65536):
    """Plain PyTorch K2 over the bf16 mirror ``xb`` of a row-major arena:
    bf16-rounded operands, f32 sums, the (min, first argmin) of each 128-row
    group, then a running top-k over the group winners.  ``chunk`` must be
    a multiple of 128."""
    q = _prep_query(q, metric)
    qc = D.round_bf16(q)
    b, dims = q.shape
    cap = xb.shape[0]
    best_s = torch.full((b, k), INF, dtype=torch.float32, device=q.device)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=q.device)
    for s in range(0, cap, chunk):
        xs = D.round_bf16(xb[s:s + chunk, :dims].to(torch.float32))
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


def pool_candidates_reference(qf, plane, valid, x_sq, scales=None, *, k, metric,
                              seg=None, chunk=65536):
    """Plain :func:`pool_candidates`: the scores in the kernel's order of
    operations (int8: ``bias - (qs * scale) * f32(qq . hi)`` with exact
    integer sums; bf16: ``x_sq - 2 q.x`` or ``-q.x`` on bf16-rounded
    operands), the (min, first row) of each bin of 32 rows {8j + 2t + h: j
    < 16, h < 2} of a 128-row tile (t < 4), then each segment's ``k``
    smallest (score, row) keys.  ``chunk``: arena rows scored at a time, a
    multiple of 128."""
    i8 = plane.dtype == torch.int8
    b, dims = qf.shape
    cap = plane.shape[0]
    seg_keys = _seg_keys(cap, seg)
    dev = qf.device
    if i8:
        q, qs = quantize_queries(qf, metric)
        # integer sums exact in f32 up to 2**24 (rows of up to 1040 columns)
        exact_t = torch.float32 if dims * 127 * 127 < (1 << 24) else torch.float64
        q = q[:, :dims].to(exact_t)
    else:
        q = D.round_bf16(qf.to(torch.float32))
    wv, wr = [], []
    for s in range(0, cap, chunk):
        e = min(cap, s + chunk)
        rows = plane[s:e, :dims]
        live = valid[s:e]
        bias = torch.where(live, x_sq[s:e] if metric == "l2" else torch.zeros_like(
            x_sq[s:e]), INF)
        if i8:
            acc = (q @ rows.to(q.dtype).T).to(torch.float32)
            c = qs[:, None] * scales[None, s:e]
            sc = bias[None, :] - c * acc
        else:
            dots = q @ D.round_bf16(rows.to(torch.float32)).T
            sc = bias[None, :] - 2.0 * dots if metric == "l2" else bias[None, :] - dots
        ragged = -sc.shape[1] % GROUP
        if ragged:
            sc = torch.nn.functional.pad(sc, (0, ragged), value=INF)
        # [B, tiles, j, t, h] -> [B, tiles, t, (j, h)]: a bin's rows in order
        bins = sc.view(b, -1, GROUP // 8, _TILE_BINS, 2).transpose(2, 3)
        v, a = bins.reshape(b, -1, POOL_BIN).min(dim=2)  # first row among ties
        tile = torch.arange(v.shape[1], device=dev) // _TILE_BINS
        t = torch.arange(v.shape[1], device=dev) % _TILE_BINS
        wv.append(v)
        wr.append(s + tile * GROUP + (a // 2) * 8 + t * 2 + a % 2)
    v, r = torch.cat(wv, dim=1), torch.cat(wr, dim=1)
    n_seg = -(-v.shape[1] // seg_keys)
    pad = n_seg * seg_keys - v.shape[1]
    bits = v.contiguous().view(torch.int32).to(torch.int64)
    order = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)  # signed order of floats
    key = order * (1 << 32) + r
    if pad:  # (pad's value goes through a float: int64's largest would wrap)
        key = torch.cat([key, key.new_full((b, pad), torch.iinfo(torch.int64).max)], dim=1)
        v = torch.nn.functional.pad(v, (0, pad), value=INF)
        r = torch.nn.functional.pad(r, (0, pad), value=-1)
    kk = min(k, seg_keys)
    pos = torch.topk(key.view(b, n_seg, seg_keys), kk, dim=2, largest=False).indices
    sv = torch.gather(v.view(b, n_seg, seg_keys), 2, pos)
    si = torch.gather(r.view(b, n_seg, seg_keys), 2, pos)
    fin = torch.isfinite(sv)
    sv, si = torch.where(fin, sv, INF), torch.where(fin, si, -1).to(torch.int32)
    if kk < k:
        sv = torch.nn.functional.pad(sv, (0, k - kk), value=INF)
        si = torch.nn.functional.pad(si, (0, k - kk), value=-1)
    return sv, si
