#!/usr/bin/env python3
"""Smoke run of the PyTorch port (embeddinghub_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), the CUDA version,
   and the seconds it takes to build the kernels from csrc/.
2. Kernels against their plain PyTorch versions, on the card, at every
   shape a path below gives them (capacity and live rows included), and at
   B=1024 for l2 and cosine over 1M rows (capacity 1,048,576) x 128, plus
   K1's bf16-operand instantiation and K1 l2 at B=4096 (distances in the
   hundreds, the tight case of its compensated TF32 product): K1 at k=16,
   K2 (on the arena's bf16 mirror) at k=128, and K1's large-k route at
   k=2048.  Median device ms of each (CUDA events, 5 runs after 2
   warm-ups), beside its bound (the larger of the operations over the
   card's peak for their type and the bytes over its memory rate, counted
   from this case's live rows; bf16 operands, K2's and K1's exact=False,
   count at the bf16 tensor-core rate; K1's f32 operands at the lesser of
   f32 FMA and its three TF32 passes, and the line keeps the FMA figure
   too), the achieved TFLOP/s and library_ms: the same product alone as
   one PyTorch call per arena chunk (bf16 matmul with bf16 output for K2,
   bf16 matmul with f32 output for K1's exact=False, f32 matmul with TF32
   off for K1's exact=True), which the port never calls.  Each
   K1 case also prints the largest error of its distances, and of its plain
   version's, against a float64 product of the rows each returned.  Two K1
   cases are the graph build's pools (phase 8): B=4096, k=256, bf16
   operands (exact=False), l2 over the 1M rows, and an upper layer's, k=64
   over a 65,536-row sub-arena of which 62,165 rows are live (layer 1 of
   a 1M-row graph: the level draws are the index's, seed 100).  Three K1
   cases are the graph writes' pools (phase 9), bf16 operands at B=4096:
   the layer-0 wave pool, k=200 over the arena's live prefix of 1,114,688
   rows (the last wave's high-water mark); the upper wave pool, k=64 over
   the 69,197 rows of layer 1's members; and refine's pools, k=256 over
   1,118,784 rows of which 1,108,784 are live.  The summary line reports
   the 1M-row cosine numbers at B=4096 (K1, K2) and B=16 (large k), and
   the graph build's and the waves' pool cases as entries of their own.
3. Main path in process, at SIFT-1M scale: EmbeddingHub on "cuda" ->
   create_space(128, cosine) -> Version.multiset of 1,000,000 keyed rows in
   4096-row batches -> nearest_batch of 4096 queries at k=10 under
   mode="auto" (must run K2, recall@10 >= 0.995 against an exact oracle
   computed on the card) -> FlatIndex.search(mode="exact") (must run K1,
   ids equal to the oracle up to ties) -> keyed nearest (excludes self) ->
   delete (the key never comes back).
4. Over the wire: the port's gRPC server in process on 127.0.0.1, driven
   through the raw EmbeddingHubStub: CreateSpace, MultiSet of 100,000 rows,
   NearestNeighbor by embedding and by key, NearestNeighbor with num=1500
   (a 2048-wide fetch: K1's large-k route), BatchNearestNeighbor of 1024
   queries and Get must equal the in-process store's answers; Set after
   FreezeSpace fails with FAILED_PRECONDITION, NearestNeighbor with key and
   embedding with INVALID_ARGUMENT.  Skipped, with the reason printed, when
   grpc is not installed.
5. Restore, 1M x 128 cosine, in a temporary data directory removed at the
   end: EmbeddingHub.load_or_create(dir, "cuda") -> multiset of 1,000,000
   rows in 4096-row batches with the WAL on (rows/s, WAL bytes) -> delete
   "k123" -> nearest_batch of 4096 queries at k=10 -> drop the hub unsaved
   and reopen from the WAL alone (reopen s): the same lists, "k123" absent,
   K2 launched -> save (s, snapshot bytes) and reopen from the snapshot
   (reopen s, first query s with the full upload): the same lists again ->
   exact search at k=10 (K1) and at k=2048 (K1's large-k route) of 16
   queries, ids equal to an on-card oracle up to ties.
6. Crash, over the wire and without jax: the port's server as a subprocess
   on a data directory; through the port's EmbeddingHubClient a MultiSet of
   20,000 acknowledged rows and 500 set(wait=False); SIGKILL; restart on the
   same directory: every acknowledged row comes back bit-exact (MultiGet),
   Download holds at least 20,000 rows, NearestNeighbor by key excludes the
   key; on SIGTERM the server prints its kernel launches.  Every wait on
   the subprocess is bounded (service/spawn.py).  Skipped, with the reason
   printed, when grpc is not installed.
7. Offline: the port's sdk.offline.Index on "cuda" over the first 100,000
   rows answers nearest_neighbor_batch and a keyed nearest_neighbor as a
   Version over the same rows does, at recall@10 >= 0.99 against the
   exact oracle.
8. Graph, the hnsw engine at 1M x 128 (the ROADMAP's graph cell): SIFT-
   statistics proxy rows and 1,024 queries (sift_proxy, a numpy copy of
   benchmarks/cluster_build.py:40-76, rng seeds 0 and 1) ->
   EmbeddingHub.load_or_create(dir, engine="hnsw", device="cuda") ->
   create_space(128, l2) -> one Version.multiset of all rows with the WAL
   on: one exact bulk build at M=16, efC=200 (must launch K1 for its
   pools), its seconds by part (pools, prune, symmetrize, upper, host) ->
   an exact top-10 oracle from K1 (exact=True) -> HNSWIndex.search at ef
   50, 100 and 200 (expand 8, the bf16 walk), B=1024, k=10: recall@10,
   device ms per batch (CUDA events around the call, median of 5 after 2
   warm-ups), beam iterations (hops) and ms per hop; recall@10 at ef=100
   must be >= 0.95 -> the same at ef=100 on the packed walk (pack_walk) ->
   save -> the port's gRPC server in process on the data directory (a
   reopen from the snapshot): nearest_batch, BatchNearestNeighbor and
   NearestNeighbor give the lists the store gave before the save.  About
   a minute on an H100.
9. Graph writes, into the store phase 8 reopened (no second build): 24
   Version.multiset calls of 4,096 new SIFT-proxy rows (rng seed 2), one
   wave each (K1 must launch): rows/s, median ms a wave, the wave's parts
   (HNSWIndex.wave_seconds: layer-0 pool, upper pools, scatter, prune,
   reciprocal commits, device-state rebuild, host, the rollback copies)
   and the capacity-growth
   wave (2**20 -> 2**21 rows) apart -> a raw-stub MultiSet of 20,480 rows
   over the wire (5 flushes, 5 waves; by multiset without grpc) ->
   recall@10 at ef 50/100/200 against an exact K1 oracle over every live
   row (ef=100 must reach 0.95) and a self-check (1,024 inserted rows
   find themselves in their top 10 at ef=100 at a rate of 0.99 or more)
   -> 10,000 Version.delete calls, half old rows and half new (deletes/s;
   no deleted key in any list; recall at ef=100 still 0.95) -> refine of
   8,192 inserted rows (K1 must launch; recall may fall by 0.005 at most)
   -> save, then one more wave and 100 deletes unsaved -> the store
   dropped and reopened from snapshot + WAL: every acknowledged key
   bit-exact (Get), no deleted key, recall at ef=100 still 0.95.

The launch counters are zeroed just before each path (main: phases 3-4;
restore: 5; offline: 7; graph: 8; writes: 9) and read just after it; the crash
path's (6) are those its restarted server process reports.  Each path must
have launched the kernels it runs.  The second-to-last line is a JSON
summary of the kernels, an entry per summary case: "launches" is the main
path's count (the graph path's for the build's pool cases, the writes
path's for the waves'), "paths" each path's own.  The last line is {"ok": true, "device": {...}}.  Data comes from
numpy with a fixed seed.
"""

from __future__ import annotations

import gc
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SEED = 20261016
ROWS, CAP, DIMS = 1_000_000, 1 << 20, 128
MAIN_B, MAIN_K = 4096, 10
WIRE_ROWS, WIRE_B = 100_000, 1024
WIRE_CAP = 1 << 17  # the capacity 100,000 rows take (and the offline Index's)
BIG_K, BIG_B, BIG_NUM = 2048, 16, 1500  # exact search past K1's lists (k > 1024)
CRASH_ROWS, CRASH_UNACKED = 20_000, 500
CRASH_CAP = 1 << 15
OFFLINE_ROWS, OFFLINE_B = 100_000, 1024
# K2 keeps one row per 128-row group: over 782 groups two of a query's 10
# nearest share one with odds about 45/782, so recall@10 is near 0.994 by
# design (0.9995 over the 1M rows of phase 3).
OFFLINE_RECALL = 0.99
GRAPH_QUERIES, GRAPH_K, GRAPH_EFS = 1024, 10, (50, 100, 200)
GRAPH_M, GRAPH_EFC, GRAPH_RECALL = 16, 200, 0.95  # recall@10 at ef=100
GRAPH_POOL_B, GRAPH_POOL_K = 4096, 256  # the build's layer-0 pools
# Layer 1 of a 1M-row graph: 62,165 members of the index's level draws
# (seed 100, P(level >= 1) = 1/16), a sub-arena rounded up to 65,536, pools
# of 4M = 64.
UPPER_CAP, UPPER_ROWS, UPPER_K = 1 << 16, 62_165, 64
FLUSH = 4096  # the server's MultiSet flush size
CARD = "cuda"  # the device of phases 8 and 9
# Phase 9, writes into the phase-8 graph: 24 in-process multisets of FLUSH
# rows, 5 wire flushes, 10,000 deletes, a refine of 8,192 rows, one more
# wave after a save.  Each multiset of FLUSH rows is one wave.
WAVE_ROWS, WIRE_WAVE_ROWS = 24 * FLUSH, 5 * FLUSH
WAVE_POOL_K = 200  # ef0 = min(max(efC, 16), 1024)
# The last wave's layer-0 pool scans the arena's live prefix (its
# high-water mark), and its layer-1 pool the layer's 69,415 members: the
# 62,165 of the build and those of the first 114,688 level draws of the
# reopened index (a fresh generator, seed 100; P(level >= 1) = 1/16).
WAVE_HI = ROWS + WAVE_ROWS + WIRE_WAVE_ROWS - FLUSH
WAVE_UPPER = 69_415
DELETES, REFINE_ROWS, SELF_QUERIES, SELF_RATE = 10_000, 8_192, 1_024, 0.99
# (kernel, metric, B, k, exact, capacity, live rows) compared with its plain
# version, at every shape a path gives it; exact is K1's operand precision
# (None for K2, which is always bf16).
KERNEL_CASES = (
    ("fused_topk_search", "l2", GRAPH_POOL_B, GRAPH_POOL_K, False, CAP, ROWS),  # graph
    ("fused_topk_search", "l2", GRAPH_POOL_B, UPPER_K, False, UPPER_CAP, UPPER_ROWS),
    ("fused_topk_search", "l2", GRAPH_QUERIES, GRAPH_K, True, CAP, ROWS),  # graph oracle
    ("fused_topk_search", "l2", FLUSH, WAVE_POOL_K, False, WAVE_HI, WAVE_HI),  # writes
    ("fused_topk_search", "l2", FLUSH, UPPER_K, False, WAVE_UPPER, WAVE_UPPER),
    ("fused_topk_search", "l2", FLUSH, GRAPH_POOL_K, False, WAVE_HI + FLUSH,  # refine
     WAVE_HI + FLUSH - DELETES),
    ("fused_topk_search", "l2", 1024, 16, True, CAP, ROWS),
    ("fused_topk_search", "cosine", 1024, 16, True, CAP, ROWS),
    ("fused_topk_search", "cosine", 1024, 16, False, CAP, ROWS),
    ("fused_topk_search", "cosine", MAIN_B, 16, True, CAP, ROWS),       # main, restore
    ("fused_topk_search", "l2", MAIN_B, 16, True, CAP, ROWS),
    ("fused_topk_search", "l2", 1, 16, True, CRASH_CAP, CRASH_ROWS + CRASH_UNACKED),  # crash
    ("fused_topk_search_v2", "l2", 1024, 128, None, CAP, ROWS),
    ("fused_topk_search_v2", "cosine", 1024, 128, None, CAP, ROWS),
    ("fused_topk_search_v2", "cosine", MAIN_B, 128, None, CAP, ROWS),   # main, restore
    ("fused_topk_search_v2", "cosine", 1, 128, None, CAP, ROWS),        # main
    ("fused_topk_search_v2", "l2", WIRE_B, 128, None, WIRE_CAP, WIRE_ROWS),     # wire
    ("fused_topk_search_v2", "l2", 1, 128, None, WIRE_CAP, WIRE_ROWS),          # wire
    ("fused_topk_search_v2", "cosine", OFFLINE_B, 128, None, WIRE_CAP, OFFLINE_ROWS),  # offline
    ("fused_topk_search_v2", "cosine", 1, 128, None, WIRE_CAP, OFFLINE_ROWS),   # offline
    ("fused_topk_search_large_k", "l2", 1, BIG_K, True, WIRE_CAP, WIRE_ROWS),   # wire
    ("fused_topk_search_large_k", "cosine", BIG_B, BIG_K, True, CAP, ROWS),     # restore
)
# Published peaks of one H100 SXM (dense): bf16 and TF32 tensor cores, f32
# FMA outside them, HBM3.
PEAK_BF16, PEAK_TF32, PEAK_F32, PEAK_BYTES = 989e12, 495e12, 67e12, 3.35e12
LIBRARY_CHUNK_BYTES = 1 << 30  # one [B, chunk] product of library_ms at most
# The cases whose numbers the summary line reports, an entry each: (metric,
# B, k, exact, capacity) -> (kernel, label).
SUMMARY = {
    ("cosine", MAIN_B, 16, True, CAP): ("fused_topk_search", "main"),
    ("cosine", MAIN_B, 128, None, CAP): ("fused_topk_search_v2", "main"),
    ("cosine", BIG_B, BIG_K, True, CAP): ("fused_topk_search_large_k", "main"),
    ("l2", GRAPH_POOL_B, GRAPH_POOL_K, False, CAP): ("fused_topk_search", "graph pool"),
    ("l2", GRAPH_POOL_B, UPPER_K, False, UPPER_CAP): ("fused_topk_search",
                                                       "graph upper-layer pool"),
    ("l2", FLUSH, WAVE_POOL_K, False, WAVE_HI): ("fused_topk_search", "wave pool"),
    ("l2", FLUSH, UPPER_K, False, WAVE_UPPER): ("fused_topk_search",
                                                "wave upper-layer pool"),
}
# the path whose launches a summary case reports
CASE_PATH = {"main": "main", "graph pool": "graph", "graph upper-layer pool": "graph",
             "wave pool": "writes", "wave upper-layer pool": "writes"}
SERVER_START_S, WAIT_S = 300, 60  # bounds on every wait for the server subprocess


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def device_ms(torch, fn, warmup: int = 2, runs: int = 5) -> float:
    """Median device milliseconds of ``fn`` on the current stream."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def scores_of(torch, q, x, x_sq, ids, metric, bf16):
    """Distances of the given rows under a kernel's own scoring."""
    from embeddinghub_tpu_torch.ops import distance as D

    q = q.float()
    if metric == "cosine":
        q = D.normalize(q)
    rows = x[ids.clamp(min=0).long()]
    qc = q
    if bf16:
        qc, rows = D.round_bf16(q), D.round_bf16(rows)
    dots = torch.einsum("bkd,bd->bk", rows, qc)
    if metric == "l2":
        d = torch.clamp(x_sq[ids.clamp(min=0).long()] - 2 * dots
                        + (q * q).sum(1, keepdim=True), min=0)
    else:
        d = 1 - dots
    return torch.where(ids >= 0, d, float("inf"))


def compare(torch, name, got, want, truth, gap, rtol, atol):
    """Kernel (d, ids) against its plain version: same distances within
    (rtol, atol); where the ids differ, the kernel's row must score within
    ``gap + rtol*|d|`` of the plain version's row (a near-tie; the relative
    term covers f32 rounding of l2 distances in the hundreds).  Returns the
    largest absolute distance error and the number of tie swaps."""
    (dk, ik), (dr, ir) = got, want
    fin = torch.isfinite(dr)
    check(torch.equal(fin, torch.isfinite(dk)), f"{name}: finite slots differ")
    check(torch.allclose(dk[fin], dr[fin], rtol=rtol, atol=atol),
          f"{name}: distances differ beyond rtol={rtol} atol={atol}")
    swaps = ik != ir
    if swaps.any():
        off = ((truth(ik) - dr).abs() - rtol * dr.abs())[swaps]
        check(bool((off <= gap).all()),
              f"{name}: {int(swaps.sum())} id mismatches, worst gap "
              f"{float(off.max()):.3g} > {gap}")
    return float((dk[fin] - dr[fin]).abs().max()), int(swaps.sum())


def bound(name, b, rows, cap, dims, k, exact=True):
    """(ms, "operations" or "bytes", unit, f32 FMA ms): the least time the
    card could take for a kernel's work at this case.  Operations:
    2*B*rows*D products and sums over the live rows, on bf16 tensor cores
    for bf16 operands (K2, and K1 with ``exact=False``: one bf16 product
    with f32 sums computes its scores); for K1's f32 operands the lesser of
    f32 FMA and three TF32 passes on the tensor cores (its compensated
    split), named in ``unit``, with the FMA figure returned beside it.
    Bytes: each input read once (the live rows of the arena, bf16 for K2
    and f32 for K1, and their x_sq; the whole valid mask; the f32 queries)
    and the [B, k] results written once."""
    k2 = name == "fused_topk_search_v2"
    flops = 2 * b * rows * dims
    fma_ms = flops / PEAK_F32 * 1e3
    if k2 or not exact:
        ops_ms, unit = flops / PEAK_BF16 * 1e3, "bf16"
    else:
        ops_ms, unit = min((3 * flops / PEAK_TF32 * 1e3, "3 TF32 passes"),
                           (fma_ms, "f32 FMA"))
    nbytes = rows * (dims * (2 if k2 else 4) + 4) + cap + b * dims * 4 + b * k * 8
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations", unit, fma_ms
    return bytes_ms, "bytes", "HBM", fma_ms


def f64_error(torch, q, x, x_sq, got, metric, bf16):
    """The largest error of the finite distances in ``got = (d, ids)``
    against a float64 product of the rows named, in the kernel's own
    scoring (operands rounded to bf16 first when ``bf16``)."""
    from embeddinghub_tpu_torch.ops import distance as D

    d, ids = got
    q = q.float()
    if metric == "cosine":
        q = D.normalize(q)
    worst = 0.0
    for s in range(0, q.shape[0], 256):  # [256, k, D] float64 at a time
        i = ids[s:s + 256].clamp(min=0).long()
        rows, qc = x[i], q[s:s + 256]
        if bf16:
            rows, qc = D.round_bf16(rows), D.round_bf16(qc)
        dots = torch.einsum("bkd,bd->bk", rows.double(), qc.double())
        if metric == "l2":
            want = torch.clamp(x_sq[i].double() - 2 * dots
                               + (q[s:s + 256].double() ** 2).sum(1, keepdim=True), min=0)
        else:
            want = 1 - dots
        fin = torch.isfinite(d[s:s + 256]) & (ids[s:s + 256] >= 0)
        if fin.any():
            worst = max(worst, float((d[s:s + 256].double() - want)[fin].abs().max()))
    return worst


def library_product(torch, name, q, x, xb, exact=True):
    """The product alone, as a library would compute it before any top-k:
    bf16 ``q @ xb.T`` with bf16 output for K2, the same with f32 output for
    K1's bf16 operands (``exact=False``), f32 ``q @ x.T`` (TF32 off) for
    K1's f32 operands; one ``torch.mm`` per arena chunk of at most
    LIBRARY_CHUNK_BYTES of output."""
    from embeddinghub_tpu_torch.ops import fused_topk as F

    k2 = name == "fused_topk_search_v2"
    bf16 = k2 or not exact
    lhs = F.arena_bf16(q) if bf16 else q.float()
    rhs = xb if bf16 else x
    kw = {"out_dtype": torch.float32} if bf16 and not k2 else {}
    out_size = 2 if k2 else 4
    chunk = max(F.GROUP, LIBRARY_CHUNK_BYTES // (out_size * lhs.shape[0]))

    def run():
        for s in range(0, rhs.shape[0], chunk):
            torch.mm(lhs, rhs[s:s + chunk].T, **kw)
    return run


def phase_kernels(torch, x_host, report):
    from embeddinghub_tpu_torch.ops import distance as D
    from embeddinghub_tpu_torch.ops import fused_topk as F

    kernels = {
        "fused_topk_search": (F.exact_topk, F.fused_topk_search_reference),
        "fused_topk_search_v2": (F.approx_candidates, F.fused_topk_search_v2_reference),
        "fused_topk_search_large_k": (F.exact_topk_large_k,
                                      F.fused_topk_search_large_k_reference),
    }
    rng = np.random.default_rng(SEED + 1)
    q_all = torch.from_numpy(rng.standard_normal(
        (max(c[2] for c in KERNEL_CASES), DIMS), dtype=np.float32)).cuda()
    # past ROWS (the wave cases' grown arena): more rows of the same draw
    raw = torch.zeros((max(CAP, max(c[5] for c in KERNEL_CASES)), DIMS),
                      dtype=torch.float32, device="cuda")
    raw[:ROWS] = torch.from_numpy(x_host).cuda()
    raw[ROWS:] = torch.from_numpy(rng.standard_normal(
        (raw.shape[0] - ROWS, DIMS), dtype=np.float32)).cuda()
    for metric in ("l2", "cosine"):
        x_full = D.preprocess_vectors(raw, metric)
        xb_full = F.arena_bf16(x_full)
        x_sq_full = D.sqnorms(x_full)
        for name, m, b, k, exact, cap, rows in KERNEL_CASES:
            if m != metric:
                continue
            kernel, plain = kernels[name]
            q = q_all[:b]
            # the first cap rows: contiguous
            x, xb, x_sq = x_full[:cap], xb_full[:cap], x_sq_full[:cap]
            arena = xb if name == "fused_topk_search_v2" else x
            valid = torch.arange(cap, device="cuda") < rows
            args = dict(k=k, metric=metric)
            if exact is not None:
                args["exact"] = exact
            bf16 = exact is not True
            # (tie gap, rtol, atol): f32 operands on both sides differ only
            # in summation order; bf16 operands leave ties 1e-3 wide
            gap, rtol, atol = (1e-3, 1e-3, 1e-3) if bf16 else (1e-4, 1e-5, 1e-4)
            got = kernel(q, arena, valid, x_sq, **args)
            want = plain(q, arena, valid, x_sq, **args)
            torch.cuda.synchronize()
            err, swaps = compare(
                torch, f"{name}/{metric}/B={b}/cap={cap}", got, want,
                lambda ids: scores_of(torch, q, x, x_sq, ids, metric, bf16),
                gap, rtol, atol)
            f64 = ""
            if exact is not None:
                f64 = (f" f64_err={f64_error(torch, q, x, x_sq, got, metric, bf16):.3g}"
                       f" plain_f64_err={f64_error(torch, q, x, x_sq, want, metric, bf16):.3g}")
            ms = device_ms(torch, lambda: kernel(q, arena, valid, x_sq, **args))
            plain_ms = device_ms(torch, lambda: plain(q, arena, valid, x_sq, **args))
            library_ms = device_ms(torch, library_product(torch, name, q, x, xb,
                                                          exact is not False))
            bound_ms, bound_by, unit, fma_ms = bound(name, b, rows, cap, DIMS, k,
                                                     exact is not False)
            tflops = 2 * b * rows * DIMS / (ms * 1e-3) / 1e12
            print(f"[kernels] {name} {metric} B={b} cap={cap} rows={rows} k={k}"
                  f"{'' if exact is None else f' exact={exact}'}: "
                  f"max_abs_err={err:.3g}{f64} tie_swaps={swaps} "
                  f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
                  f"bound_ms={bound_ms:.3f} ({bound_by}: {unit}; f32 FMA "
                  f"{fma_ms:.3f}) tflops={tflops:.1f} "
                  f"library_ms={library_ms:.3f}", flush=True)
            worst = report.setdefault(name, {"max_abs_err": 0.0})
            worst["max_abs_err"] = max(worst["max_abs_err"], err)
            label = SUMMARY.get((metric, b, k, exact, cap))
            if label is not None:
                report[label] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, bound_unit=unit, fma_bound_ms=fma_ms,
                    library_ms=library_ms,
                    shape=f"{metric} B={b} k={k} exact={exact} cap={cap} rows={rows}")
        del x_full, xb_full, x_sq_full, x, xb, x_sq, valid
    del raw, q_all
    torch.cuda.empty_cache()


def exact_oracle(torch, x_dev, queries, k, chunk=1 << 17, dead=()):
    """Exact cosine top-k on the card, in chunks, independent of the port:
    f32 products (TF32 is off for the whole script).  Rows in ``dead`` are
    left out."""
    qn = queries / queries.norm(dim=1, keepdim=True).clamp(min=1e-30)
    best_d = best_i = None
    for s in range(0, x_dev.shape[0], chunk):
        xs = x_dev[s:s + chunk]
        xs = xs / xs.norm(dim=1, keepdim=True).clamp(min=1e-30)
        d = 1 - qn @ xs.T
        for r in dead:
            if s <= r < s + xs.shape[0]:
                d[:, r - s] = float("inf")
        cd, ci = torch.topk(d, k, dim=1, largest=False)
        ci = ci + s
        if best_d is None:
            best_d, best_i = cd, ci
        else:
            best_d, pos = torch.topk(torch.cat([best_d, cd], 1), k, dim=1, largest=False)
            best_i = torch.gather(torch.cat([best_i, ci], 1), 1, pos)
    return best_d, best_i


def check_exact(i_ex, d_ex, od, oi, queries, x_host, what) -> int:
    """Exact-search ids and cosine distances against the oracle's: where
    the ids differ, the port's row must lie within 1e-4 of the oracle's
    distance at that position (a tie).  Returns the number of swaps."""
    oi_host, od_host = oi.cpu().numpy(), od.cpu().numpy()
    swaps = i_ex != oi_host
    if swaps.any():
        qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
        xr = x_host[i_ex[swaps]]
        xr = xr / np.linalg.norm(xr, axis=1, keepdims=True)
        rq = np.nonzero(swaps)[0]
        true_d = 1 - np.einsum("nd,nd->n", xr, qn[rq])
        check(np.abs(true_d - od_host[swaps]).max() <= 1e-4,
              f"{what}: ids differ from the oracle beyond ties")
    check(np.allclose(d_ex, od_host, rtol=1e-5, atol=1e-4), f"{what}: distances")
    return int(swaps.sum())


def phase_main(torch, x_host, launches):
    from embeddinghub_tpu_torch.store.hub import EmbeddingHub

    rng = np.random.default_rng(SEED + 2)
    queries = rng.standard_normal((MAIN_B, DIMS), dtype=np.float32)
    hub = EmbeddingHub.in_memory(device="cuda")
    version = hub.create_space("smoke", DIMS, "cosine").default_version()
    keys = [f"k{j}" for j in range(ROWS)]
    t0 = time.perf_counter()
    for s in range(0, ROWS, FLUSH):
        version.multiset(zip(keys[s:s + FLUSH], x_host[s:s + FLUSH]))
    ingest_s = time.perf_counter() - t0
    check(version.size == ROWS and version.index.capacity == CAP,
          f"size {version.size} cap {version.index.capacity}")
    print(f"[main] multiset {ROWS} rows in {FLUSH}-row batches: {ingest_s:.2f} s "
          f"({ROWS / ingest_s:.0f} rows/s)", flush=True)

    before = dict(launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = version.nearest_batch(queries, MAIN_K)
    first_s = time.perf_counter() - t0
    check(launches["fused_topk_search_v2"] > before["fused_topk_search_v2"],
          "auto search did not launch K2")
    check(launches["fused_topk_search"] == before["fused_topk_search"],
          "auto search launched K1")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = version.nearest_batch(queries, MAIN_K)
        times.append(time.perf_counter() - t0)
    check(again == got, "repeated nearest_batch differs")
    steady = statistics.median(times)
    print(f"[main] nearest_batch B={MAIN_B} k={MAIN_K} auto: first call (with "
          f"full sync) {first_s * 1e3:.1f} ms; steady median of 3 "
          f"{steady * 1e3:.1f} ms = {MAIN_B / steady:.0f} queries/s", flush=True)

    x_dev = torch.from_numpy(x_host).cuda()
    q_dev = torch.from_numpy(queries).cuda()
    od, oi = exact_oracle(torch, x_dev, q_dev, MAIN_K)
    oi_host = oi.cpu().numpy()
    check(all(len(r) == MAIN_K for r in got), "short result rows")
    hits = sum(len({int(k[1:]) for k in r} & set(o)) for r, o in zip(got, oi_host))
    recall = hits / (MAIN_B * MAIN_K)
    print(f"[main] recall@{MAIN_K} auto vs exact oracle: {recall:.5f}", flush=True)
    check(recall >= 0.995, f"recall@10 {recall} < 0.995")

    before = dict(launches)
    t0 = time.perf_counter()
    d_ex, i_ex = version.index.search(queries, MAIN_K, mode="exact")
    exact_s = time.perf_counter() - t0
    check(launches["fused_topk_search"] > before["fused_topk_search"],
          "exact search did not launch K1")
    check(launches["fused_topk_search_v2"] == before["fused_topk_search_v2"],
          "exact search launched K2")
    swaps = check_exact(i_ex, d_ex, od, oi, queries, x_host, "exact search")
    print(f"[main] exact search B={MAIN_B}: {exact_s * 1e3:.1f} ms "
          f"({MAIN_B / exact_s:.0f} queries/s), {swaps} tie swaps "
          f"vs oracle", flush=True)

    near = version.nearest(MAIN_K, key="k123")
    check(len(near) == MAIN_K and "k123" not in near, f"keyed nearest {near}")
    version.delete("k123")
    back = version.nearest_batch(x_host[123:124], MAIN_K)[0]
    check("k123" not in back and "k123" not in version, "deleted key came back")
    print("[main] keyed nearest excludes self; deleted key never comes back",
          flush=True)
    del x_dev, q_dev, hub, version
    torch.cuda.empty_cache()


def phase_wire(torch, x_host):
    try:
        import grpc
    except ImportError as e:
        print(f"[wire] not run: grpc is not installed ({e})", flush=True)
        return False
    from embeddinghub_tpu_torch.service.server import build_server, pb, pb_grpc

    server, service, port = build_server("127.0.0.1:0", "cuda")
    server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        stub = pb_grpc.EmbeddingHubStub(channel)
        stub.CreateSpace(pb.CreateSpaceRequest(name="wire", dims=DIMS))
        rows = x_host[:WIRE_ROWS]

        def requests():
            for j in range(WIRE_ROWS):
                req = pb.MultiSetRequest(space="wire", key=f"w{j}")
                req.embedding.values[:] = rows[j].tolist()
                yield req

        t0 = time.perf_counter()
        stub.MultiSet(requests())
        print(f"[wire] MultiSet {WIRE_ROWS} rows: {time.perf_counter() - t0:.2f} s",
              flush=True)
        version = service._store.get_version("wire")
        check(version.size == WIRE_ROWS, f"wire size {version.size}")

        rng = np.random.default_rng(SEED + 3)
        queries = rng.standard_normal((WIRE_B, DIMS), dtype=np.float32)
        resp = stub.NearestNeighbor(pb.NearestNeighborRequest(
            space="wire", embedding=pb.Embedding(values=queries[0].tolist()), num=10))
        check(list(resp.keys) == version.nearest(10, vector=queries[0]),
              "NearestNeighbor by embedding differs from the store")
        resp = stub.NearestNeighbor(pb.NearestNeighborRequest(space="wire", key="w5", num=10))
        check(list(resp.keys) == version.nearest(10, key="w5") and "w5" not in resp.keys,
              "NearestNeighbor by key differs from the store")
        # num=1500 fetches 2048: K1's large-k route
        resp = stub.NearestNeighbor(pb.NearestNeighborRequest(
            space="wire", embedding=pb.Embedding(values=queries[1].tolist()), num=BIG_NUM))
        check(len(resp.keys) == BIG_NUM
              and list(resp.keys) == version.nearest(BIG_NUM, vector=queries[1]),
              f"NearestNeighbor num={BIG_NUM} differs from the store")
        req = pb.BatchNearestNeighborRequest(space="wire", num=10)
        for qv in queries:
            req.embeddings.add().values[:] = qv.tolist()
        t0 = time.perf_counter()
        resp = stub.BatchNearestNeighbor(req)
        batch_s = time.perf_counter() - t0
        check([list(r.keys) for r in resp.results] == version.nearest_batch(queries, 10),
              "BatchNearestNeighbor differs from the store")
        print(f"[wire] BatchNearestNeighbor B={WIRE_B} k=10: {batch_s * 1e3:.1f} ms "
              f"round trip", flush=True)
        got = stub.Get(pb.GetRequest(space="wire", key="w7"))
        check(np.array_equal(np.asarray(got.embedding.values, np.float32), rows[7]),
              "Get differs")

        stub.FreezeSpace(pb.FreezeSpaceRequest(name="wire"))
        for what, call, code in (
            ("Set after FreezeSpace",
             lambda: stub.Set(pb.SetRequest(space="wire", key="new",
                                            embedding=pb.Embedding(values=rows[0].tolist()))),
             grpc.StatusCode.FAILED_PRECONDITION),
            ("NearestNeighbor with key and embedding",
             lambda: stub.NearestNeighbor(pb.NearestNeighborRequest(
                 space="wire", key="w1", embedding=pb.Embedding(values=rows[1].tolist()),
                 num=3)),
             grpc.StatusCode.INVALID_ARGUMENT),
        ):
            try:
                call()
            except grpc.RpcError as e:
                check(e.code() == code, f"{what}: {e.code()} != {code}")
            else:
                raise RuntimeError(f"check failed: {what} succeeded")
        print("[wire] answers equal the in-process store's; FAILED_PRECONDITION "
              "and INVALID_ARGUMENT as expected", flush=True)
    finally:
        channel.close()
        server.stop(0).wait()
        service.stop()
    return True


def dir_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


def phase_restore(torch, x_host, launches):
    from embeddinghub_tpu_torch.store.hub import EmbeddingHub

    rng = np.random.default_rng(SEED + 4)
    queries = rng.standard_normal((MAIN_B, DIMS), dtype=np.float32)
    keys = [f"k{j}" for j in range(ROWS)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_restore_") as tmp:
        base = Path(tmp) / "store"
        vdir = base / "restore" / "initial"
        hub = EmbeddingHub.load_or_create(base, device="cuda")
        version = hub.create_space("restore", DIMS, "cosine").default_version()
        t0 = time.perf_counter()
        for s in range(0, ROWS, FLUSH):
            version.multiset(zip(keys[s:s + FLUSH], x_host[s:s + FLUSH]))
        ingest_s = time.perf_counter() - t0
        print(f"[restore] multiset {ROWS} rows in {FLUSH}-row batches, WAL on: "
              f"{ingest_s:.2f} s ({ROWS / ingest_s:.0f} rows/s); WAL "
              f"{(vdir / 'wal.bin').stat().st_size} bytes", flush=True)
        version.delete("k123")
        want = version.nearest_batch(queries, MAIN_K)
        check(all(len(r) == MAIN_K and "k123" not in r for r in want),
              "nearest_batch before the restart")
        del hub, version  # dropped unsaved: the WAL is all that is left
        gc.collect()
        torch.cuda.empty_cache()

        def reopen(what):
            t0 = time.perf_counter()
            hub = EmbeddingHub.load_or_create(base, device="cuda")
            reopen_s = time.perf_counter() - t0
            version = hub.get_version("restore")
            check(version is not None and version.size == ROWS - 1
                  and "k123" not in version, f"{what}: store after reopen")
            before = launches["fused_topk_search_v2"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = version.nearest_batch(queries, MAIN_K)
            first_s = time.perf_counter() - t0
            check(got == want, f"{what}: nearest_batch differs from before the restart")
            check(launches["fused_topk_search_v2"] > before, f"{what}: K2 not launched")
            print(f"[restore] reopen from {what}: {reopen_s:.2f} s; first "
                  f"nearest_batch B={MAIN_B} (with the full upload) "
                  f"{first_s * 1e3:.1f} ms; lists equal to before the restart",
                  flush=True)
            return hub, version

        hub, version = reopen("the WAL alone")
        t0 = time.perf_counter()
        hub.save()
        save_s = time.perf_counter() - t0
        snap = next(vdir.glob("index-*"))
        print(f"[restore] save: {save_s:.2f} s; snapshot {dir_bytes(snap)} bytes "
              f"+ meta.json {(vdir / 'meta.json').stat().st_size} bytes; WAL "
              f"{(vdir / 'wal.bin').stat().st_size} bytes after", flush=True)
        del hub, version
        gc.collect()
        torch.cuda.empty_cache()
        hub, version = reopen("the snapshot")

        x_dev = torch.from_numpy(x_host[:ROWS]).cuda()
        for k, b, engine in ((MAIN_K, MAIN_B, "fused_topk_search"),
                             (BIG_K, BIG_B, "fused_topk_search_large_k")):
            before = launches[engine]
            t0 = time.perf_counter()
            d_ex, i_ex = version.index.search(queries[:b], k, mode="exact")
            exact_s = time.perf_counter() - t0
            check(launches[engine] > before, f"exact k={k} did not run {engine}")
            od, oi = exact_oracle(torch, x_dev, torch.from_numpy(queries[:b]).cuda(),
                                  k, dead=(123,))
            swaps = check_exact(i_ex, d_ex, od, oi, queries[:b], x_host,
                                f"restored exact k={k}")
            print(f"[restore] exact search B={b} k={k} ({engine}): "
                  f"{exact_s * 1e3:.1f} ms, {swaps} tie swaps vs oracle", flush=True)
        del x_dev, hub, version
        gc.collect()
        torch.cuda.empty_cache()


def phase_crash(torch, x_host):
    """Returns the kernel launches of the restarted server's process, or
    None when grpc is not installed."""
    try:
        import grpc
    except ImportError as e:
        print(f"[crash] not run: grpc is not installed ({e})", flush=True)
        return None
    from concurrent.futures import TimeoutError as FutureTimeout

    from embeddinghub_tpu_torch.sdk.client import EmbeddingHubClient
    from embeddinghub_tpu_torch.service.spawn import ServerProcess

    rows = x_host[:CRASH_ROWS]
    keys = [f"c{j}" for j in range(CRASH_ROWS)]
    bounds = dict(device="cuda", start_timeout=SERVER_START_S, wait_timeout=WAIT_S)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_crash_") as tmp:
        data_dir = Path(tmp) / "store"
        t0 = time.perf_counter()
        server = ServerProcess(data_dir, **bounds)
        print(f"[crash] server subprocess up in {time.perf_counter() - t0:.1f} s",
              flush=True)
        try:
            c = EmbeddingHubClient(host="127.0.0.1", port=server.port)
            c.create_space("crash", DIMS)
            t0 = time.perf_counter()
            c.multiset("crash", ((keys[j], rows[j].tolist()) for j in range(CRASH_ROWS)))
            ingest_s = time.perf_counter() - t0
            futures = [c.set("crash", f"u{j}", x_host[CRASH_ROWS + j].tolist(), wait=False)
                       for j in range(CRASH_UNACKED)]
            os.kill(server.proc.pid, signal.SIGKILL)
            server.proc.wait(timeout=WAIT_S)
            lost = 0
            for f in futures:
                try:
                    f.result(timeout=WAIT_S)
                except (grpc.RpcError, FutureTimeout):
                    lost += 1
            c.close()
            print(f"[crash] MultiSet {CRASH_ROWS} acknowledged rows: {ingest_s:.2f} s "
                  f"({CRASH_ROWS / ingest_s:.0f} rows/s); SIGKILL with "
                  f"{CRASH_UNACKED} set(wait=False) sent, {lost} of them failed",
                  flush=True)
        finally:
            server.kill()

        t0 = time.perf_counter()
        server = ServerProcess(data_dir, port=server.port, **bounds)
        restart_s = time.perf_counter() - t0
        try:
            c = EmbeddingHubClient(host="127.0.0.1", port=server.port)
            got = np.asarray(list(c.multiget("crash", keys)), dtype=np.float32)
            check(np.array_equal(got, rows), "acknowledged rows not bit-exact after restart")
            n = sum(1 for _ in c.download("crash"))
            check(n >= CRASH_ROWS, f"download holds {n} < {CRASH_ROWS} rows")
            near = list(c.nearest_neighbor("crash", MAIN_K, key="c5"))
            check(len(near) == MAIN_K and "c5" not in near, f"keyed nearest {near}")
            c.close()
            launches = server.stop()
        finally:
            server.kill()
    print(f"[crash] restart on the same directory: {restart_s:.1f} s to listening; "
          f"all {CRASH_ROWS} acknowledged rows bit-exact, download {n} rows, "
          f"keyed nearest excludes the key", flush=True)
    return launches


def phase_offline(torch, x_host):
    from embeddinghub_tpu_torch.sdk.offline import Index
    from embeddinghub_tpu_torch.store.version import Version

    rows = x_host[:OFFLINE_ROWS]
    keys = [f"o{j}" for j in range(OFFLINE_ROWS)]
    queries = np.random.default_rng(SEED + 5).standard_normal((OFFLINE_B, DIMS),
                                                              dtype=np.float32)
    t0 = time.perf_counter()
    index = Index(zip(keys, rows), DIMS, metric="cosine", device="cuda")
    build_s = time.perf_counter() - t0
    got = index.nearest_neighbor_batch(MAIN_K, queries)
    version = Version("offline", "initial", DIMS, "cosine", device="cuda")
    version.multiset(zip(keys, rows))
    check(got == version.nearest_batch(queries, MAIN_K),
          "offline Index differs from a Version over the same rows")
    check(index.nearest_neighbor(MAIN_K, key="o5") == version.nearest(MAIN_K, key="o5"),
          "offline keyed nearest_neighbor differs")
    x_dev = torch.from_numpy(rows).cuda()
    _, oi = exact_oracle(torch, x_dev, torch.from_numpy(queries).cuda(), MAIN_K)
    hits = sum(len({int(k[1:]) for k in r} & set(o)) for r, o in zip(got, oi.cpu().numpy()))
    recall = hits / (OFFLINE_B * MAIN_K)
    check(recall >= OFFLINE_RECALL, f"offline recall@{MAIN_K} {recall} < {OFFLINE_RECALL}")
    print(f"[offline] Index over {OFFLINE_ROWS} rows on cuda: built in {build_s:.2f} s; "
          f"nearest_neighbor_batch B={OFFLINE_B} and keyed nearest_neighbor equal "
          f"a Version's; recall@{MAIN_K} vs exact oracle {recall:.5f}", flush=True)
    del index, version, x_dev
    torch.cuda.empty_cache()


def sift_desc(count: int, r):
    """``count`` SIFT-descriptor-statistics rows of 128 integer-valued f32
    from generator ``r``: a numpy copy of ``sample_desc`` in
    benchmarks/cluster_build.py:40-76, which imports the JAX package's
    benchmarks."""
    base_ori = r.uniform(0, 8, size=(count, 1, 1))
    drift = r.normal(0, 1.2, size=(count, 4, 4)).cumsum(2)
    ori = (base_ori + drift) % 8
    bins = np.arange(8)[None, None, None, :]
    ang = np.minimum(np.abs(bins - ori[..., None]), 8 - np.abs(bins - ori[..., None]))
    resp = np.exp(-(ang ** 2) / (2 * 1.1 ** 2))
    energy = r.gamma(2.0, 1.0, size=(count, 4, 4, 1))
    noise = r.gamma(1.0, 0.25, size=(count, 4, 4, 8))
    d = (resp * energy + noise).reshape(count, 128)
    d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-12
    d = np.minimum(d, 0.2)
    d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-12
    return np.floor(512.0 * d).astype(np.float32)


def sift_rows(n: int, seed: int) -> np.ndarray:
    """``n`` rows of :func:`sift_desc` from rng ``seed``, drawn chunk by chunk
    as ``sift_desc_chunked`` draws them."""
    chunk = 1 << 18
    rng = np.random.default_rng(seed)
    out = np.empty((n, DIMS), np.float32)
    for done in range(0, n, chunk):
        out[done:done + chunk] = sift_desc(min(chunk, n - done), rng)
    return out


def sift_proxy(n: int, nq: int, dims: int):
    """SIFT-proxy rows ``[n, dims]`` (rng seed 0) and queries ``[nq, dims]``
    (rng seed 1), as benchmarks/cluster_build.py draws them."""
    return sift_rows(n, 0), sift_desc(nq, np.random.default_rng(1))


def graph_walk(torch, index, test, oracle, ef, what, tag="graph"):
    """Recall@10 of ``index.search`` at ``ef`` against ``oracle`` rows,
    device ms per batch (CUDA events, median of 5 after 2 warm-ups) and
    the beam's hops."""
    _, ids = index.search(test, GRAPH_K, ef=ef)
    recall = np.mean([len(set(a) & set(b)) / GRAPH_K for a, b in zip(ids, oracle)])
    ms = device_ms(torch, lambda: index.search(test, GRAPH_K, ef=ef))
    hops = index.last_hops
    print(f"[{tag}] search {what} B={len(test)} k={GRAPH_K} ef={ef}: "
          f"recall@{GRAPH_K} {recall:.4f}; {ms:.3f} ms per batch, "
          f"{hops} hops, {ms / hops:.3f} ms per hop", flush=True)
    return recall


def phase_graph(torch, launches, wire, base):
    """Phase 8.  Returns what phase 9 writes into: the reopened store (behind
    the gRPC server when grpc is installed), the rows and the queries."""
    from embeddinghub_tpu_torch.index.hnsw import HNSWIndex
    from embeddinghub_tpu_torch.ops import distance as D
    from embeddinghub_tpu_torch.ops import fused_topk as F
    from embeddinghub_tpu_torch.store.hub import EmbeddingHub
    from embeddinghub_tpu_torch.utils.config import Config

    t0 = time.perf_counter()
    train, test = sift_proxy(ROWS, GRAPH_QUERIES, DIMS)
    print(f"[graph] SIFT proxy {ROWS} x {DIMS} and {GRAPH_QUERIES} queries: "
          f"{time.perf_counter() - t0:.1f} s on the host", flush=True)
    keys = [f"g{j}" for j in range(ROWS)]
    config = Config(engine="hnsw", hnsw_m=GRAPH_M, hnsw_ef_construction=GRAPH_EFC)
    hub = EmbeddingHub.load_or_create(base, engine="hnsw", device=CARD)
    version = hub.create_space("graph", DIMS, "l2").default_version()
    index = version.index
    check(isinstance(index, HNSWIndex) and (index.m, index.ef_construction)
          == (GRAPH_M, GRAPH_EFC), "engine=hnsw did not give an M=16 efC=200 graph")
    before = launches["fused_topk_search"]
    t0 = time.perf_counter()
    version.multiset(zip(keys, train))
    ingest_s = time.perf_counter() - t0
    built = launches["fused_topk_search"] - before
    check(built > 0, "the bulk build did not launch K1")
    parts = ", ".join(f"{k} {v:.2f}" for k, v in index.build_seconds.items())
    print(f"[graph] multiset {ROWS} rows, WAL on, one exact bulk build: "
          f"{ingest_s:.2f} s; build {sum(index.build_seconds.values()):.2f} s "
          f"({parts}); K1 launched {built} times; levels up to "
          f"{index._max_level}", flush=True)

    x_dev = torch.from_numpy(train).to(CARD)
    q_dev = torch.from_numpy(test).to(CARD)
    valid = torch.ones(ROWS, dtype=torch.bool, device=CARD)
    _, oracle = F.exact_topk(q_dev, x_dev, valid, D.sqnorms(x_dev), k=GRAPH_K,
                             metric="l2", exact=True)
    oracle = oracle.cpu().numpy()
    del x_dev, q_dev, valid

    recalls = {ef: graph_walk(torch, index, test, oracle, ef, "bf16 walk")
               for ef in GRAPH_EFS}
    check(recalls[100] >= GRAPH_RECALL,
          f"recall@10 at ef=100 {recalls[100]} < {GRAPH_RECALL}")
    t0 = time.perf_counter()
    index.pack_walk()
    torch.cuda.synchronize()
    print(f"[graph] pack_walk: {time.perf_counter() - t0:.2f} s", flush=True)
    graph_walk(torch, index, test, oracle, 100, "packed walk")
    index.walk_packed = False

    want = version.nearest_batch(test, GRAPH_K)
    singles = [version.nearest(GRAPH_K, vector=test[j]) for j in range(8)]
    t0 = time.perf_counter()
    hub.save()
    save_s = time.perf_counter() - t0
    del hub, version, index
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[graph] save: {save_s:.2f} s; snapshot "
          f"{dir_bytes(base / 'graph' / 'initial')} bytes", flush=True)
    ctx = {"train": train, "test": test, "base": base, "wire": None}
    if not wire:
        hub = EmbeddingHub.load_or_create(base, engine="hnsw", device=CARD)
        check(hub.get_version("graph").nearest_batch(test, GRAPH_K) == want,
              "nearest_batch after the reopen differs")
        print("[graph] over the wire: not run (grpc is not installed); "
              "reopened from the snapshot, nearest_batch lists equal", flush=True)
        ctx["hub"] = hub
        return ctx
    import grpc

    from embeddinghub_tpu_torch.service.server import build_server, pb, pb_grpc

    t0 = time.perf_counter()
    server, service, port = build_server("127.0.0.1:0", CARD, data_dir=str(base),
                                         config=config)
    reopen_s = time.perf_counter() - t0
    server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    ctx["hub"], ctx["wire"] = service._store, (server, service, channel)
    version = service._store.get_version("graph")
    check(isinstance(version.index, HNSWIndex) and version.size == ROWS,
          "the reopened store holds no 1M-row graph")
    check(version.nearest_batch(test, GRAPH_K) == want,
          "nearest_batch after the reopen differs")
    stub = pb_grpc.EmbeddingHubStub(channel)
    req = pb.BatchNearestNeighborRequest(space="graph", num=GRAPH_K)
    for qv in test:
        req.embeddings.add().values[:] = qv.tolist()
    resp = stub.BatchNearestNeighbor(req)
    check([list(r.keys) for r in resp.results] == want,
          "BatchNearestNeighbor differs from the store before the save")
    for j, keys_j in enumerate(singles):
        resp = stub.NearestNeighbor(pb.NearestNeighborRequest(
            space="graph", embedding=pb.Embedding(values=test[j].tolist()),
            num=GRAPH_K))
        check(list(resp.keys) == keys_j,
              "NearestNeighbor differs from the store before the save")
    print(f"[graph] reopened from the snapshot in process ({reopen_s:.2f} s): "
          f"nearest_batch, BatchNearestNeighbor (B={GRAPH_QUERIES}) and "
          f"NearestNeighbor (8 queries) equal the lists before the save",
          flush=True)
    return ctx


def close_graph(torch, ctx) -> None:
    """Stops phase 8's server, if it runs, and drops its store."""
    if ctx.get("wire"):
        server, service, channel = ctx["wire"]
        channel.close()
        server.stop(0).wait()
        service.stop()
    ctx.pop("wire", None)
    ctx.pop("hub", None)
    gc.collect()
    torch.cuda.empty_cache()


class Rows:
    """What phase 9 has written: every key, its vector and whether it is
    live, for the oracle over the live rows and the reopen's checks."""

    def __init__(self, keys, vecs):
        self.keys, self.vecs = list(keys), [vecs]
        self.live = dict.fromkeys(self.keys, True)
        self.at = {k: j for j, k in enumerate(self.keys)}

    def add(self, keys, vecs):
        for k in keys:
            self.at[k] = len(self.keys)
            self.keys.append(k)
            self.live[k] = True
        self.vecs.append(vecs)

    def matrix(self):
        if len(self.vecs) > 1:
            self.vecs = [np.concatenate(self.vecs)]
        return self.vecs[0]

    def vector(self, key):
        return self.matrix()[self.at[key]]

    def oracle(self, torch, version, queries, k=GRAPH_K):
        """Exact top-k rows of the version over its live keys, from K1 with
        f32 operands on an arena built from what was written."""
        from embeddinghub_tpu_torch.ops import distance as D
        from embeddinghub_tpu_torch.ops import fused_topk as F

        live = [key for key, ok in self.live.items() if ok]
        rows = np.fromiter((version.keymap.row(key) for key in live), np.int64, len(live))
        x = torch.zeros((int(rows.max()) + 1, DIMS), dtype=torch.float32, device=CARD)
        x[torch.from_numpy(rows).to(CARD)] = torch.from_numpy(
            self.matrix()[[self.at[key] for key in live]]).to(CARD)
        valid = torch.zeros(x.shape[0], dtype=torch.bool, device=CARD)
        valid[torch.from_numpy(rows).to(CARD)] = True
        _, ids = F.exact_topk(torch.from_numpy(queries).to(CARD), x, valid,
                              D.sqnorms(x), k=k, metric="l2", exact=True)
        return ids.cpu().numpy()


def phase_writes(torch, launches, ctx):
    """Phase 9: writes into the reopened 1M-row graph of phase 8."""
    from embeddinghub_tpu_torch.index.hnsw import WAVE_SECONDS
    from embeddinghub_tpu_torch.store.hub import EmbeddingHub

    test = ctx["test"]
    version = ctx["hub"].get_version("graph")
    index = version.index
    t_phase = t0 = time.perf_counter()
    new = sift_rows(WAVE_ROWS + WIRE_WAVE_ROWS + FLUSH, 2)
    new_keys = [f"w{j}" for j in range(len(new))]
    print(f"[writes] {len(new)} new SIFT-proxy rows (rng seed 2): "
          f"{time.perf_counter() - t0:.1f} s on the host", flush=True)
    rows = Rows((f"g{j}" for j in range(ROWS)), ctx["train"])

    # 1. in process: one wave a multiset
    per_wave, parts, special = [], dict.fromkeys(WAVE_SECONDS, 0.0), []
    k1 = launches["fused_topk_search"]
    waves0 = index.waves
    t_all = time.perf_counter()
    for b in range(WAVE_ROWS // FLUSH):
        s = b * FLUSH
        cap0, fresh = index._cap, index._device_state is None
        t0 = time.perf_counter()
        version.multiset(zip(new_keys[s:s + FLUSH], new[s:s + FLUSH]))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        seconds = dict(index.wave_seconds)
        if fresh or index._cap != cap0:
            special.append((b, dt, seconds, cap0, index._cap, fresh))
        else:
            per_wave.append(dt)
            for key, v in seconds.items():
                parts[key] += v
    in_s = time.perf_counter() - t_all
    rows.add(new_keys[:WAVE_ROWS], new[:WAVE_ROWS])
    k1_waves = launches["fused_topk_search"] - k1
    check(index.waves - waves0 == WAVE_ROWS // FLUSH, "a multiset was not one wave")
    check(k1_waves > 0, "the waves did not launch K1")
    check(version.size == ROWS + WAVE_ROWS and index._cap == 2 * CAP,
          f"size {version.size} capacity {index._cap}")
    n = len(per_wave)
    print(f"[writes] {WAVE_ROWS // FLUSH} multisets of {FLUSH} rows in process "
          f"(one wave each): {in_s:.2f} s, {WAVE_ROWS / in_s:.0f} rows/s; K1 "
          f"launched {k1_waves} times; median {statistics.median(per_wave) * 1e3:.1f} "
          f"ms a multiset over the {n} waves without a rebuild", flush=True)
    print(f"[writes] wave parts, mean ms a wave over those {n}: " + ", ".join(
        f"{key} {v / n * 1e3:.2f}" for key, v in parts.items())
        + f"; store (keys, WAL) "
        f"{(sum(per_wave) - sum(parts.values())) / n * 1e3:.2f}", flush=True)
    for b, dt, seconds, cap0, cap1, fresh in special:
        what = ("the first wave after the reopen: the device state built whole"
                if fresh else f"the capacity growth {cap0} -> {cap1}: the device "
                "state rebuilt whole")
        print(f"[writes] multiset {b + 1}, {what}: {dt * 1e3:.1f} ms, of which "
              f"rebuild {seconds['rebuild'] * 1e3:.1f} ms, pool0 "
              f"{seconds['pool0'] * 1e3:.1f} ms", flush=True)

    # 2. over the wire: 5 flushes, 5 waves
    s = WAVE_ROWS
    wire_keys = new_keys[s:s + WIRE_WAVE_ROWS]
    if ctx.get("wire"):
        from embeddinghub_tpu_torch.service.server import pb, pb_grpc

        stub = pb_grpc.EmbeddingHubStub(ctx["wire"][2])

        def requests():
            for j in range(WIRE_WAVE_ROWS):
                req = pb.MultiSetRequest(space="graph", key=wire_keys[j])
                req.embedding.values[:] = new[s + j].tolist()
                yield req

        waves0 = index.waves
        t0 = time.perf_counter()
        stub.MultiSet(requests())
        wire_s = time.perf_counter() - t0
        check(index.waves - waves0 == WIRE_WAVE_ROWS // FLUSH,
              f"wire MultiSet made {index.waves - waves0} waves")
        print(f"[writes] raw-stub MultiSet of {WIRE_WAVE_ROWS} rows "
              f"({WIRE_WAVE_ROWS // FLUSH} flushes, one wave each): {wire_s:.2f} s, "
              f"{WIRE_WAVE_ROWS / wire_s:.0f} rows/s", flush=True)
    else:
        for j in range(0, WIRE_WAVE_ROWS, FLUSH):
            version.multiset(zip(wire_keys[j:j + FLUSH], new[s + j:s + j + FLUSH]))
        print("[writes] over the wire: not run (grpc is not installed); the same "
              f"{WIRE_WAVE_ROWS} rows by multiset", flush=True)
    rows.add(wire_keys, new[s:s + WIRE_WAVE_ROWS])
    check(version.size == ROWS + WAVE_ROWS + WIRE_WAVE_ROWS, f"size {version.size}")
    # the last wave pooled layer 1 over the members of the rows before it
    upper = int(np.count_nonzero(index._levels[:WAVE_HI] >= 1))
    check(upper == WAVE_UPPER, f"layer-1 members at the last wave: {upper}")

    # 3. recall against an exact oracle over every live row; new rows
    # find themselves
    oracle = rows.oracle(torch, version, test)
    recalls = {ef: graph_walk(torch, index, test, oracle, ef, "after the inserts",
                              "writes") for ef in GRAPH_EFS}
    check(recalls[100] >= GRAPH_RECALL,
          f"recall@10 at ef=100 after the inserts {recalls[100]} < {GRAPH_RECALL}")
    pick = np.linspace(0, WAVE_ROWS + WIRE_WAVE_ROWS - 1, SELF_QUERIES).astype(np.int64)
    want_rows = np.asarray([version.keymap.row(new_keys[j]) for j in pick])
    _, ids = index.search(new[pick], GRAPH_K, ef=100)
    self_rate = float(np.mean([r in got for r, got in zip(want_rows, ids)]))
    print(f"[writes] self-check: {SELF_QUERIES} inserted rows queried by their own "
          f"vectors at ef=100 find themselves in their top {GRAPH_K}: {self_rate:.4f}",
          flush=True)
    check(self_rate >= SELF_RATE, f"self-check {self_rate} < {SELF_RATE}")

    # 4. deletes: half old rows, half new
    gone = ([f"g{j}" for j in range(0, ROWS, 2 * ROWS // DELETES)][:DELETES // 2]
            + [new_keys[j] for j in range(0, WAVE_ROWS + WIRE_WAVE_ROWS,
                                          (WAVE_ROWS + WIRE_WAVE_ROWS) * 2 // DELETES)
               ][:DELETES // 2])
    check(len(set(gone)) == DELETES, "delete keys")
    gone_rows = np.asarray([version.keymap.row(k) for k in gone])
    t0 = time.perf_counter()
    version.delete(gone[0])
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for key in gone[1:]:
        version.delete(key)
    rest_s = time.perf_counter() - t0
    for key in gone:
        rows.live[key] = False
    lists = version.nearest_batch(test, GRAPH_K)
    gone_set = set(gone)
    check(not any(k in gone_set for r in lists for k in r), "a deleted key came back")
    _, ids = index.search(rows.matrix()[[rows.at[k] for k in gone[::10]]], GRAPH_K,
                          ef=100)
    check(not np.isin(ids, gone_rows).any(), "a deleted row came back")
    print(f"[writes] {DELETES} deletes ({DELETES // 2} old rows, {DELETES // 2} new): "
          f"the first {first_s * 1e3:.1f} ms (it pulls the graph down to the host), "
          f"the other {DELETES - 1} {rest_s:.2f} s, {(DELETES - 1) / rest_s:.0f} "
          f"deletes/s; no deleted key in any list", flush=True)
    oracle = rows.oracle(torch, version, test)
    after_delete = graph_walk(torch, index, test, oracle, 100, "after the deletes",
                              "writes")
    check(after_delete >= GRAPH_RECALL,
          f"recall@10 at ef=100 after the deletes {after_delete} < {GRAPH_RECALL}")

    # 5. refine 8,192 inserted rows
    ref_rows = np.asarray([version.keymap.row(new_keys[j])
                           for j in range(0, WAVE_ROWS, 2)
                           if rows.live[new_keys[j]]][:REFINE_ROWS])
    k1 = launches["fused_topk_search"]
    t0 = time.perf_counter()
    with version.lock:
        index.refine(ref_rows)
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t0
    check(launches["fused_topk_search"] > k1, "refine did not launch K1")
    print(f"[writes] refine of {len(ref_rows)} inserted rows: {refine_s:.2f} s, K1 "
          f"launched {launches['fused_topk_search'] - k1} times", flush=True)
    refined = graph_walk(torch, index, test, oracle, 100, "after the refine", "writes")
    check(refined >= after_delete - 0.005,
          f"recall@10 at ef=100 fell from {after_delete} to {refined} in the refine")

    # 6. save; then a wave and 100 deletes unsaved; reopen from snapshot + WAL
    t0 = time.perf_counter()
    ctx["hub"].save()
    save_s = time.perf_counter() - t0
    s = WAVE_ROWS + WIRE_WAVE_ROWS
    version.multiset(zip(new_keys[s:], new[s:]))
    rows.add(new_keys[s:], new[s:])
    late_gone = [f"g{j}" for j in range(1, 200, 2)]
    for key in late_gone:
        version.delete(key)
        rows.live[key] = False
    n_live = sum(rows.live.values())
    check(version.size == n_live, f"size {version.size} != {n_live}")
    del version, index
    close_graph(torch, ctx)
    t0 = time.perf_counter()
    hub = EmbeddingHub.load_or_create(ctx["base"], engine="hnsw", device=CARD)
    reopen_s = time.perf_counter() - t0
    version = hub.get_version("graph")
    check(version.size == n_live, f"reopened size {version.size} != {n_live}")
    live = [k for k, ok in rows.live.items() if ok]
    got = np.stack(version.multiget(live))
    check(np.array_equal(got, rows.matrix()[[rows.at[k] for k in live]]),
          "an acknowledged key is not bit-exact after the reopen")
    check(not any(k in version for k in gone + late_gone), "a deleted key is back")
    oracle = rows.oracle(torch, version, test)
    reopened = graph_walk(torch, version.index, test, oracle, 100,
                          "after the reopen", "writes")
    check(reopened >= GRAPH_RECALL,
          f"recall@10 at ef=100 after the reopen {reopened} < {GRAPH_RECALL}")
    print(f"[writes] save {save_s:.2f} s; then {FLUSH} rows and {len(late_gone)} "
          f"deletes unsaved; reopen from snapshot + WAL {reopen_s:.2f} s: all "
          f"{n_live} acknowledged keys bit-exact (Get), no deleted key", flush=True)
    print(f"[writes] phase 9: {time.perf_counter() - t_phase:.1f} s", flush=True)
    del hub, version
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # every f32 product in full f32
    from embeddinghub_tpu_torch.ops import _build
    from embeddinghub_tpu_torch.ops import fused_topk as F

    t0 = time.perf_counter()
    _build.library()
    print(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}; kernel build {time.perf_counter() - t0:.1f} s",
          flush=True)

    rng = np.random.default_rng(SEED)
    x_host = rng.standard_normal((ROWS, DIMS), dtype=np.float32)
    report: dict = {}
    phase_kernels(torch, x_host, report)

    # Each path: counts zeroed just before it, read just after it.
    paths = {}
    F.reset_launches()
    phase_main(torch, x_host, F.LAUNCHES)
    wire = phase_wire(torch, x_host)
    paths["main"] = dict(F.LAUNCHES)
    needs = {"main": tuple(F.LAUNCHES) if wire else ("fused_topk_search",
                                                     "fused_topk_search_v2"),
             "restore": tuple(F.LAUNCHES),
             "offline": ("fused_topk_search_v2",),
             "graph": ("fused_topk_search",),
             "writes": ("fused_topk_search",),
             "crash": ("fused_topk_search",)}
    for path, run in (("restore", lambda: phase_restore(torch, x_host, F.LAUNCHES)),
                      ("offline", lambda: phase_offline(torch, x_host))):
        F.reset_launches()
        run()
        paths[path] = dict(F.LAUNCHES)
    # the graph path builds and saves the graph (phase 8) and the writes path
    # writes into it after a reopen (phase 9)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_graph_") as tmp:
        ctx = {}
        try:
            F.reset_launches()
            ctx = phase_graph(torch, F.LAUNCHES, wire, Path(tmp) / "store")
            paths["graph"] = dict(F.LAUNCHES)
            F.reset_launches()
            phase_writes(torch, F.LAUNCHES, ctx)
            paths["writes"] = dict(F.LAUNCHES)
        finally:
            close_graph(torch, ctx)
    # the crash path's kernels run in the server subprocess, which reports them
    crash = phase_crash(torch, x_host)
    if crash is not None:
        paths["crash"] = crash
    for path, counts in paths.items():
        print(f"[{path}] launches on the {path} path: {counts}", flush=True)
        for name in needs[path]:
            check(counts.get(name, 0) > 0, f"{name} was not launched on the {path} path")

    replaces = {"fused_topk_search": "embeddinghub_tpu/ops/pallas_topk.py:124",
                "fused_topk_search_v2": "embeddinghub_tpu/ops/pallas_topk.py:270",
                "fused_topk_search_large_k": "embeddinghub_tpu/ops/pallas_topk.py:124"}
    sources = {"fused_topk_search": "embeddinghub_tpu_torch/csrc/k1_scan.cu",
               "fused_topk_search_v2": "embeddinghub_tpu_torch/csrc/k2_scan.cu",
               "fused_topk_search_large_k": "embeddinghub_tpu_torch/csrc/k1_scan.cu"}
    # An entry per summary case.  launches: the count of the path the case
    # belongs to (CASE_PATH: the main path's; the graph path's for the
    # build's pool shapes, the writes path's for the waves');
    # paths: each path's own.  A main entry's max_abs_err is its kernel's
    # largest over every case.
    entries = []
    for name, label in SUMMARY.values():
        path = CASE_PATH[label]
        numbers = dict(report[(name, label)])
        if label == "main":
            numbers["max_abs_err"] = report[name]["max_abs_err"]
        entries.append({
            "name": name, "case": label, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": paths[path][name],
            "paths": {p: counts.get(name, 0) for p, counts in paths.items()},
            **{key: numbers[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "bound_unit",
                "fma_bound_ms", "library_ms", "shape")}})
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
