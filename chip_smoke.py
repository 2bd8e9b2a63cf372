#!/usr/bin/env python3
"""Smoke run of the PyTorch port (embeddinghub_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), the CUDA version,
   and the seconds it takes to build the kernels from csrc/.
2. Kernels against their plain PyTorch versions, on the card, at 1M rows
   (capacity 1,048,576) x 128: K1 at k=16 and K2 at k=128, at B=1024 for
   l2 and cosine, and at every shape the main path gives them (cosine: K1
   at B=4096 under mode="exact", K2 at B=4096 under mode="auto" and at B=1
   for a single keyed query), plus K1's bf16-operand instantiation.  Median
   device ms of each (CUDA events, 5 runs after 2 warm-ups); the summary
   line reports the B=4096 cosine times.
3. Main path in process, at SIFT-1M scale: EmbeddingHub on "cuda" ->
   create_space(128, cosine) -> Version.multiset of 1,000,000 keyed rows in
   4096-row batches -> nearest_batch of 4096 queries at k=10 under
   mode="auto" (must run K2, recall@10 >= 0.995 against an exact oracle
   computed on the card) -> FlatIndex.search(mode="exact") (must run K1,
   ids equal to the oracle up to ties) -> keyed nearest (excludes self) ->
   delete (the key never comes back).
4. Over the wire: the port's gRPC server in process on 127.0.0.1, driven
   through the raw EmbeddingHubStub: CreateSpace, MultiSet of 100,000 rows,
   NearestNeighbor by embedding and by key, BatchNearestNeighbor of 1024
   queries and Get must equal the in-process store's answers; Set after
   FreezeSpace fails with FAILED_PRECONDITION, NearestNeighbor with key and
   embedding with INVALID_ARGUMENT.  Skipped, with the reason printed, when
   grpc is not installed.

The launch counters are zeroed just before phase 3 and read after phase 4.
The second-to-last line is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.  Data comes from numpy with a fixed seed.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 20261016
ROWS, CAP, DIMS = 1_000_000, 1 << 20, 128
# (kernel, metric, B, k, exact) compared with its plain version; exact is
# K1's operand precision (None for K2, which is always bf16).
KERNEL_CASES = (
    ("fused_topk_search", "l2", 1024, 16, True),
    ("fused_topk_search", "cosine", 1024, 16, True),
    ("fused_topk_search", "cosine", 1024, 16, False),
    ("fused_topk_search", "cosine", 4096, 16, True),
    ("fused_topk_search_v2", "l2", 1024, 128, None),
    ("fused_topk_search_v2", "cosine", 1024, 128, None),
    ("fused_topk_search_v2", "cosine", 4096, 128, None),
    ("fused_topk_search_v2", "cosine", 1, 128, None),
)
MAIN_B, MAIN_K = 4096, 10
WIRE_ROWS, WIRE_B = 100_000, 1024
FLUSH = 4096  # the server's MultiSet flush size


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


def phase_kernels(torch, x_host, report):
    from embeddinghub_tpu_torch.ops import distance as D
    from embeddinghub_tpu_torch.ops import fused_topk as F

    kernels = {
        "fused_topk_search": (F.exact_topk, F.fused_topk_search_reference),
        "fused_topk_search_v2": (F.approx_candidates, F.fused_topk_search_v2_reference),
    }
    rng = np.random.default_rng(SEED + 1)
    q_all = torch.from_numpy(rng.standard_normal(
        (max(c[2] for c in KERNEL_CASES), DIMS), dtype=np.float32)).cuda()
    raw = torch.zeros((CAP, DIMS), dtype=torch.float32, device="cuda")
    raw[:ROWS] = torch.from_numpy(x_host).cuda()
    valid = torch.zeros(CAP, dtype=torch.bool, device="cuda")
    valid[:ROWS] = True
    for metric in ("l2", "cosine"):
        x = D.preprocess_vectors(raw, metric)
        x_sq = D.sqnorms(x)
        for name, m, b, k, exact in KERNEL_CASES:
            if m != metric:
                continue
            kernel, plain = kernels[name]
            q = q_all[:b]
            args = dict(k=k, metric=metric)
            if exact is not None:
                args["exact"] = exact
            bf16 = exact is not True
            # (tie gap, rtol, atol): f32 operands on both sides differ only
            # in summation order; bf16 operands leave ties 1e-3 wide
            gap, rtol, atol = (1e-3, 1e-3, 1e-3) if bf16 else (1e-4, 1e-5, 1e-4)
            got = kernel(q, x, valid, x_sq, **args)
            want = plain(q, x, valid, x_sq, **args)
            torch.cuda.synchronize()
            err, swaps = compare(
                torch, f"{name}/{metric}/B={b}", got, want,
                lambda ids: scores_of(torch, q, x, x_sq, ids, metric, bf16),
                gap, rtol, atol)
            ms = device_ms(torch, lambda: kernel(q, x, valid, x_sq, **args))
            plain_ms = device_ms(torch, lambda: plain(q, x, valid, x_sq, **args))
            print(f"[kernels] {name} {metric} B={b} cap={CAP} k={k}"
                  f"{'' if exact is None else f' exact={exact}'}: "
                  f"max_abs_err={err:.3g} tie_swaps={swaps} "
                  f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f}", flush=True)
            entry = report.setdefault(name, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            if metric == "cosine" and b == MAIN_B and exact is not False:
                # the main path's shape: these are the summary line's times
                entry["ms"], entry["plain_ms"] = ms, plain_ms
        del x, x_sq
    del raw, valid, q_all
    torch.cuda.empty_cache()


def exact_oracle(torch, x_dev, queries, k, chunk=1 << 17):
    """Exact cosine top-k on the card, in chunks, independent of the port:
    f32 products (TF32 is off for the whole script)."""
    qn = queries / queries.norm(dim=1, keepdim=True).clamp(min=1e-30)
    best_d = best_i = None
    for s in range(0, x_dev.shape[0], chunk):
        xs = x_dev[s:s + chunk]
        xs = xs / xs.norm(dim=1, keepdim=True).clamp(min=1e-30)
        d = 1 - qn @ xs.T
        cd, ci = torch.topk(d, k, dim=1, largest=False)
        ci = ci + s
        if best_d is None:
            best_d, best_i = cd, ci
        else:
            best_d, pos = torch.topk(torch.cat([best_d, cd], 1), k, dim=1, largest=False)
            best_i = torch.gather(torch.cat([best_i, ci], 1), 1, pos)
    return best_d, best_i


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
    swaps = i_ex != oi_host
    od_host = od.cpu().numpy()
    if swaps.any():
        qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
        xr = x_host[i_ex[swaps]]
        xr = xr / np.linalg.norm(xr, axis=1, keepdims=True)
        rq = np.nonzero(swaps)[0]
        true_d = 1 - np.einsum("nd,nd->n", xr, qn[rq])
        check(np.abs(true_d - od_host[swaps]).max() <= 1e-4,
              "exact ids differ from the oracle beyond ties")
    check(np.allclose(d_ex, od_host, rtol=1e-5, atol=1e-4), "exact distances")
    print(f"[main] exact search B={MAIN_B}: {exact_s * 1e3:.1f} ms "
          f"({MAIN_B / exact_s:.0f} queries/s), {int(swaps.sum())} tie swaps "
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

    F.reset_launches()
    phase_main(torch, x_host, F.LAUNCHES)
    wire = phase_wire(torch, x_host)
    launches = dict(F.LAUNCHES)
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    print(f"[main] launches on the main path (in-process{' + wire' if wire else ''}): "
          f"{launches}", flush=True)

    replaces = {"fused_topk_search": "embeddinghub_tpu/ops/pallas_topk.py:124",
                "fused_topk_search_v2": "embeddinghub_tpu/ops/pallas_topk.py:270"}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "embeddinghub_tpu_torch/csrc/fused_topk.cu",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": report[name]["max_abs_err"],
         "ms": report[name]["ms"], "plain_ms": report[name]["plain_ms"]}
        for name in ("fused_topk_search", "fused_topk_search_v2")]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
