#!/usr/bin/env python3
"""What bounds K2's scan and its candidate pools: the scan with parts of it
switched off, and each pool call split by kernel, on one CUDA card.

    python3 tools/probe_k2_parts.py [--tree DIR] [--pools-only] [--variants A,B]

``--tree`` probes the kernels and the package of another checkout (an
earlier commit unpacked into a directory, to split its kernels with this
probe); ``--pools-only`` skips the main path's shape.

Builds copies of ``embeddinghub_tpu_torch/csrc`` in which one text edit of
``k2_scan.cu`` switches a part of the scan off (each copy under
``embeddinghub_tpu_torch/_build/parts/<name>/``, every ``nvcc`` run started
together; the other sources are compiled once), then times each variant in
its own process (``torch.profiler``, median of 5 calls after a warm-up):

  * the main path, ``k2_scan_kernel`` alone over 1,000,000 x 128 cosine rows
    (capacity 1,048,576), k=128, at B = 4096, 1024 and 1;
  * the candidate pools (``fused_topk.pool_candidates``, cosine rows drawn
    on the card): the int8 instantiation at 1M x 128 (B=4096, k=128, one
    segment), at 10,485,760 x 96 with 10,000,000 live rows (B=1,024, k=256,
    40 segments of 262,144 rows) and a shard's 4,194,304 x 96 with
    2,500,000 live (B=1,024, k=256, 16 segments); the bf16 pool at the deep
    shape (k=128).  Each call is split into the scan, the select and the
    wrapper's other kernels (by name, with their launches), beside the
    call's device time from CUDA events.  The live rows go to the wrapper
    where it takes them (``rows``).

The variants:

  * ``full``: the kernels as they are;
  * ``no_epilogue``: TMA stream and products, no bin winners or keys;
  * ``no_products``: TMA stream and epilogue on zero products;
  * ``stream``: the TMA stream alone;
  * ``min_only``: the epilogue keeps each chain's minimum but not its row;
  * ``shared_a``: bf16 queries from shared memory by every product (the
    path of rows wider than 192 columns) instead of from registers;
  * ``stream_4_stages``: the stream alone through a ring of 4 stages;
  * ``no_wait_timeout``: the barrier waits without their 10 s timeout;
  * ``no_scores``: the epilogue stores its keys but computes no score (no
    conversion, products, differences or minima).

``full`` also prints the opcode counts of each scan instantiation's SASS
(``cuobjdump -sass`` of the built cubin): the epilogue's instructions a
score, the int32 -> f32 conversions among them (``I2FP``, or ``I2F``).  For each
variant it prints how many ptxas C7514 notes (every wgmma serialized) the
scan kernels get.  The switched-off variants compute wrong candidates, so
nothing but time is read from them.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
K2 = "k2_scan.cu"

# An edit is a list of (old, new) pairs, each applied where the source has
# its old text, at least one of them.
_NO_PRODUCTS = [("      wgmma_128_rs(acc, afrag[j][kk]",
                 "      if (j < 0) wgmma_128_rs(acc, afrag[j][kk]")]
_NO_PRODUCTS_I8 = [
    ("            wgmma_128_i8(acc, sw128_desc(a_addr + 32 * kk), sw128_desc(b_addr + 32 * kk),\n"
     "                         (j | kk) != 0);",
     "          { if (j < 0) wgmma_128_i8(acc, sw128_desc(a_addr + 32 * kk), "
     "sw128_desc(b_addr + 32 * kk), (j | kk) != 0); }")]
# (a condition no thread meets: where an int8 sum hit the value, one thread
# alone would wait at the key store's named barrier)
_NO_EPILOGUE = [("  if (e.active && write) {",
                 "  if (e.active && write && acc[0] == 12345 && e.tile_bytes < 0) {")]
VARIANTS = {
    "full": [],
    "no_epilogue": [_NO_EPILOGUE],
    "no_products": [_NO_PRODUCTS, _NO_PRODUCTS_I8],
    "stream": [_NO_PRODUCTS, _NO_PRODUCTS_I8, _NO_EPILOGUE],
    "no_scores": [[("    for (int j = 0; j < GROUP / 8; ++j) {\n      const float2 bb",
                    "    for (int j = 0; j < 0; ++j) {\n      const float2 bb")]],
    "min_only": [[("        c[p] = sa < v[p] ? 8 * j + h : c[p];\n", "")],
                 [("        c[2 + p] = sb < v[2 + p] ? 8 * j + h : c[2 + p];\n", "")]],
    "shared_a": [[("  const int rs = L.resident && L.nb <= 3 && L.stages >= 2 * L.nb ? L.nb : 0;",
                   "  const int rs = 0;")]],
    "stream_4_stages": [_NO_PRODUCTS, _NO_PRODUCTS_I8, _NO_EPILOGUE,
                        [("constexpr int MAX_STAGES = 8;", "constexpr int MAX_STAGES = 4;")]],
    "no_wait_timeout": [[("""    if ((++polls & 1023u) == 0) {
      if (start == 0)
        start = now_ns();
      else if (now_ns() - start > 10000000000ull)
        __trap();
    }
""", "")]],
}
# edits of hopper_common.cuh rather than k2_scan.cu
_HEADER_EDITS = {"no_wait_timeout"}
POOL_VARIANTS = ("full", "no_epilogue", "no_products", "stream", "no_scores")

# (label, dtype, B, k, capacity, live rows, dims, segment rows or None)
POOL_SHAPES = (
    ("int8 1M", "int8", 4096, 128, 1 << 20, 1_000_000, 128, None),
    ("int8 deep", "int8", 1024, 256, 10 << 20, 10_000_000, 96, 1 << 18),
    ("int8 shard deep", "int8", 1024, 256, 1 << 22, 2_500_000, 96, 1 << 18),
    ("bf16 deep", "bf16", 1024, 128, 10 << 20, 10_000_000, 96, 1 << 18),
)

_TIMER = r'''
import inspect, statistics, sys
from pathlib import Path
import torch
sys.path.insert(0, sys.argv[3])
from embeddinghub_tpu_torch.index.flat import quantize_planes
from embeddinghub_tpu_torch.ops import _build, distance as D, fused_topk as F
from torch.profiler import ProfilerActivity, profile
_build.library_path = lambda: Path(sys.argv[1])
POOL_SHAPES = POOL_SHAPES_HERE
name, main_too, pools = sys.argv[2], sys.argv[4] == "1", sys.argv[5] == "1"
D.full_f32()
gen = torch.Generator(device="cuda").manual_seed(0)

def kernels_ms(run, runs=5):
    """name -> (median ms per call, launches per call), over the runs whose
    trace has the kernel."""
    run()
    out = {}
    for _ in range(runs):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.self_device_time_total > 0:
                out.setdefault(e.key, []).append((e.self_device_time_total / 1e3, e.count))
    return {n: (statistics.median(t for t, _ in v), v[0][1]) for n, v in out.items()
            if 2 * len(v) > runs}

def events_ms(run, runs=5):
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)

if main_too:
    cap, rows, dims = 1 << 20, 1_000_000, 128
    x = torch.zeros((cap, dims), device="cuda")
    x[:rows] = torch.randn(rows, dims, device="cuda", generator=gen)
    x = D.normalize(x)
    xb, x_sq = F.arena_bf16(x), D.sqnorms(x)
    valid = torch.arange(cap, device="cuda") < rows
    for b in (4096, 1024, 1):
        q = torch.randn(b, dims, device="cuda", generator=gen)
        got = kernels_ms(lambda: F.approx_candidates(q, xb, valid, x_sq, k=128,
                                                     metric="cosine"))
        scan = sum(t for n, (t, _) in got.items() if "k2_scan" in n)
        sel = sum(t for n, (t, _) in got.items() if "k2_select" in n)
        print(f"{name} main B={b} scan_ms={scan:.3f} select_ms={sel:.3f}", flush=True)
    del x, xb, x_sq, valid

takes_rows = "rows" in inspect.signature(F.pool_candidates).parameters
arenas = {}
for label, dtype, b, k, cap, rows, dims, seg in (POOL_SHAPES if pools else ()):
    if dims not in arenas:  # one arena a width; a shape takes its prefix
        arenas.clear()
        torch.cuda.empty_cache()
        big = max(c for *_, c, _, d, _ in POOL_SHAPES if d == dims)
        n_live = max(r for *_, r, d, _ in POOL_SHAPES if d == dims)
        raw = torch.zeros((big, dims), device="cuda")
        raw[:n_live] = torch.randn((n_live, dims), device="cuda", generator=gen)
        arenas[dims] = (quantize_planes(raw, "cosine", "int8"),
                        F.arena_bf16(D.normalize(raw)) if any(
                            s[1] == "bf16" and s[6] == dims for s in POOL_SHAPES) else None)
        del raw
    p8, xb = arenas[dims]
    i8 = dtype == "int8"
    plane = p8["hi"][:cap] if i8 else xb[:cap]
    q = D.normalize(torch.randn((b, dims), device="cuda", generator=gen))
    valid = torch.arange(cap, device="cuda") < rows
    kw = dict(k=k, metric="cosine", seg=seg)
    if takes_rows:
        kw["rows"] = rows
    args = (q, plane, valid, p8["sq"][:cap], p8["sc"][:cap] if i8 else None)
    run = lambda: F.pool_candidates(*args, **kw)
    got = kernels_ms(run)
    scan = sum(t for n, (t, _) in got.items() if "k2_scan" in n)
    sel = sum(t for n, (t, _) in got.items() if "k2_select" in n)
    rest = {n: v for n, v in got.items() if "k2_scan" not in n and "k2_select" not in n}
    calls = sum(c for n, (_, c) in got.items() if "k2_scan" in n)
    print(f"{name} {label} B={b} k={k} cap={cap} rows={rows} D={dims} scan_ms={scan:.3f} "
          f"(launches {calls}) select_ms={sel:.3f} other_kernels_ms="
          f"{sum(t for t, _ in rest.values()):.3f} call_ms={events_ms(run):.3f}", flush=True)
    if name == "full":
        for n, (t, c) in sorted(rest.items(), key=lambda kv: -kv[1][0]):
            print(f"    {t:.3f} ms x{c}  {n[:90]}", flush=True)
'''


def sass_counts(cuobjdump: str, cubin: Path) -> dict[str, Counter]:
    """Opcode counts of each k2_scan_kernel instantiation's SASS."""
    text = subprocess.run([cuobjdump, "-sass", str(cubin)], capture_output=True, text=True,
                          check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            cur = m.group(1) if "k2_scan_kernel" in m.group(1) else None
            if cur:
                out[cur] = Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\.[A-Z0-9_.]+)?",
                     line)
        if cur and m:
            out[cur][m.group(1)] += 1
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, default=None,
                    help="the checkout whose kernels and package to probe (default: this one)")
    ap.add_argument("--pools-only", action="store_true", help="skip the main path's shape")
    ap.add_argument("--variants", default=None, help="comma-separated names: only these")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("probe_k2_parts: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from embeddinghub_tpu_torch.ops import _build

    tree = (args.tree or REPO).resolve()
    src = tree / "embeddinghub_tpu_torch" / "csrc"
    out = REPO / "embeddinghub_tpu_torch" / "_build" / (
        "parts" if args.tree is None else "parts_tree")
    variants = {n: e for n, e in VARIANTS.items()
                if (n in POOL_VARIANTS or not args.pools_only)
                and (args.variants is None or n in args.variants.split(","))}
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    shutil.rmtree(out, ignore_errors=True)
    nvcc = _build._nvcc()
    shared = out / "_shared"
    shared.mkdir(parents=True)
    others = [s for s in sorted(src.glob("*.cu")) if s.name != K2]
    compiles = [[nvcc, *_build._FLAGS, "-c", "-o", str(shared / f"{s.stem}.o"), str(s)]
                for s in others]
    dirs = {}
    for name, edits in variants.items():
        d = out / name / "csrc"
        shutil.copytree(src, d)
        file = "hopper_common.cuh" if name in _HEADER_EDITS else K2
        text = (d / file).read_text()
        skipped = False
        for pairs in edits:
            hits = [(o, n) for o, n in pairs if o in text]
            if not hits:
                print(f"{name}: {pairs[0][0]!r} is not in this tree, skipped", flush=True)
                skipped = True
                break
            for old, new_text in hits:
                text = text.replace(old, new_text)
        if skipped:
            continue
        (d / file).write_text(text)
        dirs[name] = d
        for s in [d / K2] + ([d / o.name for o in others] if name in _HEADER_EDITS else []):
            compiles.append([nvcc, *_build._FLAGS, "-c", "-o", str(d / f"{s.stem}.o"), str(s)])
    _build._run_all(compiles)  # every object at once, then the links
    links = []
    for d in dirs.values():
        objs = {o.stem: o for o in shared.glob("*.o")}
        objs.update({o.stem: o for o in d.glob("*.o")})
        links.append([nvcc, *_build._FLAGS, "-shared", "-o", str(d / "lib.so"),
                      *map(str, objs.values())])
    _build._run_all(links)
    notes = [[nvcc, *_build._FLAGS, "-Xptxas", "-v", "-cubin", "-o", str(d / "k2.cubin"),
              str(d / K2)] for d in dirs.values()]
    procs = [subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True) for cmd in notes]
    for name, p in zip(dirs, procs):
        err = p.communicate()[1]
        print(f"{name} ptxas C7514 notes: {err.count('C7514')}", flush=True)
        if name == "full":
            for line in err.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"    {line.strip()}", flush=True)
    if "full" in dirs:
        cuobjdump = str(Path(nvcc).parent / "cuobjdump")
        for fn, ops in sass_counts(cuobjdump, dirs["full"] / "k2.cubin").items():
            top = ", ".join(f"{o} {c}" for o, c in ops.most_common(24))
            print(f"full SASS {fn}: {sum(ops.values())} instructions; I2F {ops['I2F']}, "
                  f"I2FP {ops['I2FP']}; {top}", flush=True)
    timer = _TIMER.replace("POOL_SHAPES_HERE", repr(POOL_SHAPES))
    failed = False
    for name, d in dirs.items():
        # each variant in its own process: one kernel library per process
        rc = subprocess.run([sys.executable, "-c", timer, str(d / "lib.so"), name,
                             str(tree), str(int(not args.pools_only)),
                             str(int(name in POOL_VARIANTS))]).returncode
        if rc:
            print(f"{name}: the timing process exited with {rc}", flush=True)
            failed = True
    return int(failed)


if __name__ == "__main__":
    sys.exit(main())
