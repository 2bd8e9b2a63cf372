#!/usr/bin/env python3
"""What bounds K1's scan and its large-k route: the scan with parts of it
switched off, and the large-k route split by kernel, on one CUDA card.

    python3 tools/probe_k1_parts.py [--tree DIR] [--long-only] [--variants A,B]

``--tree`` probes the kernels and the package of another checkout (an
earlier commit unpacked into a directory, to split its scan with this
probe); ``--long-only`` runs only the long-list shapes and their
variants.

Builds copies of ``embeddinghub_tpu_torch/csrc`` in which text edits of the
K1 source switch a part of the scan off (each copy under
``embeddinghub_tpu_torch/_build/k1_parts/<name>/``, all ``nvcc`` runs
started together; the other sources are compiled once), then times the scan
kernel alone (``torch.profiler``, median of 5 calls after a warm-up, each
variant in its own process) over 1,000,000 x 128 cosine rows (capacity
1,048,576), k=16, at B = 4096, 1024 and 16:

  * ``full``: the scan as it is;
  * ``no_epilogue``: stream and products, no candidate leaves a thread;
  * ``no_products``: stream and epilogue on zero products (every score
    ties, and only a strictly smaller one is queued: the lists fill once);
  * ``stream``: the arena stream alone;
  * ``one_pass``: one TF32 product instead of the three of the compensated
    split (wrong results at f32 grade; only the time is of interest);
  * ``stream_4_stages``: the stream alone through a ring of at most 4 boxes;
  * ``nq_64``: query tiles of at most 64;
  * ``no_wait_timeout``: the barrier waits without their 10 s timeout.

Then the long lists (k > 32) at three of the graph engine's pool shapes,
bf16 operands, l2, over random normal rows: the graph pool (B=4096,
k=256, 1,000,000 rows), a shard's wave pool (B=1,024, k=200, 251,024
rows) and the routed pool (B=4096, k=257, 32,768 rows), each split into
the stream (``stream``), the products (``no_epilogue`` less ``stream``),
the epilogue and the drains (``full`` less ``no_epilogue``), the drains
alone (``drain_clock``: the share of each scan block's cycles its
consumers spend in drains, from ``clock64`` on one thread a block, times
the scan's time), and the merge kernel.  ``drain_clock`` also counts the
drains a block and the candidates merged into each (query, split) list;
``long_ring_8`` gives the long lists a ring of 8 boxes (and shorter
queues), ``long_least_eighth`` drains of every queue an eighth full (not a
quarter), ``long_no_refresh`` no bound for the queries a drain passes
over.

For each variant it also prints how many ptxas C7514 notes (every wgmma
serialized) the source gets.  Then, with the unedited build, it splits one
call of the large-k route (B=16, k=2048, and B=1 over 131,072 rows) into
its kernels by name: the store (the scan), the radix digits, the collect,
the sort and the epilogue, with the launches of each.

The switched-off variants compute wrong answers, so nothing but time is
read from them.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_NO_PRODUCTS = ("Mma<N>::rs(acc,", "if (box < 0) Mma<N>::rs(acc,")
# with no products every score ties: only a strictly smaller one may pass
_STRICT = ("if (sc[f] <= ((f & 1) ? thy : thx)) {", "if (sc[f] < ((f & 1) ? thy : thx)) {")
_NO_EPILOGUE = ("fminf(s1, s3) - th.y) <= 0.f)", "fminf(s1, s3) - th.y) <= 0.f && acc[0] == 12345.f)")
_NO_TIMEOUT = ("""    if ((++polls & 1023u) == 0) {
      if (start == 0)
        start = now_ns();
      else if (now_ns() - start > 10000000000ull)
        __trap();
    }
""", "")
# drain_clock: clock64 on thread 0 around every drain of the scan loop and
# around the consumers' whole scan, summed over blocks into k1_probe (drain
# cycles, scan cycles, drains, candidates merged), read by
# ehtorch_probe_read.
_PROBE_DEFS = ("// The per-query state of a block's running lists",
               "__device__ unsigned long long k1_probe[4];\n\n"
               "// The per-query state of a block's running lists")
# candidates merged into the lists (drain_long, or the earlier k > 32 drain)
_PROBE_CANDS = [("    return;\n  }\n  unsigned long long a[E];\n",
                 "    return;\n  }\n  if (lane == 0) atomicAdd(&k1_probe[3], (unsigned long long)cnt);\n"
                 "  unsigned long long a[E];\n"),
                ("  if (cnt == 0) return;\n  unsigned long long worst;\n",
                 "  if (cnt == 0) return;\n  if (lane == 0) atomicAdd(&k1_probe[3], "
                 "(unsigned long long)cnt);\n  unsigned long long worst;\n")]
_PROBE_READ = ('extern "C" {\n', 'extern "C" {\n\nint ehtorch_probe_read(unsigned long long* out) {\n'
               '  cudaError_t e = cudaMemcpyFromSymbol(out, k1_probe, sizeof(k1_probe));\n'
               '  const unsigned long long zero[4] = {0, 0, 0, 0};\n'
               '  if (e == cudaSuccess) e = cudaMemcpyToSymbol(k1_probe, zero, sizeof(zero));\n'
               '  return (int)e;\n}\n')
_PROBE_START = ("  for (int t = t_begin; t < t_end; ++t) {\n    // Boxes two by two",
                "  unsigned long long probe_d = 0, probe_n = 0;\n"
                "  const unsigned long long probe_t0 = clock64();\n"
                "  for (int t = t_begin; t < t_end; ++t) {\n    // Boxes two by two")
# the drain in the retry loop: this tree's text or an earlier one's
_PROBE_DRAIN = [("        drain_all(least);\n", "        const unsigned long long probe_c = clock64();\n"
                 "        drain_all(least);\n        probe_d += clock64() - probe_c;\n"
                 "        ++probe_n;\n"),
                ("        drain_all();\n        named_sync(DRAIN, CONSUMERS);\n",
                 "        const unsigned long long probe_c = clock64();\n        drain_all();\n"
                 "        named_sync(DRAIN, CONSUMERS);\n        probe_d += clock64() - probe_c;\n"
                 "        ++probe_n;\n")]
_PROBE_END = [("    drain_all(1);\n", "    drain_all(1);\n    PROBE_SUM\n"),
               ("    named_sync(DRAIN, CONSUMERS);  // every candidate is queued\n    drain_all();\n",
                "    named_sync(DRAIN, CONSUMERS);  // every candidate is queued\n    drain_all();\n"
                "    PROBE_SUM\n")]
_PROBE_SUM = ("if (tid == 0) { atomicAdd(&k1_probe[0], probe_d); "
              "atomicAdd(&k1_probe[1], clock64() - probe_t0); atomicAdd(&k1_probe[2], probe_n); }")
# variant -> [(file, old, new)]; an entry that is a list takes the first of
# its (old, new) pairs whose old text the source has
VARIANTS = {
    "full": [],
    "no_epilogue": [("k1_scan.cu", *_NO_EPILOGUE)],
    "no_products": [("k1_scan.cu", *_NO_PRODUCTS), ("k1_scan.cu", *_STRICT),
                    ("k1_scan.cu", "fminf(s1, s3) - th.y) <= 0.f)", "fminf(s1, s3) - th.y) < 0.f)")],
    "stream": [("k1_scan.cu", *_NO_PRODUCTS), ("k1_scan.cu", *_NO_EPILOGUE)],
    "one_pass": [
        ("k1_scan.cu", "        Mma<N>::rs(acc, big[kk], sw128_desc(qsmall + boff + 32 * kk), "
                       "keep);\n", ""),
        ("k1_scan.cu", "        Mma<N>::rs(acc, small[kk], sw128_desc(qbig + boff + 32 * kk), 1);\n",
         ""),
        ("k1_scan.cu", "        Mma<N>::rs(acc, big[kk], sw128_desc(qbig + boff + 32 * kk), 1);",
         "        Mma<N>::rs(acc, big[kk], sw128_desc(qbig + boff + 32 * kk), keep);"),
    ],
    "stream_4_stages": [("k1_scan.cu", *_NO_PRODUCTS), ("k1_scan.cu", *_NO_EPILOGUE),
                        ("k1_scan.cu", "constexpr int MAX_STAGES = 8;",
                         "constexpr int MAX_STAGES = 4;")],
    "nq_64": [("k1_scan.cu", "constexpr int MAX_NQ = 128;", "constexpr int MAX_NQ = 64;")],
    "no_wait_timeout": [("hopper_common.cuh", *_NO_TIMEOUT)],
    "long_ring_8": [("k1_scan.cu", "constexpr int LONG_STAGES = 4;",
                     "constexpr int LONG_STAGES = 8;")],
    "long_least_eighth": [("k1_scan.cu", "const int least = MODE == LONG ? (L.qd + 3) / 4 : 1;",
                           "const int least = MODE == LONG ? (L.qd + 7) / 8 : 1;")],
    "long_no_refresh": [("k1_scan.cu", """    const float shared = shared_bound(s.bound, q, lane);
    if (lane == 0) s.thr[qq] = fminf(s.thr[qq], shared);
    return;""", "    return;")],
    "drain_clock": [("k1_scan.cu", *_PROBE_DEFS), ("k1_scan.cu", *_PROBE_READ),
                    ("k1_scan.cu", *_PROBE_START), ("k1_scan.cu", _PROBE_DRAIN),
                    ("k1_scan.cu", _PROBE_CANDS),
                    ("k1_scan.cu", [(o, n.replace("PROBE_SUM", _PROBE_SUM))
                                    for o, n in _PROBE_END])],
}
# the variants timed at the long-list shapes (the others only at k=16)
LONG_VARIANTS = ("full", "no_epilogue", "stream", "drain_clock", "long_ring_8",
                 "long_least_eighth", "long_no_refresh")

LONG_SHAPES = (("graph pool", 4096, 256, 1_000_000),
               ("shard wave pool", 1024, 200, 251_024),
               ("routed pool", 4096, 257, 32_768))

_TIMER = r'''
import statistics, sys
from pathlib import Path
import torch
sys.path.insert(0, sys.argv[3])
from embeddinghub_tpu_torch.ops import _build, distance as D, fused_topk as F
from torch.profiler import ProfilerActivity, profile
_build.library_path = lambda: Path(sys.argv[1])
LONG_SHAPES = LONG_SHAPES_HERE
LONG_VARIANTS = LONG_VARIANTS_HERE
D.full_f32()
gen = torch.Generator(device="cuda").manual_seed(0)
cap, rows, dims = 1 << 20, 1_000_000, 128
x = torch.zeros((cap, dims), device="cuda")
x[:rows] = torch.randn(rows, dims, device="cuda", generator=gen)
x = D.normalize(x)
x_sq = D.sqnorms(x)
valid = torch.arange(cap, device="cuda") < rows

def kernels_ms(run, runs=5):
    """name -> (median ms per call, launches per call), over the runs whose
    trace has the kernel (a profiler cycle now and then drops a run's
    events: a kernel missing from more than half the runs reads 0)."""
    run()
    out = {}
    for _ in range(runs):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            out.setdefault(e.key, []).append((e.self_device_time_total / 1e3, e.count))
    return {n: (statistics.median(t for t, _ in v), v[0][1]) for n, v in out.items()
            if 2 * len(v) > runs}

name, long_only = sys.argv[2], sys.argv[4] == "1"
clock = name == "drain_clock"
if not long_only and not clock:
    for b in (4096, 1024, 16):
        q = torch.randn(b, dims, device="cuda", generator=gen)
        got = kernels_ms(lambda: F.exact_topk(q, x, valid, x_sq, k=16, metric="cosine"))
        scan = sum(t for n, (t, _) in got.items() if "scan_kernel" in n)
        rest = sum(t for n, (t, _) in got.items() if "scan_kernel" not in n)
        print(f"{name} B={b} scan_ms={scan:.3f} other_kernels_ms={rest:.3f}", flush=True)
if name in LONG_VARIANTS:
    # the long lists (never the large-k route): l2 over random normal rows,
    # bf16 operands
    F.LARGE_K_FROM = getattr(F, "MAX_K_LISTS", F.MAX_K_EXACT)
    xl = torch.randn(cap, dims, device="cuda", generator=gen)
    xl_sq = D.sqnorms(xl)
    lib = _build.library()
    for label, b, k, c in LONG_SHAPES:
        q = torch.randn(b, dims, device="cuda", generator=gen)
        live = torch.ones(c, dtype=torch.bool, device="cuda")
        run = lambda: F.exact_topk(q, xl[:c], live, xl_sq[:c], k=k, metric="l2", exact=False)
        got = kernels_ms(run)
        scan = sum(t for n, (t, _) in got.items() if "scan_kernel" in n)
        merge = sum(t for n, (t, _) in got.items() if "merge_kernel" in n)
        line = f"{name} {label} B={b} k={k} rows={c} scan_ms={scan:.3f} merge_ms={merge:.3f}"
        if clock:
            import ctypes
            lib.ehtorch_probe_read.argtypes = [ctypes.c_void_p]
            probe = (ctypes.c_ulonglong * 4)()
            torch.cuda.synchronize()
            lib.ehtorch_probe_read(probe)  # clears what the timing runs summed
            run()
            torch.cuda.synchronize()
            if lib.ehtorch_probe_read(probe) != 0:
                raise RuntimeError("ehtorch_probe_read failed")
            share = probe[0] / max(probe[1], 1)
            nq = lib.ehtorch_k1_tile(b, dims, 0, 0)
            splits, _ = F._splits(b, nq, c, torch.device("cuda"), F._MERGE_SLOTS // k)
            blocks = -(-b // nq) * splits
            line += (f" drain_share={share:.4f} drains_ms={share * scan:.3f}"
                     f" drains_a_block={probe[2] / blocks:.1f} blocks={blocks}"
                     f" merged_a_list={probe[3] / (b * splits):.1f}")
        print(line, flush=True)
if name == "full" and not long_only:
    for b, c in ((16, cap), (1, 1 << 17)):
        q = torch.randn(b, dims, device="cuda", generator=gen)
        got = kernels_ms(lambda: F.exact_topk_large_k(q, x[:c], valid[:c], x_sq[:c], k=2048,
                                                      metric="cosine"))
        total = sum(t for t, _ in got.values())
        print(f"large k B={b} cap={c} k=2048: device ms in kernels {total:.3f}, "
              f"launches {sum(n for _, n in got.values())}", flush=True)
        for n, (t, count) in sorted(got.items(), key=lambda kv: -kv[1][0]):
            print(f"    {t:.3f} ms x{count}  {n[:100]}", flush=True)
'''


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, default=None,
                    help="the checkout whose kernels and package to probe (default: this one)")
    ap.add_argument("--long-only", action="store_true",
                    help="only the long-list shapes and their variants")
    ap.add_argument("--variants", default=None,
                    help="comma-separated names: only these variants")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("probe_k1_parts: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from embeddinghub_tpu_torch.ops import _build

    tree = (args.tree or REPO).resolve()
    src = tree / "embeddinghub_tpu_torch" / "csrc"
    out = REPO / "embeddinghub_tpu_torch" / "_build" / (
        "k1_parts" if args.tree is None else "k1_parts_tree")
    variants = {n: e for n, e in VARIANTS.items()
                if (n in LONG_VARIANTS or not args.long_only)
                and (args.variants is None or n in args.variants.split(","))}
    if args.tree is not None:  # an earlier tree may lack what a variant edits
        for name in list(variants):
            for file, *edit in variants[name]:
                pairs = edit[0] if len(edit) == 1 else [tuple(edit)]
                if not any(o in (src / file).read_text() for o, _ in pairs):
                    print(f"{name}: not in this tree, skipped", flush=True)
                    del variants[name]
                    break
    k1 = "k1_scan.cu"
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    shutil.rmtree(out, ignore_errors=True)
    nvcc = _build._nvcc()
    dirs, compiles = {}, []
    shared = out / "_shared"
    shared.mkdir(parents=True)
    others = [s for s in sorted(src.glob("*.cu")) if s.name != k1]
    compiles += [[nvcc, *_build._FLAGS, "-c", "-o", str(shared / f"{s.stem}.o"), str(s)]
                 for s in others]
    for name, edits in variants.items():
        d = out / name / "csrc"
        shutil.copytree(src, d)
        for file, *edit in edits:
            text = (d / file).read_text()
            pairs = edit[0] if len(edit) == 1 else [tuple(edit)]
            old, new_text = next(((o, n) for o, n in pairs if o in text), (None, None))
            if old is None:
                raise RuntimeError(f"{name}: none of {[o for o, _ in pairs]!r} is in {file}")
            (d / file).write_text(text.replace(old, new_text))
        dirs[name] = d
        header = any(e[0].endswith(".cuh") for e in edits)
        for s in [d / k1] + ([d / o.name for o in others] if header else []):
            compiles.append([nvcc, *_build._FLAGS, "-c", "-o", str(d / f"{s.stem}.o"), str(s)])
    _build._run_all(compiles)  # every object at once, then the links
    links = []
    for d in dirs.values():
        objs = {o.stem: o for o in shared.glob("*.o")}
        objs.update({o.stem: o for o in d.glob("*.o")})
        links.append([nvcc, *_build._FLAGS, "-shared", "-o", str(d / "lib.so"),
                      *map(str, objs.values())])
    _build._run_all(links)
    notes = [[nvcc, *_build._FLAGS, "-Xptxas", "-v", "-cubin", "-o", str(d / "k1.cubin"),
              str(d / k1)] for d in dirs.values()]
    procs = [subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True) for cmd in notes]
    for name, p in zip(dirs, procs):
        print(f"{name} ptxas C7514 notes: {p.communicate()[1].count('C7514')}", flush=True)
    timer = (_TIMER.replace("LONG_SHAPES_HERE", repr(LONG_SHAPES))
             .replace("LONG_VARIANTS_HERE", repr(LONG_VARIANTS)))
    for name, d in dirs.items():
        # each variant in its own process: one kernel library per process
        subprocess.run([sys.executable, "-c", timer, str(d / "lib.so"), name, str(tree),
                        str(int(args.long_only))], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
