#!/usr/bin/env python3
"""What bounds K1's scan and its large-k route: the scan with parts of it
switched off, and the large-k route split by kernel, on one CUDA card.

    python3 tools/probe_k1_parts.py

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
# variant -> [(file, old, new)]
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
}

_TIMER = r'''
import statistics, sys
from pathlib import Path
import torch
sys.path.insert(0, sys.argv[3])
from embeddinghub_tpu_torch.ops import _build, distance as D, fused_topk as F
from torch.profiler import ProfilerActivity, profile
_build.library_path = lambda: Path(sys.argv[1])
D.full_f32()
gen = torch.Generator(device="cuda").manual_seed(0)
cap, rows, dims = 1 << 20, 1_000_000, 128
x = torch.zeros((cap, dims), device="cuda")
x[:rows] = torch.randn(rows, dims, device="cuda", generator=gen)
x = D.normalize(x)
x_sq = D.sqnorms(x)
valid = torch.arange(cap, device="cuda") < rows

def kernels_ms(run, runs=5):
    """name -> (median ms per call, launches per call)."""
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
            if len(v) == runs}

for b in (4096, 1024, 16):
    q = torch.randn(b, dims, device="cuda", generator=gen)
    got = kernels_ms(lambda: F.exact_topk(q, x, valid, x_sq, k=16, metric="cosine"))
    scan = sum(t for n, (t, _) in got.items() if "scan_kernel" in n)
    rest = sum(t for n, (t, _) in got.items() if "scan_kernel" not in n)
    print(f"{sys.argv[2]} B={b} scan_ms={scan:.3f} other_kernels_ms={rest:.3f}", flush=True)
if sys.argv[2] == "full":
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
    import torch

    if not torch.cuda.is_available():
        print("probe_k1_parts: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from embeddinghub_tpu_torch.ops import _build

    src = REPO / "embeddinghub_tpu_torch" / "csrc"
    out = REPO / "embeddinghub_tpu_torch" / "_build" / "k1_parts"
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
    for name, edits in VARIANTS.items():
        d = out / name / "csrc"
        shutil.copytree(src, d)
        for file, old, new_text in edits:
            text = (d / file).read_text()
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in {file}")
            (d / file).write_text(text.replace(old, new_text))
        dirs[name] = d
        header = any(f.endswith(".cuh") for f, _, _ in edits)
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
    for name, d in dirs.items():
        # each variant in its own process: one kernel library per process
        subprocess.run([sys.executable, "-c", _TIMER, str(d / "lib.so"), name, str(REPO)],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
