#!/usr/bin/env python3
"""What bounds K2's scan: the scan with parts of it switched off, on one
CUDA card.

    python3 tools/probe_k2_parts.py

Builds copies of ``embeddinghub_tpu_torch/csrc`` in which one text edit of
``k2_scan.cu`` switches a part of the scan off (each copy under
``embeddinghub_tpu_torch/_build/parts/<name>/``, all ``nvcc`` runs started
together), then times ``k2_scan_kernel`` alone (``torch.profiler``, median
of 5 calls after a warm-up, each in its own process) over 1,000,000 x 128
cosine rows (capacity 1,048,576), k=128, at B = 4096, 1024 and 1:

  * ``full``: the scan as it is;
  * ``no_epilogue``: TMA stream and products, no group winners or keys;
  * ``no_products``: TMA stream and epilogue on zero products;
  * ``stream``: the TMA stream alone;
  * ``min_only``: the epilogue keeps each chain's minimum but not its row
    (the keys are wrong; only the time is of interest);
  * ``shared_a``: the queries taken from shared memory by every product
    (the path of rows wider than 192 columns) instead of from registers;
  * ``stream_4_stages``: the TMA stream alone through a ring of 4 stages
    instead of 8;
  * ``no_wait_timeout``: the barrier waits without their 10 s timeout.

For each variant it also prints how many ptxas C7514 notes (every wgmma
serialized) the scan kernels get.

The switched-off variants compute wrong candidates, so nothing but time is
read from them.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "embeddinghub_tpu_torch" / "csrc"
OUT = REPO / "embeddinghub_tpu_torch" / "_build" / "parts"

_NO_PRODUCTS = ("      wgmma_128_rs(acc, afrag[j][kk]", "      if (j < 0) wgmma_128_rs(acc, afrag[j][kk]")
_NO_EPILOGUE = ("  if (e.active && write) {", "  if (e.active && write && acc[0] == 12345.f) {")
VARIANTS = {
    "full": [],
    "no_epilogue": [_NO_EPILOGUE],
    "no_products": [_NO_PRODUCTS],
    "stream": [_NO_PRODUCTS, _NO_EPILOGUE],
    "min_only": [("        c[p] = sa < v[p] ? 8 * j + h : c[p];\n", ""),
                 ("        c[2 + p] = sb < v[2 + p] ? 8 * j + h : c[2 + p];\n", "")],
    "shared_a": [("  const int rs = L.resident && L.nb <= 3 && L.stages >= 2 * L.nb ? L.nb : 0;",
                  "  const int rs = 0;")],
    "stream_4_stages": [_NO_PRODUCTS, _NO_EPILOGUE,
                        ("constexpr int MAX_STAGES = 8;", "constexpr int MAX_STAGES = 4;")],
    "no_wait_timeout": [("""    if ((++polls & 1023u) == 0) {
      if (start == 0)
        start = now_ns();
      else if (now_ns() - start > 10000000000ull)
        __trap();
    }
""", "")],
}

_TIMER = r'''
import statistics, sys
from pathlib import Path
import torch
sys.path.insert(0, sys.argv[2])
from embeddinghub_tpu_torch.ops import _build, distance as D, fused_topk as F
from torch.profiler import ProfilerActivity, profile
_build.library_path = lambda: Path(sys.argv[1]).parent / "lib" / "lib.so"
gen = torch.Generator(device="cuda").manual_seed(0)
cap, rows, dims = 1 << 20, 1_000_000, 128
x = torch.zeros((cap, dims), device="cuda")
x[:rows] = torch.randn(rows, dims, device="cuda", generator=gen)
x = D.normalize(x)
xb, x_sq = F.arena_bf16(x), D.sqnorms(x)
valid = torch.arange(cap, device="cuda") < rows
for b in (4096, 1024, 1):
    q = torch.randn(b, dims, device="cuda", generator=gen)
    run = lambda: F.approx_candidates(q, xb, valid, x_sq, k=128, metric="cosine")
    run()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        times.append(sum(e.self_device_time_total for e in prof.key_averages()
                         if "k2_scan" in e.key) / 1e3)
    print(f"{sys.argv[3]} B={b} scan_ms={statistics.median(times):.3f}", flush=True)
'''


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_k2_parts: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from embeddinghub_tpu_torch.ops import _build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    shutil.rmtree(OUT, ignore_errors=True)
    dirs = {}
    for name, edits in VARIANTS.items():
        d = OUT / name / "csrc"
        shutil.copytree(SRC, d)
        text = (d / "k2_scan.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in k2_scan.cu")
            text = text.replace(old, new)
        (d / "k2_scan.cu").write_text(text)
        dirs[name] = d
    # every variant's objects at once, then the links
    nvcc = _build._nvcc()
    _build._run_all([[nvcc, *_build._FLAGS, "-c", "-o", str(d / f"{src.stem}.o"), str(src)]
                     for d in dirs.values() for src in sorted(d.glob("*.cu"))])
    for d in dirs.values():
        lib_dir = d.parent / "lib"
        lib_dir.mkdir()
        _build._run_all([[nvcc, *_build._FLAGS, "-shared", "-o", str(lib_dir / "lib.so"),
                          *map(str, sorted(d.glob("*.o")))]])
    notes = [[nvcc, *_build._FLAGS, "-Xptxas", "-v", "-cubin", "-o", str(d / "k2_scan.cubin"),
              str(d / "k2_scan.cu")] for d in dirs.values()]
    procs = [subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True) for cmd in notes]
    for name, p in zip(dirs, procs):
        print(f"{name} ptxas C7514 notes: {p.communicate()[1].count('C7514')}", flush=True)
    for name, d in dirs.items():
        # each variant in its own process: one kernel library per process
        subprocess.run([sys.executable, "-c", _TIMER, str(d), str(REPO), name], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
