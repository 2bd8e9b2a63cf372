#!/usr/bin/env python3
"""Run one cell of the benchmark of embeddinghub_tpu_torch once.

    python3 hubbench/run.py --workload <config>.<traffic> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration
(``hubbench/configs/<config>.json``), its traffic mix
(``hubbench/traffic/<traffic>.json``) and its metrics are found by name
through ``BENCHMARK.json``; so are the store that gives the configuration's
durability (``hubbench/stores/<durability>.py``), the store operation the
traffic drives (``hubbench/ops/<op>.py``), its loop
(``hubbench/loops/<loop>.py``) and each metric's reader
(``hubbench/metrics/<metric>.py``).  Set-up makes the rows and queries on
the card from ``--seed``, fills the store through ``Version.multiset`` and
warms up the traffic's calls; the window then drives the op for
``--seconds``.  Once the window has closed and the store is freed, the
plain reference (``reference.py``) scores every answer (the op's
``score``).  The last line of standard output is the result as JSON:
``--trace 0`` the cell's end-to-end metrics, ``--trace 1`` its per-layer
metrics, with ``torch.profiler`` over the window's first
``trace_seconds`` and the host clock's per-layer metrics read from the
calls after it.  The numbers that decide ``correct`` come last there
(``checks``) and as the last lines of standard error.  Without enough CUDA
devices, with a configuration whose guarantees it cannot give, or with JAX
or the JAX package loaded, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# a Triton compile, if anything made one, would cache inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "hubbench" / "_cache" / "triton")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from hubbench import check, faults, reference  # noqa: E402
from hubbench.trace import Tracer  # noqa: E402

# Top-level module names that no run may load (compared whole: the port's
# name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "embeddinghub_tpu")
SUB_WINDOWS = 5  # stretches of the window whose rates go to standard error


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


@dataclass
class Run:
    """What one run measured, for the metric readers."""

    cell: Cell
    setup_s: float
    calls: list  # loops.closed.Call of the window, by start
    window_s: float  # the first call's start to the last call's return
    trace: object = None  # trace.Trace of the traced stretch, with --trace 1
    trace_end: float | None = None  # when the profiler stopped (perf_counter s)
    recall: float | None = None  # mean recall@k over every answer
    captured: dict = field(default_factory=dict)  # metric name -> capture()

    @property
    def answered(self) -> list:
        return [c for c in self.calls if c.answer is not None]

    @property
    def untraced(self) -> list:
        """The answered calls made with no profiler running: those that
        started after it stopped, or every one in a run without a trace."""
        if self.trace_end is None:
            return self.answered
        return [c for c in self.answered if c.t_call >= self.trace_end]


def _module(kind: str, name: str):
    """``hubbench/<kind>/<name>.py``, or ``SystemExit`` where there is none."""
    try:
        return importlib.import_module(f"hubbench.{kind}.{name}")
    except ModuleNotFoundError as exc:
        if exc.name != f"hubbench.{kind}.{name}":
            raise
        raise SystemExit(f"hubbench: no {kind} module {name!r} (hubbench/{kind}/{name}.py)")


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The workload ``name`` of ``BENCHMARK.json``, with its configuration,
    traffic mix and the metrics it reports.  ``SystemExit`` where the
    harness has no store for the configuration's durability, or no module
    for the traffic's op or loop."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    work = next((w for w in spec["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == work["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "hubbench" / "traffic" / f"{work['traffic']}.json")
                         .read_text())
    _module("stores", config["durability"])
    _module("ops", traffic["op"])
    _module("loops", traffic["loop"])

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(name, work["chips"], config, traffic, mine(spec["end_to_end"]),
                mine(spec["per_layer"]))


def reader(metric: str):
    return importlib.import_module(f"hubbench.metrics.{metric}")


def _generate(config: dict, traffic: dict, seed: int, device):
    data = config["data"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 64))
    return importlib.import_module(f"hubbench.data.{data['generator']}").generate(
        data, config["rows"], traffic["query_pool"], config["dims"], gen, device)


def _log(t_start: float, what: str) -> None:
    print(f"hubbench: {time.perf_counter() - t_start:8.2f} s  {what}", file=sys.stderr,
          flush=True)


def _merge(base: dict, over: dict | None) -> dict:
    return {**base, **(over or {})}


def sub_window_rates(calls: list, parts: int = SUB_WINDOWS) -> list[float]:
    """Items answered a second in ``parts`` equal stretches of the window,
    each call counted in the stretch where it returned."""
    done = [c for c in calls if c.answer is not None]
    if not done:
        return []
    t0 = min(c.t_call for c in calls)
    span = (max(c.t_ret for c in calls) - t0) / parts
    if span <= 0:
        return []
    count = [0] * parts
    for c in done:
        count[min(parts - 1, int((c.t_ret - t0) / span))] += len(c.asked)
    return [n / span for n in count]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             overrides: dict | None = None, fault: str | None = None,
             t_start: float = T_START):
    """Set up, measure and check one run.  Returns ``(result, checks, run)``:
    the result line's dict, the numbers compared, each with its limit, and
    the ``Run``.  ``overrides`` (``{"config": {...}, "traffic": {...}}``)
    changes the configuration or the traffic, as a control does; ``fault``
    plants one of ``faults.FAULTS`` under the timed path."""
    overrides = overrides or {}
    config = _merge(cell.config, overrides.get("config"))
    traffic = _merge(cell.traffic, overrides.get("traffic"))
    batch = int(traffic["batch"])

    store_mod = _module("stores", config["durability"])
    op_mod = _module("ops", traffic["op"])
    loop_mod = _module("loops", traffic["loop"])
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()

    _log(t_start, "imports")
    rows, pool = _generate(config, traffic, seed, device)
    rows_host = rows.cpu().numpy()
    pool_host = pool.cpu().numpy()
    del rows, pool
    keys = check.key_of(config["rows"])
    _log(t_start, "rows, queries and keys")
    hub, version = store_mod.open_store(config, traffic, device)
    version.multiset(zip(keys, rows_host))
    del rows_host, keys
    _log(t_start, "multiset")

    if fault is not None:
        faults.plant(fault, version.index)
    op = op_mod.Op(version, traffic, config)
    index = op.index
    # the first call syncs the device arena (the quantization guard, the
    # planes' upload): once, before any client, as a store is loaded
    op(pool_host[:batch])
    _log(t_start, "first call")
    loop = loop_mod.Loop(op, traffic, pool_host, seed % (1 << 64))
    loop.warm()
    gc.collect()
    gc.freeze()  # set-up's objects are never collected inside the window
    setup_s = time.perf_counter() - t_start
    _log(t_start, "warm-up: set-up ends")

    # the profiler traces the window's first ``trace_seconds``; the calls
    # after it are the host clock's
    tracer = Tracer() if trace else None
    stopped = {}

    def stop_trace():
        # the traced calls are those returned before the profiler stops;
        # its stop holds the interpreter for seconds, so the host clock's
        # calls start after it
        stopped["calls"] = loop.calls()
        tracer.stop()
        stopped["at"] = time.perf_counter()

    at = None
    if tracer:
        tracer.start()
        at = (min(float(traffic.get("trace_seconds", seconds)), seconds), stop_trace)
    calls, lost = loop.measure(seconds, at=at)
    t0 = min((c.t_call for c in calls), default=0.0)
    t1 = max((c.t_ret for c in calls), default=0.0)
    run = Run(cell, setup_s, calls, t1 - t0)
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    metrics = cell.per_layer if trace else cell.end_to_end
    for m in metrics:
        capture = getattr(reader(m["name"]), "capture", None)
        if capture is not None:
            run.captured[m["name"]] = capture(version)
    departed = int(config.get("storage_dtype", getattr(index, "storage_dtype", None))
                   != getattr(index, "storage_dtype", None))
    _log(t_start, f"window closed: {len(calls)} calls; rates by stretch "
         + " ".join(f"{r:.1f}" for r in sub_window_rates(calls)))
    if tracer:
        run.trace = tracer.reduce(stopped["calls"])
        run.trace_end = stopped["at"]
        _log(t_start, "trace reduced")
    del index, op, version, hub, loop
    gc.unfreeze()
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    # the reference, on the same generated rows and queries
    attempted = sum(len(c.asked) for c in calls) + lost
    answered = run.answered
    rows, pool = _generate(config, traffic, seed, device)
    rows, pool = reference.prepare(rows, pool, config["metric"])
    numbers, run.recall = op_mod.score(answered, rows, pool, config, traffic)
    del rows, pool
    _log(t_start, "reference and check")
    failed = attempted - sum(len(c.asked) for c in answered)
    checks = {name: {"value": value, "limit": config["limits"][name]}
              for name, value in numbers.items()}
    checks["failed_queries"] = {"value": failed, "limit": 0}
    checks["storage_departed"] = {"value": departed, "limit": 0}
    errors = sorted({c.error for c in calls if c.error})
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": attempted,
        "failed": failed,
        "metrics": {},
        "device": {
            "platform": "gpu" if device != "cpu" else "cpu",
            "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": peak,
        },
    }
    for m in metrics:
        value = reader(m["name"]).read(run)
        if value is not None:
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    if errors:
        result["errors"] = errors[:5]
    result["checks"] = checks
    return result, checks, run


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"hubbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              f"available", file=sys.stderr)
        return 2
    result, checks, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"hubbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
