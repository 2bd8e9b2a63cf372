"""CPU tests of the harness: ``python -m pytest hubbench -q`` from the root.

The runs here drive the whole harness on the CPU at a small size, the
program on its plain kernels: a sound run comes out correct, and the
control (the program's int8 path) and each fault a search cell can have
(``faults.py``) come out not correct.  The test marked ``cuda`` runs a small cell on the
card and skips without one.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hubbench import check, faults, peaks, reference, run
from hubbench.loops.closed import Call
from hubbench.trace import Trace, _label_gaps, _union

ROOT = Path(__file__).resolve().parent.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
DEEP = "deep10m-int8x2.search-b1024-c1"
GRAPH = "sift1m-hnsw.search-b1024-ef100"


def small(name: str, rows: int = 20_000, **data) -> run.Cell:
    """The cell ``name`` cut to ``rows`` rows and a small batch and pool."""
    cell = copy.deepcopy(run.load_cell(name))
    cell.config["rows"] = rows
    cell.config["data"] = dict(cell.config["data"], **data)
    cell.traffic.update(batch=64, query_pool=400, warmup_calls=1)
    return cell


def small_deep() -> run.Cell:
    # 64 centres keep about 300 rows a centre: the sound run passes the
    # cell's limit and the int8 control does not
    return small(DEEP, centers=64)


# ---------------------------------------------------------------- generators


@pytest.mark.parametrize("generator,dims", [("deep_clustered", 96), ("sift_desc", 128)])
def test_generators_deterministic_by_seed(generator, dims):
    spec = {"generator": generator, "centers": 16, "center_scale": 3.0, "noise": 0.35}
    mod = __import__(f"hubbench.data.{generator}", fromlist=["generate"])

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return mod.generate(spec, 3000, 50, dims, gen, "cpu")

    a, b, c = draw(2**31 + 5), draw(2**31 + 5), draw(7)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (3000, dims) and a[1].shape == (50, dims)
    assert a[0].dtype == torch.float32


def test_sift_rows_are_descriptor_like():
    from hubbench.data import sift_desc

    rows, _ = sift_desc.generate({}, 2000, 10, 128, torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(rows, rows.floor()) and rows.min() >= 0 and rows.max() <= 255


# ----------------------------------------------------------------- reference


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_reference_matches_numpy_brute_force(metric):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 50, (3000, 24)).astype(np.float32) + rng.random((3000, 24),
                                                                       dtype=np.float32)
    q = rng.standard_normal((40, 24)).astype(np.float32) * 10 + 25
    rows, qs = reference.prepare(torch.from_numpy(x.copy()), torch.from_numpy(q), metric)
    s, i = reference.exact_topk(rows, qs, 10, metric)
    if metric == "cosine":
        xn = x / np.linalg.norm(x, axis=1, keepdims=True)
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        want = np.argsort(-(qn.astype(np.float64) @ xn.T.astype(np.float64)), axis=1)[:, :10]
    else:
        d = ((q[:, None, :].astype(np.float64) - x[None].astype(np.float64)) ** 2).sum(2)
        want = np.argsort(d, axis=1)[:, :10]
    assert np.array_equal(i.numpy(), want)
    again = reference.scores_of(rows, qs, i, metric)
    assert torch.allclose(again, s, rtol=1e-5, atol=1e-5)


def test_reference_scores_empty_slots():
    rows, qs = reference.prepare(torch.ones(4, 3), torch.ones(1, 3), "l2")
    out = reference.scores_of(rows, qs, torch.tensor([[0, -1]]), "l2")
    assert out[0, 0] == 0 and out[0, 1] == -float("inf")


# --------------------------------------------------------------------- check


def test_answer_rows_parses_dedupes_and_pads_in_order():
    got = check.answer_rows([["3", "1", "3"], ["x", "2"], [], ["5", "4", "5"]], 3)
    assert got[0].tolist() == [3, 1, -1]
    assert got[1].tolist() == [-1, 2, -1]
    assert got[2].tolist() == [-1, -1, -1]
    assert got[3].tolist() == [5, 4, -1]


def test_hits_count_ties_with_the_kth():
    # integer l2 distances: rows 1 and 2 tie at the k-th distance
    x = torch.tensor([[0.0], [1.0], [-1.0], [5.0]])
    rows, pool = reference.prepare(x, torch.tensor([[0.0]]), "l2")
    truth, _ = reference.exact_topk(rows, pool, 2, "l2")
    got = np.array([[0, 2], [0, 3]])
    asked = np.array([0, 0])
    hit = check.hits(check.score_answers(rows, pool, asked, got, "l2"), truth, asked)
    assert hit.tolist() == [2, 1]
    assert check.miss_rate(hit, 2) == pytest.approx(0.25)
    assert check.miss_rate(np.zeros(0), 10) == 1.0


def test_misordered_share_counts_pairs_past_the_rounding():
    got_s = torch.tensor([[0.9, 0.8, 0.85, -float("inf")],
                          [0.5, 0.5 + 1e-8, 0.4, 0.3]])
    # one pair of five rises by 0.05; a rise within the tie allowance is none
    assert check.misordered_share(got_s, 0.0) == pytest.approx(1 / 5)
    assert check.misordered_share(got_s, 0.1) == 0.0
    assert check.misordered_share(torch.full((2, 3), -float("inf")), 0.0) == 0.0
    reverse = torch.tensor([[0.1, 0.2, 0.3]])
    assert check.misordered_share(reverse, 0.0) == 1.0


# --------------------------------------------------------- cells and readers


def test_every_cell_config_traffic_and_metric_is_found_by_name():
    for work in SPEC["workloads"]:
        cell = run.load_cell(work["name"])
        assert cell.config["name"] == work["config"]
        assert cell.end_to_end and cell.per_layer
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        __import__(f"hubbench.data.{cell.config['data']['generator']}")
        __import__(f"hubbench.loops.{cell.traffic['loop']}")
        __import__(f"hubbench.stores.{cell.config['durability']}")
        __import__(f"hubbench.ops.{cell.traffic['op']}")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(run.reader(m["name"]).read)
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in SPEC["workloads"]}
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["limits"]["miss_at_10"] > 0 and "control" in cfg
        assert cfg["limits"]["misordered_share"] > 0 and cfg["order_rounding"] >= 0


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        run.load_cell("no-such.cell")


@pytest.mark.parametrize("part,key,value", [("config", "durability", "wal"),
                                            ("traffic", "op", "multiset"),
                                            ("traffic", "loop", "open")])
def test_guarantee_or_op_the_harness_cannot_give_is_refused(tmp_path, part, key, value):
    """A configuration whose durability has no store module, or a traffic
    mix whose op or loop has no module, is refused before any run."""
    work = SPEC["workloads"][0]
    (tmp_path / "hubbench" / "traffic").mkdir(parents=True)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(SPEC))
    conf = next(c for c in SPEC["configs"] if c["name"] == work["config"])
    files = {"config": (conf["file"], ROOT / conf["file"]),
             "traffic": (f"hubbench/traffic/{work['traffic']}.json",
                         ROOT / "hubbench" / "traffic" / f"{work['traffic']}.json")}
    for name, (rel, src) in files.items():
        body = json.loads(src.read_text())
        if name == part:
            body[key] = value
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(json.dumps(body))
    with pytest.raises(SystemExit, match=f"no [a-z]+ module '{value}'"):
        run.load_cell(work["name"], root=tmp_path)
    run.load_cell(work["name"])  # the committed files are found


def _calls(spans, batch=4):
    return [Call(0, t0, t1, t0 + 0.1 * (t1 - t0), t1 - 0.1 * (t1 - t0),
                 np.arange(batch), [["0"]] * batch) for t0, t1 in spans]


def _run(calls, config=None, trace=None, trace_end=None):
    cell = run.Cell("c", 1, config or {}, {}, [], [])
    t0 = min(c.t_call for c in calls)
    t1 = max(c.t_ret for c in calls)
    return run.Run(cell, 1.0, calls, t1 - t0, trace=trace, trace_end=trace_end)


def test_rate_is_all_work_over_the_whole_window():
    calls = _calls([(0.0, 1.0), (1.0, 1.5), (0.2, 3.0)])
    r = _run(calls)
    assert run.reader("queries_per_s").read(r) == pytest.approx(12 / 3.0)
    # no trace: every call is the host clock's
    assert run.reader("graph_queries_per_s").read(r) == pytest.approx(12 / 3.0)
    calls[1].answer = None  # a failed call answers nothing
    assert run.reader("queries_per_s").read(r) == pytest.approx(8 / 3.0)


def test_host_clock_readers_leave_out_the_traced_calls():
    calls = _calls([(0.0, 1.0), (1.0, 1.5), (1.5, 3.5), (3.5, 4.0)])
    r = _run(calls, trace=Trace(window_s=1.5, busy_s=0.1, device_s=0.1, calls=calls[:2]),
             trace_end=1.2)
    assert [c.t_call for c in r.untraced] == [1.5, 3.5]
    assert run.reader("graph_queries_per_s").read(r) == pytest.approx(8 / 2.5)
    assert run.reader("flat_search_ms").read(r) == pytest.approx(1000.0)
    assert run.reader("batch_p95_ms").read(r) == pytest.approx(
        np.percentile([2000.0, 500.0], 95))
    # the rate of the whole window counts every call, traced or not
    assert run.reader("queries_per_s").read(r) == pytest.approx(16 / 4.0)
    r.trace_end = 5.0
    for name in ("graph_queries_per_s", "flat_search_ms", "store_self_ms", "batch_p95_ms"):
        assert run.reader(name).read(r) is None


def test_p95_is_over_every_call():
    calls = _calls([(0.0, 0.001 * (j + 1)) for j in range(100)])
    r = _run(calls)
    assert run.reader("batch_p95_ms").read(r) == pytest.approx(
        np.percentile(np.arange(1, 101), 95))


def test_store_self_and_search_ms():
    r = _run(_calls([(0.0, 1.0), (1.0, 3.0)]))
    assert run.reader("flat_search_ms").read(r) == pytest.approx(1200.0)
    assert run.reader("store_self_ms").read(r) == pytest.approx(300.0)


def test_sub_window_rates():
    calls = _calls([(0.0, 1.0), (1.0, 2.0), (2.0, 3.0), (3.0, 4.0)])
    calls[2].answer = None
    # returns at 1.0 | 2.0 and 4.0 (the call returning at 3.0 failed)
    assert run.sub_window_rates(calls, 2) == pytest.approx([4 / 2.0, 8 / 2.0])
    assert run.sub_window_rates([], 2) == []


def test_roofline_is_computed_from_shapes():
    calls = _calls([(0.0, 1.0), (1.0, 2.0)], batch=1024)
    cfg = {"rows": 10_000_000, "dims": 96, "storage_dtype": "int8x2"}
    tr = Trace(window_s=2.0, busy_s=0.1, device_s=0.1, calls=calls)
    least = 2 * 1024 * 10_000_000 * 96 / peaks.INT8_OPS
    assert peaks.deep_search_least_s(1024, 10_000_000, 96) == pytest.approx(least)
    got = run.reader("deep_search_roofline").read(_run(calls, cfg, tr))
    assert got == pytest.approx(100 * 2 * least / 0.1)
    assert run.reader("deep_search_roofline").read(_run(calls, cfg)) is None
    assert run.reader("device_idle_share").read(_run(calls, cfg, tr)) == pytest.approx(0.95)
    assert run.reader("device_idle_share").read(
        _run(calls, cfg, Trace(window_s=2.0, busy_s=0.0, device_s=0.0))) is None


def test_union_and_idle_gaps():
    spans = np.array([[10, 20], [15, 30], [40, 50]], dtype=np.int64)
    busy, gaps = _union(spans, 0, 60)
    assert busy == 30 and gaps.tolist() == [[0, 10], [30, 40], [50, 60]]
    call = Call(0, 0.0, 45e-9, 25e-9, 42e-9, np.arange(1), [["0"]])
    labels = dict(_label_gaps(gaps, [call]))
    assert labels["index.search"] == pytest.approx(10e-9)
    assert labels["store"] == pytest.approx(10e-9)
    assert labels["none"] == pytest.approx(10e-9)


# -------------------------------------------------------------- import guard


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "embeddinghub_tpu_torch_extra", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "embeddinghub_tpu.store", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert run.forbidden_modules() == ["embeddinghub_tpu", "jax"]


def test_no_result_without_cuda():
    out = subprocess.run([sys.executable, "hubbench/run.py", "--workload", DEEP, "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert out.returncode != 0 and out.stdout.strip() == ""


# ------------------------------------------------------ whole runs, the CPU


def test_sound_run_is_correct():
    result, checks, _ = run.run_cell(small_deep(), 2**31 + 11, 1.0, False, device="cpu")
    assert result["correct"], checks
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"queries_per_s", "recall_at_10", "setup_s"}
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(checks) == {"miss_at_10", "misordered_share", "failed_queries",
                           "storage_departed"}


def test_traced_run_reads_the_per_layer_metrics():
    cell = small_deep()
    cell.traffic["trace_seconds"] = 0.5
    result, _, r = run.run_cell(cell, 5, 1.5, True, device="cpu")
    assert result["correct"]
    # no device here: the trace's device metrics find nothing to read; the
    # host clock's read the calls after the trace
    assert set(result["metrics"]) == {"batch_p95_ms", "store_self_ms", "flat_search_ms"}
    assert 0 < result["device"]["window_s"] < 1.2 and "breakdown" in result
    assert r.untraced and all(c.t_call >= r.trace_end for c in r.untraced)
    assert len(r.untraced) < len(r.answered)


def test_control_is_not_correct():
    cell = small_deep()
    result, checks, _ = run.run_cell(cell, 2**31 + 11, 1.0, False, device="cpu",
                                     overrides=cell.config["control"])
    assert not result["correct"]
    assert checks["miss_at_10"]["value"] > 3 * checks["miss_at_10"]["limit"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_faults_are_not_correct(fault):
    result, checks, _ = run.run_cell(small_deep(), 2**31 + 11, 1.0, False, device="cpu",
                                     fault=fault)
    assert not result["correct"], checks


def test_graph_cell_runs_on_the_cpu():
    cell = small(GRAPH, rows=3000)
    result, checks, _ = run.run_cell(cell, 9, 1.0, False, device="cpu")
    assert result["correct"], checks
    assert set(result["metrics"]) == {"recall_at_10", "setup_s"}
    assert result["metrics"]["recall_at_10"]["value"] > 0.9


def test_traced_sub_window():
    cell = small(GRAPH, rows=3000)
    cell.traffic["trace_seconds"] = 0.5
    result, _, _ = run.run_cell(cell, 9, 1.5, True, device="cpu")
    assert set(result["metrics"]) == {"graph_build_s", "graph_queries_per_s"}
    assert 0 < result["device"]["window_s"] < 1.2


# --------------------------------------------------------------- on the card


@pytest.mark.cuda
def test_small_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = small_deep()
    cell.traffic["trace_seconds"] = 1.0
    result, checks, _ = run.run_cell(cell, 2**31 + 13, 2.0, True, device="cuda")
    assert result["correct"], checks
    assert result["device"]["busy_s"] > 0
