"""``embeddinghub_tpu_torch.utils.tracing`` against the JAX package's
``utils/tracing.py``: ``span`` logs the same record, ``profile`` writes a
Chrome trace that holds ``annotate``'s ranges, nested or not, and stays
best effort when the profiler or its directory fails."""

import glob
import json
import os

import pytest
import torch

from embeddinghub_tpu.featurestore import logging as jax_logging
from embeddinghub_tpu.utils import tracing as jax_tracing
from embeddinghub_tpu_torch.featurestore import logging as port_logging
from embeddinghub_tpu_torch.utils import tracing


def _records(err):
    return [json.loads(line) for line in err.splitlines() if line.startswith("{")]


def test_span_logs_the_reference_record(capsys):
    jax_logging.set_request_id("req-1")
    port_logging.set_request_id("req-1")
    try:
        with jax_tracing.span("ff.nearest", feature="emb", k=10, token="x"):
            pass
        with tracing.span("ff.nearest", feature="emb", k=10, token="x"):
            pass
    finally:
        jax_logging.set_request_id("")
        port_logging.set_request_id("")
    want, got = _records(capsys.readouterr().err)[-2:]
    assert set(got) == set(want)
    for key in ("ts", "ms"):
        assert isinstance(got.pop(key), float)
        want.pop(key)
    assert got == want
    assert got["token"] == "<redacted>" and got["request_id"] == "req-1"


def test_span_logs_when_the_block_raises(capsys):
    with pytest.raises(KeyError):
        with tracing.span("boom"):
            raise KeyError("x")
    rec = _records(capsys.readouterr().err)[-1]
    assert rec["msg"] == "span" and rec["span"] == "boom" and rec["ms"] >= 0


def _trace(log_dir):
    paths = glob.glob(os.path.join(log_dir, "*.json"))
    assert len(paths) == 1, paths
    with open(paths[0]) as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def _ranges(events, name):
    return [e for e in events
            if e.get("name") == name and e.get("cat") == "user_annotation"]


def test_profile_writes_annotated_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    with tracing.profile(log_dir):
        for _ in range(3):
            with tracing.annotate("ff.nearest"):
                with tracing.annotate("inner"):
                    y = x @ x
    assert float(y[0, 0]) == float((x @ x)[0, 0])
    events = _trace(log_dir)
    outer, inner = _ranges(events, "ff.nearest"), _ranges(events, "inner")
    assert len(outer) == 3 and len(inner) == 3
    for o, i in zip(sorted(outer, key=lambda e: e["ts"]),
                    sorted(inner, key=lambda e: e["ts"])):
        assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]


def test_annotate_without_profile():
    with tracing.annotate("alone"):
        with tracing.annotate("nested"):
            v = torch.ones(3).sum()
    assert float(v) == 3.0


def test_profile_into_an_unwritable_dir_is_best_effort(tmp_path):
    """A ``log_dir`` that cannot be made (under a regular file): the block
    runs and no error escapes; an error of the block itself still does."""
    blocker = tmp_path / "file"
    blocker.write_text("")
    ran = []
    with tracing.profile(str(blocker / "trace")):
        with tracing.annotate("r"):
            ran.append(1)
    assert ran == [1]
    assert not os.path.exists(blocker / "trace")
    with pytest.raises(ValueError):
        with tracing.profile(str(blocker / "trace")):
            raise ValueError("the block's own error")


def test_profile_when_the_profiler_cannot_start(tmp_path, monkeypatch):
    def broken(**kw):
        raise RuntimeError("no profiler")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    ran = []
    with tracing.profile(str(tmp_path)):
        ran.append(1)
    assert ran == [1] and not glob.glob(str(tmp_path / "*.json"))
