"""TransformEngine — the compute-offload seam.

The reference never runs heavy transformations inside the coordinator:
``SourceTask`` picks an execution engine and *submits a job to it* —
a PySpark script shipped to EMR/Databricks/generic Spark
(``provider/scripts/spark/offline_store_spark_runner.py:75,851,1112``)
or an indexed Kubernetes Job (``provider/k8s.go``,
``coordinator/spawner``).  This module is that seam rebuilt: a
``submit / poll / fetch`` interface with two local implementations —

  * :class:`InProcessEngine` — the MemoryJobSpawner analog; executes
    the job synchronously in the coordinator process;
  * :class:`SubprocessEngine` — the k8s/Spark-submit analog; ships a
    self-contained JSON job spec to a worker process
    (``python -m embeddinghub_tpu_torch.featurestore.transform_worker``) and
    polls its exit.

External engines (Spark, EMR, Databricks, k8s) slot in behind the same
three methods; the job-spec contract is deliberately self-contained
(inputs travel as rows, the transformation as SQL text or function
source) exactly like the Spark runner's argparse payload — the worker
needs no provider credentials or metadata access.
"""

from __future__ import annotations

import json
import os
import re
import sqlite3
import subprocess
import sys
import tempfile
import textwrap
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable

from embeddinghub_tpu_torch.featurestore import fferr

# --------------------------------------------------------------- job spec
#
# spec = {
#   "name": str, "variant": str,
#   "transformation": {"sql": "..."} | {"df": <function source text>},
#   "inputs": [["name", "variant"], ...],
#   "input_rows": {"name/variant": [ {col: val, ...}, ... ]},
# }


def build_spec(src, offline) -> dict:
    """Build a self-contained job spec for a SourceVariant: snapshot the
    input tables as rows (the Spark analog ships file URIs; rows keep
    the local workers hermetic) and degrade DF callables to source."""
    transformation = dict(src.transformation or {})
    transformation.pop("engine", None)
    if callable(transformation.get("df")):
        transformation["df"] = _fn_source(transformation["df"])
    inputs = [list(i) for i in src.inputs]
    seen = {tuple(i) for i in src.inputs}
    if "sql" in transformation:
        for m in re.finditer(
            r"\{\{\s*([\w-]+)\.([\w-]+)\s*\}\}", transformation["sql"]
        ):
            seen.add((m.group(1), m.group(2)))
    input_rows = {
        f"{n}/{v}": offline.table_rows(n, v) for n, v in sorted(seen)
    }
    return {
        "name": src.name,
        "variant": src.variant,
        "transformation": transformation,
        "inputs": inputs,
        "input_rows": input_rows,
    }


def _fn_source(fn: Callable) -> str:
    import inspect

    try:
        return inspect.getsource(fn)
    except (OSError, TypeError) as e:
        raise fferr.InvalidResourceError(
            f"df transformation {fn!r} has no retrievable source "
            f"(required for engine offload): {e}"
        )


def _compile_df(source: str) -> Callable:
    """Function source -> callable.  This code came from the operator's
    own registration path (the coordinator extracted it from the
    registered callable, or the operator shipped it in a definitions
    file) — the same trust domain as the Spark runner executing the
    submitted script; it is NOT arbitrary client bytes."""
    lines = textwrap.dedent(source).splitlines()
    for j, ln in enumerate(lines):
        if ln.startswith("def ") or ln.startswith("async def "):
            lines = lines[j:]
            break
    ns: dict = {}
    exec(compile("\n".join(lines), "<df_transformation>", "exec"), ns)  # noqa: S102
    fns = [v for v in ns.values() if callable(v) and not isinstance(v, type)]
    if not fns:
        raise fferr.InvalidResourceError(
            "df transformation source defines no function"
        )
    return fns[-1]


def execute_spec(spec: dict) -> list[dict]:
    """Run a job spec to output rows — the worker-side entrypoint
    (reference ``offline_store_spark_runner.py:851`` execute_sql_query /
    ``:1112`` execute_df_job)."""
    transformation = spec["transformation"]
    input_rows = spec.get("input_rows", {})
    if "sql" in transformation:
        con = sqlite3.connect(":memory:")
        try:
            query = transformation["sql"]
            for key, rows in input_rows.items():
                n, v = key.split("/", 1)
                tbl = _safe_table(n, v)
                if rows:
                    cols = list(rows[0].keys())
                    con.execute(
                        f"CREATE TABLE {tbl} "
                        f"({', '.join(repr(c) for c in cols)})"
                    )
                    con.executemany(
                        f"INSERT INTO {tbl} VALUES "
                        f"({', '.join('?' for _ in cols)})",
                        [tuple(r.get(c) for c in cols) for r in rows],
                    )
                else:
                    con.execute(f"CREATE TABLE {tbl} (placeholder)")
                query = re.sub(
                    r"\{\{\s*" + re.escape(f"{n}.{v}") + r"\s*\}\}",
                    tbl, query,
                )
            try:
                cur = con.execute(query)
            except sqlite3.Error as e:
                raise fferr.InvalidResourceError(
                    f"sql transformation failed: {e}"
                )
            cols = [c[0] for c in cur.description]
            return [dict(zip(cols, row)) for row in cur]
        finally:
            con.close()
    if "df" in transformation:
        fn = transformation["df"]
        if isinstance(fn, str):
            fn = _compile_df(fn)
        frames = [
            input_rows.get(f"{n}/{v}", []) for n, v in spec.get("inputs", [])
        ]
        out = fn(*frames)
        if not isinstance(out, list) or not out:
            raise fferr.InvalidResourceError(
                "df transformation must return a non-empty list of dicts"
            )
        return out
    raise fferr.InvalidResourceError(
        f"unsupported transformation: {list(transformation)}"
    )


def _safe_table(name: str, variant: str) -> str:
    return "src_" + re.sub(r"[^A-Za-z0-9_]", "_", f"{name}_{variant}")


# ---------------------------------------------------------------- engines

PENDING, RUNNING, SUCCESS, FAILED = "PENDING", "RUNNING", "SUCCESS", "FAILED"


@dataclass
class _Job:
    job_id: str
    spec: dict
    status: str = PENDING
    error: str = ""
    rows: list = field(default_factory=list)


class TransformEngine:
    """submit / poll / fetch — the reference's job-runner contract
    (``runner/types.go`` Runner + CompletionWatcher collapsed to a poll
    loop; Spark submit + WaitForCompletion is the production shape)."""

    def submit(self, spec: dict) -> str:
        raise NotImplementedError

    def poll(self, job_id: str) -> tuple[str, str]:
        """-> (status, error)."""
        raise NotImplementedError

    def fetch(self, job_id: str) -> list[dict]:
        """Output rows of a SUCCESS job."""
        raise NotImplementedError

    def run(
        self, spec: dict, timeout_s: float = 300.0, poll_s: float = 0.05,
        on_log: Callable[[str], None] | None = None,
    ) -> list[dict]:
        """Convenience: submit, poll to completion, fetch."""
        job_id = self.submit(spec)
        if on_log:
            on_log(f"submitted transform job {job_id} to {type(self).__name__}")
        deadline = time.time() + timeout_s
        while True:
            status, error = self.poll(job_id)
            if status == SUCCESS:
                return self.fetch(job_id)
            if status == FAILED:
                raise fferr.JobFailedError(job_id, error)
            if time.time() > deadline:
                raise fferr.JobFailedError(job_id, "transform job timed out")
            time.sleep(poll_s)


class InProcessEngine(TransformEngine):
    """MemoryJobSpawner analog (``coordinator/spawner/memory.go``):
    executes at submit time in the calling process."""

    def __init__(self):
        self._jobs: dict[str, _Job] = {}

    def submit(self, spec: dict) -> str:
        job = _Job(uuid.uuid4().hex[:12], spec, status=RUNNING)
        self._jobs[job.job_id] = job
        try:
            job.rows = execute_spec(spec)
            job.status = SUCCESS
        except Exception as e:  # noqa: BLE001 — job failure is data
            job.status, job.error = FAILED, str(e)
        return job.job_id

    def poll(self, job_id: str) -> tuple[str, str]:
        job = self._jobs[job_id]
        return job.status, job.error

    def fetch(self, job_id: str) -> list[dict]:
        return self._jobs[job_id].rows


class SubprocessEngine(TransformEngine):
    """Spark-submit / KubernetesJobSpawner analog: the spec travels to
    an isolated worker process as JSON; completion = process exit."""

    def __init__(self, workdir: str | None = None):
        self._dir = workdir or tempfile.mkdtemp(prefix="ehtpu-transform-")
        self._procs: dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()

    def _paths(self, job_id: str) -> tuple[str, str, str]:
        base = os.path.join(self._dir, job_id)
        return base + ".spec.json", base + ".out.json", base + ".err.txt"

    def submit(self, spec: dict) -> str:
        job_id = uuid.uuid4().hex[:12]
        spec_path, out_path, err_path = self._paths(job_id)
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        env = dict(os.environ)
        with open(err_path, "w") as errf:
            proc = subprocess.Popen(
                [
                    sys.executable, "-m",
                    "embeddinghub_tpu_torch.featurestore.transform_worker",
                    "--spec", spec_path, "--output", out_path,
                ],
                stderr=errf, stdout=subprocess.DEVNULL, env=env,
            )
        with self._lock:
            self._procs[job_id] = proc
        return job_id

    def poll(self, job_id: str) -> tuple[str, str]:
        proc = self._procs[job_id]
        rc = proc.poll()
        if rc is None:
            return RUNNING, ""
        if rc == 0:
            return SUCCESS, ""
        _, _, err_path = self._paths(job_id)
        try:
            with open(err_path) as f:
                tail = f.read()[-2000:]
        except OSError:
            tail = ""
        return FAILED, f"worker exited rc={rc}: {tail}"

    def fetch(self, job_id: str) -> list[dict]:
        _, out_path, _ = self._paths(job_id)
        with open(out_path) as f:
            return json.load(f)


_ENGINES: dict[str, Callable[[], TransformEngine]] = {
    "inprocess": InProcessEngine,
    "subprocess": SubprocessEngine,
}
_instances: dict[str, TransformEngine] = {}


def register_engine(name: str, factory: Callable[[], TransformEngine]) -> None:
    """Plug in an external engine (the seat where Spark/EMR/Databricks/
    k8s submission sits in the reference, provider/spark.go)."""
    _ENGINES[name] = factory


def get_engine(name: str | None = None) -> TransformEngine | None:
    """Resolve an engine by name; None/"native" means "no offload — let
    the offline provider run the transformation itself".  Default comes
    from EHTPU_TRANSFORM_ENGINE."""
    name = name or os.environ.get("EHTPU_TRANSFORM_ENGINE", "native")
    if name in ("", "native"):
        return None
    if name not in _ENGINES:
        raise fferr.InvalidResourceError(
            f"unknown transform engine {name!r} "
            f"(have: native, {', '.join(sorted(_ENGINES))})"
        )
    if name not in _instances:
        _instances[name] = _ENGINES[name]()
    return _instances[name]
