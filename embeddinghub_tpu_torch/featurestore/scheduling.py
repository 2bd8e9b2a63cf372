"""Task scheduling model.

Rebuild of reference ``scheduling/``: ``TaskMetadata`` (what work
exists), ``TaskRunMetadata`` (each execution attempt with status
PENDING/RUNNING/READY/FAILED/CANCELLED, ``task_run.go:213``), and
``TaskDAG`` topological ordering (``task_dag.go:17-80``); managed by a
``TaskManager`` (the reference's ``TaskMetadataManager`` +
the Tasks gRPC surface hosted by metadata, ``metadata.go:1940-2233``).
"""

from __future__ import annotations

import enum
import re
import threading
import time
from dataclasses import dataclass, field

from embeddinghub_tpu_torch.featurestore import fferr
from embeddinghub_tpu_torch.featurestore.resources import ResourceID


class RunStatus(str, enum.Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    READY = "READY"
    FAILED = "FAILED"
    CANCELLED = "CANCELLED"


@dataclass
class TaskMetadata:
    id: int
    name: str
    task_type: str          # e.g. "materialize", "source", "trainingset"
    target: ResourceID
    created_at: float = field(default_factory=time.time)
    # cron-lite schedule string ("@every 30s", "*/5 * * * *", bare
    # seconds); parsed by parse_schedule.  The coordinator's poll loop
    # creates a fresh run once the last READY run is older than the
    # interval (the reference's CronJob scheduling,
    # kubernetes/kubernetes.go:223-236, wired from RequestScheduleChange)
    schedule: str = ""


_DURATION_UNITS = {"ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}


def parse_schedule(schedule: str) -> float | None:
    """Schedule string -> interval seconds (None when empty).

    Accepted forms (cron-lite — the reference passes k8s cron strings,
    kubernetes.go:223-236; an interval covers the coordinator's needs):
      * ``@every 30s`` / ``@every 5m`` / ``@every 1.5h`` (Go cron syntax)
      * bare number (seconds), e.g. ``90``
      * step-form cron ``*/N * * * *`` (every N minutes)
    Raises ValueError on anything else."""
    if not schedule or not schedule.strip():
        return None
    s = schedule.strip()
    if s.startswith("@every"):
        s = s[len("@every"):].strip()
    parts = s.split()
    if len(parts) == 5:  # cron
        minute = parts[0]
        if parts[1:] == ["*"] * 4 and minute.startswith("*/"):
            return float(minute[2:]) * 60.0
        if parts[1:] == ["*"] * 4 and minute == "*":
            return 60.0
        raise ValueError(f"unsupported cron schedule {schedule!r} "
                         "(use */N * * * * or @every <duration>)")
    m = re.fullmatch(r"(\d+(?:\.\d+)?)\s*(ms|s|m|h|d)?", s)
    if m is None:
        raise ValueError(f"unparseable schedule {schedule!r}")
    return float(m.group(1)) * _DURATION_UNITS[m.group(2) or "s"]


@dataclass
class TaskRunMetadata:
    run_id: int
    task_id: int
    name: str
    status: RunStatus = RunStatus.PENDING
    error: str = ""
    logs: list[str] = field(default_factory=list)
    resume_id: str = ""      # SetRunResumeID hook (scheduling.proto:28)
    started_at: float | None = None
    ended_at: float | None = None
    attempts: int = 0

    def log(self, msg: str) -> None:
        self.logs.append(f"[{time.strftime('%H:%M:%S')}] {msg}")


class TaskDAG:
    """Dependency DAG over task ids with topological ordering."""

    def __init__(self):
        self._deps: dict[int, set[int]] = {}

    def add_task(self, task_id: int) -> None:
        self._deps.setdefault(task_id, set())

    def add_dependency(self, task_id: int, depends_on: int) -> None:
        self.add_task(task_id)
        self.add_task(depends_on)
        self._deps[task_id].add(depends_on)
        if self._has_cycle():
            self._deps[task_id].discard(depends_on)
            raise fferr.InvalidResourceError(
                f"dependency cycle: task {task_id} -> {depends_on}"
            )

    def dependencies(self, task_id: int) -> set[int]:
        return set(self._deps.get(task_id, ()))

    def sorted_tasks(self) -> list[int]:
        """Kahn topological sort (reference task_dag.go:30-80)."""
        indeg = {t: len(d) for t, d in self._deps.items()}
        rdeps: dict[int, list[int]] = {t: [] for t in self._deps}
        for t, deps in self._deps.items():
            for d in deps:
                rdeps[d].append(t)
        ready = sorted(t for t, n in indeg.items() if n == 0)
        out = []
        while ready:
            t = ready.pop(0)
            out.append(t)
            for r in sorted(rdeps[t]):
                indeg[r] -= 1
                if indeg[r] == 0:
                    ready.append(r)
        if len(out) != len(self._deps):
            raise fferr.InvalidResourceError("dependency cycle in task DAG")
        return out

    def _has_cycle(self) -> bool:
        try:
            self.sorted_tasks()
            return False
        except fferr.FFError:
            return True


class TaskManager:
    """Creates tasks + runs, tracks statuses, reconciles."""

    def __init__(self):
        self._lock = threading.RLock()
        self._next_task = 0
        self._next_run = 0
        self._tasks: dict[int, TaskMetadata] = {}
        self._runs: dict[int, TaskRunMetadata] = {}
        self.dag = TaskDAG()

    # ------------------------------------------------------------- creation

    def create_task(
        self,
        name: str,
        task_type: str,
        target: ResourceID,
        depends_on: list[int] | None = None,
    ) -> TaskMetadata:
        with self._lock:
            self._next_task += 1
            task = TaskMetadata(self._next_task, name, task_type, target)
            self._tasks[task.id] = task
            self.dag.add_task(task.id)
            for dep in depends_on or ():
                self.dag.add_dependency(task.id, dep)
            return task

    def create_run(self, task_id: int, name: str = "") -> TaskRunMetadata:
        with self._lock:
            self._next_run += 1
            run = TaskRunMetadata(
                self._next_run, task_id, name or f"run-{self._next_run}"
            )
            self._runs[run.run_id] = run
            return run

    # --------------------------------------------------------------- status

    def set_run_status(
        self, run_id: int, status: RunStatus, error: str = ""
    ) -> None:
        with self._lock:
            run = self._runs[run_id]
            run.status = status
            run.error = error
            if status == RunStatus.RUNNING:
                run.started_at = time.time()
                run.attempts += 1
            if status in (RunStatus.READY, RunStatus.FAILED, RunStatus.CANCELLED):
                run.ended_at = time.time()

    def set_schedule(self, task_id: int, schedule: str) -> None:
        """Attach/replace a task's schedule string (validated).  The
        reference's RequestScheduleChange updates the resource's
        CronJob; here the coordinator poll loop honors it."""
        parse_schedule(schedule)  # raises on junk before we store it
        with self._lock:
            task = self._tasks.get(task_id)
            if task is None:
                raise fferr.ResourceNotFoundError("task", str(task_id))
            task.schedule = schedule

    def set_run_resume_id(self, run_id: int, resume_id: str) -> None:
        with self._lock:
            self._runs[run_id].resume_id = resume_id

    # ----------------------------------------------------------------- read

    def task(self, task_id: int) -> TaskMetadata:
        return self._tasks[task_id]

    def run(self, run_id: int) -> TaskRunMetadata:
        return self._runs[run_id]

    def task_for_target(self, rid: ResourceID) -> TaskMetadata | None:
        with self._lock:
            for t in self._tasks.values():
                if t.target.key() == rid.key():
                    return t
        return None

    def runs_for_task(self, task_id: int) -> list[TaskRunMetadata]:
        with self._lock:
            return [r for r in self._runs.values() if r.task_id == task_id]

    def unfinished_runs(self) -> list[TaskRunMetadata]:
        """What the scheduler polls every tick (scheduler.go:52-79)."""
        with self._lock:
            return [
                r
                for r in self._runs.values()
                if r.status in (RunStatus.PENDING, RunStatus.RUNNING)
            ]

    def all_runs(self) -> list[TaskRunMetadata]:
        with self._lock:
            return list(self._runs.values())
