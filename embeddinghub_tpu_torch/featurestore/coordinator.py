"""Coordinator — task orchestration.

Rebuild of reference ``coordinator/``: a poll scheduler
(``scheduler.go:52-79``) that fetches unfinished task runs and executes
them; an executor that double-locks task+run via ffsync, waits for
dependencies, and dispatches by target resource type
(``executor.go:40-101``, task factory ``tasks/tasks.go:24-42``); task
implementations for sources (``tasks/source.go``), features /
materialization (``tasks/feature.go:35``, ``runner/materialize.go``,
hot copy loop ``runner/copy.go:65-140``), labels and training sets
(``tasks/trainingset.go``).

The data-plane copy (offline materialization -> online store) runs as
chunked batched writes — the reference's worker-pool/chunk-index
machinery collapses into ``Materialization.iterate_chunk`` +
``batch_set`` (with the vector store, a chunk lands as one batched
device insert).
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from embeddinghub_tpu_torch.featurestore import fferr, ffsync
from embeddinghub_tpu_torch.featurestore.metadata import MetadataStore
from embeddinghub_tpu_torch.featurestore.providers import base as provider_base
from embeddinghub_tpu_torch.featurestore.resources import (
    FeatureVariant,
    LabelVariant,
    Provider,
    Resource,
    ResourceID,
    ResourceType,
    SourceVariant,
    Status,
    TrainingSetVariant,
)
from embeddinghub_tpu_torch.featurestore.scheduling import (
    RunStatus,
    TaskManager,
    TaskRunMetadata,
)

TASK_POLL_INTERVAL_S = 1.0  # reference TaskPollInterval=1s


class Coordinator:
    def __init__(
        self,
        metadata: MetadataStore,
        tasks: TaskManager | None = None,
        locker: ffsync.Locker | None = None,
    ):
        self.metadata = metadata
        self.tasks = tasks if tasks is not None else TaskManager()
        self.locker = locker if locker is not None else ffsync.MemoryLocker()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        metadata.watch(self._on_resource_created)

    # -------------------------------------------------------------- wiring

    def _on_resource_created(self, res: Resource) -> None:
        """Create a task + pending run when a resource needs a job
        (metadata.go:169-199's needsJob/needsRun wiring)."""
        if not res.needs_job():
            return
        deps = []
        for dep in res.dependencies():
            t = self.tasks.task_for_target(dep)
            if t is not None:
                deps.append(t.id)
        task = self.tasks.create_task(
            f"{res.rtype.value.lower()}:{res.rid()}",
            _task_type(res),
            res.rid(),
            depends_on=deps,
        )
        self.tasks.create_run(task.id, name=f"create {res.rid()}")

    # ----------------------------------------------------------- scheduling

    def start(self, poll_interval_s: float = TASK_POLL_INTERVAL_S) -> None:
        """Background poll loop (daemon thread per unfinished run, like
        the reference's goroutine-per-run); reconciles stuck runs every
        ~minute (the reference's SyncUnfinishedRuns, scheduler.go:55-60)."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            ticks = 0
            while not self._stop.is_set():
                self.schedule_refreshes()
                self.run_pending_sync()
                ticks += 1
                if ticks % max(1, int(60 / max(poll_interval_s, 0.01))) == 0:
                    self.reconcile()
                self._stop.wait(poll_interval_s)

        self._thread = threading.Thread(target=loop, name="coordinator", daemon=True)
        self._thread.start()

    def schedule_refreshes(self) -> int:
        """Scheduled re-runs: tasks with a schedule string (set via
        RequestScheduleChange) or whose target declares
        ``refresh_interval_s`` get a fresh PENDING run once the previous
        READY run is older than the interval (the reference's CronJob
        scheduling for sources/materializations,
        kubernetes/kubernetes.go:223-236)."""
        import time as _time

        from embeddinghub_tpu_torch.featurestore.scheduling import parse_schedule

        created = 0
        now = _time.time()
        for task in list(self.tasks._tasks.values()):
            try:
                interval = parse_schedule(task.schedule)
            except ValueError:
                interval = None
            if interval is None:
                res = self.metadata.maybe_get(task.target)
                interval = getattr(res, "refresh_interval_s", 0) if res else 0
            if not interval:
                continue
            runs = self.tasks.runs_for_task(task.id)
            if not runs:
                continue
            last = max(runs, key=lambda r: r.run_id)
            if (
                last.status == RunStatus.READY
                and last.ended_at is not None
                and now - last.ended_at >= interval
            ):
                self.tasks.create_run(task.id, name=f"refresh {task.target}")
                created += 1
        return created

    def reconcile(self, stale_after_s: float = 300.0) -> int:
        """Failure detection: a RUNNING run whose owner died leaves its
        lease to lapse; once both locks are free again and the run is
        stale, requeue it as PENDING so the poll loop re-executes it
        (reference executor.go:87-94 semantics).  Returns requeued count."""
        import time as _time

        requeued = 0
        now = _time.time()
        for run in self.tasks.unfinished_runs():
            if run.status != RunStatus.RUNNING:
                continue
            if run.started_at is None or now - run.started_at < stale_after_s:
                continue
            try:
                task_key = self.locker.lock(f"task/{run.task_id}")
            except fferr.KeyAlreadyLockedError:
                continue  # a live owner still holds it
            try:
                run_key = self.locker.lock(f"run/{run.run_id}")
            except fferr.KeyAlreadyLockedError:
                self.locker.unlock(task_key)
                continue
            try:
                run.log("reconciler: stale RUNNING run requeued")
                self.tasks.set_run_status(run.run_id, RunStatus.PENDING)
                requeued += 1
            finally:
                self.locker.unlock(run_key)
                self.locker.unlock(task_key)
        return requeued

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def run_pending_sync(self, max_passes: int = 32) -> None:
        """Drive all runnable tasks to completion synchronously (used by
        apply(wait=True) and tests; the poll loop calls one pass)."""
        for _ in range(max_passes):
            progressed = False
            for run in self.tasks.unfinished_runs():
                if self._execute_run(run):
                    progressed = True
            if not progressed:
                return

    # -------------------------------------------------------------- executor

    def _execute_run(self, run: TaskRunMetadata) -> bool:
        """Executor.RunTask semantics: lock task+run, skip non-pending,
        wait for deps, cancel on failed deps (executor.go:40-101)."""
        task = self.tasks.task(run.task_id)
        try:
            task_key = self.locker.lock(f"task/{task.id}")
        except fferr.KeyAlreadyLockedError:
            return False
        try:
            run_key = self.locker.lock(f"run/{run.run_id}")
        except fferr.KeyAlreadyLockedError:
            self.locker.unlock(task_key)
            return False
        try:
            if run.status not in (RunStatus.PENDING, RunStatus.RUNNING):
                return False
            dep_state = self._deps_state(task.id)
            if dep_state == "failed":
                self.tasks.set_run_status(
                    run.run_id, RunStatus.CANCELLED, "dependency failed"
                )
                self.metadata.set_status(
                    task.target, Status.FAILED, "dependency failed"
                )
                return True
            if dep_state == "waiting":
                return False
            self.tasks.set_run_status(run.run_id, RunStatus.RUNNING)
            self.metadata.set_status(task.target, Status.RUNNING)
            run.log(f"starting {task.task_type} for {task.target.key()}")
            try:
                _TASK_IMPLS[task.task_type](self, task.target, run)
            except Exception as e:  # noqa: BLE001 — task failure is data
                run.log(f"failed: {e}")
                self.tasks.set_run_status(run.run_id, RunStatus.FAILED, str(e))
                self.metadata.set_status(task.target, Status.FAILED, str(e))
                from embeddinghub_tpu_torch.featurestore.notifications import NOTIFIER

                NOTIFIER.task_run(task.name, run.run_id, "FAILED", str(e))
                return True
            run.log("ready")
            self.tasks.set_run_status(run.run_id, RunStatus.READY)
            self.metadata.set_status(task.target, Status.READY)
            return True
        finally:
            self.locker.unlock(run_key)
            self.locker.unlock(task_key)

    def _deps_state(self, task_id: int) -> str:
        for dep_id in self.tasks.dag.dependencies(task_id):
            dep_runs = self.tasks.runs_for_task(dep_id)
            if not dep_runs:
                continue
            last = max(dep_runs, key=lambda r: r.run_id)
            if last.status in (RunStatus.FAILED, RunStatus.CANCELLED):
                return "failed"
            if last.status != RunStatus.READY:
                return "waiting"
        return "ready"

    # ------------------------------------------------------------- providers

    def provider_for(self, name: str) -> provider_base.Provider:
        res = self.metadata.maybe_get(ResourceID(ResourceType.PROVIDER, name))
        if res is None or not isinstance(res, Provider):
            raise fferr.ProviderNotFoundError(name)
        return provider_base.get_provider(
            res.provider_type, res.config, cache_key=name
        )


# ------------------------------------------------------------------- tasks


def _task_type(res: Resource) -> str:
    return {
        ResourceType.SOURCE_VARIANT: "source",
        ResourceType.FEATURE_VARIANT: "materialize",
        ResourceType.LABEL_VARIANT: "label",
        ResourceType.TRAINING_SET_VARIANT: "trainingset",
    }.get(res.rtype, "noop")


def _run_source(coord: Coordinator, rid: ResourceID, run: TaskRunMetadata) -> None:
    src: SourceVariant = coord.metadata.get(rid)  # type: ignore[assignment]
    offline = coord.provider_for(src.provider).as_offline_store()
    if src.is_transformation():
        # compute-offload seam (reference tasks/source.go picking Spark
        # vs k8s): a transformation may name an engine — its job spec is
        # submitted/polled/fetched instead of running provider-native.
        from embeddinghub_tpu_torch.featurestore.transform_engine import (
            build_spec,
            get_engine,
        )

        engine = get_engine((src.transformation or {}).get("engine"))
        if engine is not None:
            run.log(
                f"submitting transformation to {type(engine).__name__} "
                f"(inputs {src.inputs})"
            )
            rows = engine.run(build_spec(src, offline), on_log=run.log)
            offline.write_rows(src.name, src.variant, rows)
        else:
            run.log(f"running transformation with inputs {src.inputs}")
            offline.create_transformation(
                src.name, src.variant, src.transformation, src.inputs
            )
    else:
        run.log("registering primary data")
        offline.register_primary(src.name, src.variant, src.primary)


def _run_materialize(
    coord: Coordinator, rid: ResourceID, run: TaskRunMetadata
) -> None:
    feat: FeatureVariant = coord.metadata.get(rid)  # type: ignore[assignment]
    if feat.on_demand_fn is not None:
        return
    if feat.stream:
        # stream feature: provision the inference-store table only;
        # values arrive by direct writes (reference StreamFeature)
        online = coord.provider_for(feat.provider).as_online_store()
        online.create_table(feat.name, feat.variant, feat.value_type)
        run.log("provisioned stream inference table")
        return
    sname, svariant = feat.source
    src: SourceVariant = coord.metadata.get(
        ResourceID(ResourceType.SOURCE_VARIANT, sname, svariant)
    )  # type: ignore[assignment]
    offline = coord.provider_for(src.provider).as_offline_store()
    online = coord.provider_for(feat.provider).as_online_store()

    mat = offline.materialize(
        sname, svariant, feat.entity_column, feat.value_column,
        feat.timestamp_column,
    )
    run.log(f"materialized {len(mat)} rows in {mat.num_chunks()} chunks")

    if feat.is_embedding:
        if not isinstance(online, provider_base.VectorStore):
            raise fferr.ProviderTypeError(feat.provider, "VectorStore")
        table = online.create_index(feat.name, feat.variant, feat.dims)
    else:
        table = online.create_table(feat.name, feat.variant, feat.value_type)

    # hot copy loop: chunk iterator -> batched online writes
    # (reference copy.go:65-140's channel/worker-pool equivalent)
    for chunk_idx in range(mat.num_chunks()):
        table.batch_set(list(mat.iterate_chunk(chunk_idx)))
        run.log(f"chunk {chunk_idx + 1}/{mat.num_chunks()} copied")


def _run_label(coord: Coordinator, rid: ResourceID, run: TaskRunMetadata) -> None:
    # labels need no data movement; the variant is validated at get time
    coord.metadata.get(rid)


def _run_trainingset(
    coord: Coordinator, rid: ResourceID, run: TaskRunMetadata
) -> None:
    ts: TrainingSetVariant = coord.metadata.get(rid)  # type: ignore[assignment]
    label: LabelVariant = coord.metadata.get(
        ResourceID(ResourceType.LABEL_VARIANT, *ts.label)
    )  # type: ignore[assignment]
    lab_src: SourceVariant = coord.metadata.get(
        ResourceID(ResourceType.SOURCE_VARIANT, *label.source)
    )  # type: ignore[assignment]
    offline = coord.provider_for(ts.provider or lab_src.provider).as_offline_store()

    features = []
    for fname, fvariant in ts.features:
        feat: FeatureVariant = coord.metadata.get(
            ResourceID(ResourceType.FEATURE_VARIANT, fname, fvariant)
        )  # type: ignore[assignment]
        features.append(
            {
                "source": feat.source,
                "entity_column": feat.entity_column,
                "value_column": feat.value_column,
                "timestamp_column": feat.timestamp_column,
            }
        )
    # lagged columns: same feature spec with a "lag" offset the join
    # subtracts from the label timestamp (provider/k8s.go:63-75)
    for fl in getattr(ts, "feature_lags", []):
        feat = coord.metadata.get(
            ResourceID(ResourceType.FEATURE_VARIANT,
                       fl["feature"], fl["variant"])
        )  # type: ignore[assignment]
        features.append(
            {
                "source": feat.source,
                "entity_column": feat.entity_column,
                "value_column": feat.value_column,
                "timestamp_column": feat.timestamp_column,
                "lag": float(fl["lag"]),
                "name": fl.get("name", ""),
            }
        )
    offline.create_training_set(
        ts.name,
        ts.variant,
        {
            "source": label.source,
            "entity_column": label.entity_column,
            "value_column": label.value_column,
            "timestamp_column": label.timestamp_column,
        },
        features,
    )
    run.log(f"training set built from label {ts.label} + {len(features)} features")


def _run_noop(coord, rid, run) -> None:
    pass


_TASK_IMPLS: dict[str, Callable] = {
    "source": _run_source,
    "materialize": _run_materialize,
    "label": _run_label,
    "trainingset": _run_trainingset,
    "noop": _run_noop,
}
