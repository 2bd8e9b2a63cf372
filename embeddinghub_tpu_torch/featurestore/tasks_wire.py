"""Wire-parity Tasks gRPC service over the in-process TaskManager.

Speaks the reference's scheduling proto verbatim
(``scheduling/proto/scheduling.proto:18-31``); hosted by the metadata
server alongside the Metadata service, the way the reference metadata
server hosts Tasks (``metadata/metadata.go:1940-2233``).  Runners and
dashboards built against the reference stubs can create runs, stream
statuses, append logs and watch for cancellation against this server.
"""

from __future__ import annotations

import time

import grpc
from google.protobuf import timestamp_pb2

from embeddinghub_tpu_torch.featurestore.proto import ff_metadata_pb2 as mpb
from embeddinghub_tpu_torch.featurestore.proto import ff_scheduling_pb2 as pb
from embeddinghub_tpu_torch.featurestore.proto.ff_scheduling_grpc import (
    TasksServicer,
    add_TasksServicer_to_server,
)
from embeddinghub_tpu_torch.featurestore.metadata_wire import _PB_RTYPE
from embeddinghub_tpu_torch.featurestore.scheduling import (
    RunStatus,
    TaskManager,
    TaskMetadata,
    TaskRunMetadata,
)

_RTYPE_TO_PB = {v: k for k, v in _PB_RTYPE.items()}

_RUN_STATUS_TO_PB = {
    RunStatus.PENDING: mpb.ResourceStatus.PENDING,
    RunStatus.RUNNING: mpb.ResourceStatus.RUNNING,
    RunStatus.READY: mpb.ResourceStatus.READY,
    RunStatus.FAILED: mpb.ResourceStatus.FAILED,
    RunStatus.CANCELLED: mpb.ResourceStatus.CANCELLED,
}
_RUN_STATUS_FROM_PB = {v: k for k, v in _RUN_STATUS_TO_PB.items()}

_TASK_TYPE_TO_PB = {
    "deletion": pb.TaskType.RESOURCE_DELETION,
    "health": pb.TaskType.HEALTH_CHECK,
    "metrics": pb.TaskType.METRICS,
}

_TERMINAL = (RunStatus.READY, RunStatus.FAILED, RunStatus.CANCELLED)


def _ts(t: float | None) -> timestamp_pb2.Timestamp:
    out = timestamp_pb2.Timestamp()
    if t:
        out.FromMilliseconds(int(t * 1000))
    return out


def task_to_pb(task: TaskMetadata) -> pb.TaskMetadata:
    out = pb.TaskMetadata(
        id=pb.TaskID(id=str(task.id)),
        name=task.name,
        type=_TASK_TYPE_TO_PB.get(
            task.task_type, pb.TaskType.RESOURCE_CREATION
        ),
        targetType=pb.TargetType.NAME_VARIANT,
        created=_ts(task.created_at),
    )
    rid = task.target
    out.nameVariant.resourceID.resource.name = rid.name
    out.nameVariant.resourceID.resource.variant = rid.variant or ""
    out.nameVariant.resourceID.resource_type = _RTYPE_TO_PB.get(
        rid.type, mpb.ResourceType.SOURCE_VARIANT
    )
    return out


def run_to_pb(run: TaskRunMetadata, task: TaskMetadata | None) -> pb.TaskRunMetadata:
    out = pb.TaskRunMetadata(
        runID=pb.RunID(id=str(run.run_id)),
        taskID=pb.TaskID(id=str(run.task_id)),
        name=run.name,
        triggerType=pb.TriggerType.ON_APPLY,
        startTime=_ts(run.started_at),
        endTime=_ts(run.ended_at),
        resumeID=pb.ResumeID(id=run.resume_id),
    )
    out.apply.name = run.name
    out.logs.extend(run.logs)
    out.status.status = _RUN_STATUS_TO_PB.get(
        run.status, mpb.ResourceStatus.NO_STATUS
    )
    if run.error:
        out.status.error_message = run.error
    if task is not None:
        t = task_to_pb(task)
        out.nameVariant.CopyFrom(t.nameVariant)
        out.targetType = t.targetType
        out.isDelete = t.type == pb.TaskType.RESOURCE_DELETION
    return out


class TasksWireService(TasksServicer):
    def __init__(self, tasks: TaskManager, watch_timeout_s: float = 30.0):
        self.tasks = tasks
        self.watch_timeout_s = watch_timeout_s

    # ------------------------------------------------------------- helpers

    def _task(self, task_id_msg, context) -> TaskMetadata:
        try:
            return self.tasks.task(int(task_id_msg.id))
        except (KeyError, ValueError):
            context.abort(
                grpc.StatusCode.NOT_FOUND, f"no task {task_id_msg.id!r}"
            )

    def _run(self, run_id_msg, context) -> TaskRunMetadata:
        try:
            return self.tasks.run(int(run_id_msg.id))
        except (KeyError, ValueError):
            context.abort(
                grpc.StatusCode.NOT_FOUND, f"no run {run_id_msg.id!r}"
            )

    def _run_pb(self, run: TaskRunMetadata) -> pb.TaskRunMetadata:
        task = self.tasks._tasks.get(run.task_id)
        return run_to_pb(run, task)

    # ----------------------------------------------------------------- RPCs

    def CreateTaskRun(self, request, context):
        task = self._task(request.taskID, context)
        run = self.tasks.create_run(task.id, name=request.name)
        return pb.RunID(id=str(run.run_id))

    def SyncUnfinishedRuns(self, request, context):
        # reconciliation runs continuously in the coordinator poll loop
        # (coordinator.py reconcile); this RPC is an explicit nudge in
        # the reference (scheduler.go:55-60) and a no-op barrier here
        return pb.Empty()

    def GetTaskByID(self, request, context):
        return task_to_pb(self._task(request, context))

    def GetRuns(self, request, context):
        task = self._task(request, context)
        for run in self.tasks.runs_for_task(task.id):
            yield self._run_pb(run)

    def GetRunMetadata(self, request, context):
        return self._run_pb(self._run(request.runID, context))

    def GetAllRuns(self, request, context):
        for run in self.tasks.all_runs():
            yield self._run_pb(run)

    def GetUnfinishedRuns(self, request, context):
        for run in self.tasks.unfinished_runs():
            yield self._run_pb(run)

    def GetLatestRun(self, request, context):
        task = self._task(request, context)
        runs = self.tasks.runs_for_task(task.id)
        if not runs:
            context.abort(
                grpc.StatusCode.NOT_FOUND, f"task {task.id} has no runs"
            )
        return self._run_pb(max(runs, key=lambda r: r.run_id))

    def SetRunStatus(self, request, context):
        run = self._run(request.runID, context)
        status = _RUN_STATUS_FROM_PB.get(request.status.status)
        if status is None:
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"unsupported run status {request.status.status}",
            )
        self.tasks.set_run_status(
            run.run_id, status, request.status.error_message
        )
        return pb.Empty()

    def SetRunResumeID(self, request, context):
        run = self._run(request.runID, context)
        self.tasks.set_run_resume_id(run.run_id, request.resumeID.id)
        return pb.Empty()

    def AddRunLog(self, request, context):
        self._run(request.runID, context).log(request.log)
        return pb.Empty()

    def SetRunEndTime(self, request, context):
        run = self._run(request.runID, context)
        run.ended_at = request.end.ToMilliseconds() / 1000.0
        return pb.Empty()

    def WatchForCancel(self, request, context):
        """Block until the run reaches a terminal status (the reference
        runner watches this to abort cancelled jobs), bounded by
        ``watch_timeout_s``."""
        run = self._run(request.runID, context)
        deadline = time.monotonic() + self.watch_timeout_s
        while (
            run.status not in _TERMINAL
            and time.monotonic() < deadline
            and context.is_active()
        ):
            time.sleep(0.05)
        out = mpb.ResourceStatus()
        out.status = _RUN_STATUS_TO_PB.get(
            run.status, mpb.ResourceStatus.NO_STATUS
        )
        if run.error:
            out.error_message = run.error
        return out


def register(service: TasksWireService, server) -> None:
    add_TasksServicer_to_server(service, server)
