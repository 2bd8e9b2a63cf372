"""Metadata gRPC service + remote client.

The api-gateway/metadata-service capability (reference ``api/api.go``
proxying to the ``Metadata`` gRPC service, ``metadata/metadata.go``):
resource CRUD and orchestration over the network, so a remote
``Registrar`` can ``apply()`` against a central control plane.

Resources travel as typed JSON payloads (resources.to_wire/from_wire —
pickle is gone from the wire; client callables degrade to source text).
For byte-level interop with reference clients use the typed wire-parity
service in metadata_wire.py; this compact service is the internal fast
path.

Run standalone: handled by ``embeddinghub_tpu_torch.main`` (one process runs
everything) or embed ``build_server`` next to any MetadataStore.
"""

from __future__ import annotations

from concurrent import futures as cf

import grpc

from embeddinghub_tpu_torch.featurestore import fferr
from embeddinghub_tpu_torch.featurestore.metadata import MetadataStore
from embeddinghub_tpu_torch.featurestore.proto import metadata_pb2 as pb
from embeddinghub_tpu_torch.featurestore.proto import metadata_pb2_grpc as pb_grpc
from embeddinghub_tpu_torch.featurestore.resources import (
    ResourceID,
    ResourceType,
    from_wire,
    to_wire,
)
from embeddinghub_tpu_torch.featurestore.search import SearchIndex

_CODE = {
    "NOT_FOUND": grpc.StatusCode.NOT_FOUND,
    "ALREADY_EXISTS": grpc.StatusCode.ALREADY_EXISTS,
    "FAILED_PRECONDITION": grpc.StatusCode.FAILED_PRECONDITION,
    "INVALID_ARGUMENT": grpc.StatusCode.INVALID_ARGUMENT,
    "ABORTED": grpc.StatusCode.ABORTED,
    "INTERNAL": grpc.StatusCode.INTERNAL,
}


def _blob(res) -> pb.ResourceBlob:
    return pb.ResourceBlob(
        type=res.rtype.value,
        name=res.name,
        variant=getattr(res, "variant", ""),
        payload=to_wire(res),
        status=res.status.value,
        status_error=res.status_error,
    )


class MetadataService(pb_grpc.MetadataServicer):
    def __init__(self, metadata: MetadataStore, coordinator=None):
        self._metadata = metadata
        self._coordinator = coordinator
        self._search = SearchIndex(metadata)

    def _abort(self, context, e: fferr.FFError):
        context.abort(_CODE.get(e.code, grpc.StatusCode.INTERNAL), str(e))

    def CreateResource(self, request, context):
        try:
            res = from_wire(request.payload)
            created = self._metadata.create(res)
        except fferr.FFError as e:
            self._abort(context, e)
        except Exception as e:  # noqa: BLE001 — bad payloads are client errors
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        return pb.CreateResponse(created=created)

    def GetResource(self, request, context):
        try:
            res = self._metadata.get(
                ResourceID(
                    ResourceType(request.type), request.name, request.variant
                )
            )
        except (fferr.FFError, ValueError) as e:
            code = getattr(e, "code", "INVALID_ARGUMENT")
            context.abort(_CODE.get(code, grpc.StatusCode.INVALID_ARGUMENT), str(e))
        return _blob(res)

    def ListResources(self, request, context):
        try:
            rtype = ResourceType(request.type)
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        for res in self._metadata.list_type(rtype):
            yield _blob(res)

    def DeleteResource(self, request, context):
        try:
            self._metadata.delete(
                ResourceID(
                    ResourceType(request.type), request.name, request.variant
                )
            )
        except (fferr.FFError, ValueError) as e:
            code = getattr(e, "code", "INVALID_ARGUMENT")
            context.abort(_CODE.get(code, grpc.StatusCode.INVALID_ARGUMENT), str(e))
        return pb.Empty()

    def RunTasks(self, request, context):
        if self._coordinator is not None:
            self._coordinator.run_pending_sync()
            from embeddinghub_tpu_torch.featurestore.scheduling import RunStatus

            runs = self._coordinator.tasks.all_runs()
            return pb.RunSummary(
                ready=sum(r.status == RunStatus.READY for r in runs),
                failed=sum(r.status == RunStatus.FAILED for r in runs),
                pending=sum(
                    r.status in (RunStatus.PENDING, RunStatus.RUNNING)
                    for r in runs
                ),
            )
        return pb.RunSummary()

    def Search(self, request, context):
        for hit in self._search.search(request.q, request.limit or 20):
            yield pb.SearchHit(
                type=hit["type"],
                name=hit["name"],
                variant=hit["variant"],
                description=hit["description"],
            )


def build_server(
    address: str, metadata: MetadataStore, coordinator=None,
    interceptors=None, serving=None,
) -> grpc.Server:
    """One gRPC server hosting the metadata surfaces: the compact
    internal service, the reference-wire-parity typed service
    (``featureform.serving.metadata.proto.Metadata``) — the way the
    reference metadata server hosts Metadata + Tasks together
    (``metadata/metadata.go:1940``) — and the reference ``Api`` gateway
    surface incl. the WriteFeatures/WriteLabels streams (api/api.go)."""
    from embeddinghub_tpu_torch.featurestore.interceptors import make_server

    server = make_server(
        cf.ThreadPoolExecutor(max_workers=16),
        interceptors=interceptors or (),
    )
    pb_grpc.add_MetadataServicer_to_server(
        MetadataService(metadata, coordinator), server
    )
    from embeddinghub_tpu_torch.featurestore.metadata_wire import (
        MetadataWireService,
        register,
    )

    tasks = coordinator.tasks if coordinator is not None else None
    register(MetadataWireService(metadata, tasks=tasks), server)
    from embeddinghub_tpu_torch.featurestore.api_wire import ApiWireService
    from embeddinghub_tpu_torch.featurestore.api_wire import (
        register as register_api,
    )

    register_api(
        ApiWireService(metadata, serving=serving, tasks=tasks), server
    )
    if coordinator is not None:
        from embeddinghub_tpu_torch.featurestore.tasks_wire import TasksWireService
        from embeddinghub_tpu_torch.featurestore.tasks_wire import (
            register as register_tasks,
        )

        register_tasks(TasksWireService(coordinator.tasks), server)
    from embeddinghub_tpu_torch.utils.channels import add_server_port

    add_server_port(server, address)
    return server


class RemoteMetadataClient:
    """Typed remote metadata handle (reference metadata/client.go role)."""

    def __init__(
        self,
        host: str = "0.0.0.0",
        port: int = 8080,
        channel=None,
        insecure: bool = True,
        cert_path: str | None = None,
    ):
        from embeddinghub_tpu_torch.utils.channels import make_channel

        self._channel = channel or make_channel(
            host, port, insecure=insecure, cert_path=cert_path
        )
        self._stub = pb_grpc.MetadataStub(self._channel)

    def close(self):
        self._channel.close()

    def create(self, res) -> bool:
        return self._stub.CreateResource(_blob(res)).created

    def get(self, rtype: ResourceType, name: str, variant: str = ""):
        blob = self._stub.GetResource(
            pb.ResourceRef(type=rtype.value, name=name, variant=variant)
        )
        return from_wire(blob.payload)

    def list(self, rtype: ResourceType):
        return [
            from_wire(b.payload)
            for b in self._stub.ListResources(pb.TypeRef(type=rtype.value))
        ]

    def delete(self, rtype: ResourceType, name: str, variant: str = ""):
        self._stub.DeleteResource(
            pb.ResourceRef(type=rtype.value, name=name, variant=variant)
        )

    def run_tasks(self):
        s = self._stub.RunTasks(pb.Empty())
        return {"ready": s.ready, "failed": s.failed, "pending": s.pending}

    def search(self, q: str, limit: int = 20):
        return [
            {"type": h.type, "name": h.name, "variant": h.variant}
            for h in self._stub.Search(pb.SearchQuery(q=q, limit=limit))
        ]

    def apply(self, registrar) -> int:
        """Remote apply: submit the registrar's resources in dependency
        order, then run orchestration (the reference client.apply() path
        through the api gateway, register.py:4927)."""
        from embeddinghub_tpu_torch.featurestore.registry import _topo_sort

        created = 0
        for res in _topo_sort(registrar.resources()):
            if self.create(res):
                created += 1
        self.run_tasks()
        registrar.reset()
        return created
