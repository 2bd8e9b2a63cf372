"""gRPC stubs/registration for the wire-parity Tasks service.

Hand-written (the image ships no grpcio-tools): a method table drives
both the client stub and the server registration, producing the same
method paths ``/featureform.scheduling.proto.Tasks/<RPC>`` a
reference-generated stub uses (reference service definition:
``scheduling/proto/scheduling.proto:18-31``; the reference metadata
server hosts these RPCs alongside Metadata, ``metadata.go:1940-2233``).
"""

from __future__ import annotations

import grpc

from embeddinghub_tpu_torch.featurestore.proto import ff_metadata_pb2 as mpb
from embeddinghub_tpu_torch.featurestore.proto import ff_scheduling_pb2 as pb

_PKG = "featureform.scheduling.proto"

# name -> (kind, request message, response message)
#   uu = unary_unary, us = unary_stream
METHODS = {
    "CreateTaskRun": ("uu", pb.CreateRunRequest, pb.RunID),
    "SyncUnfinishedRuns": ("uu", pb.Empty, pb.Empty),
    "GetTaskByID": ("uu", pb.TaskID, pb.TaskMetadata),
    "GetRuns": ("us", pb.TaskID, pb.TaskRunMetadata),
    "GetRunMetadata": ("uu", pb.TaskRunID, pb.TaskRunMetadata),
    "GetAllRuns": ("us", pb.Empty, pb.TaskRunMetadata),
    "GetUnfinishedRuns": ("us", pb.Empty, pb.TaskRunMetadata),
    "GetLatestRun": ("uu", pb.TaskID, pb.TaskRunMetadata),
    "SetRunStatus": ("uu", pb.StatusUpdate, pb.Empty),
    "SetRunResumeID": ("uu", pb.ResumeIDUpdate, pb.Empty),
    "AddRunLog": ("uu", pb.Log, pb.Empty),
    "SetRunEndTime": ("uu", pb.RunEndTimeUpdate, pb.Empty),
    "WatchForCancel": ("uu", pb.TaskRunID, mpb.ResourceStatus),
}


class TasksStub:
    """Client stub, method-path compatible with the reference's."""

    def __init__(self, channel: grpc.Channel):
        for name, (kind, req, resp) in METHODS.items():
            path = f"/{_PKG}.Tasks/{name}"
            factory = {
                "uu": channel.unary_unary,
                "us": channel.unary_stream,
            }[kind]
            setattr(
                self,
                name,
                factory(
                    path,
                    request_serializer=req.SerializeToString,
                    response_deserializer=resp.FromString,
                ),
            )


class TasksServicer:
    """Subclass and override the methods you serve; unimplemented ones
    return UNIMPLEMENTED."""

    pass


def _unimplemented(request, context):
    context.abort(grpc.StatusCode.UNIMPLEMENTED, "method not implemented")


def add_TasksServicer_to_server(servicer, server) -> None:
    handlers = {}
    for name, (kind, req, resp) in METHODS.items():
        fn = getattr(servicer, name, _unimplemented)
        maker = {
            "uu": grpc.unary_unary_rpc_method_handler,
            "us": grpc.unary_stream_rpc_method_handler,
        }[kind]
        handlers[name] = maker(
            fn,
            request_deserializer=req.FromString,
            response_serializer=resp.SerializeToString,
        )
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(f"{_PKG}.Tasks", handlers),)
    )
