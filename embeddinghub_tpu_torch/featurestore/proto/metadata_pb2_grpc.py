"""gRPC stubs for the Metadata service (hand-written grpcio boilerplate)."""

import grpc

from embeddinghub_tpu_torch.featurestore.proto import metadata_pb2 as pb

_SERVICE = "embeddinghub_tpu.metadata.proto.Metadata"

_METHODS = [
    ("CreateResource", "uu", pb.ResourceBlob, pb.CreateResponse),
    ("GetResource", "uu", pb.ResourceRef, pb.ResourceBlob),
    ("ListResources", "us", pb.TypeRef, pb.ResourceBlob),
    ("DeleteResource", "uu", pb.ResourceRef, pb.Empty),
    ("RunTasks", "uu", pb.Empty, pb.RunSummary),
    ("Search", "us", pb.SearchQuery, pb.SearchHit),
]


class MetadataStub:
    def __init__(self, channel: grpc.Channel):
        for name, kind, req, resp in _METHODS:
            factory = {
                "uu": channel.unary_unary,
                "us": channel.unary_stream,
            }[kind]
            setattr(
                self,
                name,
                factory(
                    f"/{_SERVICE}/{name}",
                    request_serializer=req.SerializeToString,
                    response_deserializer=resp.FromString,
                ),
            )


class MetadataServicer:
    def _unimplemented(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()

    CreateResource = _unimplemented
    GetResource = _unimplemented
    ListResources = _unimplemented
    DeleteResource = _unimplemented
    RunTasks = _unimplemented
    Search = _unimplemented


def add_MetadataServicer_to_server(servicer, server) -> None:
    handlers = {}
    for name, kind, req, resp in _METHODS:
        factory = {
            "uu": grpc.unary_unary_rpc_method_handler,
            "us": grpc.unary_stream_rpc_method_handler,
        }[kind]
        handlers[name] = factory(
            getattr(servicer, name),
            request_deserializer=req.FromString,
            response_serializer=resp.SerializeToString,
        )
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(_SERVICE, handlers),)
    )
