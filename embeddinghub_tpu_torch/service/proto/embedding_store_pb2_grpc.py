"""gRPC client stub + server registration for the EmbeddingHub service.

Hand-written (the image ships no grpcio-tools); standard grpcio
boilerplate equivalent to what ``protoc --grpc_python_out`` would emit
for embedding_store.proto.
"""

import grpc

from embeddinghub_tpu_torch.service.proto import embedding_store_pb2 as pb

_SERVICE = "featureform.embedding.proto.EmbeddingHub"

# (method, kind, request type, response type); kind: uu=unary-unary,
# su=stream-unary, ss=stream-stream, us=unary-stream
_METHODS = [
    ("CreateSpace", "uu", pb.CreateSpaceRequest, pb.CreateSpaceResponse),
    ("DeleteSpace", "uu", pb.DeleteSpaceRequest, pb.DeleteSpaceResponse),
    ("FreezeSpace", "uu", pb.FreezeSpaceRequest, pb.FreezeSpaceResponse),
    ("Set", "uu", pb.SetRequest, pb.SetResponse),
    ("Get", "uu", pb.GetRequest, pb.GetResponse),
    ("MultiSet", "su", pb.MultiSetRequest, pb.MultiSetResponse),
    ("MultiGet", "ss", pb.MultiGetRequest, pb.MultiGetResponse),
    ("NearestNeighbor", "uu", pb.NearestNeighborRequest, pb.NearestNeighborResponse),
    ("Download", "us", pb.DownloadRequest, pb.DownloadResponse),
    (
        "BatchNearestNeighbor",
        "uu",
        pb.BatchNearestNeighborRequest,
        pb.BatchNearestNeighborResponse,
    ),
]


class EmbeddingHubStub:
    def __init__(self, channel: grpc.Channel):
        for name, kind, req, resp in _METHODS:
            path = f"/{_SERVICE}/{name}"
            factory = {
                "uu": channel.unary_unary,
                "su": channel.stream_unary,
                "ss": channel.stream_stream,
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


class EmbeddingHubServicer:
    """Subclass and override; unimplemented methods return UNIMPLEMENTED."""

    def _unimplemented(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        context.set_details("Method not implemented")
        raise NotImplementedError()

    CreateSpace = _unimplemented
    DeleteSpace = _unimplemented
    FreezeSpace = _unimplemented
    Set = _unimplemented
    Get = _unimplemented
    MultiSet = _unimplemented
    MultiGet = _unimplemented
    NearestNeighbor = _unimplemented
    Download = _unimplemented
    BatchNearestNeighbor = _unimplemented


def add_EmbeddingHubServicer_to_server(servicer, server) -> None:
    handlers = {}
    for name, kind, req, resp in _METHODS:
        factory = {
            "uu": grpc.unary_unary_rpc_method_handler,
            "su": grpc.stream_unary_rpc_method_handler,
            "ss": grpc.stream_stream_rpc_method_handler,
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
