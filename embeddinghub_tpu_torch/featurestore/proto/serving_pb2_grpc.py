"""gRPC stubs for the Feature serving service (hand-written grpcio
boilerplate; the image has no grpcio-tools)."""

import grpc

from embeddinghub_tpu_torch.featurestore.proto import serving_pb2 as pb

_SERVICE = "featureform.serving.proto.Feature"

_METHODS = [
    ("TrainingData", "us", pb.TrainingDataRequest, pb.TrainingDataRows),
    ("TrainTestSplit", "ss", pb.TrainTestSplitRequest, pb.BatchTrainTestSplitResponse),
    ("FeatureServe", "uu", pb.FeatureServeRequest, pb.FeatureRow),
    ("SourceData", "us", pb.SourceDataRequest, pb.SourceDataRows),
    ("Nearest", "uu", pb.NearestRequest, pb.NearestResponse),
    ("BatchFeatureServe", "us", pb.BatchFeatureServeRequest, pb.BatchFeatureRows),
    ("TrainingDataColumns", "uu", pb.TrainingDataColumnsRequest, pb.TrainingColumns),
    ("SourceColumns", "uu", pb.SourceColumnRequest, pb.SourceDataColumns),
    ("GetResourceLocation", "uu", pb.ResourceIdRequest, pb.ResourceLocation),
]


class FeatureStub:
    def __init__(self, channel: grpc.Channel):
        for name, kind, req, resp in _METHODS:
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
                    f"/{_SERVICE}/{name}",
                    request_serializer=req.SerializeToString,
                    response_deserializer=resp.FromString,
                ),
            )


class FeatureServicer:
    def _unimplemented(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        context.set_details("Method not implemented")
        raise NotImplementedError()

    TrainingData = _unimplemented
    TrainTestSplit = _unimplemented
    FeatureServe = _unimplemented
    SourceData = _unimplemented
    Nearest = _unimplemented
    BatchFeatureServe = _unimplemented
    TrainingDataColumns = _unimplemented
    SourceColumns = _unimplemented
    GetResourceLocation = _unimplemented


def add_FeatureServicer_to_server(servicer, server) -> None:
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
