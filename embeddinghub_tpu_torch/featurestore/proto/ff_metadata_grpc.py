"""gRPC stubs/registration for the wire-parity Metadata service.

Hand-written (the image ships no grpcio-tools): a method table drives
both the client stub and the server registration, producing the same
method paths ``/featureform.serving.metadata.proto.Metadata/<RPC>`` a
reference-generated stub uses (reference service definition:
``metadata/proto/metadata.proto:19-70``).
"""

from __future__ import annotations

import grpc

from embeddinghub_tpu_torch.featurestore.proto import ff_metadata_pb2 as pb

_PKG = "featureform.serving.metadata.proto"

# name -> (kind, request message, response message)
#   uu = unary_unary, us = unary_stream, ss = stream_stream
METHODS = {
    "CreateUser": ("uu", pb.UserRequest, pb.Empty),
    "CreateProvider": ("uu", pb.ProviderRequest, pb.Empty),
    "CreateSourceVariant": ("uu", pb.SourceVariantRequest, pb.Empty),
    "CreateEntity": ("uu", pb.EntityRequest, pb.Empty),
    "CreateFeatureVariant": ("uu", pb.FeatureVariantRequest, pb.Empty),
    "CreateLabelVariant": ("uu", pb.LabelVariantRequest, pb.Empty),
    "CreateTrainingSetVariant": ("uu", pb.TrainingSetVariantRequest, pb.Empty),
    "CreateModel": ("uu", pb.ModelRequest, pb.Empty),
    "RequestScheduleChange": ("uu", pb.ScheduleChangeRequest, pb.Empty),
    "GetUsers": ("ss", pb.NameRequest, pb.User),
    "GetFeatures": ("ss", pb.NameRequest, pb.Feature),
    "GetFeatureVariants": ("ss", pb.NameVariantRequest, pb.FeatureVariant),
    "GetLabels": ("ss", pb.NameRequest, pb.Label),
    "GetLabelVariants": ("ss", pb.NameVariantRequest, pb.LabelVariant),
    "GetTrainingSets": ("ss", pb.NameRequest, pb.TrainingSet),
    "GetTrainingSetVariants": (
        "ss", pb.NameVariantRequest, pb.TrainingSetVariant,
    ),
    "GetSources": ("ss", pb.NameRequest, pb.Source),
    "GetSourceVariants": ("ss", pb.NameVariantRequest, pb.SourceVariant),
    "GetProviders": ("ss", pb.NameRequest, pb.Provider),
    "GetEntities": ("ss", pb.NameRequest, pb.Entity),
    "GetModels": ("ss", pb.NameRequest, pb.Model),
    "MarkForDeletion": (
        "uu", pb.MarkForDeletionRequest, pb.MarkForDeletionResponse,
    ),
    "FinalizeDeletion": (
        "uu", pb.FinalizeDeletionRequest, pb.FinalizeDeletionResponse,
    ),
    "GetStagedForDeletionResource": (
        "uu",
        pb.GetStagedForDeletionResourceRequest,
        pb.GetStagedForDeletionResourceResponse,
    ),
    "PruneResource": ("uu", pb.PruneResourceRequest, pb.PruneResourceResponse),
    "GetEquivalent": ("uu", pb.GetEquivalentRequest, pb.ResourceVariant),
    "Run": ("uu", pb.RunRequest, pb.Empty),
    "ListFeatures": ("us", pb.ListRequest, pb.Feature),
    "ListLabels": ("us", pb.ListRequest, pb.Label),
    "ListTrainingSets": ("us", pb.ListRequest, pb.TrainingSet),
    "ListSources": ("us", pb.ListRequest, pb.Source),
    "ListUsers": ("us", pb.ListRequest, pb.User),
    "ListProviders": ("us", pb.ListRequest, pb.Provider),
    "ListEntities": ("us", pb.ListRequest, pb.Entity),
    "ListModels": ("us", pb.ListRequest, pb.Model),
    "SetResourceStatus": ("uu", pb.SetStatusRequest, pb.Empty),
}


# The reference's Api service (metadata.proto:72-118) shares the
# Metadata method set minus the deletion-staging/status internals, and
# adds the streaming write RPCs (api/api.go:1150).
API_METHODS = {
    name: spec
    for name, spec in METHODS.items()
    if name not in (
        "FinalizeDeletion", "GetStagedForDeletionResource",
        "SetResourceStatus",
    )
}
API_METHODS.update({
    "WriteFeatures": ("su", pb.StreamingFeatureVariant, pb.Empty),
    "WriteLabels": ("su", pb.StreamingLabelVariant, pb.Empty),
})


def _make_stub(obj, channel, service: str, methods: dict) -> None:
    for name, (kind, req, resp) in methods.items():
        path = f"/{_PKG}.{service}/{name}"
        factory = {
            "uu": channel.unary_unary,
            "us": channel.unary_stream,
            "su": channel.stream_unary,
            "ss": channel.stream_stream,
        }[kind]
        setattr(
            obj,
            name,
            factory(
                path,
                request_serializer=req.SerializeToString,
                response_deserializer=resp.FromString,
            ),
        )


class MetadataStub:
    """Client stub, method-path compatible with the reference's."""

    def __init__(self, channel: grpc.Channel):
        _make_stub(self, channel, "Metadata", METHODS)


class ApiStub:
    """Client stub for the reference's Api gateway service."""

    def __init__(self, channel: grpc.Channel):
        _make_stub(self, channel, "Api", API_METHODS)


class MetadataServicer:
    """Subclass and override the methods you serve; unimplemented ones
    return UNIMPLEMENTED."""

    pass


def _unimplemented(request, context):
    context.abort(grpc.StatusCode.UNIMPLEMENTED, "method not implemented")


def _add_servicer(servicer, server, service: str, methods: dict) -> None:
    handlers = {}
    for name, (kind, req, resp) in methods.items():
        fn = getattr(servicer, name, _unimplemented)
        maker = {
            "uu": grpc.unary_unary_rpc_method_handler,
            "us": grpc.unary_stream_rpc_method_handler,
            "su": grpc.stream_unary_rpc_method_handler,
            "ss": grpc.stream_stream_rpc_method_handler,
        }[kind]
        handlers[name] = maker(
            fn,
            request_deserializer=req.FromString,
            response_serializer=resp.SerializeToString,
        )
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(f"{_PKG}.{service}", handlers),)
    )


def add_MetadataServicer_to_server(servicer, server) -> None:
    _add_servicer(servicer, server, "Metadata", METHODS)


def add_ApiServicer_to_server(servicer, server) -> None:
    _add_servicer(servicer, server, "Api", API_METHODS)
