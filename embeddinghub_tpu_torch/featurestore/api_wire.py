"""Wire-parity ``Api`` gRPC service.

The reference fronts its control plane with an ``Api`` service
(``metadata/proto/metadata.proto:72-118``) that carries the Metadata
method set plus the streaming write RPCs ``WriteFeatures``/``WriteLabels``
(``api/api.go:1150-1229``: each streamed record is written to the
feature's offline resource table AND its online table).

In the single-process composition this servicer answers the Api surface
directly over the same :class:`MetadataStore` (the reference's extra
gRPC hop to the metadata service buys nothing in-process); the
byte-level request-id proxy in :mod:`api_gateway` remains the
multi-process fronting story.  Method paths match the reference's
generated stubs (``/featureform.serving.metadata.proto.Api/<RPC>``).
"""

from __future__ import annotations

import grpc

from embeddinghub_tpu_torch.featurestore import fferr
from embeddinghub_tpu_torch.featurestore.metadata import MetadataStore
from embeddinghub_tpu_torch.featurestore.metadata_wire import MetadataWireService
from embeddinghub_tpu_torch.featurestore.proto import ff_metadata_pb2 as pb
from embeddinghub_tpu_torch.featurestore.proto.ff_metadata_grpc import (
    add_ApiServicer_to_server,
)
from embeddinghub_tpu_torch.featurestore.resources import (
    FeatureVariant,
    LabelVariant,
    ResourceID,
    ResourceType,
)


def _parse_value(raw: str, value_type: str):
    """Streamed values travel as strings (StreamingFeatureVariant.value);
    cast to the variant's declared type so serving returns typed values."""
    try:
        if value_type in ("int", "int32", "int64"):
            return int(raw)
        if value_type in ("float32", "float64"):
            return float(raw)
        if value_type == "bool":
            return raw.lower() in ("true", "1")
    except ValueError:
        pass
    return raw


class ApiWireService(MetadataWireService):
    """Api = Metadata surface + streaming writes.

    ``serving`` is a :class:`~embeddinghub_tpu_torch.featurestore.serving.
    ServingClient` used to resolve online tables / providers the same
    way FeatureServe does — a streamed write is immediately visible to
    a subsequent serve."""

    def __init__(self, store: MetadataStore, serving=None, tasks=None):
        super().__init__(store, tasks=tasks)
        if serving is None:
            from embeddinghub_tpu_torch.featurestore.serving import ServingClient

            serving = ServingClient(store)
        self.serving = serving

    # ------------------------------------------------------ streaming writes

    def _offline_append(self, res, entity: str, value, ts) -> None:
        """Append the record to the variant's source table so batch
        reads / re-materializations see streamed rows (the reference's
        offline resource-table write, api.go:1212-1219)."""
        if not res.source or not res.source[0]:
            return
        src = self.store.maybe_get(
            ResourceID(ResourceType.SOURCE_VARIANT, *res.source)
        )
        if src is None or not src.provider:
            return
        offline = self.serving._provider(src.provider).as_offline_store()
        row = {}
        if res.entity_column:
            row[res.entity_column] = entity
        if res.value_column:
            row[res.value_column] = value
        if res.timestamp_column and ts is not None and (
            ts.seconds or ts.nanos
        ):
            row[res.timestamp_column] = ts.ToDatetime().isoformat()
        if row:
            offline.append_rows(res.source[0], res.source[1], [row])

    def WriteFeatures(self, request_iterator, context):
        for fv in request_iterator:
            feat = self.store.maybe_get(
                ResourceID(ResourceType.FEATURE_VARIANT, fv.name, fv.variant)
            )
            if not isinstance(feat, FeatureVariant):
                context.abort(
                    grpc.StatusCode.NOT_FOUND,
                    f"feature {fv.name}/{fv.variant} not found",
                )
            value = _parse_value(fv.value, feat.value_type)
            try:
                self._offline_append(feat, fv.entity, value, fv.ts)
                # online overwrite (api.go:1224: always the latest value)
                try:
                    table = self.serving._table(feat)
                except fferr.ResourceNotFoundError:
                    # first streamed write beats materialization to the
                    # table — create it (streams have no materializer)
                    online = self.serving._provider(
                        feat.provider
                    ).as_online_store()
                    online.create_table(
                        feat.name, feat.variant, feat.value_type
                    )
                    table = self.serving._table(feat)
                table.set(fv.entity, value)
            except fferr.FFError as e:
                context.abort(e.grpc_code(), str(e))
        return pb.Empty()

    def WriteLabels(self, request_iterator, context):
        for lv in request_iterator:
            label = self.store.maybe_get(
                ResourceID(ResourceType.LABEL_VARIANT, lv.name, lv.variant)
            )
            if not isinstance(label, LabelVariant):
                context.abort(
                    grpc.StatusCode.NOT_FOUND,
                    f"label {lv.name}/{lv.variant} not found",
                )
            value = _parse_value(lv.value, label.value_type)
            try:
                # labels have no online table — offline append only
                self._offline_append(label, lv.entity, value, lv.ts)
            except fferr.FFError as e:
                context.abort(e.grpc_code(), str(e))
        return pb.Empty()


def register(service: ApiWireService, server) -> None:
    add_ApiServicer_to_server(service, server)
