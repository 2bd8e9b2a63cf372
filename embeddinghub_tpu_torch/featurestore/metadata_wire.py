"""Wire-parity Metadata gRPC service.

Implements the reference's typed ``Metadata`` service
(``metadata/proto/metadata.proto:19-70``; Go server
``metadata/metadata.go:1927``) over the embeddable
:class:`~embeddinghub_tpu_torch.featurestore.metadata.MetadataStore`, so a
stub generated from the *reference's own proto* can register and fetch
resources against this server (proof: ``tests/test_metadata_wire.py``).

This REPLACES the pickled-blob transport of the round-1 compact service
for cross-process use: everything on this wire is typed protobuf —
client-supplied function bodies travel as opaque bytes/source text and
are NEVER deserialized into code objects here (the reference limits
dill to on-demand/DF functions executed by its own runners; we store
the bytes and execute only natively-registered callables).
"""

from __future__ import annotations

import json

import grpc

from embeddinghub_tpu_torch.featurestore import fferr
from embeddinghub_tpu_torch.featurestore.metadata import MetadataStore
from embeddinghub_tpu_torch.featurestore.proto import ff_metadata_pb2 as pb
from embeddinghub_tpu_torch.featurestore.proto.ff_metadata_grpc import (
    MetadataServicer,
    add_MetadataServicer_to_server,
)
from embeddinghub_tpu_torch.featurestore.resources import (
    Entity,
    FeatureVariant,
    LabelVariant,
    Model,
    Provider,
    Resource,
    ResourceID,
    ResourceType,
    SourceVariant,
    Status,
    TrainingSetVariant,
    User,
)

_STATUS_TO_PB = {
    Status.NO_STATUS: pb.ResourceStatus.NO_STATUS,
    Status.CREATED: pb.ResourceStatus.CREATED,
    Status.PENDING: pb.ResourceStatus.PENDING,
    Status.READY: pb.ResourceStatus.READY,
    Status.FAILED: pb.ResourceStatus.FAILED,
    Status.RUNNING: pb.ResourceStatus.RUNNING,
    Status.DELETING: pb.ResourceStatus.DELETING,
}
_STATUS_FROM_PB = {v: k for k, v in _STATUS_TO_PB.items()}

_SCALARS = {
    "int": pb.ScalarType.INT,
    "int32": pb.ScalarType.INT32,
    "int64": pb.ScalarType.INT64,
    "float32": pb.ScalarType.FLOAT32,
    "float64": pb.ScalarType.FLOAT64,
    "string": pb.ScalarType.STRING,
    "bool": pb.ScalarType.BOOL,
    "datetime": pb.ScalarType.DATETIME,
}
_SCALARS_BACK = {v: k for k, v in _SCALARS.items()}

_PB_RTYPE = {
    pb.ResourceType.FEATURE_VARIANT: ResourceType.FEATURE_VARIANT,
    pb.ResourceType.LABEL_VARIANT: ResourceType.LABEL_VARIANT,
    pb.ResourceType.TRAINING_SET_VARIANT: ResourceType.TRAINING_SET_VARIANT,
    pb.ResourceType.SOURCE_VARIANT: ResourceType.SOURCE_VARIANT,
    pb.ResourceType.PROVIDER: ResourceType.PROVIDER,
    pb.ResourceType.ENTITY: ResourceType.ENTITY,
    pb.ResourceType.MODEL: ResourceType.MODEL,
    pb.ResourceType.USER: ResourceType.USER,
}


def _status_msg(res: Resource) -> pb.ResourceStatus:
    return pb.ResourceStatus(
        status=_STATUS_TO_PB.get(res.status, pb.ResourceStatus.NO_STATUS),
        error_message=res.status_error,
    )


def _tags(res: Resource) -> pb.Tags:
    return pb.Tags(tag=list(res.tags))


def _props(res: Resource) -> pb.Properties:
    return pb.Properties(
        property={
            k: pb.Property(string_value=v) for k, v in res.properties.items()
        }
    )


def _common_from_pb(msg) -> dict:
    out = {}
    if msg.HasField("tags") if hasattr(msg, "tags") else False:
        out["tags"] = list(msg.tags.tag)
    if hasattr(msg, "properties"):
        out["properties"] = {
            k: p.string_value for k, p in msg.properties.property.items()
        }
    return out


def _value_type_to_pb(fv: FeatureVariant) -> pb.ValueType:
    if fv.is_embedding or fv.value_type == "embedding" or fv.dims:
        return pb.ValueType(
            vector=pb.VectorType(
                scalar=pb.ScalarType.FLOAT32,
                dimension=int(fv.dims),
                is_embedding=True,
            )
        )
    return pb.ValueType(
        scalar=_SCALARS.get(fv.value_type, pb.ScalarType.FLOAT32)
    )


# ------------------------------------------------------------- to-proto


def feature_variant_to_pb(fv: FeatureVariant) -> pb.FeatureVariant:
    msg = pb.FeatureVariant(
        name=fv.name,
        variant=fv.variant,
        source=pb.NameVariant(name=fv.source[0], variant=fv.source[1]),
        entity=fv.entity,
        owner=fv.owner,
        description=fv.description,
        provider=fv.provider,
        status=_status_msg(fv),
        tags=_tags(fv),
        properties=_props(fv),
        type=_value_type_to_pb(fv),
    )
    if fv.on_demand_fn is not None:
        src = fv.definition().get("on_demand_fn", "")
        msg.mode = pb.ComputationMode.CLIENT_COMPUTED
        msg.function.query = (
            src.encode() if isinstance(src, str) else bytes(src)
        )
    else:
        msg.mode = pb.ComputationMode.PRECOMPUTED
        msg.columns.entity = fv.entity_column
        msg.columns.value = fv.value_column
        msg.columns.ts = fv.timestamp_column
    return msg


def feature_variant_from_pb(msg: pb.FeatureVariant) -> FeatureVariant:
    vt, dims, is_emb = "float32", 0, False
    if msg.type.WhichOneof("Type") == "vector":
        dims = msg.type.vector.dimension
        is_emb = msg.type.vector.is_embedding
        vt = "embedding" if is_emb else "float32"
    elif msg.type.WhichOneof("Type") == "scalar":
        vt = _SCALARS_BACK.get(msg.type.scalar, "float32")
    fv = FeatureVariant(
        name=msg.name,
        variant=msg.variant or "default",
        source=(msg.source.name, msg.source.variant),
        entity=msg.entity,
        owner=msg.owner,
        description=msg.description,
        provider=msg.provider,
        value_type=vt,
        dims=dims,
        is_embedding=is_emb,
        **_common_from_pb(msg),
    )
    if msg.WhichOneof("location") == "columns":
        fv.entity_column = msg.columns.entity
        fv.value_column = msg.columns.value
        fv.timestamp_column = msg.columns.ts
    elif msg.WhichOneof("location") == "function":
        # opaque client function payload: stored as source/bytes, never
        # deserialized into code here
        fv.on_demand_fn = msg.function.query.decode("utf-8", "replace")
    return fv


def label_variant_to_pb(lv: LabelVariant) -> pb.LabelVariant:
    msg = pb.LabelVariant(
        name=lv.name,
        variant=lv.variant,
        description=lv.description,
        source=pb.NameVariant(name=lv.source[0], variant=lv.source[1]),
        entity=lv.entity,
        owner=lv.owner,
        status=_status_msg(lv),
        tags=_tags(lv),
        properties=_props(lv),
        type=pb.ValueType(
            scalar=_SCALARS.get(lv.value_type, pb.ScalarType.FLOAT32)
        ),
    )
    msg.entity_mappings.value_column = lv.value_column
    msg.entity_mappings.timestamp_column = lv.timestamp_column
    msg.entity_mappings.mappings.add(
        name=lv.entity, entity_column=lv.entity_column
    )
    return msg


def label_variant_from_pb(msg: pb.LabelVariant) -> LabelVariant:
    lv = LabelVariant(
        name=msg.name,
        variant=msg.variant or "default",
        description=msg.description,
        source=(msg.source.name, msg.source.variant),
        entity=msg.entity,
        owner=msg.owner,
        **_common_from_pb(msg),
    )
    which = msg.WhichOneof("location")
    if which == "entity_mappings":
        lv.value_column = msg.entity_mappings.value_column
        lv.timestamp_column = msg.entity_mappings.timestamp_column
        if msg.entity_mappings.mappings:
            m = msg.entity_mappings.mappings[0]
            lv.entity_column = m.entity_column
            lv.entity = lv.entity or m.name
    elif which == "columns":
        lv.entity_column = msg.columns.entity
        lv.value_column = msg.columns.value
        lv.timestamp_column = msg.columns.ts
    return lv


def source_variant_to_pb(sv: SourceVariant) -> pb.SourceVariant:
    msg = pb.SourceVariant(
        name=sv.name,
        variant=sv.variant,
        owner=sv.owner,
        description=sv.description,
        provider=sv.provider,
        status=_status_msg(sv),
        tags=_tags(sv),
        properties=_props(sv),
    )
    if sv.transformation is not None:
        tf = sv.transformation
        nvs = [pb.NameVariant(name=n, variant=v) for n, v in sv.inputs]
        if "sql" in tf:
            msg.transformation.SQLTransformation.query = tf["sql"]
            msg.transformation.SQLTransformation.source.extend(nvs)
        else:
            df = tf.get("df")
            src_text = df if isinstance(df, str) else tf.get("source", "")
            raw = tf.get("bytes", b"")
            msg.transformation.DFTransformation.query = raw
            msg.transformation.DFTransformation.source_text = src_text or ""
            msg.transformation.DFTransformation.inputs.extend(nvs)
    elif sv.primary is not None:
        if "table" in sv.primary:
            msg.primaryData.table.name = str(sv.primary["table"])
        elif "path" in sv.primary:
            msg.primaryData.filestore.path = str(sv.primary["path"])
        ts = sv.primary.get("timestamp_column", "")
        if ts:
            msg.primaryData.timestamp_column = ts
    return msg


def source_variant_from_pb(msg: pb.SourceVariant) -> SourceVariant:
    sv = SourceVariant(
        name=msg.name,
        variant=msg.variant or "default",
        owner=msg.owner,
        description=msg.description,
        provider=msg.provider,
        **_common_from_pb(msg),
    )
    which = msg.WhichOneof("definition")
    if which == "transformation":
        tf = msg.transformation
        tkind = tf.WhichOneof("type")
        if tkind == "SQLTransformation":
            sv.transformation = {"sql": tf.SQLTransformation.query}
            sv.inputs = [
                (nv.name, nv.variant) for nv in tf.SQLTransformation.source
            ]
        elif tkind == "DFTransformation":
            # keep the payload opaque; source_text is display/equivalence
            sv.transformation = {
                "df": tf.DFTransformation.source_text
                or tf.DFTransformation.query.decode("utf-8", "replace"),
                "bytes": bytes(tf.DFTransformation.query),
            }
            sv.inputs = [
                (nv.name, nv.variant) for nv in tf.DFTransformation.inputs
            ]
    elif which == "primaryData":
        loc = msg.primaryData.WhichOneof("location")
        if loc == "table":
            sv.primary = {"table": msg.primaryData.table.name}
        elif loc == "filestore":
            sv.primary = {"path": msg.primaryData.filestore.path}
        else:
            sv.primary = {}
        if msg.primaryData.timestamp_column:
            sv.primary["timestamp_column"] = msg.primaryData.timestamp_column
    return sv


def _feature_lag_to_pb(fl: dict) -> pb.FeatureLag:
    msg = pb.FeatureLag(
        feature=fl["feature"],
        variant=fl.get("variant", "default"),
        name=fl.get("name", ""),
    )
    secs = float(fl.get("lag", 0.0))
    msg.lag.seconds = int(secs)
    msg.lag.nanos = int(round((secs - int(secs)) * 1e9))
    return msg


def training_set_variant_to_pb(ts: TrainingSetVariant) -> pb.TrainingSetVariant:
    return pb.TrainingSetVariant(
        name=ts.name,
        variant=ts.variant,
        description=ts.description,
        owner=ts.owner,
        provider=ts.provider,
        status=_status_msg(ts),
        label=pb.NameVariant(name=ts.label[0], variant=ts.label[1]),
        features=[
            pb.NameVariant(name=n, variant=v) for n, v in ts.features
        ],
        feature_lags=[_feature_lag_to_pb(fl) for fl in ts.feature_lags],
        tags=_tags(ts),
        properties=_props(ts),
    )


def training_set_variant_from_pb(msg: pb.TrainingSetVariant) -> TrainingSetVariant:
    return TrainingSetVariant(
        name=msg.name,
        variant=msg.variant or "default",
        description=msg.description,
        owner=msg.owner,
        provider=msg.provider,
        label=(msg.label.name, msg.label.variant),
        features=[(nv.name, nv.variant) for nv in msg.features],
        feature_lags=[
            {
                "feature": fl.feature,
                "variant": fl.variant or "default",
                "name": fl.name,
                "lag": fl.lag.seconds + fl.lag.nanos / 1e9,
            }
            for fl in msg.feature_lags
        ],
        **_common_from_pb(msg),
    )


def provider_to_pb(p: Provider) -> pb.Provider:
    return pb.Provider(
        name=p.name,
        description=p.description,
        type=p.provider_type,
        software=p.software,
        team=p.team,
        serialized_config=json.dumps(p.config).encode(),
        status=_status_msg(p),
        tags=_tags(p),
        properties=_props(p),
    )


def provider_from_pb(msg: pb.Provider) -> Provider:
    try:
        config = json.loads(msg.serialized_config or b"{}")
    except (ValueError, UnicodeDecodeError):
        config = {"raw": msg.serialized_config.hex()}
    return Provider(
        name=msg.name,
        description=msg.description,
        provider_type=msg.type,
        software=msg.software,
        team=msg.team,
        config=config if isinstance(config, dict) else {"value": config},
        **_common_from_pb(msg),
    )


def _first_variant_name(store: MetadataStore, rtype, name) -> list[str]:
    return sorted(
        {getattr(r, "variant", "") for r in store.variants(rtype, name)}
    )


class MetadataWireService(MetadataServicer):
    """The reference ``Metadata`` surface over our MetadataStore.

    ``tasks`` (a :class:`scheduling.TaskManager`, optional) lets
    RequestScheduleChange attach cron-lite schedules to the target's
    task; without it the RPC only validates the schedule string."""

    def __init__(self, store: MetadataStore, tasks=None):
        self.store = store
        self.tasks = tasks

    # -------------------------------------------------------------- create

    def _create(self, res: Resource, context) -> pb.Empty:
        try:
            self.store.create(res)
        except fferr.ResourceChangedError as e:
            context.abort(grpc.StatusCode.ALREADY_EXISTS, str(e))
        except fferr.FFError as e:
            context.abort(e.grpc_code(), str(e))
        return pb.Empty()

    def CreateUser(self, request, context):
        u = request.user
        return self._create(
            User(name=u.name, tags=list(u.tags.tag),
                 properties={k: p.string_value
                             for k, p in u.properties.property.items()}),
            context,
        )

    def CreateProvider(self, request, context):
        return self._create(provider_from_pb(request.provider), context)

    def CreateEntity(self, request, context):
        e = request.entity
        return self._create(
            Entity(name=e.name, description=e.description,
                   tags=list(e.tags.tag),
                   properties={k: p.string_value
                               for k, p in e.properties.property.items()}),
            context,
        )

    def CreateModel(self, request, context):
        m = request.model
        return self._create(
            Model(name=m.name, description=m.description,
                  features=[(nv.name, nv.variant) for nv in m.features],
                  trainingsets=[(nv.name, nv.variant)
                                for nv in m.trainingsets]),
            context,
        )

    def CreateSourceVariant(self, request, context):
        return self._create(source_variant_from_pb(request.source_variant), context)

    def CreateFeatureVariant(self, request, context):
        return self._create(
            feature_variant_from_pb(request.feature_variant), context
        )

    def CreateLabelVariant(self, request, context):
        return self._create(label_variant_from_pb(request.label_variant), context)

    def CreateTrainingSetVariant(self, request, context):
        return self._create(
            training_set_variant_from_pb(request.training_set_variant), context
        )

    def RequestScheduleChange(self, request, context):
        """Attach a cron-lite schedule to the target resource's task;
        the coordinator's poll loop re-runs it on the interval
        (reference CronJob scheduling, kubernetes.go:223-236)."""
        from embeddinghub_tpu_torch.featurestore.scheduling import parse_schedule

        rid = request.resource_id
        rtype = _PB_RTYPE.get(rid.resource_type)
        if rtype is None:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          "unsupported resource type")
        try:
            parse_schedule(request.schedule)
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        if self.tasks is not None:
            target = ResourceID(rtype, rid.resource.name, rid.resource.variant)
            task = self.tasks.task_for_target(target)
            if task is None:
                context.abort(
                    grpc.StatusCode.NOT_FOUND,
                    f"no task targets {target.key()}",
                )
            self.tasks.set_schedule(task.id, request.schedule)
        return pb.Empty()

    # ----------------------------------------------------------------- get

    def _variant_getter(self, rtype, to_pb):
        def handle(request_iterator, context):
            for req in request_iterator:
                nv = req.name_variant
                res = self.store.maybe_get(
                    ResourceID(rtype, nv.name, nv.variant or "default")
                )
                if res is None:
                    context.abort(
                        grpc.StatusCode.NOT_FOUND,
                        f"{rtype.value} {nv.name} ({nv.variant}) not found",
                    )
                yield to_pb(res)

        return handle

    def _parent_getter(self, rtype, parent_cls):
        def handle(request_iterator, context):
            for req in request_iterator:
                name = req.name.name
                variants = self.store.variants(rtype, name)
                if not variants:
                    context.abort(
                        grpc.StatusCode.NOT_FOUND,
                        f"{rtype.value} {name} not found",
                    )
                vnames = sorted(getattr(v, "variant", "") for v in variants)
                yield parent_cls(
                    name=name,
                    default_variant=vnames[0] if vnames else "",
                    variants=vnames,
                )

        return handle

    def GetFeatureVariants(self, request_iterator, context):
        yield from self._variant_getter(
            ResourceType.FEATURE_VARIANT, feature_variant_to_pb
        )(request_iterator, context)

    def GetLabelVariants(self, request_iterator, context):
        yield from self._variant_getter(
            ResourceType.LABEL_VARIANT, label_variant_to_pb
        )(request_iterator, context)

    def GetSourceVariants(self, request_iterator, context):
        yield from self._variant_getter(
            ResourceType.SOURCE_VARIANT, source_variant_to_pb
        )(request_iterator, context)

    def GetTrainingSetVariants(self, request_iterator, context):
        yield from self._variant_getter(
            ResourceType.TRAINING_SET_VARIANT, training_set_variant_to_pb
        )(request_iterator, context)

    def GetFeatures(self, request_iterator, context):
        yield from self._parent_getter(
            ResourceType.FEATURE_VARIANT, pb.Feature
        )(request_iterator, context)

    def GetLabels(self, request_iterator, context):
        yield from self._parent_getter(ResourceType.LABEL_VARIANT, pb.Label)(
            request_iterator, context
        )

    def GetSources(self, request_iterator, context):
        yield from self._parent_getter(ResourceType.SOURCE_VARIANT, pb.Source)(
            request_iterator, context
        )

    def GetTrainingSets(self, request_iterator, context):
        yield from self._parent_getter(
            ResourceType.TRAINING_SET_VARIANT, pb.TrainingSet
        )(request_iterator, context)

    def GetUsers(self, request_iterator, context):
        for req in request_iterator:
            res = self.store.maybe_get(
                ResourceID(ResourceType.USER, req.name.name)
            )
            if res is None:
                context.abort(grpc.StatusCode.NOT_FOUND, "user not found")
            yield pb.User(name=res.name, status=_status_msg(res),
                          tags=_tags(res), properties=_props(res))

    def GetProviders(self, request_iterator, context):
        for req in request_iterator:
            res = self.store.maybe_get(
                ResourceID(ResourceType.PROVIDER, req.name.name)
            )
            if res is None:
                context.abort(grpc.StatusCode.NOT_FOUND, "provider not found")
            yield provider_to_pb(res)

    def GetEntities(self, request_iterator, context):
        for req in request_iterator:
            res = self.store.maybe_get(
                ResourceID(ResourceType.ENTITY, req.name.name)
            )
            if res is None:
                context.abort(grpc.StatusCode.NOT_FOUND, "entity not found")
            yield pb.Entity(name=res.name, description=res.description,
                            status=_status_msg(res), tags=_tags(res),
                            properties=_props(res))

    def GetModels(self, request_iterator, context):
        for req in request_iterator:
            res = self.store.maybe_get(
                ResourceID(ResourceType.MODEL, req.name.name)
            )
            if res is None:
                context.abort(grpc.StatusCode.NOT_FOUND, "model not found")
            yield pb.Model(
                name=res.name, description=res.description,
                features=[pb.NameVariant(name=n, variant=v)
                          for n, v in res.features],
                trainingsets=[pb.NameVariant(name=n, variant=v)
                              for n, v in res.trainingsets],
            )

    # ---------------------------------------------------------------- list

    def _lister_parent(self, rtype, parent_cls):
        names = sorted({r.name for r in self.store.list_type(rtype)})
        for name in names:
            vnames = sorted(
                getattr(v, "variant", "")
                for v in self.store.variants(rtype, name)
            )
            yield parent_cls(
                name=name,
                default_variant=vnames[0] if vnames else "",
                variants=vnames,
            )

    def ListFeatures(self, request, context):
        yield from self._lister_parent(ResourceType.FEATURE_VARIANT, pb.Feature)

    def ListLabels(self, request, context):
        yield from self._lister_parent(ResourceType.LABEL_VARIANT, pb.Label)

    def ListSources(self, request, context):
        yield from self._lister_parent(ResourceType.SOURCE_VARIANT, pb.Source)

    def ListTrainingSets(self, request, context):
        yield from self._lister_parent(
            ResourceType.TRAINING_SET_VARIANT, pb.TrainingSet
        )

    def ListUsers(self, request, context):
        for res in self.store.list_type(ResourceType.USER):
            yield pb.User(name=res.name, status=_status_msg(res))

    def ListProviders(self, request, context):
        for res in self.store.list_type(ResourceType.PROVIDER):
            yield provider_to_pb(res)

    def ListEntities(self, request, context):
        for res in self.store.list_type(ResourceType.ENTITY):
            yield pb.Entity(name=res.name, description=res.description,
                            status=_status_msg(res))

    def ListModels(self, request, context):
        for res in self.store.list_type(ResourceType.MODEL):
            yield pb.Model(name=res.name, description=res.description)

    # ----------------------------------------------------- status/equiv/run

    def SetResourceStatus(self, request, context):
        rid = request.resource_id
        rtype = _PB_RTYPE.get(rid.resource_type)
        if rtype is None:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          "unsupported resource type")
        try:
            self.store.set_status(
                ResourceID(rtype, rid.resource.name, rid.resource.variant),
                _STATUS_FROM_PB.get(request.status.status, Status.NO_STATUS),
                request.status.error_message,
            )
        except fferr.FFError as e:
            context.abort(e.grpc_code(), str(e))
        return pb.Empty()

    _EQUIV = (
        ("feature_variant", ResourceType.FEATURE_VARIANT,
         "feature_variant_to_pb", "feature_variant_from_pb"),
        ("label_variant", ResourceType.LABEL_VARIANT,
         "label_variant_to_pb", "label_variant_from_pb"),
        ("training_set_variant", ResourceType.TRAINING_SET_VARIANT,
         "training_set_variant_to_pb", "training_set_variant_from_pb"),
        ("source_variant", ResourceType.SOURCE_VARIANT,
         "source_variant_to_pb", "source_variant_from_pb"),
    )

    def GetEquivalent(self, request, context):
        which = request.variant.WhichOneof("resource")
        out = pb.ResourceVariant()
        for field, rtype, to_name, from_name in self._EQUIV:
            if which != field:
                continue
            msg = getattr(request.variant, field)
            cand = globals()[from_name](msg)
            for existing in self.store.variants(rtype, cand.name):
                if existing.equiv_hash() == cand.equiv_hash():
                    getattr(out, field).CopyFrom(
                        globals()[to_name](existing)
                    )
                    return out
        return out  # empty = no equivalent

    def Run(self, request, context):
        # Tasks are created at registration time (MetadataStore.create);
        # the coordinator's poll loop picks them up — Run is an explicit
        # nudge in the reference and a no-op barrier here.
        return pb.Empty()

    # ------------------------------------------------------------- deletion

    def MarkForDeletion(self, request, context):
        rid = request.resource_id
        rtype = _PB_RTYPE.get(rid.resource_type)
        if rtype is None:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          "unsupported resource type")
        try:
            self.store.delete(
                ResourceID(rtype, rid.resource.name, rid.resource.variant)
            )
        except fferr.FFError as e:
            context.abort(e.grpc_code(), str(e))
        return pb.MarkForDeletionResponse()

    _VARIANT_FIELD = {
        ResourceType.FEATURE_VARIANT: ("feature_variant", feature_variant_to_pb),
        ResourceType.LABEL_VARIANT: ("label_variant", label_variant_to_pb),
        ResourceType.SOURCE_VARIANT: ("source_variant", source_variant_to_pb),
        ResourceType.TRAINING_SET_VARIANT: (
            "training_set_variant", training_set_variant_to_pb,
        ),
    }

    def GetStagedForDeletionResource(self, request, context):
        """The staged (MarkForDeletion'd, not yet pruned) copy of a
        resource variant — reference ``metadata.go:2558`` (DeletedOnly
        lookup)."""
        rid = request.resource_id
        rtype = _PB_RTYPE.get(rid.resource_type)
        if rtype not in self._VARIANT_FIELD:
            context.abort(
                grpc.StatusCode.INTERNAL,
                f"resource type {rid.resource_type} is not deletable",
            )
        try:
            res = self.store.get_staged(
                ResourceID(rtype, rid.resource.name, rid.resource.variant)
            )
        except fferr.FFError as e:
            context.abort(e.grpc_code(), str(e))
        field, to_pb = self._VARIANT_FIELD[rtype]
        rv = pb.ResourceVariant()
        getattr(rv, field).CopyFrom(to_pb(res))
        return pb.GetStagedForDeletionResourceResponse(resource_variant=rv)

    def FinalizeDeletion(self, request, context):
        rid = request.resource_id
        rtype = _PB_RTYPE.get(rid.resource_type)
        if rtype is not None:
            self.store.prune(
                ResourceID(rtype, rid.resource.name, rid.resource.variant)
            )
        return pb.FinalizeDeletionResponse()

    def PruneResource(self, request, context):
        rid = request.resource_id
        rtype = _PB_RTYPE.get(rid.resource_type)
        if rtype is not None:
            res_id = ResourceID(rtype, rid.resource.name, rid.resource.variant)
            try:
                self.store.delete(res_id)
            except fferr.FFError:
                pass  # already gone / never existed: prune is idempotent
            self.store.prune(res_id)
        return pb.PruneResourceResponse()


def register(service: MetadataWireService, server) -> None:
    add_MetadataServicer_to_server(service, server)
