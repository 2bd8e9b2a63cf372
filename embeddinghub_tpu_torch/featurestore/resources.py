"""Typed resources and variants.

Rebuild of the reference resource model: Go ``metadata/metadata.go``'s
``Resource`` interface + per-type ``*Variant`` structs and the Python
client's dataclasses (``client/src/featureform/resources.py``).  A
resource is identified by (type, name[, variant]); variant-typed
resources are immutable once created — re-registering with identical
properties is a no-op (the ``GetEquivalent`` dedupe,
``metadata/proto/metadata.proto:57`` / ``metadata/equivalence/``),
re-registering with different properties is an error.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import json
import time
from dataclasses import dataclass, field
from typing import Any


class ResourceType(str, enum.Enum):
    USER = "USER"
    PROVIDER = "PROVIDER"
    ENTITY = "ENTITY"
    SOURCE_VARIANT = "SOURCE_VARIANT"
    FEATURE_VARIANT = "FEATURE_VARIANT"
    LABEL_VARIANT = "LABEL_VARIANT"
    TRAINING_SET_VARIANT = "TRAINING_SET_VARIANT"
    MODEL = "MODEL"


class Status(str, enum.Enum):
    NO_STATUS = "NO_STATUS"
    CREATED = "CREATED"
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    READY = "READY"
    FAILED = "FAILED"
    DELETING = "DELETING"


VARIANT_TYPES = {
    ResourceType.SOURCE_VARIANT,
    ResourceType.FEATURE_VARIANT,
    ResourceType.LABEL_VARIANT,
    ResourceType.TRAINING_SET_VARIANT,
}


@dataclass
class ResourceID:
    type: ResourceType
    name: str
    variant: str = ""

    def key(self) -> str:
        return f"{self.type.value}/{self.name}/{self.variant}"

    def __str__(self) -> str:
        if self.variant:
            return f"{self.name}.{self.variant}"
        return self.name


@dataclass
class Resource:
    """Base resource: subclasses add their properties; ``definition()``
    returns the canonical dict used for equivalence hashing."""

    name: str
    description: str = ""
    owner: str = ""
    tags: list[str] = field(default_factory=list)
    properties: dict[str, str] = field(default_factory=dict)
    status: Status = Status.NO_STATUS
    status_error: str = ""
    created_at: float = field(default_factory=time.time)

    rtype: ResourceType = ResourceType.USER  # overridden

    def rid(self) -> ResourceID:
        return ResourceID(self.rtype, self.name, getattr(self, "variant", ""))

    def definition(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        for volatile in (
            "status",
            "status_error",
            "created_at",
            "tags",
            "properties",
            "description",
        ):
            d.pop(volatile, None)
        return d

    def equiv_hash(self) -> str:
        blob = json.dumps(self.definition(), sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def equiv_diff(self, other: "Resource") -> list[str]:
        """Names of canonical-definition fields that differ — the
        reference's equivalence package reports *which* fields diverge
        on a conflicting re-registration instead of a bare mismatch
        (``metadata/equivalence/source_variant.go:337``)."""
        a, b = self.definition(), other.definition()

        def canon(v):
            return json.dumps(v, sort_keys=True, default=str)

        return sorted(
            k
            for k in set(a) | set(b)
            if canon(a.get(k)) != canon(b.get(k))
        )

    def needs_job(self) -> bool:
        """Whether creation schedules an orchestration task (the
        reference's needsJob wiring, metadata.go:169-199)."""
        return False

    def dependencies(self) -> list[ResourceID]:
        return []


def normalize_sql(text: str) -> str:
    """Whitespace-normalized SQL, the reference's equivalence rule for
    SQL transformations (``metadata/equivalence/source_variant.go``
    isSqlEqual: collapse all whitespace runs, trim) so a re-registration
    that only reformats the query dedupes instead of erroring."""
    import re

    return re.sub(r"\s+", " ", text).strip()


def canonicalize_fn_text(fn) -> str:
    """Comment/docstring/whitespace-insensitive function text — the
    reference canonicalizes transformation functions through the AST
    before comparing (``client/src/featureform/parse.py``
    canonicalize_function_definition) so formatting-only edits dedupe.
    Decorators are dropped (the registration decorator itself must not
    affect equivalence).  Falls back to raw source/text when the AST is
    unavailable (lambdas inside expressions, interactive defs)."""
    import ast
    import inspect
    import textwrap

    try:
        src = textwrap.dedent(inspect.getsource(fn))
    except (OSError, TypeError):
        return repr(fn)
    try:
        tree = ast.parse(src)
    except (SyntaxError, ValueError):
        return src.strip()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            node.decorator_list = []
            if (
                node.body
                and isinstance(node.body[0], ast.Expr)
                and isinstance(node.body[0].value, ast.Constant)
                and isinstance(node.body[0].value.value, str)
            ):
                node.body = node.body[1:] or [ast.Pass()]
    return ast.unparse(tree)


# ------------------------------------------------------------- wire codec
#
# JSON-based resource serialization for network/disk transport.  This
# deliberately replaces pickle on every cross-process path: pickled
# payloads execute arbitrary code at load time, a hazard the reference
# does not ship (it restricts dill to on-demand/DF function bodies).
# Callables degrade to their source text (marker-wrapped); executing
# such client-supplied source on the server side is opt-in via
# EHTPU_ALLOW_REMOTE_CODE (default off), mirroring the reference's
# "dill only for on-demand features" posture but fail-closed.

_TUPLE_FIELDS = {"source", "label"}
_TUPLE_LIST_FIELDS = {"features", "trainingsets", "inputs"}


def _sanitize(v):
    import base64
    import inspect

    if isinstance(v, bytes):
        return {"__b64__": base64.b64encode(v).decode()}
    if isinstance(v, enum.Enum):
        return v.value
    if callable(v) and not isinstance(v, type):
        try:
            src = inspect.getsource(v)
        except (OSError, TypeError):
            src = repr(v)
        return {"__src__": src}
    if isinstance(v, (list, tuple)):
        return [_sanitize(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _sanitize(x) for k, x in v.items()}
    return v


def _restore(v):
    import base64

    if isinstance(v, dict):
        if set(v) == {"__b64__"}:
            return base64.b64decode(v["__b64__"])
        if set(v) == {"__src__"}:
            return v["__src__"]  # source text; never exec'd here
        return {k: _restore(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_restore(x) for x in v]
    return v


def to_wire(res: "Resource") -> bytes:
    d = {
        f.name: _sanitize(getattr(res, f.name))
        for f in dataclasses.fields(res)
    }
    d.pop("rtype", None)
    return json.dumps({"rtype": res.rtype.value, "data": d}).encode()


def from_wire(blob: bytes) -> "Resource":
    obj = json.loads(blob)
    cls = RESOURCE_CLASSES[ResourceType(obj["rtype"])]
    data = {k: _restore(v) for k, v in obj["data"].items()}
    known = {f.name for f in dataclasses.fields(cls)}
    data = {k: v for k, v in data.items() if k in known}
    if "status" in data:
        data["status"] = Status(data["status"])
    for f in _TUPLE_FIELDS & set(data):
        if isinstance(data[f], list):
            data[f] = tuple(data[f])
    for f in _TUPLE_LIST_FIELDS & set(data):
        if isinstance(data[f], list):
            data[f] = [tuple(x) if isinstance(x, list) else x for x in data[f]]
    return cls(**data)


@dataclass
class User(Resource):
    rtype: ResourceType = ResourceType.USER


@dataclass
class Model(Resource):
    rtype: ResourceType = ResourceType.MODEL
    features: list[tuple[str, str]] = field(default_factory=list)
    trainingsets: list[tuple[str, str]] = field(default_factory=list)


@dataclass
class Entity(Resource):
    rtype: ResourceType = ResourceType.ENTITY


@dataclass
class Provider(Resource):
    rtype: ResourceType = ResourceType.PROVIDER
    provider_type: str = ""      # e.g. MEMORY_ONLINE, SQLITE_OFFLINE, EMBEDDINGHUB_TPU
    software: str = ""
    team: str = ""
    config: dict[str, Any] = field(default_factory=dict)

    def definition(self) -> dict[str, Any]:
        d = super().definition()
        return d


@dataclass
class SourceVariant(Resource):
    rtype: ResourceType = ResourceType.SOURCE_VARIANT
    variant: str = "default"
    provider: str = ""
    # re-run the source task every N seconds (the reference's CronJob
    # scheduling, kubernetes.go:223-236); 0 = run once
    refresh_interval_s: float = 0.0
    # primary data: {"table": ...} | {"path": ...}; transformation:
    # {"sql": "..."} or {"df": callable-name} with inputs
    primary: dict[str, Any] | None = None
    transformation: dict[str, Any] | None = None
    inputs: list[tuple[str, str]] = field(default_factory=list)

    def is_transformation(self) -> bool:
        return self.transformation is not None

    def __getitem__(self, columns):
        """``source[["entity_col", "value_col", ("ts_col")]]`` — the
        class-based registration selection (reference
        ColumnSourceRegistrar.__getitem__, register.py:1330)."""
        from embeddinghub_tpu_torch.featurestore.class_api import select_columns

        return select_columns((self.name, self.variant), columns)

    def needs_job(self) -> bool:
        return True

    def dependencies(self) -> list[ResourceID]:
        return [
            ResourceID(ResourceType.SOURCE_VARIANT, n, v) for n, v in self.inputs
        ]

    def definition(self) -> dict[str, Any]:
        d = super().definition()
        tf = d.get("transformation")
        if tf and "sql" in tf and isinstance(tf.get("sql"), str):
            # formatting-insensitive SQL equivalence (isSqlEqual,
            # source_variant.go) — the stored resource keeps the
            # original text; only the canonical definition normalizes
            tf = dict(tf)
            tf["sql"] = normalize_sql(tf["sql"])
            d["transformation"] = tf
        if tf and "df" in tf:
            if callable(tf.get("df")):
                tf = dict(tf)
                tf["df"] = canonicalize_fn_text(tf["df"])
                d["transformation"] = tf
            # df transformations compare inputs as a SET (reference
            # dfTransformation.IsEquivalent uses lib.ToSet on Inputs);
            # SQL sources stay order-sensitive like the reference
            d["inputs"] = sorted(tuple(i) for i in d.get("inputs", []))
        return d


@dataclass
class FeatureVariant(Resource):
    rtype: ResourceType = ResourceType.FEATURE_VARIANT
    variant: str = "default"
    source: tuple[str, str] = ("", "")
    entity: str = ""
    value_type: str = "float32"  # or "embedding"
    entity_column: str = ""
    value_column: str = ""
    timestamp_column: str = ""
    provider: str = ""           # online store provider
    dims: int = 0                # embedding dims (value_type == embedding)
    is_embedding: bool = False
    on_demand_fn: Any = None     # client-side on-demand feature function
    refresh_interval_s: float = 0.0  # scheduled re-materialization
    # stream features have no batch source: values arrive by direct
    # writes (reference StreamFeature, register.py register_feature_stream)
    stream: bool = False
    offline_provider: str = ""   # stream durability seat

    def needs_job(self) -> bool:
        # on-demand functions have no task at all; streams get a task
        # that only provisions the inference-store table (no batch
        # materialization — values arrive by direct writes)
        return self.on_demand_fn is None

    def dependencies(self) -> list[ResourceID]:
        if self.on_demand_fn is not None or self.stream:
            return []
        return [ResourceID(ResourceType.SOURCE_VARIANT, *self.source)]

    def definition(self) -> dict[str, Any]:
        d = super().definition()
        if callable(d.get("on_demand_fn")):
            import inspect

            try:
                d["on_demand_fn"] = inspect.getsource(d["on_demand_fn"])
            except OSError:
                d["on_demand_fn"] = repr(d["on_demand_fn"])
        return d


@dataclass
class LabelVariant(Resource):
    rtype: ResourceType = ResourceType.LABEL_VARIANT
    variant: str = "default"
    source: tuple[str, str] = ("", "")
    entity: str = ""
    value_type: str = "float32"
    entity_column: str = ""
    value_column: str = ""
    timestamp_column: str = ""
    stream: bool = False         # see FeatureVariant.stream
    offline_provider: str = ""

    def needs_job(self) -> bool:
        return False

    def dependencies(self) -> list[ResourceID]:
        if self.stream:
            return []
        return [ResourceID(ResourceType.SOURCE_VARIANT, *self.source)]


@dataclass
class TrainingSetVariant(Resource):
    rtype: ResourceType = ResourceType.TRAINING_SET_VARIANT
    variant: str = "default"
    label: tuple[str, str] = ("", "")
    features: list[tuple[str, str]] = field(default_factory=list)
    provider: str = ""
    # lagged feature columns: each entry appends one extra column — the
    # named feature's value as of (label ts - lag seconds).  Reference:
    # LagFeatures on the training-set def (provider/k8s.go:63-75 shifts
    # the feature timestamp by LagDelta before the point-in-time join).
    feature_lags: list = field(default_factory=list)

    def needs_job(self) -> bool:
        return True

    def dependencies(self) -> list[ResourceID]:
        deps = [ResourceID(ResourceType.LABEL_VARIANT, *self.label)]
        deps += [
            ResourceID(ResourceType.FEATURE_VARIANT, n, v)
            for n, v in self.features
        ]
        for fl in self.feature_lags:
            rid = ResourceID(ResourceType.FEATURE_VARIANT,
                             fl["feature"], fl["variant"])
            if rid not in deps:
                deps.append(rid)
        return deps


RESOURCE_CLASSES: dict[ResourceType, type] = {
    ResourceType.USER: User,
    ResourceType.MODEL: Model,
    ResourceType.ENTITY: Entity,
    ResourceType.PROVIDER: Provider,
    ResourceType.SOURCE_VARIANT: SourceVariant,
    ResourceType.FEATURE_VARIANT: FeatureVariant,
    ResourceType.LABEL_VARIANT: LabelVariant,
    ResourceType.TRAINING_SET_VARIANT: TrainingSetVariant,
}
