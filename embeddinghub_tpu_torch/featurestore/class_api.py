"""Class-based registration API — the reference quickstart surface.

Reference: ``client/src/featureform/register.py`` — ``entity()``
(register.py:6286), ``FeatureColumnResource`` / ``LabelColumnResource``
/ ``EmbeddingColumnResource`` (register.py:1601/1816/1869), ``Variants``
(register.py:1582) and ``ColumnSourceRegistrar.__getitem__``
(register.py:1330).  A reference user writes:

    @ff.entity
    class User:
        avg_transactions = ff.Feature(
            transactions[["CustomerID", "TransactionAmount"]],
            type=ff.Float32, inference_store=redis,
        )
        fraudulent = ff.Label(
            transactions[["CustomerID", "IsFraud"]], type=ff.Bool,
        )

The entity name is the lowercased class name; unnamed resources take
their attribute name.  Implementation is original: selections are a
small named tuple produced by ``SourceVariant.__getitem__`` and the
decorator drives the ordinary Registrar builders.
"""

from __future__ import annotations

from typing import Any, NamedTuple

# -------------------------------------------------------- scalar types
# Accepted anywhere a value type is taken; plain strings work too.
Float32 = "float32"
Float64 = "float64"
Int = "int"
Int32 = "int32"
Int64 = "int64"
String = "string"
Bool = "bool"
Timestamp = "timestamp"
Datetime = "datetime"

_SCALARS = {Float32, Float64, Int, Int32, Int64, String, Bool,
            Timestamp, Datetime}


def _type_str(t: Any) -> str:
    s = getattr(t, "value", t)
    if not isinstance(s, str):
        raise TypeError(f"value type must be a string-like, got {t!r}")
    if s and s not in _SCALARS and s != "embedding":
        # permissive like the reference (custom strings allowed), but
        # catch the common typo space
        s = s.lower()
    return s


class ColumnSelection(NamedTuple):
    """``source[["entity_col", "value_col", ("ts_col")]]`` result."""

    source: tuple[str, str]
    entity_column: str
    value_column: str
    timestamp_column: str = ""


def select_columns(source_nv: tuple[str, str], columns) -> ColumnSelection:
    cols = list(columns)
    if len(cols) < 2:
        raise ValueError(
            f"expected [entity_column, value_column(, timestamp_column)]"
            f", got {len(cols)} column(s)"
        )
    if len(cols) > 3:
        raise ValueError(
            f"unrecognized extra columns {cols[3:]} — expected 2 required"
            " columns and an optional 3rd timestamp column"
        )
    ts = cols[2] if len(cols) == 3 else ""
    return ColumnSelection(tuple(source_nv), str(cols[0]), str(cols[1]),
                           str(ts))


def _provider_name(p: Any) -> str:
    return getattr(p, "name", p) or ""


class _ColumnResource:
    """Shared state for Feature/Label/Embedding class attributes."""

    def __init__(
        self,
        selection: ColumnSelection,
        *,
        type: Any = "float32",
        name: str = "",
        variant: str = "",
        owner: str = "",
        timestamp_column: str = "",
        description: str = "",
        tags: list | None = None,
        properties: dict | None = None,
    ):
        if not isinstance(selection, ColumnSelection):
            raise TypeError(
                "first argument must be source[[entity_col, value_col]] "
                f"(a column selection), got {type(selection).__name__!s}"
            )
        if timestamp_column and selection.timestamp_column:
            raise ValueError("timestamp column specified twice")
        self.selection = selection._replace(
            timestamp_column=selection.timestamp_column or timestamp_column
        )
        self.value_type = _type_str(type)
        self.name = name
        self.variant = variant or "default"
        self.owner = owner
        self.description = description
        self.tags = list(tags or [])
        self.properties = dict(properties or {})
        self.entity = ""

    def _common_kw(self) -> dict:
        return dict(
            source=self.selection.source,
            entity=self.entity,
            entity_column=self.selection.entity_column,
            value_column=self.selection.value_column,
            timestamp_column=self.selection.timestamp_column,
            variant=self.variant,
            description=self.description,
            tags=self.tags,
            properties=self.properties,
            **({"owner": self.owner} if self.owner else {}),
        )

    def register(self, registrar) -> None:
        raise NotImplementedError


class Feature(_ColumnResource):
    def __init__(self, selection, *, inference_store: Any = "", **kw):
        super().__init__(selection, **kw)
        self.inference_store = _provider_name(inference_store)

    def register(self, registrar) -> None:
        registrar.register_feature(
            self.name,
            provider=self.inference_store,
            value_type=self.value_type,
            **self._common_kw(),
        )


class Label(_ColumnResource):
    def register(self, registrar) -> None:
        kw = self._common_kw()
        registrar.register_label(self.name, value_type=self.value_type,
                                 **kw)


class Embedding(_ColumnResource):
    """Embedding feature bound to a vector store (reference
    EmbeddingColumnResource, register.py:1869)."""

    def __init__(self, selection, *, dims: int, vector_db: Any = "", **kw):
        kw.setdefault("type", "embedding")
        super().__init__(selection, **kw)
        if int(dims) <= 0:
            raise ValueError("embedding dims must be positive")
        self.dims = int(dims)
        self.vector_db = _provider_name(vector_db)

    def register(self, registrar) -> None:
        registrar.register_embedding_feature(
            self.name,
            dims=self.dims,
            provider=self.vector_db,
            **self._common_kw(),
        )


class Variants:
    """Several variants of one logical resource under one attribute
    (reference register.py:1582): keys are variant names and must match
    any explicitly-set resource variant."""

    def __init__(self, resources: dict[str, _ColumnResource]):
        self.resources = dict(resources)
        for key, res in self.resources.items():
            if res.variant in ("", "default"):
                res.variant = key
            elif res.variant != key:
                raise ValueError(
                    f"variant key {key!r} does not match resource "
                    f"variant {res.variant!r}"
                )


def entity(cls=None, *, registrar=None):
    """Class decorator: registers the entity (lowercased class name)
    plus every Feature/Label/Embedding/Variants attribute on it."""

    def apply(klass):
        from embeddinghub_tpu_torch.featurestore.registry import global_registrar

        reg = registrar or global_registrar()
        ent = reg.register_entity(klass.__name__.lower())
        for attr, value in vars(klass).items():
            if isinstance(value, _ColumnResource):
                value.name = value.name or attr
                value.entity = ent.name
                value.register(reg)
            elif isinstance(value, Variants):
                for res in value.resources.values():
                    res.name = res.name or attr
                    res.entity = ent.name
                    res.register(reg)
        return klass

    return apply(cls) if cls is not None else apply
