"""Feature serving.

Rebuild of reference ``serving/`` + the client's serving surface
(``client/src/featureform/serving.py``):

  * online reads: ``features()`` resolves each (feature, variant) for
    an entity — metadata + provider handles are cached like the
    reference's ``getOrCacheFeatureMetadata`` (``features.go:133-224``);
    batched entity reads fan out per feature;
  * on-demand features run caller-supplied functions client-side;
  * ``nearest()`` lands on the vector store table
    (``serving.go:744-771``);
  * offline reads: ``training_set()`` returns a :class:`Dataset` with
    ``repeat`` / ``shuffle`` / ``batch`` (``serving.py:692-744``).
"""

from __future__ import annotations

import random
from typing import Any, Iterator

from embeddinghub_tpu_torch.featurestore import fferr
from embeddinghub_tpu_torch.featurestore.metadata import MetadataStore
from embeddinghub_tpu_torch.featurestore.providers import base as provider_base
from embeddinghub_tpu_torch.featurestore.resources import (
    FeatureVariant,
    ResourceID,
    ResourceType,
    Status,
    TrainingSetVariant,
)


class ServingClient:
    def __init__(self, metadata: MetadataStore, coordinator=None):
        self.metadata = metadata
        self._coordinator = coordinator
        self._feat_cache: dict[tuple[str, str], FeatureVariant] = {}
        self._table_cache: dict[tuple[str, str], Any] = {}

    # ---------------------------------------------------------------- online

    def features(
        self,
        features: list[tuple[str, str] | str],
        entities: dict[str, Any],
        params: dict | None = None,
        model: str | None = None,
    ) -> list[Any]:
        """Current values of the given features for an entity map.
        ``model`` records model<->feature lineage (the reference's
        addModel, serving.go:566)."""
        if model:
            self.record_model(model, features=features)
        out = []
        for fref in features:
            name, variant = _split_ref(fref)
            feat = self._feature(name, variant)
            if feat.on_demand_fn is not None:
                fn = feat.on_demand_fn
                if isinstance(fn, str):
                    # Crossed a process boundary: the wire codec ships
                    # function SOURCE, never code objects (the reference
                    # dill-execs client bytes in the server,
                    # serving/serving.go — we keep that capability but
                    # not that hazard).  Resolution order:
                    #   1. an operator-registered callable for this
                    #      feature (safe: native code, no exec), or
                    #   2. the shipped source, opt-in via
                    #      EHTPU_ALLOW_REMOTE_CODE (fail closed).
                    registered = lookup_on_demand(name, variant)
                    fn = (
                        registered
                        if registered is not None
                        else _compile_on_demand(fn)
                    )
                out.append(fn(None, params or {}, entities))
                continue
            if feat.status != Status.READY:
                raise fferr.DependencyNotReadyError(
                    f"feature {name}/{variant} is {feat.status.value}"
                )
            entity_val = entities.get(feat.entity)
            if entity_val is None:
                raise fferr.InvalidResourceError(
                    f"missing entity {feat.entity} for feature {name}"
                )
            table = self._table(feat)
            try:
                out.append(table.get(str(entity_val)))
            except fferr.FFError as e:
                raise fferr.EntityNotFoundError(name, variant, str(entity_val))
        return out

    def batch_features(
        self, features: list[tuple[str, str] | str], entity_rows: list[dict]
    ) -> list[list[Any]]:
        return [self.features(features, row) for row in entity_rows]

    def batch_feature_entities(
        self, features: list[tuple[str, str] | str]
    ) -> Iterator[tuple[str, list[Any]]]:
        """All entities of the first feature's table with every feature's
        value (the BatchFeatureServe scan, serving.proto:23)."""
        resolved = [self._feature(*_split_ref(f)) for f in features]
        if not resolved:
            return
        first_table = self._table(resolved[0])
        entities = getattr(first_table, "entities", None)
        if entities is None:
            raise fferr.InvalidResourceError(
                "provider table does not support entity enumeration"
            )
        for entity in entities():
            vals = []
            for feat in resolved:
                try:
                    vals.append(self._table(feat).get(entity))
                except fferr.FFError:
                    vals.append(None)
            yield entity, vals

    def nearest(self, name: str, variant: str, vector, k: int) -> list[str]:
        """k nearest entity keys by embedding feature (serving.go:744)."""
        feat = self._feature(name, variant)
        if not feat.is_embedding:
            raise fferr.InvalidResourceError(
                f"feature {name}/{variant} is not an embedding"
            )
        table = self._table(feat)
        if not isinstance(table, provider_base.VectorStoreTable):
            raise fferr.ProviderTypeError(feat.provider, "VectorStore")
        return table.nearest(name, variant, vector, k)

    def record_model(
        self,
        name: str,
        features: list | None = None,
        trainingsets: list | None = None,
    ) -> None:
        """Upsert a Model resource accumulating served feature /
        training-set lineage edges."""
        from embeddinghub_tpu_torch.featurestore.resources import Model

        rid = ResourceID(ResourceType.MODEL, name)
        existing = self.metadata.maybe_get(rid)
        model = existing if isinstance(existing, Model) else Model(name=name)
        for ref in features or []:
            edge = _split_ref(ref)
            if edge not in model.features:
                model.features.append(edge)
        for ref in trainingsets or []:
            edge = _split_ref(ref)
            if edge not in model.trainingsets:
                model.trainingsets.append(edge)
        self.metadata.create(model)

    # --------------------------------------------------------------- offline

    def training_set(
        self, name: str, variant: str = "default", model: str | None = None
    ) -> "Dataset":
        if model:
            self.record_model(model, trainingsets=[(name, variant)])
        return self._training_set(name, variant)

    def _training_set(self, name: str, variant: str = "default") -> "Dataset":
        ts = self.metadata.get(
            ResourceID(ResourceType.TRAINING_SET_VARIANT, name, variant)
        )
        assert isinstance(ts, TrainingSetVariant)
        if ts.status != Status.READY:
            raise fferr.DependencyNotReadyError(
                f"training set {name}/{variant} is {ts.status.value}"
            )
        provider_name = ts.provider
        if not provider_name:
            label = self.metadata.get(
                ResourceID(ResourceType.LABEL_VARIANT, *ts.label)
            )
            src = self.metadata.get(
                ResourceID(ResourceType.SOURCE_VARIANT, *label.source)
            )
            provider_name = src.provider
        offline = self._provider(provider_name).as_offline_store()
        rows = list(offline.training_set_rows(name, variant))
        return Dataset(rows)

    # --------------------------------------------------------------- caches

    def _feature(self, name: str, variant: str) -> FeatureVariant:
        key = (name, variant)
        if key not in self._feat_cache:
            feat = self.metadata.get(
                ResourceID(ResourceType.FEATURE_VARIANT, name, variant)
            )
            assert isinstance(feat, FeatureVariant)
            self._feat_cache[key] = feat
        else:
            feat = self._feat_cache[key]
            if feat.status != Status.READY:
                # refresh: status may have advanced
                self._feat_cache.pop(key)
                return self._feature(name, variant)
        return self._feat_cache[key]

    def _table(self, feat: FeatureVariant):
        key = (feat.name, feat.variant)
        if key not in self._table_cache:
            online = self._provider(feat.provider).as_online_store()
            self._table_cache[key] = online.get_table(feat.name, feat.variant)
        return self._table_cache[key]

    def _provider(self, name: str):
        res = self.metadata.get(ResourceID(ResourceType.PROVIDER, name))
        return provider_base.get_provider(
            res.provider_type, res.config, cache_key=name
        )


class Row:
    """One training row (reference serving.py's Row: features + label)."""

    def __init__(self, features: list, label):
        self._features = features
        self._label = label

    def features(self) -> list:
        return self._features

    def label(self):
        return self._label

    def to_numpy(self):
        import numpy as np

        return np.asarray(self._features, dtype=object), self._label

    def __repr__(self):
        return f"Row(features={self._features}, label={self._label})"


class Dataset:
    """Iterable training set with repeat/shuffle/batch combinators
    (reference serving.py:438,692-744)."""

    def __init__(self, rows: list[tuple[list, Any]]):
        self._rows = rows
        self._repeat = 1
        self._shuffle_buf = 0
        self._batch = 0
        self._seed = None

    def repeat(self, n: int) -> "Dataset":
        self._repeat = max(1, int(n))
        return self

    def shuffle(self, buffer_size: int, seed: int | None = None) -> "Dataset":
        self._shuffle_buf = int(buffer_size)
        self._seed = seed
        return self

    def batch(self, size: int) -> "Dataset":
        self._batch = int(size)
        return self

    def __len__(self) -> int:
        return len(self._rows) * self._repeat

    def dataframe(self):
        """The training set as a pandas DataFrame — feature columns
        plus a ``label`` column (reference serving.py:578/683
        Dataset.dataframe()/pandas()); combinators (repeat/shuffle/
        batch) are iteration concerns and do not apply."""
        import pandas as pd

        if not self._rows:
            return pd.DataFrame()
        width = len(self._rows[0][0])
        cols = [f"feature_{i}" for i in range(width)]
        data = [list(f) + [label] for f, label in self._rows]
        return pd.DataFrame(data, columns=cols + ["label"])

    pandas = dataframe  # reference alias (serving.py:683)

    def __iter__(self) -> Iterator:
        rng = random.Random(self._seed)

        def row_iter():
            for _ in range(self._repeat):
                if self._shuffle_buf:
                    buf: list = []
                    for row in self._rows:
                        buf.append(row)
                        if len(buf) >= self._shuffle_buf:
                            yield buf.pop(rng.randrange(len(buf)))
                    while buf:
                        yield buf.pop(rng.randrange(len(buf)))
                else:
                    yield from self._rows

        if self._batch:
            batch: list[Row] = []
            for feats, label in row_iter():
                batch.append(Row(feats, label))
                if len(batch) >= self._batch:
                    yield batch
                    batch = []
            if batch:
                yield batch
        else:
            for feats, label in row_iter():
                yield Row(feats, label)


# Operator-registered on-demand callables: the SAFE way to serve
# on-demand features to remote clients.  The server operator registers
# the function natively (by feature name or name/variant); a remotely
# registered variant whose body arrived as source text is then answered
# by this native callable and nothing is ever exec'd.
_ON_DEMAND_REGISTRY: dict[str, "Callable"] = {}


def register_on_demand(name: str, fn=None, variant: str = ""):
    """Register a server-side callable for an on-demand feature.

    Usable directly (``register_on_demand("risk", fn)``) or as a
    decorator (``@register_on_demand("risk")``).  Signature matches the
    on-demand convention: ``fn(client, params, entities)``."""
    key = f"{name}/{variant}" if variant else name

    def _put(f):
        _ON_DEMAND_REGISTRY[key] = f
        return f

    if fn is None:
        return _put
    return _put(fn)


def lookup_on_demand(name: str, variant: str = ""):
    return _ON_DEMAND_REGISTRY.get(f"{name}/{variant}") or \
        _ON_DEMAND_REGISTRY.get(name)


def _compile_on_demand(source: str):
    """Rebuild an on-demand feature callable from wire-shipped source.
    Disabled unless EHTPU_ALLOW_REMOTE_CODE=1: running client-supplied
    code is exactly the hazard dropping pickle was meant to close (the
    reference accepts it by always dill-executing on-demand functions;
    we require the operator to opt in)."""
    import os

    if os.environ.get("EHTPU_ALLOW_REMOTE_CODE", "") not in ("1", "true"):
        raise fferr.InvalidResourceError(
            "on-demand feature arrived as source text from a remote "
            "client; set EHTPU_ALLOW_REMOTE_CODE=1 to allow executing it"
        )
    import textwrap

    lines = textwrap.dedent(source).splitlines()
    # registration decorators aren't defined server-side; they may span
    # multiple lines ("@register_ondemand_feature(\n  name=...,\n)"), so
    # drop everything before the first top-level def/async def
    for j, ln in enumerate(lines):
        if ln.startswith("def ") or ln.startswith("async def "):
            lines = lines[j:]
            break
    ns: dict = {}
    exec(compile("\n".join(lines), "<on_demand_feature>", "exec"), ns)  # noqa: S102
    fns = [v for v in ns.values() if callable(v) and not isinstance(v, type)]
    if not fns:
        raise fferr.InvalidResourceError(
            "on-demand feature source defines no function"
        )
    return fns[-1]


def _split_ref(ref) -> tuple[str, str]:
    if isinstance(ref, tuple):
        return ref
    if ":" in ref:
        name, variant = ref.split(":", 1)
        return name, variant
    return ref, "default"
