"""Registrar + Client — the user-facing registration API.

Rebuild of the reference Python client's surface
(``client/src/featureform/register.py``: a global Registrar with
``register_*`` builders, sql/df transformation decorators,
``ff.Embedding`` columns at ``register.py:1868``; ``client.py:66``'s
unified ``Client`` = ResourceClient + ServingClient;
``resources.py``'s ``ResourceState.create_all`` topological apply).

Example::

    import embeddinghub_tpu_torch.featurestore as ff

    ff.global_registrar().reset()
    reg = ff.global_registrar()
    offline = reg.register_sqlite_offline("warehouse")
    vectors = reg.register_engine_vector_store("vectors", device="cuda")
    reg.register_entity("user")
    src = reg.register_primary_data(
        "events", provider="warehouse",
        location={"rows": [...]})
    reg.register_embedding_feature(
        "user_embedding", source=("events", "default"), entity="user",
        entity_column="user_id", value_column="vector", dims=64,
        provider="vectors")
    client = ff.Client(local=True)
    client.apply()
    client.nearest("user_embedding", "default", query_vec, 5)
"""

from __future__ import annotations

import threading
from typing import Any, Callable

from embeddinghub_tpu_torch.featurestore import fferr
from embeddinghub_tpu_torch.featurestore.coordinator import Coordinator
from embeddinghub_tpu_torch.featurestore.metadata import MetadataStore
from embeddinghub_tpu_torch.featurestore.resources import (
    Entity,
    FeatureVariant,
    LabelVariant,
    Model,
    Provider,
    Resource,
    ResourceType,
    SourceVariant,
    TrainingSetVariant,
    User,
)
from embeddinghub_tpu_torch.featurestore.serving import ServingClient


def _source_nv(source) -> tuple:
    """Coerce a source reference to (name, variant): accepts a
    (name, variant) tuple or a SourceVariant builder/resource directly
    (``source=transactions`` — reference register.py accepts registrar
    objects wherever name-variants go)."""
    if hasattr(source, "rid"):
        return (source.name, getattr(source, "variant", "default"))
    return tuple(source)


class Registrar:
    """Accumulates resource definitions; ``Client.apply()`` submits them
    in dependency order."""

    def __init__(self):
        self._resources: list[Resource] = []
        self._default_owner = ""
        self._variant_prefix = ""
        self._run = self._new_run()

    def _new_run(self) -> str:
        # the reference stamps each registration session with a "run"
        # variant: timestamp-style under FF_GET_EQUIVALENT_VARIANTS
        # (default on), docker-style adjective_noun otherwise
        # (register.py:2007-2009)
        from embeddinghub_tpu_torch.featurestore import feature_flag
        from embeddinghub_tpu_torch.featurestore import variant_names

        if feature_flag.is_enabled("FF_GET_EQUIVALENT_VARIANTS", True):
            return variant_names.get_current_timestamp_variant(
                prefix=self._variant_prefix
            )
        return variant_names.get_random_name()

    @property
    def run(self) -> str:
        """The session's autogenerated variant name: resources
        registered with ``variant=None`` get this (reference
        ``register.py:2166``/``get_run()``)."""
        return self._run

    def set_run(self, name: str | None = None) -> str:
        """Pin (or re-roll, with ``None``) the session run name."""
        self._run = name if name else self._new_run()
        return self._run

    def set_variant_prefix(self, prefix: str) -> None:
        self._variant_prefix = prefix
        self._run = self._new_run()

    def reset(self) -> None:
        self._resources.clear()
        self._run = self._new_run()

    def resources(self) -> list[Resource]:
        return list(self._resources)

    def _add(self, res: Resource) -> Resource:
        if not res.owner:
            res.owner = self._default_owner
        if getattr(res, "variant", "") is None:
            res.variant = self._run
        # (name, None) references resolve to the run variant too, so a
        # whole run-scoped pipeline can be registered without naming it
        for f in ("source", "label"):
            v = getattr(res, f, None)
            if isinstance(v, tuple) and len(v) == 2 and v[1] is None:
                setattr(res, f, (v[0], self._run))
        for f in ("inputs", "features"):
            v = getattr(res, f, None)
            if isinstance(v, list):
                setattr(res, f, [
                    (t[0], self._run)
                    if isinstance(t, tuple) and len(t) == 2 and t[1] is None
                    else t
                    for t in v
                ])
        self._resources.append(res)
        return res

    # ----------------------------------------------------------- principals

    def register_user(self, name: str) -> User:
        user = User(name=name)
        self._add(user)
        return user

    def set_default_owner(self, name: str) -> None:
        self._default_owner = name

    def register_entity(self, name: str, description: str = "") -> Entity:
        return self._add(Entity(name=name, description=description))

    def register_model(self, name: str) -> Model:
        return self._add(Model(name=name))

    # ------------------------------------------------------------ providers

    def register_provider(
        self, name: str, provider_type: str, config: dict | None = None, **kw
    ) -> Provider:
        return self._add(
            Provider(
                name=name, provider_type=provider_type, config=config or {}, **kw
            )
        )

    def register_memory_online(self, name: str = "memory-online") -> Provider:
        return self.register_provider(name, "MEMORY_ONLINE")

    def register_sqlite_offline(
        self, name: str = "sqlite-offline", path: str = ":memory:"
    ) -> Provider:
        return self.register_provider(name, "SQLITE_OFFLINE", {"path": path})

    def register_pandas_offline(
        self, name: str = "pandas-offline", path: str | None = None
    ) -> Provider:
        """Pandas + jsonl-filestore offline store (the local seat of the
        reference's Spark/filestore offline stores; see
        providers/pandas_offline.py)."""
        return self.register_provider(name, "PANDAS_OFFLINE", {"path": path})

    def register_engine_vector_store(
        self,
        name: str = "embeddinghub-tpu",
        path: str | None = None,
        metric: str = "cosine",
        device: str = "cuda",
    ) -> Provider:
        """The engine as the vector store (where the reference wires
        Redis/Pinecone/Weaviate), on ``device``: the card unless the
        caller asks for ``"cpu"``."""
        return self.register_provider(
            name, "EMBEDDINGHUB_TPU",
            {"path": path, "metric": metric, "device": device},
        )

    def register_remote_vector_store(
        self, name: str, host: str = "0.0.0.0", port: int = 7462
    ) -> Provider:
        return self.register_provider(
            name, "EMBEDDINGHUB_GRPC", {"host": host, "port": port}
        )

    def register_redis(
        self,
        name: str = "redis",
        host: str = "127.0.0.1",
        port: int = 6379,
        password: str = "",
        prefix: str = "",
        description: str = "",
        team: str = "",
    ) -> Provider:
        """Redis online/vector store (reference ``register.py``'s
        register_redis; our provider speaks the same HSET/FT.* wire,
        providers/redis_online.py)."""
        cfg = {"host": host, "port": port}
        if password:
            cfg["password"] = password
        if prefix:
            cfg["prefix"] = prefix
        return self.register_provider(
            name, "REDIS_ONLINE", cfg, description=description, team=team
        )

    def register_sqlite_online(
        self, name: str = "sqlite-online", path: str = ":memory:"
    ) -> Provider:
        """Durable cross-process online store (the seat DynamoDB/
        Cassandra hold in the reference)."""
        return self.register_provider(name, "SQLITE_ONLINE", {"path": path})

    # ---- external-infrastructure builders (reference register.py's
    # 40+ register_* surface).  They serialize the same config fields
    # the reference sends; registration/apply/metadata work end-to-end,
    # and orchestration fails with a clear error unless a provider
    # factory for the type is installed (none of this infra exists in
    # this image — the contract seat is covered by the local providers
    # above, proven by the shared behavioral suite).

    def register_postgres(
        self, name: str = "postgres", host: str = "0.0.0.0",
        port: int = 5432, user: str = "postgres", password: str = "",
        database: str = "postgres", sslmode: str = "disable", **kw
    ) -> Provider:
        return self.register_provider(
            name, "POSTGRES_OFFLINE",
            {"host": host, "port": port, "user": user,
             "password": password, "database": database,
             "sslmode": sslmode}, **kw,
        )

    def register_snowflake(
        self, name: str = "snowflake", username: str = "", password: str = "",
        account: str = "", organization: str = "", database: str = "",
        schema: str = "PUBLIC", warehouse: str = "", role: str = "", **kw
    ) -> Provider:
        return self.register_provider(
            name, "SNOWFLAKE_OFFLINE",
            {"username": username, "password": password,
             "account": account, "organization": organization,
             "database": database, "schema": schema,
             "warehouse": warehouse, "role": role}, **kw,
        )

    def register_redshift(
        self, name: str = "redshift", host: str = "", port: int = 5439,
        user: str = "", password: str = "", database: str = "dev", **kw
    ) -> Provider:
        return self.register_provider(
            name, "REDSHIFT_OFFLINE",
            {"host": host, "port": port, "user": user,
             "password": password, "database": database}, **kw,
        )

    def register_bigquery(
        self, name: str = "bigquery", project_id: str = "",
        dataset_id: str = "", credentials_path: str = "", **kw
    ) -> Provider:
        return self.register_provider(
            name, "BIGQUERY_OFFLINE",
            {"project_id": project_id, "dataset_id": dataset_id,
             "credentials_path": credentials_path}, **kw,
        )

    def register_clickhouse(
        self, name: str = "clickhouse", host: str = "", port: int = 9000,
        user: str = "default", password: str = "", database: str = "default",
        ssl: bool = False, **kw
    ) -> Provider:
        return self.register_provider(
            name, "CLICKHOUSE_OFFLINE",
            {"host": host, "port": port, "user": user,
             "password": password, "database": database, "ssl": ssl}, **kw,
        )

    def register_mysql(
        self, name: str = "mysql", host: str = "", port: int = 3306,
        user: str = "root", password: str = "", database: str = "mysql", **kw
    ) -> Provider:
        return self.register_provider(
            name, "MYSQL_OFFLINE",
            {"host": host, "port": port, "user": user,
             "password": password, "database": database}, **kw,
        )

    def register_dynamodb(
        self, name: str = "dynamodb", region: str = "us-east-1",
        access_key: str = "", secret_key: str = "", **kw
    ) -> Provider:
        return self.register_provider(
            name, "DYNAMODB_ONLINE",
            {"region": region, "access_key": access_key,
             "secret_key": secret_key}, **kw,
        )

    def register_cassandra(
        self, name: str = "cassandra", host: str = "", port: int = 9042,
        username: str = "", password: str = "", keyspace: str = "",
        consistency: str = "THREE", replication: int = 3, **kw
    ) -> Provider:
        return self.register_provider(
            name, "CASSANDRA_ONLINE",
            {"host": host, "port": port, "username": username,
             "password": password, "keyspace": keyspace,
             "consistency": consistency, "replication": replication}, **kw,
        )

    def register_firestore(
        self, name: str = "firestore", project_id: str = "",
        collection: str = "", credentials_path: str = "", **kw
    ) -> Provider:
        return self.register_provider(
            name, "FIRESTORE_ONLINE",
            {"project_id": project_id, "collection": collection,
             "credentials_path": credentials_path}, **kw,
        )

    def register_mongodb(
        self, name: str = "mongodb", host: str = "", port: int = 27017,
        username: str = "", password: str = "", database: str = "",
        throughput: int = 1000, **kw
    ) -> Provider:
        return self.register_provider(
            name, "MONGODB_ONLINE",
            {"host": host, "port": port, "username": username,
             "password": password, "database": database,
             "throughput": throughput}, **kw,
        )

    def register_pinecone(
        self, name: str = "pinecone", project_id: str = "",
        environment: str = "", api_key: str = "", **kw
    ) -> Provider:
        """Reference vector-store seat (provider/pinecone.go); the
        engine (register_engine_vector_store) is the native drop-in."""
        return self.register_provider(
            name, "PINECONE_VECTOR",
            {"project_id": project_id, "environment": environment,
             "api_key": api_key}, **kw,
        )

    def register_weaviate(
        self, name: str = "weaviate", url: str = "", api_key: str = "", **kw
    ) -> Provider:
        return self.register_provider(
            name, "WEAVIATE_VECTOR", {"url": url, "api_key": api_key}, **kw,
        )

    def register_s3(
        self, name: str = "s3", bucket: str = "", region: str = "us-east-1",
        access_key: str = "", secret_key: str = "", path: str = "", **kw
    ) -> Provider:
        return self.register_provider(
            name, "S3_FILESTORE",
            {"bucket": bucket, "region": region, "access_key": access_key,
             "secret_key": secret_key, "path": path}, **kw,
        )

    def register_gcs(
        self, name: str = "gcs", bucket: str = "", path: str = "",
        credentials_path: str = "", **kw
    ) -> Provider:
        return self.register_provider(
            name, "GCS_FILESTORE",
            {"bucket": bucket, "path": path,
             "credentials_path": credentials_path}, **kw,
        )

    def register_azure_blob(
        self, name: str = "azure-blob", account_name: str = "",
        account_key: str = "", container: str = "", path: str = "", **kw
    ) -> Provider:
        return self.register_provider(
            name, "AZURE_FILESTORE",
            {"account_name": account_name, "account_key": account_key,
             "container": container, "path": path}, **kw,
        )

    def register_spark(
        self, name: str = "spark", executor_type: str = "EMR",
        executor_config: dict | None = None,
        filestore: str = "", executor=None, catalog=None,
        spark_flags=None, **kw
    ) -> Provider:
        """Spark offline store.  Pass a typed ``executor`` —
        EMRCredentials / DatabricksCredentials / SparkCredentials
        (``executor_credentials.py``; reference register.py:3853-3914
        takes the same union) — plus an optional GlueCatalog and
        SparkFlags; the raw executor_type/executor_config dict form
        stays accepted."""
        if executor is not None:
            executor_type = executor.type()
            executor_config = executor.config()
        cfg = {"executor_type": executor_type,
               "executor_config": executor_config or {},
               "filestore": filestore}
        if catalog is not None:
            cfg["catalog"] = catalog.config()
        if spark_flags is not None:
            cfg["spark_flags"] = spark_flags.serialize()
        return self.register_provider(name, "SPARK_OFFLINE", cfg, **kw)

    def register_kubernetes(
        self, name: str = "k8s", image: str = "", filestore: str = "", **kw
    ) -> Provider:
        return self.register_provider(
            name, "K8S_OFFLINE", {"image": image, "filestore": filestore},
            **kw,
        )

    def register_hdfs(
        self, name: str = "hdfs", host: str = "", port: int = 9000,
        path: str = "", username: str = "hdfs", **kw
    ) -> Provider:
        """HDFS filestore seat (reference register.py register_hdfs)."""
        return self.register_provider(
            name, "HDFS_FILESTORE",
            {"host": host, "port": port, "path": path,
             "username": username}, **kw,
        )

    def register_snowflake_legacy(
        self, name: str = "snowflake-legacy", username: str = "",
        password: str = "", account_locator: str = "", database: str = "",
        schema: str = "PUBLIC", warehouse: str = "", role: str = "", **kw
    ) -> Provider:
        """Account-locator form of the Snowflake config (reference
        register.py register_snowflake_legacy)."""
        return self.register_provider(
            name, "SNOWFLAKE_OFFLINE",
            {"username": username, "password": password,
             "account_locator": account_locator, "database": database,
             "schema": schema, "warehouse": warehouse, "role": role}, **kw,
        )

    # -------------------------------------------------------------- sources

    def register_primary_data(
        self,
        name: str,
        provider: str,
        location: Any,
        variant: str = "default",
        **kw,
    ) -> SourceVariant:
        return self._add(
            SourceVariant(
                name=name, variant=variant, provider=provider, primary=location, **kw
            )
        )

    # typed primary-data locations (reference register.py's
    # register_table / register_file / register_parquet_file /
    # register_iceberg_table / register_delta_table — thin wrappers
    # producing the location dict register_primary_data stores)

    def register_table(
        self, name: str, provider: str, table: str,
        schema: str = "", database: str = "", variant: str = "default", **kw
    ) -> SourceVariant:
        loc: dict = {"table": table}
        if schema:
            loc["schema"] = schema
        if database:
            loc["database"] = database
        return self.register_primary_data(name, provider, loc,
                                          variant=variant, **kw)

    def register_file(
        self, name: str, provider: str, file_path: str,
        variant: str = "default", **kw
    ) -> SourceVariant:
        return self.register_primary_data(
            name, provider, {"path": file_path}, variant=variant, **kw
        )

    def register_parquet_file(
        self, name: str, provider: str, file_path: str,
        variant: str = "default", **kw
    ) -> SourceVariant:
        return self.register_primary_data(
            name, provider, {"path": file_path, "format": "parquet"},
            variant=variant, **kw,
        )

    def register_directory(
        self, name: str, provider: str, path: str,
        variant: str = "default", **kw
    ) -> SourceVariant:
        return self.register_primary_data(
            name, provider, {"path": path, "directory": True},
            variant=variant, **kw,
        )

    def register_iceberg_table(
        self, name: str, provider: str, database: str, table: str,
        variant: str = "default", **kw
    ) -> SourceVariant:
        return self.register_primary_data(
            name, provider,
            {"database": database, "table": table, "table_format": "iceberg"},
            variant=variant, **kw,
        )

    def register_delta_table(
        self, name: str, provider: str, database: str, table: str,
        variant: str = "default", **kw
    ) -> SourceVariant:
        return self.register_primary_data(
            name, provider,
            {"database": database, "table": table, "table_format": "delta"},
            variant=variant, **kw,
        )

    def sql_transformation(
        self, name: str, provider: str, variant: str = "default", inputs=None,
        engine: str | None = None, **kw
    ) -> Callable:
        """Decorator: the function's docstring/return is the SQL text
        with ``{{ source.variant }}`` placeholders (register.py's
        sql_transformation decorator style).  ``engine`` routes
        execution through a TransformEngine ("inprocess"/"subprocess"/
        registered external) instead of the offline provider — the
        reference's Spark/k8s submission seam (tasks/source.go)."""

        def decorator(fn):
            sql = fn() if callable(fn) else fn
            if not isinstance(sql, str):
                sql = fn.__doc__ or ""
            transformation = {"sql": sql}
            if engine:
                transformation["engine"] = engine
            # returning the SourceVariant makes the decorated name
            # subscriptable for the class-based API
            # (reference SubscriptableTransformation, register.py:1090)
            return self._add(
                SourceVariant(
                    name=name,
                    variant=variant,
                    provider=provider,
                    transformation=transformation,
                    inputs=[tuple(i) for i in (inputs or [])],
                    **kw,
                )
            )

        return decorator

    def df_transformation(
        self, name: str, provider: str, inputs: list, variant: str = "default",
        engine: str | None = None, **kw
    ) -> Callable:
        """Decorator: fn(rows_of_each_input...) -> list[dict].
        ``engine`` as in :meth:`sql_transformation`."""

        def decorator(fn):
            transformation = {"df": fn}
            if engine:
                transformation["engine"] = engine
            return self._add(
                SourceVariant(
                    name=name,
                    variant=variant,
                    provider=provider,
                    transformation=transformation,
                    inputs=[tuple(i) for i in inputs],
                    **kw,
                )
            )

        return decorator

    # ------------------------------------------------------- features/labels

    def register_feature(
        self,
        name: str,
        source: tuple[str, str],
        entity: str,
        entity_column: str,
        value_column: str,
        provider: str,
        variant: str = "default",
        value_type: str = "float32",
        timestamp_column: str = "",
        **kw,
    ) -> FeatureVariant:
        return self._add(
            FeatureVariant(
                name=name,
                variant=variant,
                source=_source_nv(source),
                entity=entity,
                entity_column=entity_column,
                value_column=value_column,
                timestamp_column=timestamp_column,
                provider=provider,
                value_type=value_type,
                **kw,
            )
        )

    def register_embedding_feature(
        self,
        name: str,
        source: tuple[str, str],
        entity: str,
        entity_column: str,
        value_column: str,
        dims: int,
        provider: str,
        variant: str = "default",
        **kw,
    ) -> FeatureVariant:
        """ff.Embedding parity (register.py:1868/6218: embedding column
        resources bound to a vector_db provider)."""
        return self.register_feature(
            name,
            source,
            entity,
            entity_column,
            value_column,
            provider,
            variant=variant,
            value_type="embedding",
            is_embedding=True,
            dims=dims,
            **kw,
        )

    def ondemand_feature(
        self, name: str, variant: str = "default", **kw
    ) -> Callable:
        """Decorator for client-side on-demand features
        (fn(client, params, entities) -> value)."""

        def decorator(fn):
            self._add(
                FeatureVariant(
                    name=name, variant=variant, on_demand_fn=fn, **kw
                )
            )
            return fn

        return decorator

    def register_label(
        self,
        name: str,
        source: tuple[str, str],
        entity: str,
        entity_column: str,
        value_column: str,
        variant: str = "default",
        timestamp_column: str = "",
        **kw,
    ) -> LabelVariant:
        return self._add(
            LabelVariant(
                name=name,
                variant=variant,
                source=_source_nv(source),
                entity=entity,
                entity_column=entity_column,
                value_column=value_column,
                timestamp_column=timestamp_column,
                **kw,
            )
        )

    def register_feature_stream(
        self,
        name: str,
        entity: str,
        value_type: str,
        offline_provider: str,
        inference_store: str,
        variant: str = "default",
        **kw,
    ) -> FeatureVariant:
        """Stream feature: no batch source/materialization — values
        arrive by direct writes to the online store, with the offline
        provider as the durability seat (reference StreamFeature,
        register.py register_feature_stream)."""
        return self._add(
            FeatureVariant(
                name=name,
                variant=variant,
                entity=entity,
                value_type=value_type,
                provider=inference_store,
                offline_provider=offline_provider,
                stream=True,
                **kw,
            )
        )

    def register_label_stream(
        self,
        name: str,
        entity: str,
        value_type: str,
        offline_provider: str,
        variant: str = "default",
        **kw,
    ) -> LabelVariant:
        return self._add(
            LabelVariant(
                name=name,
                variant=variant,
                entity=entity,
                value_type=value_type,
                offline_provider=offline_provider,
                stream=True,
                **kw,
            )
        )

    def register_training_set(
        self,
        name: str,
        label: tuple[str, str],
        features: list,
        provider: str = "",
        variant: str = "default",
        **kw,
    ) -> TrainingSetVariant:
        """Features are (name, variant) tuples, or dicts
        ``{"feature": n, "variant": v, "name": alias, "lag": delta}``
        — a lagged entry adds one extra column holding the feature's
        value as of (label ts - lag).  ``lag`` is a
        ``datetime.timedelta`` or seconds.  Reference:
        register.py:4683-4731 splits the same dict form into
        feature_lags."""
        import datetime as _dt

        plain, lags = [], []
        for f in features:
            if isinstance(f, dict):
                lag = f.get("lag")
                fname, fvar = f["feature"], f.get("variant", "default")
                if lag is None:
                    plain.append((fname, fvar))
                    continue
                if isinstance(lag, _dt.timedelta):
                    lag = lag.total_seconds()
                lags.append({
                    "feature": fname,
                    "variant": fvar,
                    "name": f.get("name")
                    or f"{fname}_{fvar}_lag_{lag:g}s",
                    "lag": float(lag),
                })
            else:
                plain.append(tuple(f))
        return self._add(
            TrainingSetVariant(
                name=name,
                variant=variant,
                label=tuple(label),
                features=plain,
                feature_lags=lags,
                provider=provider,
                **kw,
            )
        )


_GLOBAL = Registrar()
_GLOBAL_LOCK = threading.Lock()


def global_registrar() -> Registrar:
    return _GLOBAL


class Client(ServingClient):
    """Unified client (resource ops + serving), reference ``client.py:66``.

    ``local=True`` runs the full control plane in-process: metadata
    store + coordinator + providers (the reference's localmode
    equivalent, minus any external infra)."""

    def __init__(
        self,
        registrar: Registrar | None = None,
        metadata: MetadataStore | None = None,
        coordinator: Coordinator | None = None,
        local: bool = True,
    ):
        self.registrar = registrar or global_registrar()
        metadata = metadata if metadata is not None else MetadataStore()
        coordinator = (
            coordinator if coordinator is not None else Coordinator(metadata)
        )
        super().__init__(metadata, coordinator)
        self.coordinator = coordinator

    # ----------------------------------------------------------------- apply

    def apply(
        self,
        wait: bool = True,
        display: bool = False,
        verbose: bool = False,
    ) -> list[Resource]:
        """Submit registered resources in dependency order (the
        reference's ResourceState.create_all), then drive tasks to
        completion when ``wait``.  With ``display`` a live status table
        tracks each resource to READY/FAILED while the coordinator
        works (reference apply's StatusDisplayer,
        ``status_display.py:47``); ``verbose`` additionally raises at
        the end if anything FAILED."""
        pending = self.registrar.resources()
        created = []
        for res in _topo_sort(pending):
            try:
                if self.metadata.create(res):
                    created.append(res)
            except fferr.ResourceChangedError:
                raise
        if wait:
            if display:
                import threading as _threading

                from embeddinghub_tpu_torch.featurestore.status_display import (
                    StatusDisplayer,
                )

                worker = _threading.Thread(
                    target=self.coordinator.run_pending_sync, daemon=True
                )
                worker.start()
                StatusDisplayer(
                    self.metadata, created, verbose=verbose
                ).display(until=lambda: not worker.is_alive())
                worker.join()
            else:
                self.coordinator.run_pending_sync()
        self.registrar.reset()
        return created

    # ------------------------------------------------------------- resource

    def get_status(self, rtype: ResourceType, name: str, variant: str = ""):
        from embeddinghub_tpu_torch.featurestore.resources import ResourceID

        return self.metadata.get(ResourceID(rtype, name, variant)).status

    def list_resources(self, rtype: ResourceType):
        return self.metadata.list_type(rtype)

    def dataframe(self, source: str, variant: str = "default"):
        """Source rows as a pandas DataFrame (reference ``client.py:123``
        returns pandas too); falls back to a list of dicts when pandas
        is unavailable."""
        rows = self.rows(source, variant)
        try:
            import pandas as pd

            return pd.DataFrame(rows)
        except ImportError:
            return rows

    def rows(self, source: str, variant: str = "default") -> list[dict]:
        """Raw rows of a source table (pandas-free variant)."""
        from embeddinghub_tpu_torch.featurestore.resources import ResourceID

        src = self.metadata.get(
            ResourceID(ResourceType.SOURCE_VARIANT, source, variant)
        )
        offline = self._provider(src.provider).as_offline_store()
        return offline.table_rows(source, variant)

    # ------------------------------------------------------------ getters
    # Reference client getter/list surface (register.py:5144-6216).

    def get_source(self, name: str, variant: str = "default"):
        return self._get_res(ResourceType.SOURCE_VARIANT, name, variant)

    def get_feature(self, name: str, variant: str = "default"):
        return self._get_res(ResourceType.FEATURE_VARIANT, name, variant)

    def get_label(self, name: str, variant: str = "default"):
        return self._get_res(ResourceType.LABEL_VARIANT, name, variant)

    def get_training_set(self, name: str, variant: str = "default"):
        return self._get_res(ResourceType.TRAINING_SET_VARIANT, name, variant)

    def get_entity(self, name: str):
        return self._get_res(ResourceType.ENTITY, name, "")

    def get_user(self, name: str):
        return self._get_res(ResourceType.USER, name, "")

    def get_model(self, name: str):
        return self._get_res(ResourceType.MODEL, name, "")

    def get_provider(self, name: str):
        return self._get_res(ResourceType.PROVIDER, name, "")

    def _get_res(self, rtype: ResourceType, name: str, variant: str):
        from embeddinghub_tpu_torch.featurestore.resources import ResourceID

        return self.metadata.get(ResourceID(rtype, name, variant))

    _VARIANT_TYPES = (
        ResourceType.SOURCE_VARIANT,
        ResourceType.FEATURE_VARIANT,
        ResourceType.LABEL_VARIANT,
        ResourceType.TRAINING_SET_VARIANT,
    )

    def get_variants(self, name: str, rtype: ResourceType | None = None):
        """All variants of a named resource, most recent last
        (reference register.py:5504).  Without ``rtype`` every
        variant-bearing type is searched."""
        types = (rtype,) if rtype else self._VARIANT_TYPES
        out = []
        for t in types:
            out.extend(self.metadata.variants(t, name))
        return sorted(out, key=lambda r: r.created_at)

    def latest_variant(self, name: str, rtype: ResourceType | None = None):
        """Most recently created variant name, or None (reference
        register.py:5519)."""
        vs = self.get_variants(name, rtype)
        return vs[-1].variant if vs else None

    def list_features(self):
        return self.metadata.list_type(ResourceType.FEATURE_VARIANT)

    def list_labels(self):
        return self.metadata.list_type(ResourceType.LABEL_VARIANT)

    def list_sources(self):
        return self.metadata.list_type(ResourceType.SOURCE_VARIANT)

    def list_training_sets(self):
        return self.metadata.list_type(ResourceType.TRAINING_SET_VARIANT)

    def list_entities(self):
        return self.metadata.list_type(ResourceType.ENTITY)

    def list_users(self):
        return self.metadata.list_type(ResourceType.USER)

    def list_models(self):
        return self.metadata.list_type(ResourceType.MODEL)

    def list_providers(self):
        return self.metadata.list_type(ResourceType.PROVIDER)

    # ------------------------------------------------------- delete/search

    def delete(self, resource, variant: str = "default",
               rtype: ResourceType | None = None) -> None:
        """Stage a resource for deletion (phase 1 of the reference's
        two-phase delete, register.py:4977 / metadata.go:2429).
        Accepts a resource object or a name (+variant/rtype)."""
        self.metadata.delete(self._target_rid(resource, variant, rtype))

    def prune(self, resource, variant: str = "default",
              rtype: ResourceType | None = None) -> None:
        """Finalize a staged deletion (reference register.py:5025)."""
        self.metadata.prune(self._target_rid(resource, variant, rtype))

    def _target_rid(self, resource, variant, rtype):
        from embeddinghub_tpu_torch.featurestore.resources import ResourceID

        if hasattr(resource, "rid"):
            return resource.rid()
        if rtype is None:
            raise fferr.InvalidResourceError(
                "deleting by name requires rtype="
            )
        return ResourceID(rtype, resource, variant)

    def search(self, query: str, limit: int = 20) -> list[dict]:
        """Full-text resource search (reference register.py:6197)."""
        from embeddinghub_tpu_torch.featurestore.search import SearchIndex

        return SearchIndex(self.metadata).search(query, limit=limit)


def _topo_sort(resources: list[Resource]) -> list[Resource]:
    """Order: users/providers/entities first, then sources (respecting
    transformation inputs), then features/labels, then training sets."""
    rank = {
        ResourceType.USER: 0,
        ResourceType.PROVIDER: 0,
        ResourceType.ENTITY: 0,
        ResourceType.MODEL: 0,
        ResourceType.SOURCE_VARIANT: 1,
        ResourceType.FEATURE_VARIANT: 2,
        ResourceType.LABEL_VARIANT: 2,
        ResourceType.TRAINING_SET_VARIANT: 3,
    }
    sources = [r for r in resources if r.rtype == ResourceType.SOURCE_VARIANT]
    order: dict[str, int] = {}

    def depth(src: SourceVariant, seen=()) -> int:
        key = f"{src.name}/{src.variant}"
        if key in order:
            return order[key]
        if key in seen:
            raise fferr.InvalidResourceError(f"source cycle at {key}")
        d = 0
        for n, v in src.inputs:
            dep = next(
                (s for s in sources if s.name == n and getattr(s, "variant", "") == v),
                None,
            )
            if dep is not None:
                d = max(d, depth(dep, seen + (key,)) + 1)
        order[key] = d
        return d

    def sort_key(r: Resource):
        base = rank.get(r.rtype, 1)
        if isinstance(r, SourceVariant):
            return (base, depth(r))
        return (base, 0)

    return sorted(resources, key=sort_key)
