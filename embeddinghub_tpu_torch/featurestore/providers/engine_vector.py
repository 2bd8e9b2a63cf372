"""Engine vector store provider — the north-star integration.

Slots this package's ANN engine in where the reference wires Redis
or Pinecone as its vector store (``provider/redis.go:245-262`` creates
a RediSearch HNSW index; ``provider/online.go:55-64`` defines the
interface; serving's ``Nearest`` lands on ``VectorStoreTable.Nearest``,
``serving/serving.go:744-771``).

Two modes:
  * in-process (default): an ``embeddinghub_tpu_torch.store.hub.EmbeddingHub``
    inside this process, on the device named by the config's ``device``
    (``"cuda"`` unless it says otherwise; a CUDA device on a host without
    one raises, never moves to the CPU);
  * remote: any EmbeddingHub gRPC endpoint (this package's server or
    the reference C++ one) via the SDK client.
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np

from embeddinghub_tpu_torch.featurestore import fferr
from embeddinghub_tpu_torch.featurestore.providers import base


def _space_name(feature: str, variant: str) -> str:
    return f"vector__{feature}__{variant}"


class _LocalVectorTable(base.VectorStoreTable):
    def __init__(self, version):
        self._version = version

    def set(self, entity: str, value) -> None:
        self._version.set(str(entity), np.asarray(value, np.float32))

    def batch_set(self, items: Iterable[tuple[str, Any]]) -> None:
        self._version.multiset(
            [(str(e), np.asarray(v, np.float32)) for e, v in items]
        )

    def get(self, entity: str):
        try:
            return self._version.get(str(entity)).tolist()
        except Exception:
            raise fferr.EntityNotFoundError("", "", str(entity))

    def nearest(self, feature: str, variant: str, vector, k: int) -> list[str]:
        return self._version.nearest(k, vector=np.asarray(vector, np.float32))

    def entities(self) -> list[str]:
        return [key for key, _ in self._version.iterator()]


class EngineVectorStore(base.VectorStore):
    """In-process engine vector store (provider type ``EMBEDDINGHUB_TPU``,
    the JAX package's name, so its definitions and metadata apply
    unchanged).  Config: {"path": snapshot dir or None, "metric":
    "cosine", "device": "cuda"}  (the reference Redis path uses COSINE,
    redis.go:254)."""

    ptype = "EMBEDDINGHUB_TPU"

    def __init__(self, config: dict | None = None):
        from embeddinghub_tpu_torch.store.hub import EmbeddingHub
        from embeddinghub_tpu_torch.utils.device import DEFAULT

        config = config or {}
        path = config.get("path")
        self._metric = config.get("metric", "cosine")
        device = config.get("device") or DEFAULT
        self._hub = (
            EmbeddingHub.load_or_create(path, device=device)
            if path else EmbeddingHub.in_memory(device=device)
        )

    def as_online_store(self):
        return self

    # ---- OnlineStore surface (vector tables are online tables too)

    def create_table(self, feature, variant, value_type="embedding"):
        raise fferr.ProviderTypeError(
            self.ptype, "scalar online table (use create_index)"
        )

    def get_table(self, feature, variant):
        space = self._hub.get_space(_space_name(feature, variant))
        if space is None:
            raise fferr.ResourceNotFoundError("vector index", feature, variant)
        return _LocalVectorTable(space.default_version())

    def delete_table(self, feature, variant):
        self.delete_index(feature, variant)

    # ---- VectorStore surface

    def create_index(self, feature, variant, dims) -> base.VectorStoreTable:
        space = self._hub.create_space(
            _space_name(feature, variant), dims, metric=self._metric
        )
        return _LocalVectorTable(space.default_version())

    def delete_index(self, feature, variant) -> None:
        self._hub.delete_space(_space_name(feature, variant))

    def save(self) -> None:
        self._hub.save()


class RemoteVectorStore(base.VectorStore):
    """EmbeddingHub-over-gRPC vector store (provider type
    ``EMBEDDINGHUB_GRPC``).  Works against this package's server or the
    reference C++ server — the wire surface is identical."""

    ptype = "EMBEDDINGHUB_GRPC"

    def __init__(self, config: dict | None = None):
        from embeddinghub_tpu_torch.sdk.client import EmbeddingHubClient

        config = config or {}
        self._client = EmbeddingHubClient(
            host=config.get("host", "0.0.0.0"), port=config.get("port", 7462)
        )

    def as_online_store(self):
        return self

    def create_index(self, feature, variant, dims):
        self._client.create_space(_space_name(feature, variant), dims)
        return _RemoteVectorTable(self._client, _space_name(feature, variant))

    def delete_index(self, feature, variant):
        self._client.delete_space(_space_name(feature, variant))

    def get_table(self, feature, variant):
        return _RemoteVectorTable(self._client, _space_name(feature, variant))

    def delete_table(self, feature, variant):
        self.delete_index(feature, variant)


class _RemoteVectorTable(base.VectorStoreTable):
    def __init__(self, client, space: str):
        self._client = client
        self._space = space

    def set(self, entity: str, value) -> None:
        self._client.set(self._space, str(entity), list(value))

    def batch_set(self, items) -> None:
        self._client.multiset(self._space, [(str(e), list(v)) for e, v in items])

    def get(self, entity: str):
        return list(self._client.get(self._space, str(entity)))

    def nearest(self, feature, variant, vector, k: int) -> list[str]:
        return list(
            self._client.nearest_neighbor(self._space, k, embedding=list(vector))
        )


base.register_factory("EMBEDDINGHUB_TPU", lambda cfg: EngineVectorStore(cfg))
base.register_factory("EMBEDDINGHUB_GRPC", lambda cfg: RemoteVectorStore(cfg))
