from embeddinghub_tpu_torch.featurestore.providers.base import (  # noqa: F401
    OfflineStore,
    OnlineStore,
    Provider,
    VectorStore,
    get_provider,
    register_factory,
)
from embeddinghub_tpu_torch.featurestore.providers import memory_online  # noqa: F401
from embeddinghub_tpu_torch.featurestore.providers import sqlite_offline  # noqa: F401
from embeddinghub_tpu_torch.featurestore.providers import engine_vector  # noqa: F401
from embeddinghub_tpu_torch.featurestore.providers import redis_online  # noqa: F401
from embeddinghub_tpu_torch.featurestore.providers import sqlite_online  # noqa: F401
from embeddinghub_tpu_torch.featurestore.providers import pandas_offline  # noqa: F401
