"""Feature-store capability layer.

A compact, engine-centric rebuild of the Featureform control plane
(reference: the Go services under ``metadata/``, ``coordinator/``,
``serving/``, ``provider/`` and the Python client in
``client/src/featureform/``).  The same resource/variant model, task
orchestration, provider abstraction and serving semantics — with this
package's vector engine slotted in where Redis/Pinecone vector stores
sat (``provider/online.go:55-64``).

Modules:
    resources   — typed resource/variant dataclasses + equivalence
    metadata    — MetadataStore (CRUD, variants, deletion staging)
    registry    — Registrar builders + Client.apply()
    scheduling  — TaskMetadata / TaskRunMetadata / TaskDAG
    coordinator — poll scheduler + task executors
    providers/  — OnlineStore / OfflineStore / VectorStore interfaces
                  + local implementations + the engine vector store
    serving     — feature serving, training sets, Nearest
    ffsync      — lockers
    fferr       — error taxonomy
    search      — resource full-text search
"""

from embeddinghub_tpu_torch.featurestore.registry import (  # noqa: F401
    Client,
    Registrar,
    global_registrar,
)
from embeddinghub_tpu_torch.featurestore.class_api import (  # noqa: F401
    Bool,
    ColumnSelection,
    Datetime,
    Embedding,
    Feature,
    Float32,
    Float64,
    Int,
    Int32,
    Int64,
    Label,
    String,
    Timestamp,
    Variants,
    entity,
)
from embeddinghub_tpu_torch.featurestore.executor_credentials import (  # noqa: F401
    AWSAssumeRoleCredentials,
    AWSStaticCredentials,
    BasicCredentials,
    DatabricksCredentials,
    EMRCredentials,
    GCPCredentials,
    GlueCatalog,
    KerberosCredentials,
    SparkCredentials,
    SparkFlags,
)
