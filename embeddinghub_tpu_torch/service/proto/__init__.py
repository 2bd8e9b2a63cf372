"""The EmbeddingHub wire format: the JAX package's
``service/proto/embedding_store.proto``, copied with its stubs so the port
imports nothing of that package.

``embedding_store_pb2`` registers the same serialized file (name
``embedding_store.proto``, package ``featureform.embedding.proto``) in the
default descriptor pool as the JAX package's copy does; adding an
identical file twice returns the same descriptor, so both packages load in
one process and speak one wire format.
"""

from embeddinghub_tpu_torch.service.proto import embedding_store_pb2  # noqa: F401
from embeddinghub_tpu_torch.service.proto import embedding_store_pb2_grpc  # noqa: F401
