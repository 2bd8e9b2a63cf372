"""Python SDK client for the EmbeddingHub gRPC service, without jax.

The twin of ``embeddinghub_tpu/sdk/client.py`` (which cannot be imported
where jax is missing: its package ``__init__`` pulls in the offline index
and, through it, jax).  Same constructor, same methods
(``create_space``/``delete_space``/``freeze_space``/``set``/``get``/
``multiset``/``multiget``/``nearest_neighbor``/``nearest_neighbor_batch``/
``download``), same ``wait=False`` futures, same ``TypeError`` on writes to
a frozen space.  It talks to either package's server: the wire format is
the reference's proto, of which the port keeps its own copy.
"""

from __future__ import annotations

import concurrent.futures
from collections.abc import Mapping

import grpc

from embeddinghub_tpu_torch.service.proto import embedding_store_pb2 as pb
from embeddinghub_tpu_torch.service.proto import embedding_store_pb2_grpc as pb_grpc
from embeddinghub_tpu_torch.utils.channels import make_channel


class EmbeddingHubClient:
    @staticmethod
    def grpc_channel(
        host: str = "0.0.0.0",
        port: int = 7462,
        insecure: bool = True,
        cert_path: str | None = None,
    ) -> grpc.Channel:
        return make_channel(host, port, insecure=insecure, cert_path=cert_path)

    def __init__(
        self,
        grpc_channel=None,
        host: str = "0.0.0.0",
        port: int = 7462,
        insecure: bool = True,
        cert_path: str | None = None,
    ):
        self._channel = (
            grpc_channel
            if grpc_channel is not None
            else EmbeddingHubClient.grpc_channel(host, port, insecure, cert_path)
        )
        self._stub = pb_grpc.EmbeddingHubStub(self._channel)

    def close(self):
        """Close the underlying channel."""
        return self._channel.close()

    # ---------------------------------------------------------------- spaces

    def create_space(self, name, dims, wait: bool = True):
        """Create a space (a table of embeddings with ``dims`` dimensions).
        Returns a future when ``wait=False``."""
        req = pb.CreateSpaceRequest(name=str(name), dims=dims)
        future = self._stub.CreateSpace.future(req)
        return future.result() if wait else future

    def delete_space(self, name, wait: bool = True):
        """Delete a space and all its contents."""
        req = pb.DeleteSpaceRequest(name=str(name))
        future = self._stub.DeleteSpace.future(req)
        return future.result() if wait else future

    def freeze_space(self, name, wait: bool = True):
        """Make a space immutable; irreversible."""
        req = pb.FreezeSpaceRequest(name=str(name))
        future = self._stub.FreezeSpace.future(req)
        return future.result() if wait else future

    # ---------------------------------------------------------------- writes

    def set(self, space, key, embedding, wait: bool = True):
        """Store ``embedding`` (list of floats) under ``key``.

        Writes to a frozen space raise TypeError, matching the reference
        SDK's translation of FAILED_PRECONDITION."""
        req = pb.SetRequest(space=str(space), key=str(key))
        req.embedding.values[:] = embedding
        future = self._stub.Set.future(req)
        if wait:
            try:
                future.result()
            except grpc.RpcError as e:
                if e.code() == grpc.StatusCode.FAILED_PRECONDITION:
                    raise TypeError(e.details())
                raise
        return future

    def multiset(self, space, embedding_tuples):
        """Stream many (key, embedding) pairs into ``space`` in one RPC.
        ``embedding_tuples`` is a mapping or an iterable of pairs."""
        if isinstance(embedding_tuples, Mapping):
            embedding_tuples = embedding_tuples.items()

        def request_iter():
            for key, embedding in embedding_tuples:
                req = pb.MultiSetRequest(space=str(space), key=str(key))
                req.embedding.values[:] = embedding
                yield req

        try:
            self._stub.MultiSet(request_iter())
        except grpc.RpcError as e:
            if e.code() == grpc.StatusCode.FAILED_PRECONDITION:
                raise TypeError(e.details())
            raise

    # ----------------------------------------------------------------- reads

    def get(self, space, key, wait: bool = True):
        """Fetch the embedding stored under ``key``."""
        req = pb.GetRequest(space=str(space), key=str(key))
        future = self._stub.Get.future(req)
        wrapped = FutureTransformWrapper(future, lambda r: r.embedding.values)
        return wrapped.result() if wait else wrapped

    def multiget(self, space, keys):
        """Fetch many embeddings by key (bidirectional stream)."""

        def request_iter():
            for key in keys:
                yield pb.MultiGetRequest(space=str(space), key=str(key))

        for resp in self._stub.MultiGet(request_iter()):
            yield resp.embedding.values

    def nearest_neighbor_batch(self, space, num, keys=None, embeddings=None):
        """Batched nearest neighbors in ONE round trip (extension beyond
        the reference SDK): pass either ``keys`` (self-excluded) or
        ``embeddings``; returns a list of key lists."""
        req = pb.BatchNearestNeighborRequest(space=str(space), num=num)
        if keys is not None:
            req.keys[:] = [str(k) for k in keys]
        if embeddings is not None:
            for e in embeddings:
                req.embeddings.add().values[:] = list(e)
        resp = self._stub.BatchNearestNeighbor(req)
        return [list(r.keys) for r in resp.results]

    def download(self, space):
        """Iterate all (key, embedding) pairs in a space."""
        req = pb.DownloadRequest(space=str(space))
        for resp in self._stub.Download(req):
            yield (resp.key, resp.embedding.values)

    # --------------------------------------------------------------- nearest

    def nearest_neighbor(self, space, num, key=None, embedding=None, wait=True):
        """``num`` nearest neighbors of a stored ``key`` XOR a raw
        ``embedding``; returns keys nearest-first."""
        emb = None
        if embedding is not None and not isinstance(embedding, pb.Embedding):
            emb = pb.Embedding(values=list(embedding))
        elif embedding is not None:
            emb = embedding
        req = pb.NearestNeighborRequest(
            space=str(space),
            key=str(key) if key is not None else None,
            embedding=emb,
            num=num,
        )
        future = self._stub.NearestNeighbor.future(req)
        wrapped = FutureTransformWrapper(future, lambda r: r.keys)
        return wrapped.result() if wait else wrapped


class FutureTransformWrapper:
    """A gRPC future whose ``result()`` is mapped through ``transform_fn``."""

    def __init__(self, future, transform_fn):
        self._future = future
        self._transform = transform_fn

    def __getattr__(self, attr):
        return getattr(self._future, attr)

    def result(self, timeout=None):
        return self._transform(self._future.result(timeout))

    def add_done_callback(self, fn):
        def wrapped(fut):
            inner = concurrent.futures.Future()
            inner.set_result(self._transform(fut.result()))
            fn(inner)

        self._future.add_done_callback(wrapped)
