"""EmbeddingHub gRPC server on the PyTorch port.

The twin of ``embeddinghub_tpu/service/server.py``: the same 9 RPCs plus
``BatchNearestNeighbor``, on the reference's proto (the port's copy of it,
``service/proto``), with the same status codes (spaces use version
"initial"; NearestNeighbor takes a key XOR an embedding and drops the key
itself from a keyed answer; writes to a frozen space fail with
FAILED_PRECONDITION).  Concurrent NearestNeighbor
RPCs go through :class:`QueryBatcher` (the port's copy of the reference's),
which fuses them into one ``nearest_batch`` per version.

The store lives on one ``torch.device``.  With a data directory it is
persistent, as the reference's server is by default: every acknowledged
write is in a WAL before the RPC returns, and a restart on the same
directory recovers it (``store/persistence.py``).

Run:  python -m embeddinghub_tpu_torch.service.server [host:port] [data_dir] \
          [--data-dir DIR] --device cuda
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
from concurrent import futures as cf

import grpc
import numpy as np
import torch

from embeddinghub_tpu_torch.ops import fused_topk
from embeddinghub_tpu_torch.service.batcher import QueryBatcher
from embeddinghub_tpu_torch.service.interceptors import make_server
from embeddinghub_tpu_torch.service.proto import embedding_store_pb2 as pb
from embeddinghub_tpu_torch.service.proto import embedding_store_pb2_grpc as pb_grpc
from embeddinghub_tpu_torch.service.spawn import LAUNCHES_TAG
from embeddinghub_tpu_torch.store import errors as store_errors
from embeddinghub_tpu_torch.store.hub import EmbeddingHub
from embeddinghub_tpu_torch.store.space import DEFAULT_VERSION
from embeddinghub_tpu_torch.utils.channels import add_server_port
from embeddinghub_tpu_torch.utils.config import get_config
from embeddinghub_tpu_torch.utils.device import resolve as resolve_device

_CODE_MAP = {
    "NOT_FOUND": grpc.StatusCode.NOT_FOUND,
    "ALREADY_EXISTS": grpc.StatusCode.ALREADY_EXISTS,
    "FAILED_PRECONDITION": grpc.StatusCode.FAILED_PRECONDITION,
    "INVALID_ARGUMENT": grpc.StatusCode.INVALID_ARGUMENT,
    "INTERNAL": grpc.StatusCode.INTERNAL,
}

_MULTISET_FLUSH = 4096  # records buffered per space before a batched index add


class EmbeddingHubService(pb_grpc.EmbeddingHubServicer):
    def __init__(self, store: EmbeddingHub, config=None):
        self._store = store
        self._config = config or get_config()
        self._batcher = QueryBatcher(
            window_ms=self._config.query_batch_window_ms,
            max_batch=self._config.max_query_batch,
        )

    # ------------------------------------------------------------- plumbing

    def _version(self, space: str, context):
        version = self._store.get_version(space, DEFAULT_VERSION)
        if version is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "Not found")
        return version

    def _abort_store_error(self, context, err: store_errors.EmbeddingHubError):
        if isinstance(err, store_errors.ImmutableVersionError):
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          "Cannot write to immutable space")
        context.abort(_CODE_MAP.get(err.grpc_code, grpc.StatusCode.INTERNAL), str(err))

    @staticmethod
    def _drop_self(keys, key: str, num: int) -> list[str]:
        keys = list(keys)
        if key in keys:
            keys.remove(key)
        elif len(keys) > num:
            keys.pop()
        return keys

    # --------------------------------------------------------------- spaces

    def CreateSpace(self, request, context):
        self._store.create_space(request.name, request.dims,
                                 self._config.default_metric)
        return pb.CreateSpaceResponse()

    def DeleteSpace(self, request, context):
        self._store.delete_space(request.name)
        return pb.DeleteSpaceResponse()

    def FreezeSpace(self, request, context):
        version = self._version(request.name, context)
        with version.lock:
            version.make_immutable()
        return pb.FreezeSpaceResponse()

    # ---------------------------------------------------------------- writes

    def Set(self, request, context):
        version = self._version(request.space, context)
        try:
            with version.lock:
                version.set(request.key, list(request.embedding.values))
        except store_errors.EmbeddingHubError as e:
            self._abort_store_error(context, e)
        return pb.SetResponse()

    def MultiSet(self, request_iterator, context):
        # Buffer per space and flush as batched index adds.
        buffers: dict[str, list[tuple[str, list[float]]]] = {}
        try:
            for request in request_iterator:
                version = self._version(request.space, context)
                buf = buffers.setdefault(request.space, [])
                buf.append((request.key, list(request.embedding.values)))
                if len(buf) >= _MULTISET_FLUSH:
                    with version.lock:
                        version.multiset(buf)
                    buf.clear()
            for space, buf in buffers.items():
                if buf:
                    version = self._version(space, context)
                    with version.lock:
                        version.multiset(buf)
        except store_errors.EmbeddingHubError as e:
            self._abort_store_error(context, e)
        return pb.MultiSetResponse()

    # ----------------------------------------------------------------- reads

    def Get(self, request, context):
        version = self._version(request.space, context)
        try:
            vec = version.get(request.key)
        except store_errors.EmbeddingHubError as e:
            self._abort_store_error(context, e)
        resp = pb.GetResponse()
        resp.embedding.values[:] = vec.tolist()
        return resp

    def MultiGet(self, request_iterator, context):
        for request in request_iterator:
            version = self._version(request.space, context)
            try:
                vec = version.get(request.key)
            except store_errors.EmbeddingHubError as e:
                self._abort_store_error(context, e)
            resp = pb.MultiGetResponse()
            resp.embedding.values[:] = vec.tolist()
            yield resp

    def Download(self, request, context):
        version = self._version(request.space, context)
        for key, vec in version.iterator():
            resp = pb.DownloadResponse()
            resp.key = key
            resp.embedding.values[:] = vec.tolist()
            yield resp

    # --------------------------------------------------------------- nearest

    def NearestNeighbor(self, request, context):
        version = self._version(request.space, context)
        has_key = request.key != ""
        has_vec = len(request.embedding.values) != 0
        if has_key and has_vec:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          "Key and embedding cannot both be set")
        if not has_key and not has_vec:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          "Key or embedding must be set")
        num = request.num
        try:
            if has_key:
                vector = version.get(request.key)
                fetch = num + 1
            else:
                vector = np.asarray(list(request.embedding.values), np.float32)
                if vector.shape[0] != version.dims:
                    raise store_errors.DimensionMismatchError(version.dims,
                                                              vector.shape[0])
                fetch = num
            keys = self._batcher.submit(version, vector, fetch).result()
        except store_errors.EmbeddingHubError as e:
            self._abort_store_error(context, e)
        if has_key:
            keys = self._drop_self(keys, request.key, num)
        resp = pb.NearestNeighborResponse()
        resp.keys[:] = list(keys)
        return resp

    def BatchNearestNeighbor(self, request, context):
        """A whole query batch in one round trip and one device dispatch."""
        version = self._version(request.space, context)
        has_keys = len(request.keys) > 0
        has_vecs = len(request.embeddings) > 0
        if has_keys == has_vecs:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          "Exactly one of keys or embeddings must be set")
        num = request.num
        try:
            if has_keys:
                queries = np.stack([version.get(k) for k in request.keys])
                fetch = num + 1
            else:
                queries = np.asarray([list(e.values) for e in request.embeddings],
                                     np.float32)
                if queries.ndim != 2 or queries.shape[1] != version.dims:
                    raise store_errors.DimensionMismatchError(
                        version.dims, queries.shape[-1] if queries.ndim else 0)
                fetch = num
            with version.lock:
                results = version.nearest_batch(queries, fetch)
        except store_errors.EmbeddingHubError as e:
            self._abort_store_error(context, e)
        resp = pb.BatchNearestNeighborResponse()
        for i, keys in enumerate(results):
            if has_keys:
                keys = self._drop_self(keys, request.keys[i], num)
            resp.results.add().keys[:] = list(keys)
        return resp

    def stop(self) -> None:
        self._batcher.stop()


def build_server(address: str, device: torch.device | str,
                 data_dir: str | None = None, config=None, max_workers: int = 32):
    """An unstarted server with a store on ``device``: opened from (or
    created in) ``data_dir``, or in memory without one.  Returns
    ``(server, service, port)``; ``port`` is the bound port (useful with
    ``host:0``)."""
    config = config or get_config()
    store = (EmbeddingHub.load_or_create(data_dir, engine=config.engine, device=device,
                                         config=config)
             if data_dir else
             EmbeddingHub.in_memory(engine=config.engine, device=device, config=config))
    service = EmbeddingHubService(store, config)
    server = make_server(cf.ThreadPoolExecutor(max_workers=max_workers))
    pb_grpc.add_EmbeddingHubServicer_to_server(service, server)
    try:
        from grpc_health.v1 import health, health_pb2_grpc

        health_pb2_grpc.add_HealthServicer_to_server(health.HealthServicer(), server)
    except ImportError:
        pass  # the health service is optional, as in the reference
    port = add_server_port(server, address)
    return server, service, port


def run_server(address: str, device: torch.device | str,
               data_dir: str | None = None) -> None:
    """Serve until SIGTERM or SIGINT, then print the launches of each
    kernel in this process (``service/spawn.py`` reads them)."""
    server, service, _ = build_server(address, device, data_dir)
    server.start()
    signal.signal(signal.SIGTERM, lambda *_: server.stop(0))
    print(f"Server listening on {address} (device {device}, data "
          f"{data_dir or 'in memory'})", flush=True)
    try:
        server.wait_for_termination()
    finally:
        service.stop()
        print(f"{LAUNCHES_TAG}{json.dumps(fused_topk.LAUNCHES)}", flush=True)


def main(argv: list[str] | None = None) -> None:
    cfg = get_config()
    ap = argparse.ArgumentParser(
        prog="embeddinghub_tpu_torch.service.server",
        description="EmbeddingHub gRPC server on PyTorch, with a persistent "
        "store in a data directory.",
    )
    ap.add_argument("address", nargs="?", default=f"{cfg.host}:{cfg.port}",
                    help="listen address (default %(default)s)")
    ap.add_argument("data_dir_pos", nargs="?", default=None,
                    help="data directory (positional, as the reference takes it)")
    ap.add_argument("--data-dir", dest="data_dir", default=None,
                    help=f"data directory (default {cfg.data_dir})")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the store (default %(default)s); "
                    "a CUDA device that is not there is an error")
    ns = ap.parse_args(argv if argv is not None else sys.argv[1:])
    run_server(ns.address, resolve_device(ns.device),
               ns.data_dir or ns.data_dir_pos or cfg.data_dir)


if __name__ == "__main__":
    main()
