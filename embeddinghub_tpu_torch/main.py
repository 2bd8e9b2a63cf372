"""Single-process composer — start every service in one process.

The port's twin of the JAX package's ``main.py`` (reference
``main/main.go:37-235``: one binary running API, metadata, coordinator,
dashboard HTTP, serving): here one process runs

  * the EmbeddingHub vector-store gRPC server   (default :7462)
  * the Feature serving gRPC server             (default :8081)
  * the metadata gRPC server                    (default :8080)
  * the dashboard/metadata HTTP API             (default :3001)
  * the coordinator poll loop

The store server keeps its store on ``--device`` (default ``cuda``; a
CUDA device that is not there is an error, never a move to the CPU).  An
engine vector store that ``--defs`` registers keeps its own ``device``
(``register_engine_vector_store(..., device=)``, ``cuda`` by default).
On SIGTERM or SIGINT every server and the coordinator stop, and the
process prints the launches of each kernel it made
(``service/spawn.LAUNCHES_TAG``) and exits 0.

Usage:
    python -m embeddinghub_tpu_torch.main [--defs definitions.py]
        [--store-port 7462] [--serving-port 8081] [--metadata-port 8080]
        [--http-port 3001] [--data-dir embedding_store.dat]
        [--metadata-db state.db] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import signal
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="embeddinghub-tpu")
    ap.add_argument("--defs", default=None, help="definitions .py to apply")
    ap.add_argument("--store-port", type=int, default=7462)
    ap.add_argument("--serving-port", type=int, default=8081)
    ap.add_argument("--metadata-port", type=int, default=8080)
    ap.add_argument("--http-port", type=int, default=3001)
    ap.add_argument("--data-dir", default="embedding_store.dat")
    ap.add_argument("--metadata-db", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the store server's store (default "
                    "%(default)s); a CUDA device that is not there is an error")
    args = ap.parse_args(argv)

    from embeddinghub_tpu_torch.utils.device import resolve

    device = resolve(args.device)

    import embeddinghub_tpu_torch.featurestore as ff
    from embeddinghub_tpu_torch.featurestore.dashboard import DashboardServer
    from embeddinghub_tpu_torch.featurestore.logging import LOGGER
    from embeddinghub_tpu_torch.featurestore.metadata import MetadataStore, SqliteStorage
    from embeddinghub_tpu_torch.featurestore.metadata_grpc import (
        build_server as build_metadata,
    )
    from embeddinghub_tpu_torch.featurestore.serving_grpc import (
        build_server as build_serving,
    )
    from embeddinghub_tpu_torch.ops import fused_topk
    from embeddinghub_tpu_torch.service.server import build_server as build_store
    from embeddinghub_tpu_torch.service.spawn import LAUNCHES_TAG

    metadata = (
        MetadataStore(SqliteStorage(args.metadata_db))
        if args.metadata_db
        else MetadataStore()
    )
    client = ff.Client(metadata=metadata)
    if args.defs:
        import runpy

        ff.global_registrar().reset()
        runpy.run_path(args.defs)
        client.apply(wait=False)

    store_server, store_service, _ = build_store(
        f"0.0.0.0:{args.store_port}", device, args.data_dir
    )
    store_server.start()
    LOGGER.info("embeddinghub grpc up", port=args.store_port)

    serving_server = build_serving(f"0.0.0.0:{args.serving_port}", client)
    serving_server.start()
    LOGGER.info("feature serving grpc up", port=args.serving_port)

    metadata_server = build_metadata(
        f"0.0.0.0:{args.metadata_port}", metadata, client.coordinator
    )
    metadata_server.start()
    LOGGER.info("metadata grpc up", port=args.metadata_port)

    dashboard = DashboardServer(
        metadata, client.coordinator, port=args.http_port
    )
    dashboard.start()
    LOGGER.info("dashboard http up", port=dashboard.port)

    client.coordinator.start()
    LOGGER.info("coordinator poll loop up")
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: store_server.stop(0))
    print(
        f"embeddinghub-tpu up: store=:{args.store_port} "
        f"serving=:{args.serving_port} metadata=:{args.metadata_port} "
        f"http=:{dashboard.port}",
        flush=True,
    )
    try:
        store_server.wait_for_termination()
    finally:
        client.coordinator.stop()
        dashboard.stop()
        serving_server.stop(0)
        metadata_server.stop(0)
        store_service.stop()
        print(f"{LAUNCHES_TAG}{json.dumps(fused_topk.LAUNCHES)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
