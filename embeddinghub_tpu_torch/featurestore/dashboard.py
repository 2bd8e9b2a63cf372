"""Dashboard HTTP backend.

Rebuild of reference ``metadata/dashboard/dashboard_metadata.go``: a
read-only HTTP/JSON API over metadata (resource listings, variants,
task runs, search, provider health) + a Prometheus ``/metrics``
endpoint.  stdlib http.server; no external web framework.

Endpoints:
    GET /data/<type>                  list resources of a type
    GET /data/<type>/<name>           variants of a resource
    GET /search?q=...                 full-text resource search
    GET /tasks                        task runs (status, logs)
    GET /tasks/<run_id>               single-run drill-down (timing, logs)
    GET /lineage/<type>/<name>/<var>  upstream/downstream resource graph
    GET /diff/<type>/<name>?v1=&v2=   field-level diff of two variants
    GET /health                       provider health checks
    GET /metrics                      Prometheus text metrics
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from embeddinghub_tpu_torch.featurestore import health as health_mod
from embeddinghub_tpu_torch.featurestore.metrics import METRICS
from embeddinghub_tpu_torch.featurestore.resources import ResourceType
from embeddinghub_tpu_torch.featurestore.search import SearchIndex

_TYPE_ALIASES = {
    "features": ResourceType.FEATURE_VARIANT,
    "sources": ResourceType.SOURCE_VARIANT,
    "labels": ResourceType.LABEL_VARIANT,
    "training-sets": ResourceType.TRAINING_SET_VARIANT,
    "trainingsets": ResourceType.TRAINING_SET_VARIANT,
    "entities": ResourceType.ENTITY,
    "users": ResourceType.USER,
    "providers": ResourceType.PROVIDER,
    "models": ResourceType.MODEL,
}


def _resource_json(res) -> dict:
    return {
        "name": res.name,
        "variant": getattr(res, "variant", ""),
        "type": res.rtype.value,
        "description": res.description,
        "owner": res.owner,
        "status": res.status.value,
        "status_error": res.status_error,
        "tags": res.tags,
        "created_at": res.created_at,
    }


def _run_json(coordinator, run, with_logs: bool = False) -> dict:
    task = coordinator.tasks.task(run.task_id)
    out = {
        "run_id": run.run_id,
        "task_id": run.task_id,
        "name": run.name,
        "task": task.name,
        "type": task.task_type,
        "target": task.target.key(),
        "schedule": task.schedule,
        "status": run.status.value,
        "error": run.error,
        "attempts": run.attempts,
        "started_at": run.started_at,
        "ended_at": run.ended_at,
        "duration_s": (
            round(run.ended_at - run.started_at, 3)
            if run.started_at and run.ended_at
            else None
        ),
        "resume_id": run.resume_id,
    }
    if with_logs:
        out["logs"] = run.logs
    return out


def _lineage(metadata, coordinator, rid) -> dict:
    """Resource lineage graph around ``rid``: upstream BFS over
    ``dependencies()``, downstream BFS over ``dependents()`` — the
    data the reference dashboard's DAG view draws
    (``metadata/dashboard/dashboard_metadata.go`` lineage endpoints).
    Each node carries its latest task-run status when one exists."""
    latest_run: dict[str, dict] = {}
    if coordinator is not None:
        for run in coordinator.tasks.all_runs():
            task = coordinator.tasks.task(run.task_id)
            cur = latest_run.get(task.target.key())
            if cur is None or run.run_id > cur["run_id"]:
                latest_run[task.target.key()] = _run_json(coordinator, run)

    nodes: dict[str, dict] = {}
    edges: list[dict] = []
    edge_seen: set[tuple[str, str]] = set()

    def edge(a: str, b: str) -> None:
        if (a, b) not in edge_seen:
            edge_seen.add((a, b))
            edges.append({"from": a, "to": b})

    def node(r) -> str:
        key = r.rid().key()
        if key not in nodes:
            d = _resource_json(r)
            d["id"] = key
            d["latest_run"] = latest_run.get(key)
            nodes[key] = d
        return key

    start = metadata.get(rid)
    frontier = [start]
    seen = {start.rid().key()}
    while frontier:  # upstream
        res = frontier.pop()
        for dep in res.dependencies():
            parent = metadata.maybe_get(dep)
            if parent is None:
                continue
            edge(node(parent), node(res))
            if parent.rid().key() not in seen:
                seen.add(parent.rid().key())
                frontier.append(parent)
    frontier = [start]
    while frontier:  # downstream
        res = frontier.pop()
        for drid in metadata.dependents(res.rid()):
            child = metadata.maybe_get(drid)
            if child is None:
                continue
            edge(node(res), node(child))
            if child.rid().key() not in seen:
                seen.add(child.rid().key())
                frontier.append(child)
    node(start)
    return {"root": start.rid().key(), "nodes": list(nodes.values()),
            "edges": edges}


def make_handler(metadata, coordinator, search_index: SearchIndex):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, payload, status=200, content_type="application/json"):
            body = (
                json.dumps(payload, default=str).encode()
                if content_type == "application/json"
                else payload.encode()
            )
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            url = urlparse(self.path)
            parts = [p for p in url.path.split("/") if p]
            try:
                if url.path in ("/", "/index.html"):
                    import os

                    ui = os.path.join(
                        os.path.dirname(os.path.abspath(__file__)),
                        "dashboard_ui.html",
                    )
                    with open(ui, encoding="utf-8") as f:
                        self._send(f.read(), content_type="text/html")
                elif url.path == "/metrics":
                    self._send(METRICS.render(), content_type="text/plain")
                elif url.path == "/metrics.json":
                    self._send(METRICS.snapshot())
                elif url.path == "/health":
                    self._send(health_mod.check_all(metadata))
                elif url.path == "/search":
                    q = parse_qs(url.query).get("q", [""])[0]
                    self._send(search_index.search(q))
                elif url.path == "/tasks":
                    runs = []
                    if coordinator is not None:
                        runs = [
                            _run_json(coordinator, run, with_logs=True)
                            for run in coordinator.tasks.all_runs()
                        ]
                    self._send(runs)
                elif parts and parts[0] == "tasks" and len(parts) == 2:
                    # drill-down: one run with logs + timing (reference
                    # dashboard task-run detail view)
                    if coordinator is None:
                        self._send({"error": "no coordinator"}, 404)
                        return
                    run_id = int(parts[1])
                    match = [
                        r
                        for r in coordinator.tasks.all_runs()
                        if r.run_id == run_id
                    ]
                    if not match:
                        self._send({"error": f"no run {run_id}"}, 404)
                        return
                    detail = _run_json(coordinator, match[0], with_logs=True)
                    # sibling runs of the same task, for the retry history
                    detail["task_runs"] = [
                        _run_json(coordinator, r)
                        for r in coordinator.tasks.all_runs()
                        if r.task_id == match[0].task_id
                    ]
                    self._send(detail)
                elif parts and parts[0] == "lineage" and len(parts) >= 3:
                    from embeddinghub_tpu_torch.featurestore.resources import (
                        ResourceID,
                    )

                    rtype = _TYPE_ALIASES.get(parts[1])
                    if rtype is None:
                        self._send({"error": f"unknown type {parts[1]}"}, 404)
                        return
                    variant = parts[3] if len(parts) > 3 else ""
                    self._send(
                        _lineage(
                            metadata,
                            coordinator,
                            ResourceID(rtype, parts[2], variant),
                        )
                    )
                elif parts and parts[0] == "diff" and len(parts) == 3:
                    # field-level diff of two variants (the equivalence
                    # package's reporting, source_variant.go:337)
                    from embeddinghub_tpu_torch.featurestore.resources import (
                        ResourceID,
                    )

                    rtype = _TYPE_ALIASES.get(parts[1])
                    if rtype is None:
                        self._send({"error": f"unknown type {parts[1]}"}, 404)
                        return
                    qs = parse_qs(url.query)
                    v1 = qs.get("v1", [""])[0]
                    v2 = qs.get("v2", [""])[0]
                    a = metadata.get(ResourceID(rtype, parts[2], v1))
                    b = metadata.get(ResourceID(rtype, parts[2], v2))
                    self._send(
                        {
                            "name": parts[2],
                            "v1": v1,
                            "v2": v2,
                            "differing_fields": a.equiv_diff(b),
                        }
                    )
                elif parts and parts[0] == "data" and len(parts) == 2:
                    rtype = _TYPE_ALIASES.get(parts[1])
                    if rtype is None:
                        self._send({"error": f"unknown type {parts[1]}"}, 404)
                        return
                    self._send(
                        [_resource_json(r) for r in metadata.list_type(rtype)]
                    )
                elif parts and parts[0] == "data" and len(parts) == 3:
                    rtype = _TYPE_ALIASES.get(parts[1])
                    if rtype is None:
                        self._send({"error": f"unknown type {parts[1]}"}, 404)
                        return
                    self._send(
                        [
                            _resource_json(r)
                            for r in metadata.variants(rtype, parts[2])
                        ]
                    )
                else:
                    self._send({"error": "not found"}, 404)
            except Exception as e:  # noqa: BLE001
                self._send({"error": str(e)}, 500)

    return Handler


class DashboardServer:
    """Reference METADATA_HTTP_PORT default: 3001 (main.go)."""

    def __init__(self, metadata, coordinator=None, port: int = 3001):
        self.search = SearchIndex(metadata)
        self._httpd = ThreadingHTTPServer(
            ("0.0.0.0", port), make_handler(metadata, coordinator, self.search)
        )
        self.port = self._httpd.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)
