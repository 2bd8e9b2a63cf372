"""Query batching front of the port's server: the JAX package's
``service/batcher.py``, copied so the port imports nothing of that package.

The reference serializes every RPC behind one global ``std::mutex``
(``server.h:65``; acquired in every handler, e.g. ``server.cc:175``), so
concurrent nearest-neighbor load executes strictly one scalar graph walk
at a time.  Here concurrent queries are *collected* into one device
dispatch.  A single worker drains the queue, groups requests by version
and fetch bucket, and runs one ``nearest_batch`` per group.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field


@dataclass
class _QueryItem:
    version: object
    vector: object  # np.ndarray [D]
    fetch: int      # how many neighbors to retrieve (incl. self-slot)
    future: Future = field(default_factory=Future)


class QueryBatcher:
    def __init__(self, window_ms: float = 2.0, max_batch: int = 1024):
        self._window_s = window_ms / 1000.0
        self._max_batch = max_batch
        self._q: queue.Queue[_QueryItem | None] = queue.Queue()
        self._thread = threading.Thread(
            target=self._run, name="query-batcher", daemon=True
        )
        self._stopped = False
        self._thread.start()

    def submit(self, version, vector, fetch: int) -> Future:
        item = _QueryItem(version, vector, fetch)
        self._q.put(item)
        return item.future

    def stop(self) -> None:
        self._stopped = True
        self._q.put(None)
        self._thread.join(timeout=5)

    # ------------------------------------------------------------------ loop

    def _run(self) -> None:
        import time

        while not self._stopped:
            first = self._q.get()
            if first is None:
                return
            batch = [first]
            deadline = time.monotonic() + self._window_s
            while len(batch) < self._max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._stopped = True
                    break
                batch.append(nxt)
            self._execute(batch)

    def _execute(self, batch: list[_QueryItem]) -> None:
        import numpy as np

        def _kbucket(fetch: int) -> int:
            b = 8
            while b < fetch:
                b *= 2
            return b

        # group by (version, fetch bucket): a k=500 straggler should not
        # inflate the fetch of a thousand k=10 queries
        groups: dict[tuple[int, int], list[_QueryItem]] = {}
        versions: dict[tuple[int, int], object] = {}
        for item in batch:
            gid = (id(item.version), _kbucket(item.fetch))
            groups.setdefault(gid, []).append(item)
            versions[gid] = item.version
        for gid, items in groups.items():
            version = versions[gid]
            try:
                queries = np.stack([np.asarray(i.vector, np.float32) for i in items])
                kmax = max(i.fetch for i in items)
                lock = getattr(version, "lock", None)
                if lock is not None:
                    with lock:
                        results = version.nearest_batch(queries, kmax)
                else:
                    results = version.nearest_batch(queries, kmax)
                for item, keys in zip(items, results):
                    item.future.set_result(keys[: item.fetch])
            except Exception as e:  # propagate to every waiter in the group
                for item in items:
                    if not item.future.done():
                        item.future.set_exception(e)
