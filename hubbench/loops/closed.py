"""A closed loop: ``clients`` threads, each sending its next call of
``batch`` queries, drawn without repeats from the query pool, once its
last call has returned.  Each client draws from its own generator, seeded
by the run's seed and its number, so one seed gives every client the same
batches in the same order.  The threads that warm up are the threads that
are measured (a thread's first products set up its own library handles).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np

# A call still running this long after the window closed never came.
LATE_S = 60.0


@dataclass
class Call:
    client: int
    t_call: float  # perf_counter seconds around the call
    t_ret: float
    s0: float  # the index search's span inside the call
    s1: float
    asked: np.ndarray  # pool indices of the batch's queries
    answer: tuple | None  # the keys of each query, nearest first; None: failed
    error: str | None = None


class Loop:
    def __init__(self, op, traffic: dict, pool: np.ndarray, seed: int):
        """``op(queries) -> (answer, s0, s1)``: one call of the system under
        test, with the span of its index search."""
        self.op = op
        self.clients = int(traffic["clients"])
        self.batch = int(traffic["batch"])
        self.warmup_calls = int(traffic["warmup_calls"])
        self.pool = pool
        self.seed = seed
        self._ready = threading.Barrier(self.clients + 1)
        self._go = threading.Event()
        self._t_end = 0.0
        self._calls: list[list[Call]] = [[] for _ in range(self.clients)]
        self._in_flight: list[int] = [0] * self.clients
        self._threads: list[threading.Thread] = []
        self.warm_errors: list[str] = []

    def _client(self, c: int) -> None:
        rng = np.random.default_rng([self.seed, c])
        try:
            for _ in range(self.warmup_calls):
                self.op(self.pool[rng.choice(len(self.pool), self.batch, replace=False)])
        except Exception as exc:  # noqa: BLE001 -- reported as the run's failure
            self.warm_errors.append(f"client {c} warm-up: {exc!r}")
        self._ready.wait()
        self._go.wait()
        if self.warm_errors:
            return
        while time.perf_counter() < self._t_end:
            asked = rng.choice(len(self.pool), self.batch, replace=False)
            queries = self.pool[asked]
            self._in_flight[c] = len(asked)
            t0 = time.perf_counter()
            try:
                answer, s0, s1 = self.op(queries)
                err = None
            except Exception as exc:  # noqa: BLE001 -- counted as failed
                answer, s0, s1, err = None, t0, t0, repr(exc)
            t1 = time.perf_counter()
            self._in_flight[c] = 0
            if answer is not None:
                # tuples of strings, which the collector stops tracking, so
                # that the answers kept for the check add no work to its
                # full passes inside the window
                answer = tuple(map(tuple, answer))
            self._calls[c].append(Call(c, t0, t1, s0, s1, asked, answer, err))
            if err is not None:
                return

    def warm(self) -> None:
        """Start the clients and return once every one has warmed up."""
        self._threads = [threading.Thread(target=self._client, args=(c,), daemon=True,
                                          name=f"hubbench-client-{c}")
                         for c in range(self.clients)]
        for t in self._threads:
            t.start()
        self._ready.wait()
        if self.warm_errors:
            raise RuntimeError("; ".join(self.warm_errors))

    def calls(self) -> list[Call]:
        """The calls returned so far, by start."""
        return sorted((r for rs in self._calls for r in list(rs)), key=lambda r: r.t_call)

    def measure(self, seconds: float, at=None) -> tuple[list[Call], int]:
        """Run the window: every client calls until ``seconds`` have passed,
        and the calls in flight then finish.  ``at``: ``(delay, fn)``, ``fn()``
        called once ``delay`` seconds into the window.  Returns the calls by
        start, and the queries of calls that never returned."""
        t0 = time.perf_counter()
        self._t_end = t0 + seconds
        self._go.set()
        if at is not None:
            time.sleep(max(0.0, t0 + at[0] - time.perf_counter()))
            at[1]()
        for t in self._threads:
            t.join(timeout=max(0.0, self._t_end + LATE_S - time.perf_counter()))
        lost = sum(self._in_flight[c] for c, t in enumerate(self._threads) if t.is_alive())
        return self.calls(), lost
