"""``op: nearest_batch``: ``Version.nearest_batch(queries, k)``, the store's
batched search (keys nearest first), with the span of the index's search
inside each call on the calling thread's clock."""

from __future__ import annotations

import threading
import time

import numpy as np

from hubbench import check, reference


class Op:
    def __init__(self, version, traffic: dict, config: dict):
        self.version = version
        self.index = version.index
        self.k = int(traffic["k"])
        self._local = threading.local()
        search = self.index.search
        local = self._local

        def timed_search(*args, **kw):
            local.s0 = time.perf_counter()
            try:
                return search(*args, **kw)
            finally:
                local.s1 = time.perf_counter()

        self.index.search = timed_search

    def __call__(self, queries):
        answer = self.version.nearest_batch(queries, self.k)
        return answer, self._local.s0, self._local.s1


def score(answered: list, rows, pool, config: dict, traffic: dict):
    k = int(traffic["k"])
    truth, _ = reference.exact_topk(rows, pool, k, config["metric"])
    if answered:
        asked = np.concatenate([c.asked for c in answered])
        got = check.answer_rows([a for c in answered for a in c.answer], k)
        got_s = check.score_answers(rows, pool, asked, got, config["metric"])
        hit = check.hits(got_s, truth, asked)
        wrong_order = check.misordered_share(got_s, float(config["order_rounding"]))
    else:
        hit, wrong_order = np.zeros(0), 0.0
    miss = check.miss_rate(hit, k)
    numbers = {"miss_at_10": miss, "misordered_share": wrong_order}
    return numbers, (1.0 - miss if hit.size else None)

