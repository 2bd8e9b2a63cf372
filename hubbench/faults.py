"""Faults a search cell can have, planted under the timed path: each wraps
an index instance's ``search`` (``(queries, k, ...) -> (dist, ids)``, ids
``-1`` where empty) so that the rest of a run, the check included, runs as
it would.  A run with a fault planted has to come out not correct
(``test_hubbench_run.py`` at a small size, ``control.py --fault`` on the
card at the cell's own).

- ``stale``: a step that returns its state unchanged (the first answer,
  again for every later call);
- ``half``: half of each batch left out (its rows answered with nothing);
- ``altered``: one answer of each query altered where it is produced (the
  first row id moved to the next row);
- ``reversed``: each answer's order reversed (a broken merge or sort).
"""

from __future__ import annotations

import numpy as np


def _stale(search, index):
    first = {}

    def fn(queries, k, *a, **kw):
        first.setdefault("answer", search(queries, k, *a, **kw))
        return first["answer"]
    return fn


def _half(search, index):
    def fn(queries, k, *a, **kw):
        d, i = search(queries, k, *a, **kw)
        i = np.array(i, copy=True)
        i[len(i) // 2:] = -1
        return d, i
    return fn


def _altered(search, index):
    def fn(queries, k, *a, **kw):
        d, i = search(queries, k, *a, **kw)
        i = np.array(i, copy=True)
        i[:, 0] = (i[:, 0] + 1) % max(1, index.size)
        return d, i
    return fn


def _reversed(search, index):
    def fn(queries, k, *a, **kw):
        d, i = search(queries, k, *a, **kw)
        return np.array(d[:, ::-1]), np.array(i[:, ::-1])
    return fn


FAULTS = {"stale": _stale, "half": _half, "altered": _altered, "reversed": _reversed}


def plant(name: str, index) -> None:
    """Break ``index``'s search by the fault ``name``."""
    index.search = FAULTS[name](index.search, index)
