"""Key <-> row-id mapping with row reuse: the twin of
``embeddinghub_tpu/store/keymap.py``, with the same ``to_state`` format, so
``KeyMap.from_state`` accepts the reference's state.

The reference keeps bidirectional key<->label maps next to hnswlib
(``embeddingstore/index.h:30-32``; python twin
``offlinehub.py:144-184``).  Same idea here: indexes speak dense int
rows (good for packed HBM shards), the store speaks user keys.
"""

from __future__ import annotations

import numpy as np


class KeyMap:
    def __init__(self):
        self._key_to_row: dict[str, int] = {}
        self._row_to_key: dict[int, str] = {}
        self._next_row = 0
        self._free: list[int] = []

    def assign(self, key: str) -> int:
        """Row for ``key``, allocating one if new (re-add reuses the same
        row — matching hnswlib's re-addPoint-same-label update semantics)."""
        row = self._key_to_row.get(key)
        if row is not None:
            return row
        row = self._free.pop() if self._free else self._next_row
        if row == self._next_row:
            self._next_row += 1
        self._key_to_row[key] = row
        self._row_to_key[row] = key
        return row

    def assign_many(self, keys: list[str]) -> np.ndarray:
        return np.fromiter(
            (self.assign(k) for k in keys), dtype=np.int64, count=len(keys)
        )

    def row(self, key: str) -> int | None:
        return self._key_to_row.get(key)

    def key(self, row: int) -> str | None:
        return self._row_to_key.get(row)

    def keys_for_rows(self, rows: np.ndarray) -> list[str | None]:
        return [self._row_to_key.get(int(r)) for r in rows]

    def release(self, key: str) -> int | None:
        row = self._key_to_row.pop(key, None)
        if row is not None:
            del self._row_to_key[row]
            self._free.append(row)
        return row

    def __contains__(self, key: str) -> bool:
        return key in self._key_to_row

    def __len__(self) -> int:
        return len(self._key_to_row)

    def items(self):
        return self._key_to_row.items()

    # -------------------------------------------------------------- snapshot

    def to_state(self) -> dict:
        return {
            "keys": list(self._key_to_row.keys()),
            "rows": [int(r) for r in self._key_to_row.values()],
            "next_row": self._next_row,
            "free": list(self._free),
        }

    @classmethod
    def from_state(cls, state: dict) -> "KeyMap":
        km = cls()
        km._key_to_row = dict(zip(state["keys"], state["rows"]))
        km._row_to_key = {r: k for k, r in km._key_to_row.items()}
        km._next_row = state["next_row"]
        km._free = list(state["free"])
        return km
