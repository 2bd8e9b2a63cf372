"""The table of peaks and the work of a search, computed from its shapes.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
power limit): int8 1,979 TOP/s, HBM 3.35 TB/s.
"""

from __future__ import annotations

INT8_OPS = 1979e12
HBM_BYTES = 3.35e12


def deep_search_least_s(batch: int, rows: int, dims: int) -> float:
    """The least time of one quantized search of ``batch`` queries over
    ``rows`` int8x2 rows: the larger of the int8 scan's ``2 B N D``
    operations at the int8 peak, and the hi and lo planes (``N D`` bytes
    each), the f32 row scales and the f32 queries read once at the memory
    peak.  It counts the work of the search, whatever implements it."""
    ops = 2.0 * batch * rows * dims
    nbytes = 2.0 * rows * dims + 4.0 * rows + 4.0 * batch * dims
    return max(ops / INT8_OPS, nbytes / HBM_BYTES)
