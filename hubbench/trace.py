"""The traced window: ``torch.profiler`` over the first seconds of the
measured window (``run.py`` says how many), reduced once the window has
closed to the device's busy time, its kernels by name and its idle gaps by
what the host was doing.

The profiler records the device's activity for the whole process (every
client thread's launches), but host ranges only of the thread that started
it, so the host side comes from the loop's own clock: each call's span
(``store``) and the index search inside it (``index.search``).  A marker
range taken on both clocks aligns them.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

_MARK = "hubbench.mark"
TOP = 10  # entries of each breakdown list


@dataclass
class Trace:
    """What the traced window shows, on the loop's clock (seconds)."""

    window_s: float
    busy_s: float  # the union of device activity within the window
    device_s: float  # the sum of device activity within the window
    device_ops: list = field(default_factory=list)  # [[name, seconds]] by time
    idle_gaps: list = field(default_factory=list)  # [[host label, seconds]] by time
    calls: list = field(default_factory=list)  # the calls of the window


def _short(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_:.]", "_", name)[:64]


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    return int(fn()) if fn is not None else int(getattr(ev, f"{what}_us")() * 1000)


class Tracer:
    def __init__(self):
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._mark_ns = 0

    def start(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.start()
        with record_function(_MARK):
            self._mark_ns = time.perf_counter_ns()

    def stop(self) -> None:
        """Stop tracing; the clients may still be calling."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()

    def reduce(self, calls) -> Trace:
        """The stopped trace from the first of ``calls`` (the loop's records
        when the trace stopped: ``t_call``, ``t_ret``, ``s0``, ``s1``) to
        the last one's return.  Run once the window has closed: it holds
        the interpreter for seconds."""
        t1 = max((c.t_ret for c in calls), default=0.0)
        t0 = min((c.t_call for c in calls), default=t1)
        events = self._prof.profiler.kineto_results.events()
        offset = None
        spans, names = [], []
        for ev in events:
            if ev.name() == _MARK and offset is None:
                offset = _ns(ev, "start") - self._mark_ns
            elif ev.device_type() == torch.autograd.DeviceType.CUDA:
                start = _ns(ev, "start")
                spans.append((start, start + _ns(ev, "duration")))
                names.append(ev.name())
        if offset is None:
            raise RuntimeError("the profiler's trace lost its marker range")
        lo, hi = int(t0 * 1e9), int(t1 * 1e9)
        arr = (np.asarray(spans, dtype=np.int64).reshape(-1, 2) - offset).clip(lo, hi)
        dur = (arr[:, 1] - arr[:, 0]) / 1e9
        by_name: dict[str, float] = {}
        for name, d in zip(names, dur):
            if d > 0:
                by_name[_short(name)] = by_name.get(_short(name), 0.0) + float(d)
        busy, gaps = _union(arr[dur > 0], lo, hi)
        return Trace(
            window_s=t1 - t0, busy_s=busy / 1e9, device_s=float(dur.sum()),
            device_ops=sorted(([n, s] for n, s in by_name.items()), key=lambda e: -e[1])[:TOP],
            idle_gaps=_label_gaps(gaps, calls)[:TOP],
            calls=list(calls))


def _union(spans: np.ndarray, lo: int, hi: int):
    """Busy nanoseconds of the spans within ``[lo, hi]``, and the idle gaps
    ``[G, 2]`` between them."""
    if len(spans) == 0:
        return 0, np.asarray([[lo, hi]], dtype=np.int64)
    spans = spans[np.argsort(spans[:, 0], kind="stable")]
    reach = np.maximum.accumulate(spans[:, 1])
    # a new busy stretch starts where a span begins past all that came before
    new = np.ones(len(spans), dtype=bool)
    new[1:] = spans[1:, 0] > reach[:-1]
    starts = spans[new, 0]
    ends = np.append(reach[np.flatnonzero(new)[1:] - 1], reach[-1])
    busy = int((ends - starts).sum())
    gap_lo = np.concatenate([[lo], ends])
    gap_hi = np.concatenate([starts, [hi]])
    keep = gap_hi > gap_lo
    return busy, np.stack([gap_lo[keep], gap_hi[keep]], axis=1)


def _label_gaps(gaps: np.ndarray, calls) -> list:
    """Idle seconds by what the host was doing at each gap's middle:
    ``index.search`` where some client was inside the index's search,
    else ``store`` where some client was inside ``nearest_batch``, else
    ``none`` (the clients between calls)."""
    mid = (gaps[:, 0] + gaps[:, 1]) / 2e9
    length = (gaps[:, 1] - gaps[:, 0]) / 1e9
    out = {}
    in_search = np.zeros(len(mid), dtype=bool)
    in_store = np.zeros(len(mid), dtype=bool)
    if calls:
        c = np.asarray([(r.t_call, r.t_ret, r.s0, r.s1) for r in calls])
        step = max(1, (1 << 24) // len(c))
        for s in range(0, len(mid), step):
            m = mid[s:s + step, None]
            in_search[s:s + step] = ((c[None, :, 2] <= m) & (m < c[None, :, 3])).any(1)
            in_store[s:s + step] = ((c[None, :, 0] <= m) & (m < c[None, :, 1])).any(1)
    for label, sel in (("index.search", in_search), ("store", in_store & ~in_search),
                       ("none", ~in_store & ~in_search)):
        if sel.any():
            out[label] = float(length[sel].sum())
    return sorted(([n, s] for n, s in out.items()), key=lambda e: -e[1])
