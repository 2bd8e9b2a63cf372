"""Tracing / profiling.

The twin of ``embeddinghub_tpu/utils/tracing.py``, with the device's
profiler in place of the JAX one:

  * :func:`span` times a block and logs it through the feature store's
    structured ``LOGGER`` (poor-man's tracing bound to its request ids,
    as the reference does);
  * :func:`profile` records a ``torch.profiler`` trace (host and, on a
    CUDA host, device timelines) and writes it into a directory as a
    Chrome trace (``chrome://tracing``, Perfetto);
  * :func:`annotate` names a region in that trace and, on a CUDA host, in
    NVTX.

Profiling is best effort, as in the reference: a profiler that cannot
start or a directory that cannot be written leaves the profiled block to
run as if unprofiled.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity

from embeddinghub_tpu_torch.featurestore.logging import LOGGER


@contextlib.contextmanager
def span(name: str, **fields):
    """Log a timed span (start not logged; completion carries ms)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        LOGGER.info(
            "span", span=name, ms=round((time.perf_counter() - t0) * 1e3, 3), **fields
        )


@contextlib.contextmanager
def profile(log_dir: str):
    """Record a ``torch.profiler`` trace of the block: CPU activity, and
    CUDA activity when CUDA is available.  On exit the trace is written to
    ``log_dir/torch_trace.<pid>.<ns>.json`` (Chrome trace format).  No
    trace, and no error, if the profiler or the directory fails."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        prof = torch.profiler.profile(activities=activities)
        prof.start()
    except Exception:  # noqa: BLE001 — profiling is best-effort
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.stop()
                os.makedirs(log_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    log_dir, f"torch_trace.{os.getpid()}.{time.time_ns()}.json"))
            except Exception:  # noqa: BLE001
                pass


@contextlib.contextmanager
def annotate(name: str):
    """Named region: a ``record_function`` range in :func:`profile`'s
    trace and, on a CUDA host, an NVTX range."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
