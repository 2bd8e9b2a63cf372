"""Metric readers, one module a metric, found by the metric's name in
BENCHMARK.json.  Each has ``read(run) -> float | None`` (``run``:
``run.Run``); ``None`` where it finds nothing to read, and the metric is
then left out of the result.  A reader on the host's clock reads
``run.untraced``, the calls made with no profiler running.  A reader may also have ``capture(version)``,
called once the window has closed while the store still exists; what it
returns is ``run.captured[<metric>]``."""
