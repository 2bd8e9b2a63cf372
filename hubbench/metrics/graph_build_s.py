"""The graph's bulk build in seconds: the sum of ``HNSWIndex.build_seconds``,
the program's own counter, read once the window has closed."""


def capture(version):
    parts = getattr(version.index, "build_seconds", None)
    return float(sum(parts.values())) if parts else None


def read(run):
    return run.captured.get("graph_build_s")
