"""The flat index's search, in ms a call on the calling thread's clock
(``FlatIndex.search``: the upload, the launches, the wait for the answer),
averaged over the calls made with no profiler running (``run.untraced``)."""


def read(run):
    calls = run.untraced
    if not calls:
        return None
    return sum(c.s1 - c.s0 for c in calls) / len(calls) * 1e3
