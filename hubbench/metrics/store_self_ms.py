"""The store's own ms a call: each call's time on the calling thread's
clock less the index search's inside it (the key lookups and the checks),
averaged over the calls made with no profiler running (``run.untraced``)."""


def read(run):
    calls = run.untraced
    if not calls:
        return None
    return sum((c.t_ret - c.t_call) - (c.s1 - c.s0) for c in calls) / len(calls) * 1e3
