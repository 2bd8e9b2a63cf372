"""The graph search's queries answered a second, over the calls made with no
profiler running (``run.untraced``): their queries over the seconds from
the first one's start to the last one's return."""


def read(run):
    calls = run.untraced
    if not calls:
        return None
    span = max(c.t_ret for c in calls) - min(c.t_call for c in calls)
    return sum(len(c.asked) for c in calls) / span if span > 0 else None
