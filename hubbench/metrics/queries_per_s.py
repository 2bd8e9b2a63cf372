"""Queries answered in the window over the window's seconds: from the first
call's start to the last call's return, every call of every client."""


def read(run):
    answered = sum(len(c.asked) for c in run.answered)
    return answered / run.window_s if answered and run.window_s > 0 else None
