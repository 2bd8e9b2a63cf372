"""Mean recall@10 of every answered query against the reference's exact
top-10 (check.py), scored once the window has closed."""


def read(run):
    return run.recall
