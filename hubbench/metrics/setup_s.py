"""Set-up seconds: from the process's start to the window's first call
(imports, the kernels' build or load, the data, the store's fill, its first
sync, the warm-up)."""


def read(run):
    return run.setup_s
