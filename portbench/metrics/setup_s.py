"""Seconds from the process's start to the window's: imports, the pool,
the kernels' build on a checkout's first run, the warm call's captures."""


def read(run):
    return run["setup_s"]
