"""Registrations completed in the window over the window's wall time."""


def read(run):
    return 60.0 * run["registrations"] / run["window_s"]
