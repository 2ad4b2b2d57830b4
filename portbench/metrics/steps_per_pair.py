"""Executed optimizer steps a registration (``CascadeResult.steps`` summed
over stages and levels), over the window's registrations."""


def read(run):
    steps = [sum(per.values()) for c in run["calls"] for per in c["steps"]]
    return sum(steps) / len(steps) if steps else None
