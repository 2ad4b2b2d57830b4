"""Share of a batch's pair-steps that were masked (pairs already stopped):
the window's step replays times the pairs a replay steps, less the pairs'
executed steps, over the former."""


def read(run):
    replays = sum(run["replays"].values()) * run["pairs_per_replay"]
    if run["pairs_per_replay"] < 2 or not replays:
        return None
    steps = sum(sum(per.values()) for c in run["calls"] for per in c["steps"])
    return 100.0 * (replays - steps) / replays
