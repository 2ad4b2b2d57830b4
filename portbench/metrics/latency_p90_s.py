"""The 90th percentile (nearest rank) of the window's registrations, each
timed from its submission to the card's synchronize after it."""
import math


def read(run):
    lat = sorted(c["latency_s"] for c in run["calls"] for _ in c["pairs"])
    return lat[math.ceil(0.9 * len(lat)) - 1] if lat else None
