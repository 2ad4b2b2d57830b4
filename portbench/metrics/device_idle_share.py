"""Share of the traced stretch in which no kernel, copy or fill ran on the
card (the union of device intervals)."""


def read(run):
    tr = (run.get("stretch") or {}).get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
