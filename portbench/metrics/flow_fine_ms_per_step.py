"""Device milliseconds of the finest flow level a step: the device time of
the operations launched inside its span in the traced stretch, over that
level's executed steps there."""


def read(run):
    st = run.get("stretch") or {}
    tr = st.get("trace")
    flow = sorted(k for k in st.get("steps", {}) if k.startswith("flow/"))
    if not tr or not flow:
        return None
    level = flow[-1]
    device_s = sum(tr["by_span"].get(level, {}).values())
    steps = st["steps"][level]
    return 1e3 * device_s / steps if device_s > 0 and steps else None
