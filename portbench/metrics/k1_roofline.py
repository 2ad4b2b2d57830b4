"""K1's share of its roofline in the traced stretch: the least time of the
cascade's resampling work (``portbench/roofline.py``, counted a warp: each
warp reads its source and field once and writes its output once), over the
device time of K1's kernels. Against the H100 SXM's published 3.35 TB/s."""
from portbench.roofline import k1_cascade_least_s

KERNELS = ("sweep_fwd_kernel", "sweep_bwd_kernel")


def read(run):
    st = run.get("stretch") or {}
    tr = st.get("trace")
    if not tr:
        return None
    device_s = sum(s for name, s in tr["ops"].items() if any(k in name for k in KERNELS))
    if device_s <= 0:
        return None
    least = k1_cascade_least_s(run["recipe"], run["shape"], st["replays"], st["calls"],
                               run["pairs_per_replay"], run["pairs_per_call"])
    return 100.0 * least / device_s
