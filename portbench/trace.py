"""The traced stretch of a run, reduced from ``torch.profiler``'s events.

The stretch is the profiled part of the window, a ``record_function`` span
of its own (:data:`STRETCH`) around whole calls. Device work is every kernel,
copy and fill in it; a device operation belongs to the program span (the
cascade's ``rigid/level0``, ..., ``flow/level2``, ``matrix/warp``,
``flow/warp``) in which the host launched it, found through its linked
correlation id (the host op that launched it); an operation linked to no
host op (a replayed CUDA graph's kernels) belongs to the span open when it
started. A level's loop ends with a host read of its stop state, which
waits for its steps, so little of a level's work runs inside the next span.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

from torch.autograd import DeviceType

STRETCH = "portbench/stretch"
OUTSIDE = "(no program span)"


def _spans(user, overlap: int = 8):
    """The name of the program span open at a host time (the latest that
    started), from the spans ``(start, end, name)``: one host thread's follow
    one another; threads that drive a device each overlap at most
    ``overlap`` of them."""
    user.sort()
    starts = [s for s, _, _ in user]

    def at(t):
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - overlap, -1), -1):
            if t < user[j][1]:
                return user[j][2]
        return OUTSIDE

    return at


def _union(intervals, lo, hi) -> tuple:
    """Length of the union of ``intervals`` clipped to ``[lo, hi]`` and the
    gaps between them ``(start, length)``."""
    busy, gaps, cur = 0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= cur:
            continue
        if s > cur:
            gaps.append((cur, s - cur))
            cur = s
        busy += e - cur
        cur = e
    if hi > cur:
        gaps.append((cur, hi - cur))
    return busy, gaps


def reduce(events) -> dict:
    """``window_s``, ``busy_s`` (the union of a card's device intervals,
    averaged over the cards), ``device_ops`` (the 10 device operations that
    took most time, seconds, summed over the cards), ``idle_gaps`` (idle
    seconds by the host span open when the card went idle, averaged over the
    cards, the 10 largest),
    ``by_span`` (``{span: {op: seconds}}``) and ``ops`` (``{op: seconds}``)
    of the stretch in ``events`` (``_KinetoEvent``s)."""
    user, host, device, stretch = [], {}, [], None
    for e in events:
        on_host = e.device_type() == DeviceType.CPU
        if on_host and e.is_user_annotation():
            name = e.name()
            if name == STRETCH:
                stretch = (e.start_ns(), e.end_ns())
            elif name.split("/")[0] in ("rigid", "affine", "flow", "matrix"):
                user.append((e.start_ns(), e.end_ns(), name))
        elif on_host:
            host[e.correlation_id()] = e.start_ns()
        elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            device.append((e.start_ns(), e.end_ns(), e.name(), e.linked_correlation_id(),
                           e.device_index()))
    if stretch is None:
        raise RuntimeError("the profile holds no stretch span")
    lo, hi = stretch
    span_at = _spans(user)
    ops, by_span = defaultdict(float), defaultdict(lambda: defaultdict(float))
    inside = defaultdict(list)
    for s, e, name, linked, card in device:
        if e <= lo or s >= hi:
            continue
        inside[card].append((s, e))
        dur = (min(e, hi) - max(s, lo)) * 1e-9
        ops[name] += dur
        by_span[span_at(host.get(linked, s))][name] += dur
    busy, idle = 0.0, defaultdict(float)
    for intervals in inside.values():
        b, gaps = _union(intervals, lo, hi)
        busy += b / len(inside)
        for start, length in gaps:
            idle[span_at(start)] += length * 1e-9 / len(inside)
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"window_s": (hi - lo) * 1e-9, "busy_s": busy * 1e-9, "device_ops": top(ops),
            "idle_gaps": top(idle), "ops": dict(ops),
            "by_span": {k: dict(v) for k, v in by_span.items()}}
