"""An engine's optimizer step, run as it comes or captured once as a CUDA
graph and replayed (the port's counterpart of a jitted step).

The engines' loops (``engines/common.optimize_scan``, ``engines/flow.
flow_register``) hand every tensor their step reads or writes to
:func:`session` ``.static`` and run their steps through ``.run(step, n)``.
Outside a :func:`graphed` block, and for a level the cascade has not named,
the session is :data:`EAGER`: ``static`` returns its tensor and ``run`` calls
the step ``n`` times.

Inside ``graphed(graphs)`` (``engines/cascade.make_cascade_fn``'s calls on a
CUDA device), each level that the cascade names with :func:`level` gets its
:class:`StepGraph` from ``graphs``. Its ``static`` keeps one buffer a name,
allocated at the first call and copied into at each later call with the same
shape; a new shape, dtype or device allocates anew and drops the graph. Its
``run`` captures the step once and replays it:

- warm-up: two steps on a side stream (``torch.cuda.graph``'s rule; first
  launches set kernel attributes and fill host-side caches), after which
  every static buffer is restored, so the warm-up changes no result;
- capture into the memory pool the factory's graphs share (they replay one
  after another, never at once);
- the launches the capture counted (which ran nothing) are taken off the
  kernels' counters, and each replay batch adds them back times its
  replays (``native.add_launch_counts``).

A step must make no host read (``.item()``, a branch on a device value) and
no host-to-device copy: the capture raises, and nothing falls back to the
eager loop. A step's results live in the static buffers, so the engines
clone what they return.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable

import torch

from .. import native

WARMUP = 2  # eager steps on a side stream before a capture

_GRAPHS: contextvars.ContextVar = contextvars.ContextVar("step_graphs", default=None)
_LEVEL: contextvars.ContextVar = contextvars.ContextVar("step_level", default=None)


class Eager:
    """Each step as it comes; tensors stay the caller's."""

    graphed = False

    def static(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return t

    def statics(self, tensors: dict, prefix: str = "") -> dict:
        return dict(tensors)

    def run(self, step: Callable[[], None], n: int) -> None:
        for _ in range(n):
            step()


EAGER = Eager()


class StepGraph:
    """One level's static buffers and its captured step."""

    graphed = True

    def __init__(self, owner: "StepGraphs", name: str):
        self.owner, self.name = owner, name
        self.buffers: dict = {}
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches: dict = {}  # the kernels' launches of one replay
        self.captures = 0
        self.replays = 0

    def static(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The level's buffer ``name`` holding ``t``'s values."""
        buf = self.buffers.get(name)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype or (
                buf.device != t.device):
            buf = t.detach().clone()
            self.buffers[name] = buf
            self.graph = None  # new shapes capture anew
        else:
            with torch.no_grad():
                buf.copy_(t)
        return buf

    def statics(self, tensors: dict, prefix: str = "") -> dict:
        return {k: self.static(prefix + k, t) for k, t in tensors.items()}

    def run(self, step: Callable[[], None], n: int) -> None:
        if n <= 0:
            return
        if self.graph is None:
            self._capture(step)
        for _ in range(n):
            self.graph.replay()
        native.add_launch_counts(self.launches, n)
        self.replays += n

    def _capture(self, step: Callable[[], None]) -> None:
        bufs = list(self.buffers.values())
        saved = [b.detach().clone() for b in bufs]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                step()
        torch.cuda.current_stream().wait_stream(side)
        with torch.no_grad():
            for b, s in zip(bufs, saved):
                b.copy_(s)
        del saved
        graph = torch.cuda.CUDAGraph()
        before = native.launch_counts()
        with torch.cuda.graph(graph, pool=self.owner.pool()):
            step()
        after = native.launch_counts()
        self.launches = {k: after[k] - before.get(k, 0) for k in after
                         if after[k] != before.get(k, 0)}
        native.add_launch_counts(self.launches, -1)  # a capture runs nothing
        self.graph = graph
        self.captures += 1


class StepGraphs:
    """The step graphs of one cascade factory, one a named level, sharing
    one memory pool."""

    def __init__(self):
        self.levels: dict = {}
        self._pool = None

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def level(self, name: str) -> StepGraph:
        if name not in self.levels:
            self.levels[name] = StepGraph(self, name)
        return self.levels[name]

    def counts(self) -> dict:
        """``{level: [captures, replays]}``."""
        return {name: [g.captures, g.replays] for name, g in self.levels.items()}


@contextlib.contextmanager
def graphed(graphs: StepGraphs):
    """Run the levels named inside this block through ``graphs``."""
    token = _GRAPHS.set(graphs)
    try:
        yield graphs
    finally:
        _GRAPHS.reset(token)


@contextlib.contextmanager
def level(name: str):
    """Name the engine level run inside this block (the cascade's
    ``rigid/level0`` and so on)."""
    token = _LEVEL.set(name)
    try:
        yield
    finally:
        _LEVEL.reset(token)


def session():
    """The current level's :class:`StepGraph`, or :data:`EAGER`."""
    graphs, name = _GRAPHS.get(), _LEVEL.get()
    if graphs is None or name is None:
        return EAGER
    return graphs.level(name)
