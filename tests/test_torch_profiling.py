"""The port's ``utils/profiling.py`` against the JAX package's, on the CPU:
``Throughput``'s keys and accounting (``tests/test_utils.py``'s case, both
packages on one fixed clock), ``trace`` as a profiler span, and
``device_trace``'s Chrome trace file."""
import json
import time

import pytest
import torch

from torchregister_tpu.utils.profiling import Throughput as JThroughput
from torchregister_tpu_torch.utils import Throughput, device_trace, trace


def test_torch_throughput_matches_jax(monkeypatch):
    monkeypatch.setattr(time, "perf_counter", lambda: 102.5)
    ours, theirs = Throughput(_t0=100.0), JThroughput(_t0=100.0)
    for t in (ours, theirs):
        t.add(voxels=1000, registrations=2)
        t.add(voxels=500)
    assert (ours.voxels_resampled, ours.registrations) == (1500, 2)
    rep, jrep = ours.report(), theirs.report()
    assert rep == jrep == {"seconds": 2.5, "registrations_per_min": 48.0,
                           "voxel_resamples_per_sec": 600.0}


def test_torch_throughput_accounting():
    t = Throughput()
    t.add(voxels=1000, registrations=2)
    t.add(voxels=500)
    time.sleep(0.01)
    rep = t.report()
    assert set(rep) == {"seconds", "registrations_per_min", "voxel_resamples_per_sec"}
    assert rep["seconds"] >= 0.01
    assert rep["registrations_per_min"] > 0 and rep["voxel_resamples_per_sec"] > 0


def test_torch_trace_is_a_profiler_span():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace("unit-test-region"):
            x = torch.ones(4, 4) * 2
    assert float(x.sum()) == 32.0
    assert "unit-test-region" in {e.name for e in prof.events()}


def test_torch_trace_passes_exceptions():
    with pytest.raises(KeyError):
        with trace("raises"):
            raise KeyError("inside")


def test_torch_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path / "logs")) as prof:
        with trace("traced-region"):
            torch.ones(8).sum()
    files = list((tmp_path / "logs").glob("trace_*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "traced-region" in names
    assert prof is not None
