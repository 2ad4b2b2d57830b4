"""The traced stretch's reduction on made-up profiler events."""
import pytest
from torch.autograd import DeviceType

from portbench.trace import OUTSIDE, STRETCH, reduce


class Event:
    def __init__(self, name, start, end, device=DeviceType.CPU, user=False, corr=0, linked=0,
                 card=0):
        self._v = (name, start, end, device, user, corr, linked, card)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]

    def device_index(self):
        return self._v[7]


def kernel(name, start, end, linked=0, card=0):
    return Event(name, start, end, DeviceType.CUDA, linked=linked, card=card)


def test_reduce_one_card():
    ev = [Event(STRETCH, 0, 1000, user=True),
          Event("rigid/level0", 0, 400, user=True), Event("flow/level2", 500, 1000, user=True),
          Event("aten::add", 10, 20, corr=7),
          kernel("add", 300, 450, linked=7),  # launched in rigid/level0, runs past it
          kernel("sweep_fwd_kernel<float>", 600, 700),  # a graph's kernel: by its start
          kernel("sweep_bwd_kernel<float>", 650, 800),
          kernel("late", 990, 1200)]  # clipped to the stretch
    out = reduce(ev)
    assert out["window_s"] == pytest.approx(1000e-9)
    assert out["busy_s"] == pytest.approx((150 + 200 + 10) * 1e-9)
    assert out["by_span"]["rigid/level0"]["add"] == pytest.approx(150e-9)
    assert out["by_span"]["flow/level2"]["sweep_bwd_kernel<float>"] == pytest.approx(150e-9)
    idle = dict(out["idle_gaps"])
    assert idle["rigid/level0"] == pytest.approx(300e-9)  # 0-300
    # a gap goes to the span open when it starts: 450-600 began outside
    assert idle[OUTSIDE] == pytest.approx(150e-9)
    assert idle["flow/level2"] == pytest.approx(190e-9)  # 800-990


def test_reduce_averages_the_cards_and_overlapping_threads():
    ev = [Event(STRETCH, 0, 100, user=True),
          Event("flow/level2", 0, 90, user=True), Event("flow/level2", 5, 60, user=True),
          kernel("k", 0, 100, card=0), kernel("k", 70, 80, card=1)]
    out = reduce(ev)
    assert out["busy_s"] == pytest.approx((100 + 10) / 2 * 1e-9)
    assert out["ops"]["k"] == pytest.approx(110e-9)
    assert out["by_span"]["flow/level2"]["k"] == pytest.approx(110e-9)
