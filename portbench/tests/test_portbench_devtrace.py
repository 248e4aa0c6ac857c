"""The trace reduction on made-up events."""

import pytest

from portbench import devtrace


class FakeEvent:
    def __init__(self, name, start, dur, device="CPU", note=False):
        self._n, self._s, self._d = name, start, dur
        self._dev, self._note = device, note

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return f"DeviceType.{self._dev}"

    def is_user_annotation(self):
        return self._note


class FakeProf:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "R", (), {"events": lambda self: events})()})()


def test_events_without_activity_type_sort_by_device_and_name():
    ev = devtrace.Events(FakeProf([
        FakeEvent("portbench.window", 0, 1_000_000, note=True),
        FakeEvent("portbench.window", 0, 1_000_000, device="CUDA",
                  note=True),
        FakeEvent("k1", 100_000, 200_000, device="CUDA"),
        FakeEvent("Memcpy HtoD (Pinned -> Device)", 250_000, 100_000,
                  device="CUDA"),
        FakeEvent("k2", 700_000, 100_000, device="CUDA"),
        FakeEvent("aten::nonzero", 400_000, 250_000),
    ]))
    assert ev.range("portbench.window") == (0, 1_000_000)
    lo, hi = ev.range("portbench.window")
    assert ev.busy_ns(lo, hi) == 250_000 + 100_000  # k1 and the copy overlap
    assert ev.device_ns(lo, hi) == 400_000
    assert ev.top_ops(lo, hi)[0] == ["k1", 0.0002]
    gaps = ev.idle_gaps(lo, hi)
    assert gaps[0] == ["idle while host in aten::nonzero", 0.00035]
    assert sum(g[1] for g in gaps) == pytest.approx(650_000 / 1e9)


def test_merged_clips_and_joins():
    ivs = [("a", 0, 10), ("b", 5, 20), ("c", 30, 40), ("d", 45, 60)]
    assert devtrace.merged(ivs, 2, 50) == [(2, 20), (30, 40), (45, 50)]
