"""The profiler's side of the benchmark: start ``torch.profiler`` over
every thread of the process, and reduce its events to device busy time,
the top device operations, the longest idle gaps by what the host was
doing, and the device time inside a named range.

Device operations are the kernels, copies and fills that CUPTI records
on the card. Host operations are the ATen operators and CUDA runtime
calls of every thread. Ranges are ``record_function`` annotations of
the harness's own threads, on the same clock as the rest.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_ACTIVITIES = ("cpu_op", "cuda_runtime", "cuda_driver")
RANGE_PREFIX = "portbench."  # the harness's own ranges
GAP_NS = 20_000  # idle gaps shorter than 20 us are not listed
NAME_CHARS = 96

Interval = Tuple[str, int, int]  # name, start ns, end ns


def start_profiler():
    """A started profiler of CPU and CUDA activity on every thread (the
    server's handler and dispatcher threads launch the work)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        prof = profile(activities=acts, experimental_config=cfg)
    except (AttributeError, TypeError):
        prof = profile(activities=acts)
    prof.start()
    return prof


class Events:
    """The events of one stopped profiler, by kind."""

    def __init__(self, prof):
        self.device: List[Interval] = []
        self.host: List[Interval] = []
        self.ranges: Dict[str, Tuple[int, int]] = {}
        for e in prof.profiler.kineto_results.events():
            s = e.start_ns()
            iv = (e.name(), s, s + e.duration_ns())
            act = _activity(e)
            if act in DEVICE_ACTIVITIES:
                self.device.append(iv)
            elif act == "user_annotation":
                self.ranges[iv[0]] = iv[1:]
            elif act in HOST_ACTIVITIES:
                self.host.append(iv)
        self.device.sort(key=lambda iv: iv[1])

    def summary(self) -> str:
        """Counts and spans by kind, for the run's log."""
        def span(ivs):
            return (min(iv[1] for iv in ivs), max(iv[2] for iv in ivs)) \
                if ivs else None
        return (f"{len(self.device)} device ops over {span(self.device)}, "
                f"{len(self.host)} host ops over {span(self.host)}, "
                f"ranges {sorted(self.ranges)[:4]}")

    def busy_ns(self, lo: int, hi: int) -> int:
        """Nanoseconds of [lo, hi) in which some device operation ran."""
        return sum(b - a for a, b in merged(self.device, lo, hi))

    def device_ns(self, lo: int, hi: int) -> int:
        """Summed time of the device operations that start in [lo, hi)."""
        return sum(e - s for _, s, e in self.device if lo <= s < hi)

    def top_ops(self, lo: int, hi: int, n: int = 10) -> List[list]:
        by: Dict[str, int] = {}
        for name, s, e in self.device:
            if lo <= s < hi:
                by[name] = by.get(name, 0) + (min(e, hi) - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:NAME_CHARS], ns / 1e9] for name, ns in top]

    def idle_gaps(self, lo: int, hi: int, n: int = 10) -> List[list]:
        """The ``n`` longest device-idle gaps in [lo, hi), each named by
        the host operation that covers most of it (or by none)."""
        gaps, t = [], lo
        for a, b in merged(self.device, lo, hi):
            if a - t >= GAP_NS:
                gaps.append((t, a))
            t = max(t, b)
        if hi - t >= GAP_NS:
            gaps.append((t, hi))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        return [[f"idle while host in {self.host_label(a, b)}",
                 (b - a) / 1e9] for a, b in gaps]

    def host_label(self, a: int, b: int) -> str:
        cover: Dict[str, int] = {}
        for name, s, e in self.host:
            if s < b and e > a:
                cover[name] = cover.get(name, 0) + min(e, b) - max(s, a)
        if not cover:
            return "python (no traced op)"
        name, ns = max(cover.items(), key=lambda kv: kv[1])
        if ns < (b - a) // 10:
            return "python (no traced op)"
        return name[:NAME_CHARS]

    def range(self, name: str) -> Optional[Tuple[int, int]]:
        return self.ranges.get(name)


def _activity(e) -> str:
    """The event's kind. PyTorch releases without ``activity_type`` on
    their events tell it from the device, the annotation flag and the
    name."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type())
    on_device = str(e.device_type()).endswith("CUDA")
    note = getattr(e, "is_user_annotation", lambda: False)()
    if on_device:
        if note or e.name().startswith(RANGE_PREFIX):
            return "gpu_user_annotation"
        name = e.name()
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if note or e.name().startswith(RANGE_PREFIX):
        return "user_annotation"
    return "cpu_op"


def merged(ivs: List[Interval], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The union of intervals sorted by start, clipped to [lo, hi)."""
    out: List[List[int]] = []
    for _, s, e in ivs:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(a, b) for a, b in out]
