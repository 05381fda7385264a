"""The traced part of a window: `torch.profiler` over the first renders, and
the reduction of the trace to device time by name, the device's busy share
and its idle gaps.

The arithmetic (the union of the device's intervals over the host's wall,
device time by kernel name) is copied from `chip_smoke.py`
`profile_render`.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field

#: the benchmark's span around the whole traced part
WINDOW = "bench:window"
#: entries of each breakdown list
TOP = 10


@dataclass
class Trace:
    """What the readers take from the trace: per device event (name,
    start, end) in microseconds of the trace's clock, the traced window's
    bounds, and the renders it holds."""

    device: list = field(default_factory=list)
    start: float = 0.0
    end: float = 0.0
    renders: int = 0

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def union(self) -> list:
        """The device's busy intervals inside the window, merged."""
        out = []
        for s0, s1 in sorted((max(e[1], self.start), min(e[2], self.end))
                             for e in self.device):
            if s1 <= s0:
                continue
            if out and s0 <= out[-1][1]:
                out[-1][1] = max(out[-1][1], s1)
            else:
                out.append([s0, s1])
        return out

    @property
    def busy_s(self) -> float:
        return sum(s1 - s0 for s0, s1 in self.union()) / 1e6

    def seconds(self, pattern: str) -> float:
        """Device seconds of the events whose name matches `pattern`."""
        rx = re.compile(pattern)
        return sum(e[2] - e[1] for e in self.device if rx.search(e[0])) / 1e6

    def per_render(self, pattern: str) -> float | None:
        """Device seconds a render of the events matching `pattern`, or
        None when the trace holds none."""
        s = self.seconds(pattern)
        return s / self.renders if s > 0 and self.renders else None

    def device_ops(self) -> list:
        by = {}
        for name, s0, s1 in self.device:
            by[name[:120]] = by.get(name[:120], 0.0) + (s1 - s0) / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:TOP]

    def idle_gaps(self) -> list:
        """The device's idle time inside the window by where it falls in
        the render: each gap is labelled with the device operations that
        end before it and start after it, summed by label."""
        busy = self.union()
        by_end = sorted(self.device, key=lambda e: e[2])
        ends = [e[2] for e in by_end]
        by_start = sorted(self.device, key=lambda e: e[1])
        starts = [e[1] for e in by_start]
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        by = {}
        for g0, g1 in zip(edges[::2], edges[1::2]):
            if g1 <= g0:
                continue
            i = bisect.bisect_right(ends, g0) - 1
            k = bisect.bisect_left(starts, g1)
            before = short(by_end[i][0]) if i >= 0 else "window start"
            after = short(by_start[k][0]) if k < len(by_start) else "window end"
            label = f"after {before}, before {after}"
            by[label] = by.get(label, 0.0) + (g1 - g0) / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:TOP]


def short(name: str) -> str:
    """A device operation's name without its return type, template and
    arguments."""
    name = re.sub(r"^void ", "", name)
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()[:60] or name[:60]


def reduce(prof, renders: int) -> Trace:
    """The profiler's events as a `Trace` of `renders` renders (read from
    the raw results, which is many times faster than `prof.events()`)."""
    from torch.autograd import DeviceType

    tr = Trace(renders=renders)
    win = None
    for e in prof.profiler.kineto_results.events():
        name, s0 = e.name(), e.start_ns() / 1e3
        s1 = s0 + e.duration_ns() / 1e3
        if name == WINDOW:
            # the span's copy on the device's timeline is an annotation
            if e.device_type() != DeviceType.CUDA:
                win = (s0, s1)
        elif e.device_type() == DeviceType.CUDA:
            tr.device.append((name, s0, s1))
    if win is not None:
        tr.start, tr.end = win
    elif tr.device:
        tr.start, tr.end = min(e[1] for e in tr.device), max(e[2] for e in tr.device)
    return tr
