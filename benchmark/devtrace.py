"""The traced window: ``torch.profiler`` over the window, reduced to the
device's busy time, the window's length, the kernels' time by name, the idle
gaps by what the host was doing, and groups of kernel launches for the
roofline readers.

The benchmark's own spans are ``record_function`` ranges ("window", "step",
"fwd", "bwd", "opt", "reset", "query"); the device timeline's copies of
them, and of any other annotation (PyTorch's optimizers annotate their
steps), are not device work and are left out.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field

SPANS = ("window", "step", "fwd", "bwd", "opt", "reset", "query")
# a kernel's own prepass (pads the points, splits the vector into bf16 words)
# is enqueued just before it; the roofline readers count it as the kernel's
PREPASS = re.compile(r"\b(pad_points_kernel|split_v_kernel|split_vt_kernel)\b")


@dataclass
class Event:
    name: str
    start_us: float
    end_us: float

    @property
    def seconds(self) -> float:
        return (self.end_us - self.start_us) * 1e-6


@dataclass
class Trace:
    """The window's device events and the host's main-thread events, in the
    profiler's microseconds, clipped to the window."""

    window: tuple[float, float]
    device: list[Event]  # kernels, copies and fills
    host: list[Event]  # main-thread CPU ops and the benchmark's spans
    counters: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device events' intervals, in order."""
        merged: list[list[float]] = []
        for e in sorted(self.device, key=lambda e: e.start_us):
            if merged and e.start_us <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e.end_us)
            else:
                merged.append([e.start_us, e.end_us])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def idle_gaps(self) -> list[tuple[float, float]]:
        gaps, t = [], self.window[0]
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.window[1] > t:
            gaps.append((t, self.window[1]))
        return gaps

    def device_ops(self, top: int = 10) -> list[list]:
        """The device operations that took most time, summed by name."""
        by_name: dict[str, float] = {}
        for e in self.device:
            key = short_name(e.name)
            by_name[key] = by_name.get(key, 0.0) + e.seconds
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]

    def idle_by_host(self, top: int = 10) -> list[list]:
        """The idle time summed by what the host's main thread was doing at
        each gap's middle: the benchmark's innermost span and the innermost
        operation inside it ("fwd/aten::item": a host read in the forward)."""
        gaps = self.idle_gaps()
        mids = sorted(((a + b) / 2, (b - a) * 1e-6) for a, b in gaps)
        labels: dict[str, float] = {}
        events = sorted(self.host, key=lambda e: (e.start_us, -e.end_us))
        starts = [e.start_us for e in events]
        stack: list[Event] = []
        pushed = 0
        for mid, seconds in mids:
            upto = bisect.bisect_right(starts, mid)
            while pushed < upto:
                e = events[pushed]
                while stack and stack[-1].end_us < e.start_us:
                    stack.pop()
                stack.append(e)
                pushed += 1
            while stack and stack[-1].end_us < mid:
                stack.pop()
            span = next((e.name for e in reversed(stack) if e.name in SPANS), "outside")
            op = stack[-1].name if stack and stack[-1].name not in SPANS else ""
            label = f"{span}/{op}" if op else span
            labels[label] = labels.get(label, 0.0) + seconds
        return [[k, v] for k, v in sorted(labels.items(), key=lambda kv: -kv[1])[:top]]

    def kernel_seconds(self, pattern: re.Pattern) -> float:
        """Device seconds of every launch whose name matches ``pattern``,
        with the prepass kernels enqueued just before each."""
        events = sorted(self.device, key=lambda e: e.start_us)
        total = 0.0
        for i, e in enumerate(events):
            if not pattern.search(e.name):
                continue
            total += e.seconds
            j = i - 1
            while j >= 0 and PREPASS.search(events[j].name) and i - j <= 2:
                total += events[j].seconds
                j -= 1
        return total

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops(), "idle_gaps": self.idle_by_host()}


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    argument list."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0].strip()[:160]


def profiler(torch):
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=False)


def reduce(torch, prof) -> Trace:
    """The window's events from a finished profiler: device events inside
    the "window" span, and the CPU events of the thread that ran it."""
    events = prof.events()
    windows = [e for e in events if e.name == "window" and e.device_type != torch.autograd.DeviceType.CUDA]
    if not windows:
        raise RuntimeError("the trace holds no window span")
    w = windows[0]
    lo, hi = w.time_range.start, w.time_range.end
    device, host = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if b <= lo or a >= hi:
            continue
        a, b = max(a, lo), min(b, hi)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name not in SPANS and not getattr(e, "is_user_annotation", False) and "#" not in e.name:
                device.append(Event(e.name, a, b))
        elif e.thread == w.thread:
            host.append(Event(e.name, a, b))
    return Trace((lo, hi), device, host)
