"""The traced run's reduction: torch.profiler over the window, reduced in
memory to what the per-layer metrics read.

The device's busy time is the union of its kernels, copies and memsets
(overlaps merged), as the program's ``utils/profiling.device_busy``
computes it from a Chrome trace; here the profiler's events are read
directly, so a window of a million events writes nothing to disk. Each
idle gap of the device inside the window is labelled by the host call
that was running when it began (the latest operator or runtime call
started before it, if it had not yet ended; else "host, between
operators").
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from dataclasses import dataclass, field

BETWEEN = "host, between operators"
WINDOW = "benchmark.window"


@dataclass
class TraceSummary:
    window_s: float  # from the window's first issue to its last completion
    busy_s: float  # the device ran at least one event
    events: int  # device events (kernels, copies, memsets) in the window
    kernel_s: dict = field(default_factory=dict)  # device s by event name
    idle_by_host: dict = field(default_factory=dict)  # idle s by host label

    def time_of(self, *fragments: str) -> float:
        """Device seconds of the events whose name holds any fragment."""
        return sum(s for name, s in self.kernel_s.items()
                   if any(f in name for f in fragments))

    def breakdown(self, top: int = 10) -> dict:
        """The device events that took most time (by :func:`short_name`)
        and the longest idle time by host label, ``top`` of each."""
        by_short = defaultdict(float)
        for name, s in self.kernel_s.items():
            by_short[short_name(name)] += s
        ops = sorted(by_short.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def short_name(name: str, width: int = 120) -> str:
    """A device event's name without ``void`` and the ``at::native::``
    namespace, cut to ``width`` characters."""
    name = name.replace("void ", "").replace("at::native::", "")
    return name[:width]


def reduce_events(device, host, t0_ns: int, t1_ns: int) -> TraceSummary:
    """device: (start_ns, end_ns, name) of the device's events; host:
    (start_ns, end_ns, name) of the host's operators; the window
    [t0_ns, t1_ns]. Events are clipped to the window."""
    spans = sorted((max(s, t0_ns), min(e, t1_ns), n) for s, e, n in device
                   if e > t0_ns and s < t1_ns)
    kernel_s = defaultdict(float)
    busy_ns, end = 0, t0_ns
    gaps = []
    for start, stop, name in spans:
        kernel_s[name] += (stop - start) / 1e9
        if start > end:
            gaps.append((end, start))
        if stop > end:
            busy_ns += stop - max(start, end)
            end = stop
    if t1_ns > end:
        gaps.append((end, t1_ns))
    host = sorted(host)
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g0) - 1
        label = host[i][2] if i >= 0 and host[i][1] >= g0 else BETWEEN
        idle[label] += (g1 - g0) / 1e9
    return TraceSummary(window_s=(t1_ns - t0_ns) / 1e9, busy_s=busy_ns / 1e9,
                        events=len(spans), kernel_s=dict(kernel_s),
                        idle_by_host=dict(idle))


class Tracer:
    """torch.profiler (host and device) around the window, reduced by
    :meth:`reduce` once it has closed."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])

    @contextlib.contextmanager
    def window(self):
        """Profile the block; the window is the span of an annotation
        around it, on the profiler's own clock."""
        from torch.profiler import record_function

        with self._prof:
            with record_function(WINDOW):
                yield self

    def reduce(self) -> TraceSummary:
        """Reduce the profiled window: the device's events are those the
        profiler places on a device; the host's, every other but the
        window's annotation (operators and runtime calls, so a gap is
        labelled by the innermost call running at its start)."""
        device, host, window = [], [], None
        for e in self._prof.profiler.kineto_results.events():
            s = e.start_ns()
            span = (s, s + e.duration_ns(), e.name())
            on_host = e.device_type().name == "CPU"
            if e.name() == WINDOW:
                if on_host:
                    window = span[:2]
            elif on_host:
                host.append(span)
            else:
                device.append(span)
        if window is None:
            raise RuntimeError("the profiler recorded no window annotation")
        return reduce_events(device, host, *window)
