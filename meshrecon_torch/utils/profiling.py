"""Per-stage wall timers (port of meshrecon/utils/profiling.StageTimer).

A stage's time ends when the work that produced its value is done: for a
value that holds a CUDA tensor the timer calls ``torch.cuda.synchronize``
on that tensor's device, so each stage reads on the card's timeline.
"""

from __future__ import annotations

import contextlib
import math
import time
from collections import defaultdict

import torch


def _cuda_devices(value, found):
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            found.add(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, found)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, found)
    return found


def _sync(value):
    """Wait for the devices holding ``value``'s CUDA tensors."""
    for dev in _cuda_devices(value, set()):
        torch.cuda.synchronize(dev)
    return value


class StageTimer:
    """Accumulates wall time, call counts and pixel counts per named stage.

    ``with timer.stage(name, pixels) as done: done(value)`` times the block
    until ``value`` is computed on its device."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.times = defaultdict(float)
        self.counts = defaultdict(int)
        self.pixels = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, pixels: int = 0):
        if not self.enabled:
            yield lambda value=None: value
            return
        t0 = time.perf_counter()
        box = {}

        def done(value=None):
            box["value"] = value
            return value

        yield done
        _sync(box.get("value"))
        self.times[name] += time.perf_counter() - t0
        self.counts[name] += 1
        self.pixels[name] += pixels

    def report(self) -> str:
        lines = ["stage                          calls   total_s    Mpix/s"]
        for name in sorted(self.times, key=lambda n: -self.times[n]):
            t = self.times[name]
            mpix = (self.pixels[name] / t / 1e6
                    if t > 0 and self.pixels[name] else 0)
            lines.append(
                f"{name:<30} {self.counts[name]:>5} {t:>9.3f} {mpix:>9.1f}")
        return "\n".join(lines)


# the categories of torch.profiler's Chrome trace that run on the device
DEVICE_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy(trace: dict) -> tuple[float, int]:
    """(seconds, count): the time in which the device ran at least one
    kernel, copy or memset of a Chrome trace (torch.profiler's export),
    overlapping events merged, and the number of such events. Host events
    (CPU ops, CUDA runtime calls, annotations) do not count."""
    spans = sorted((e["ts"], e["ts"] + e["dur"])
                   for e in trace.get("traceEvents", [])
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_EVENT_CATS)
    busy_us, end = 0.0, -math.inf
    for start, stop in spans:
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    return busy_us / 1e6, len(spans)
