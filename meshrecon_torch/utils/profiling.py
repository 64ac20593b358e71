"""Per-stage wall timers (port of meshrecon/utils/profiling.StageTimer and
``stage_report``), and the measurement helpers of the port's tools.

A stage's time ends when the work that produced its value is done: for a
value that holds a CUDA tensor the timer calls ``torch.cuda.synchronize``
on that tensor's device, so each stage reads on the card's timeline.
"""

from __future__ import annotations

import contextlib
import math
import subprocess
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


def stage_report(timer: StageTimer) -> str:
    return timer.report()


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


def best_ms(fn, reps: int, device, best_of: int = 1,
            warm_up: bool = True) -> float:
    """Milliseconds per call of ``fn``: the best of ``best_of`` passes of
    ``reps`` calls after one warm-up call (unless the caller has just made
    it); CUDA events on the card, the host clock on the CPU."""
    if warm_up:
        fn()
    best = math.inf
    for _ in range(best_of):
        if device.type == "cpu":
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            best = min(best, (time.perf_counter() - t0) * 1e3 / reps)
            continue
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        best = min(best, start.elapsed_time(end) / reps)
    return best


def device_line(device) -> str:
    """The device a tool measures on: the card's name with nvidia-smi's
    name and power limit, or the CPU with what its numbers are."""
    if device.type == "cpu":
        return "device: cpu (host-clock times; no kernel runs)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    limit = (smi.stdout.strip().splitlines() or ["not read"])[
        device.index or 0] if smi.returncode == 0 else "not read"
    return (f"device: {torch.cuda.get_device_name(device)} (nvidia-smi: "
            f"{limit.strip()})")


class RowTimer:
    """The timing rows of a micro-benchmark tool, printed as they are
    taken: ``time(name, fn)`` makes one warm-up call (its seconds, the
    kernels built beforehand, take the place of the JAX tools' compile
    column), then takes :func:`best_ms` over ``reps`` calls, best of
    ``best_of``; ``na(name, reason)`` prints a row that the port does not
    have. ``rows`` maps each name, in order, to its ms (None for n/a)."""

    def __init__(self, device, reps: int, best_of: int, width: int,
                 digits: int = 2):
        self.device, self.reps, self.best_of = device, reps, best_of
        self.width, self.digits = width, digits
        self.rows = {}

    def time(self, name: str, fn) -> float:
        t0 = time.perf_counter()
        _sync(fn())
        warm = time.perf_counter() - t0
        ms = best_ms(fn, self.reps, self.device, self.best_of, warm_up=False)
        print(f"{name:<{self.width}} {ms:8.{self.digits}f} ms"
              f" (warm-up {warm:5.1f}s)", flush=True)
        self.rows[name] = ms
        return ms

    def na(self, name: str, reason: str) -> None:
        print(f"{name:<{self.width}} {'n/a':>8}    ({reason})", flush=True)
        self.rows[name] = None
