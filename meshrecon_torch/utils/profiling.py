"""The port's recorder of spans and counters (port of
meshrecon/utils/profiling.StageTimer, ``stage_report`` and
``profile_trace``), and the measurement helpers of the port's tools.

A span is a named interval of the program: its parent (the enclosing
span of its thread), its update (the number of the top-level span it lies
under), its host start and end on ``time.time_ns()``, which is
torch.profiler's clock, and on a CUDA device its device-timeline time,
between two timing events recorded on the current stream at its entry and
at its exit. Recording a span never synchronizes the device: the events
are read when totals are read, or by ``query`` once many are pending.

A span records into the innermost enabled :class:`StageTimer` whose stage
is open on its thread (the CLI at ``-v 2``, the tools); else, while
torch.profiler runs, into the process recorder :data:`RECORDER` (a traced
benchmark window, ``--profile``); else nowhere, for two attribute reads.
Spans stay out of the profiler's event stream: the profiler mirrors a
range that encloses kernels onto the device's timeline, where a trace
would count it as device work.

Counters: ``host_syncs`` and ``sync_wait`` (host seconds blocked) count
the calls of the dense update that wait for the device, each made through
:func:`host_read`, :func:`host_values` or :func:`to_device`;
``gn_sweeps`` counts Gauss-Newton sweeps, and on CUDA ``gn_kernel`` the
triangulations that ran the GN kernels and ``gn_steps`` the pixel-steps
they took, ``sweep_kernel`` the plane-sweep depth planes that ran the
SWEEP kernels, and ``normals_kernel`` the normal estimations that ran the
NORMALS kernels.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import subprocess
import threading
import time
from collections import defaultdict

import torch

_PROFILER = torch.autograd.profiler  # its _is_profiler_enabled flag
# pending spans (device events not yet read) past which the oldest are
# read without waiting
PENDING_MAX = 2048
# the Chrome-trace category of the spans profile_trace writes
SPAN_CAT = "meshrecon_span"
# the spans ended while profile_trace's block runs (None outside one)
_EXPORT = None


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


class _Local(threading.local):
    def __init__(self):
        self.timers = []  # enabled StageTimers with a stage open
        self.open = []  # open spans, innermost last
        self.tid = threading.get_native_id()


_LOCAL = _Local()


def _recorder():
    """Where a span or a counter of this thread records, or None."""
    timers = _LOCAL.timers
    if timers:
        return timers[-1]
    if _PROFILER._is_profiler_enabled:
        return RECORDER
    return None


class _Off:
    """The span of a thread that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Span:
    """One recorded interval: ``name``, ``parent`` (a Span or None),
    ``update``, ``tid``, ``t0_ns`` and ``t1_ns`` on ``time.time_ns()``,
    ``child_ns`` (its children's host time) and ``device_s`` (None off
    CUDA, and until its recorder resolves it)."""

    __slots__ = ("recorder", "name", "pixels", "device", "end_device",
                 "parent", "update", "tid", "t0_ns", "t1_ns", "child_ns",
                 "events", "device_s")

    def __init__(self, recorder, name: str, pixels: int = 0, device=None):
        self.recorder, self.name, self.pixels = recorder, name, pixels
        self.device = self.end_device = device
        self.child_ns = 0
        self.events = self.device_s = None

    def __enter__(self):
        rec = self.recorder
        stack = _LOCAL.open
        parent = stack[-1] if stack and stack[-1].recorder is rec else None
        self.parent = parent
        self.update = rec._top() if parent is None else parent.update
        self.tid = _LOCAL.tid
        if self.device is not None:
            self.events = rec._start(self.device)
        stack.append(self)
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1_ns = time.time_ns()
        _LOCAL.open.pop()
        if self.events is not None:
            self.recorder._end(self)
        if self.parent is not None:
            self.parent.child_ns += self.t1_ns - self.t0_ns
        self.recorder._finish(self)
        return False


class StageTimer:
    """Totals, counters and pending spans of one recorder.

    ``with timer.stage(name, pixels) as done: done(value)`` records a span
    named ``name`` and, while it is open, makes the timer the recorder of
    the thread's spans (:func:`span`). ``done(value)`` names the device
    whose current stream takes the span's end event: the one CUDA device
    holding ``value``'s tensors. The stage waits for nothing.

    Per name: ``counts`` (calls), ``host_s`` (host seconds), ``self_s``
    (host seconds less the children's), ``pixels``, and, resolving the
    pending events first, ``times`` (device-timeline seconds where the span
    ran on CUDA, host seconds otherwise) and ``device_s`` (the CUDA part).
    ``counters`` by name; ``top_spans`` counts the top-level spans, which
    number the updates. Threads may share a timer (the scenes of
    ``reconstruct_scenes``): each total then adds the threads' overlapping
    times."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.counts = defaultdict(int)
        self.host_s = defaultdict(float)
        self.self_s = defaultdict(float)
        self.pixels = defaultdict(int)
        self.counters = {}
        self.top_spans = 0
        self._times = defaultdict(float)
        self._device_s = defaultdict(float)
        self._pending = collections.deque()
        self._pool = defaultdict(list)  # free timing events by device index
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str, pixels: int = 0):
        if not self.enabled:
            yield lambda value=None: value
            return
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_initialized() else None)
        s = Span(self, name, pixels, device)
        s.end_device = None

        def done(value=None):
            found = _cuda_devices(value, set())
            s.end_device = found.pop() if len(found) == 1 else None
            return value

        _LOCAL.timers.append(self)
        try:
            with s:
                yield done
        finally:
            _LOCAL.timers.pop()

    @property
    def times(self):
        self.resolve()
        return self._times

    @property
    def device_s(self):
        self.resolve()
        return self._device_s

    def add(self, name: str, value) -> None:
        """Add ``value`` to the counter ``name``."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + value

    def resolve(self):
        """Read every pending span's events, waiting for the device."""
        with self._lock:
            self._resolve(wait=True)
        return self

    def clear(self) -> None:
        """Forget every total, counter and span."""
        with self._lock:
            self._resolve(wait=True)
            for totals in (self.counts, self.host_s, self.self_s,
                           self.pixels, self.counters, self._times,
                           self._device_s):
                totals.clear()
            self.top_spans = 0

    def report(self) -> str:
        times = self.times
        lines = ["stage                          calls   total_s    Mpix/s"]
        for name in sorted(times, key=lambda n: -times[n]):
            t = times[name]
            mpix = (self.pixels[name] / t / 1e6
                    if t > 0 and self.pixels[name] else 0)
            lines.append(
                f"{name:<30} {self.counts[name]:>5} {t:>9.3f} {mpix:>9.1f}")
        if self.counters:
            lines.append("counter                            total")
            updates = self.counts.get("flow_update", 0)
            for name in sorted(self.counters):
                row = f"{name:<30} {self.counters[name]:>9.6g}"
                if name == "gn_sweeps" and updates:
                    row += (f"  ({self.counters[name] / updates:.1f} a "
                            "flow_update)")
                lines.append(row)
        return "\n".join(lines)

    # -- the recording side ----------------------------------------------
    def _top(self) -> int:
        with self._lock:
            self.top_spans += 1
            return self.top_spans

    def _start(self, device):
        with self._lock:
            pool = self._pool[device.index]
            events = [pool.pop() if pool else
                      torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record(torch.cuda.current_stream(device))
        return events

    def _end(self, span: Span) -> None:
        if span.end_device != span.device:  # a stage whose value is
            with self._lock:  # elsewhere, or not on CUDA: host time
                self._pool[span.device.index].extend(span.events)
            span.events = None
            return
        span.events[1].record(torch.cuda.current_stream(span.device))

    def _finish(self, span: Span) -> None:
        host = (span.t1_ns - span.t0_ns) / 1e9
        name = span.name
        with self._lock:
            self.counts[name] += 1
            self.host_s[name] += host
            self.self_s[name] += host - span.child_ns / 1e9
            self.pixels[name] += span.pixels
            if span.events is None:
                self._times[name] += host
            else:
                self._pending.append(span)
                if len(self._pending) > PENDING_MAX:
                    self._resolve(wait=False)
        if _EXPORT is not None:
            _EXPORT.append(span)

    def _resolve(self, wait: bool) -> None:
        """Under the lock: the pending spans' device times, oldest first;
        without ``wait``, up to the first whose end the device has not
        reached."""
        pending = self._pending
        while pending:
            span = pending[0]
            start, end = span.events
            if wait:
                end.synchronize()
            elif not end.query():
                return
            span.device_s = start.elapsed_time(end) / 1e3
            self._times[span.name] += span.device_s
            self._device_s[span.name] += span.device_s
            self._pool[span.device.index].extend(span.events)
            span.events = None
            pending.popleft()

    def _synced(self, wait_ns: int) -> None:
        with self._lock:
            c = self.counters
            c["host_syncs"] = c.get("host_syncs", 0) + 1
            c["sync_wait"] = c.get("sync_wait", 0) + wait_ns / 1e9


def stage_report(timer: StageTimer) -> str:
    return timer.report()


# the process recorder: spans and counters while torch.profiler runs and
# no enabled StageTimer has a stage open on the thread
RECORDER = StageTimer()


def span(name: str, device=None):
    """``with span(name, device):`` a span of the thread's recorder (see
    the module's docstring); ``device``: where the block's work runs, its
    device-timeline time read on a CUDA device."""
    rec = _recorder()
    if rec is None:
        return _OFF
    if device is None or device.type != "cuda":
        device = None
    elif device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Span(rec, name, 0, device)


def count(name: str, value=1) -> None:
    """Add ``value`` to the thread's recorder's counter ``name``."""
    rec = _recorder()
    if rec is not None:
        rec.add(name, value)


def _blocked(call):
    """``call()``, which waits for the device: one ``host_syncs`` and its
    host time in ``sync_wait``. The count is the call site's on a CUDA
    device, so a CPU run counts what the card's would."""
    rec = _recorder()
    if rec is None:
        return call()
    t0 = time.perf_counter_ns()
    out = call()
    rec._synced(time.perf_counter_ns() - t0)
    return out


def host_read(value):
    """``value.item()``, the dense update's one way to read a device
    value into Python: a counted host sync."""
    return _blocked(value.item)


def host_values(value) -> list:
    """``value.tolist()``: several device values read at once, one
    counted host sync."""
    return _blocked(value.tolist)


def to_device(value, device, dtype=None):
    """``torch.as_tensor(value, dtype, device)``. A value that is not a
    tensor of ``device``'s type is copied from the host: a counted host
    sync, since on a CUDA device the copy from pageable memory waits for
    the stream."""
    if (isinstance(value, torch.Tensor)
            and value.device.type == torch.device(device).type):
        return torch.as_tensor(value, dtype=dtype, device=device)
    return _blocked(lambda: torch.as_tensor(value, dtype=dtype,
                                            device=device))


def span_events(spans, base_ns: int = 0) -> list:
    """Chrome-trace complete events (category ``meshrecon_span``) of
    resolved spans, in microseconds from ``base_ns`` on their clock."""
    pid = os.getpid()
    return [{"ph": "X", "cat": SPAN_CAT, "name": s.name, "pid": pid,
             "tid": s.tid, "ts": (s.t0_ns - base_ns) / 1e3,
             "dur": (s.t1_ns - s.t0_ns) / 1e3,
             "args": {"update": s.update,
                      "parent": None if s.parent is None else s.parent.name,
                      "device_ms": (None if s.device_s is None
                                    else s.device_s * 1e3)}}
            for s in spans]


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


@contextlib.contextmanager
def profile_trace(log_dir: str, device="cuda", host: bool = True):
    """torch.profiler trace of the block, written as a Chrome trace to
    ``log_dir/trace.json`` (the host's CPU activity, on a CUDA device
    unless ``host`` is false, and the device's), and the device's busy
    share of the profiled wall time (kernels, copies and memsets, overlaps
    merged) to ``log_dir/device_busy.json``. Yields that summary's dict,
    filled in when the block ends: ``wall_s`` (the profiler's start and
    stop, the block and a synchronize of the device), ``device_busy_s``,
    ``busy_share``, ``device_events``. The busy
    figures need only the device's events: without the host's the trace
    is a third smaller and the pass less slowed. The spans that ended in
    the block are written into the trace after its export, as host events
    of the category ``meshrecon_span`` on the export's time base."""
    global _EXPORT
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] if host or not cuda else []
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    summary = {}
    outer, _EXPORT = _EXPORT, []
    spans = _EXPORT
    try:
        t0 = time.perf_counter()
        with profile(activities=activities) as prof:
            yield summary
            if cuda:
                torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    finally:
        _EXPORT = outer
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    busy, events = device_busy(trace)
    if spans:
        for rec in {s.recorder for s in spans}:
            rec.resolve()
        trace["traceEvents"] += span_events(
            spans, trace.get("baseTimeNanoseconds", 0))
        with open(path, "w") as f:
            json.dump(trace, f)
    summary.update(wall_s=wall, device_busy_s=busy, busy_share=busy / wall,
                   device_events=events)
    with open(os.path.join(log_dir, "device_busy.json"), "w") as f:
        json.dump(summary, f)


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


def nvidia_smi(device, fields: str = "name,power.limit") -> str:
    """nvidia-smi's ``--query-gpu`` row of ``fields`` for a CUDA device,
    or "not read"."""
    smi = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    row = (smi.stdout.strip().splitlines() or ["not read"])[
        device.index or 0] if smi.returncode == 0 else "not read"
    return row.strip()


def device_line(device) -> str:
    """The device a tool measures on: the card's name with nvidia-smi's
    name and power limit, or the CPU with what its numbers are."""
    if device.type == "cpu":
        return "device: cpu (host-clock times; no kernel runs)"
    return (f"device: {torch.cuda.get_device_name(device)} (nvidia-smi: "
            f"{nvidia_smi(device)})")


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
