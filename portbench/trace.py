"""What a traced run reads: the host spans of every thread, and a slice of
the window under torch.profiler.

`Spans` times named host spans from any thread (the harness's own and the
stream's stages, whose hook `models/streaming.py:_span` it replaces while
open), as sums and as intervals on the host clock. `SlicePlan` runs one
profiler session over a traced window and records a `Slice` of it: its
device records (kernels, copies, memsets), the host clock marked in the
trace, and how many launches lost their records (CUPTI drops some now
and then), in which case another slice is recorded.
"""

import contextlib
import json
import os
import sys
import tempfile
import threading
import time
from collections import defaultdict

DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "portbench.mark"


class Spans:
    """Host seconds of named spans, summed by name, and their intervals
    ((name, start, end) on `time.perf_counter`)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.intervals = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name, inner=None):
        t0 = time.perf_counter()
        try:
            if inner is None:
                yield
            else:
                with inner(name):
                    yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.totals[name] += t1 - t0
                self.intervals.append((name, t0, t1))

    @contextlib.contextmanager
    def hooked(self, streaming):
        """Time the stream's stages (every thread) while open."""
        original = streaming._span
        streaming._span = lambda name: self.span(name, original)
        try:
            yield self
        finally:
            streaming._span = original

    def label(self, start, end):
        """The span that covers most of [start, end], or "no span"."""
        best, cover = "no span", 0.0
        with self._lock:
            intervals = list(self.intervals)
        by_name = defaultdict(float)
        for name, t0, t1 in intervals:
            overlap = min(end, t1) - max(start, t0)
            if overlap > 0:
                by_name[name] += overlap
        for name, c in by_name.items():
            if c > cover:
                best, cover = name, c
        return best


class SlicePlan:
    """The profiler slice of a traced window, in one profiler session:
    `warm()` (in set-up) opens the session, which starts CUPTI (seconds);
    the slice records from `start_s` into the window for `length_s`, and
    is read at once; one whose launches lost records is traced again 0.5
    s later (up to `tries` slices). Units (batches, steps) are counted as
    the window hands them out; `overhead_s` is the host time the profiler
    took inside the window (starting, stopping and reading slices)."""

    def __init__(self, torch, device, start_s, length_s, tries=2):
        self.torch, self.device = torch, device
        self.start_s, self.length_s, self.tries = start_s, length_s, tries
        self.slices, self.open, self.prof = [], None, None
        self.overhead_s = 0.0

    def warm(self):
        from torch.profiler import ProfilerActivity, profile, schedule
        self.prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=self.tries),
            on_trace_ready=self._ready)
        self.prof.__enter__()

    def step(self, elapsed, unit):
        """Before unit `unit` is handed out, `elapsed` s into the window."""
        t0 = time.perf_counter()
        if self.open is None:
            if elapsed >= self.start_s and len(self.slices) < self.tries \
                    and not any(not s.lost for s in self.slices):
                self.open = Slice(self.torch, self.device, unit)
                self.prof.step()
                self.open.begin()
                self.overhead_s += time.perf_counter() - t0
            return
        if time.perf_counter() - self.open.t0 >= self.length_s:
            self._finish(unit)
            self.start_s = elapsed + 0.5
            self.overhead_s += time.perf_counter() - t0

    def _finish(self, unit):
        self.open.end(unit)
        self.prof.step()  # saves the slice: `_ready`
        self.slices.append(self.open)
        self.open = None

    def _ready(self, prof):
        self.open.read(prof)

    def close(self, unit):
        """At the window's end: a slice still open is cut there."""
        if self.open is not None:
            self._finish(unit)
            self.slices[-1].complete = False
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            self.prof = None

    def best(self):
        """The complete slice with the fewest lost launches (a partial one,
        cut by the window's end, only where there is no other), or None."""
        if not self.slices:
            return None
        return min(self.slices, key=lambda s: (not s.complete, s.lost))

    def near(self, depth):
        """Units handed within `depth` of a slice (the profiler's own
        start and stop stall them)."""
        out = set()
        for s in self.slices:
            out.update(range(s.first - depth, s.last + depth + 1))
        return out


class Slice:
    """One recorded stretch of the window: its wall, its device records
    (kernels, copies, memsets), the offset of the trace's clock from the
    host's, and how many launches lost their records."""

    def __init__(self, torch, device, first):
        self.torch, self.device = torch, device
        self.first, self.last, self.complete = first, first, True
        self.events, self.wall_s, self.lost = [], 0.0, 0
        self.offset_us = None  # trace ts - host clock (us)

    def begin(self):
        with self.torch.profiler.record_function(MARK):
            self.mark = time.perf_counter()
        self.t0 = time.perf_counter()

    def end(self, unit):
        """After the device has run what was launched in the slice."""
        self.torch.cuda.synchronize(self.device)
        self.wall_s = time.perf_counter() - self.t0
        self.last = unit

    def read(self, prof):
        t_read = time.perf_counter()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        marks = [e for e in events if e.get("name") == MARK and "ts" in e]
        if marks:
            self.offset_us = marks[0]["ts"] - self.mark * 1e6
        self.events = [e for e in events if e.get("cat") in DEVICE_WORK]
        kept = {e.get("args", {}).get("correlation") for e in self.events}
        lost = [e.get("name") for e in events
                if e.get("cat", "").startswith("cuda_")
                and ("LaunchKernel" in e.get("name", "")
                     or "GraphLaunch" in e.get("name", ""))
                and e.get("args", {}).get("correlation") not in kept]
        self.lost = len(lost)
        print(f"traced slice: {self.wall_s:.3f} s, {len(self.events)} device "
              f"records, {self.lost} launches without records {lost[:4]}; "
              f"read in {time.perf_counter() - t_read:.3f} s",
              file=sys.stderr)

    # readings ---------------------------------------------------------------

    def busy_s(self):
        """Seconds of the slice's wall in which a device record ran (the
        union of the records, clipped to the slice: some began before
        it)."""
        lo, hi = float("-inf"), float("inf")
        if self.offset_us is not None:
            lo = self.t0 * 1e6 + self.offset_us
            hi = lo + self.wall_s * 1e6
        busy, end = 0.0, None
        for s, e in sorted((max(ev["ts"], lo), min(ev["ts"] + ev["dur"], hi))
                           for ev in self.events):
            if e <= s:
                continue
            if end is None or s > end:
                busy, end = busy + e - s, e
            elif e > end:
                busy, end = busy + e - end, e
        return busy / 1e6

    def records(self, match=None):
        """Device records whose name `match` accepts (all without one)."""
        return [e for e in self.events if match is None or match(e["name"])]

    def seconds(self, match=None):
        return sum(e["dur"] for e in self.records(match)) / 1e6

    def breakdown(self, spans, top=10):
        """{"device_ops": [[name, s]], "idle_gaps": [[host span, s]]}: the
        device ops that took most time, and the longest gaps between device
        records by the host span that covers most of each."""
        by_name = defaultdict(float)
        for e in self.events:
            by_name[e["name"][:160]] += e["dur"] / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        end = None
        for s, e in sorted((ev["ts"], ev["ts"] + ev["dur"])
                           for ev in self.events):
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:top]:
            label = "no span"
            if self.offset_us is not None:
                label = spans.label((s - self.offset_us) / 1e6,
                                    (e - self.offset_us) / 1e6)
            out.append([label, (e - s) / 1e6])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": out}
