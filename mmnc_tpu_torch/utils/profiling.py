"""Profiling helpers: torch.profiler traces, the port's spans and
step-time statistics (mmnc_tpu/utils/profiling.py).

`trace(log_dir)` records the enclosed block with torch.profiler (host
ops, and the card's kernels and copies when CUDA is available) and writes
a Chrome trace (open it in chrome://tracing or Perfetto) into log_dir;
`start_trace` / `stop_trace` do the same across calls, as the train loop
needs. `StepTimer` accumulates wall-clock step times and reports
p50/p95/mean.

Spans. `span(name)` marks a stretch of host work in the port (the
stream's stages and waits, the graph replays, the train call's parts).
It is on only while a torch profiler records, whoever started it
(`start_trace`, `fit(profile_dir=...)`, a benchmark's profiler slice):
torch's own flag is read once a span, and with it off `span` returns one
shared context that does nothing (no clock, no allocation, no
`record_function`). With it on a span opens `record_function(name)`, so
it shows in the profiler's trace on the device trace's clock, and keeps a
`Record`: its name, start and end on `time.perf_counter()`, its thread,
the span that encloses it on that thread, the request's tag (`tagged`:
the stream batch's index, the train call's first step) and its
attributes, and the thread's CPU seconds (`time.thread_time()`) that the
spans' own bookkeeping took inside it (`cost`: its children's
`record_function`s and records, its device spans' events), so that a
reader can take the instrumentation out of a span's time. CPU, not wall:
the wall would also hold the waits for the interpreter lock that other
threads' Python fills, which runs at some other point without spans. `spans()` returns the records; `start_trace` and
`clear()` drop them; past MAX_RECORDS they are counted (`dropped()`) and
not kept, and a reader that sums them gives no reading where any were.
`tagged` is the shared no-op too while no profiler records.

`device_span(name, device)` times device work on the current stream by a
pair of timing CUDA events from a pool (a pair the card has run is read
and its events reused), while the flag is on and the stream is not being
captured (no event is recorded into a graph); `device_spans()` gives
each pair's device ms, waiting for the card where it has not run them.
"""

import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

MAX_RECORDS = 1_000_000  # span and device span records kept


def start_trace(log_dir: str):
    """Start a torch.profiler trace; returns the handle `stop_trace` takes.
    Drops the spans recorded so far (`clear`)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    clear()
    prof = profile(activities=activities)
    prof.__enter__()
    return prof, log_dir


def stop_trace(handle) -> str:
    """Wait for the card, stop the trace `start_trace` returned and write
    it as <log_dir>/trace_<time>.json; returns the path."""
    prof, log_dir = handle
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed block into log_dir."""
    handle = start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace(handle)


# --- spans ------------------------------------------------------------------

class Record(NamedTuple):
    """One span: host seconds on `time.perf_counter()`."""
    name: str
    start: float
    end: float
    thread: int               # threading.get_ident()
    id: int
    parent: Optional[int]     # the enclosing span's id, on the same thread
    tag: object               # the request's tag (`tagged`), or None
    args: Optional[dict]      # attributes, e.g. a graph's program
    cost: float = 0.0         # CPU seconds of span bookkeeping inside it


class DeviceRecord(NamedTuple):
    """One device span: the device ms between its two events, and the
    host clock when the first was recorded."""
    name: str
    start: float
    ms: float
    tag: object


class _Store:
    """The records of the process's spans, and the device spans' events
    (pending pairs and a pool of free ones)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.records = []
        self.pending = []   # (name, start, tag, start event, end event)
        self.device = []
        self.events = []    # free timing events
        self.dropped = 0

    def add(self, kept, record):
        with self.lock:
            if len(self.records) + len(self.device) \
                    + len(self.pending) < MAX_RECORDS:
                kept.append(record)
            else:
                self.dropped += 1

    def event(self):
        """A free timing event: from the pool, else the oldest pending
        pair's once the card has run it (read first), else a new one."""
        with self.lock:
            if not self.events and self.pending \
                    and self.pending[0][4].query():
                self.read(self.pending.pop(0))
            if self.events:
                return self.events.pop()
        return torch.cuda.Event(enable_timing=True)

    def read(self, pair):
        """Keep a run pending pair as a DeviceRecord; free its events."""
        name, start, tag, begin, end = pair
        self.device.append(DeviceRecord(name, start, begin.elapsed_time(end),
                                        tag))
        self.events += [begin, end]


_store = _Store()
_ids = itertools.count()
_local = threading.local()  # .stack: open span ids; .tag: the request's;
#                             .cost: this thread's bookkeeping CPU seconds


def recording() -> bool:
    """Whether a torch profiler records (torch's flag, any thread)."""
    return _autograd_profiler._is_profiler_enabled


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _cost() -> float:
    return getattr(_local, "cost", 0.0)


def _spent(since: float):
    """Count this thread's CPU seconds from `since` (`time.thread_time()`)
    to now as bookkeeping."""
    _local.cost = _cost() + time.thread_time() - since


class _Off:
    """The span while no profiler records: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def drop(self):
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "args", "id", "parent", "start", "fn", "keep",
                 "opened", "inner")

    def __init__(self, name, args, opened):
        self.name, self.args, self.keep = name, args, True
        self.opened = opened

    def __enter__(self):
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.start = time.perf_counter()
        _spent(self.opened)
        self.inner = _local.cost
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        closing = time.thread_time()
        inner = _cost() - self.inner
        _stack().pop()
        self.fn.__exit__(*exc)
        if self.keep:
            _store.add(_store.records, Record(
                self.name, self.start, end, threading.get_ident(), self.id,
                self.parent, getattr(_local, "tag", None), self.args, inner))
        _spent(closing)
        return False

    def drop(self):
        """Keep no record of this span (it still shows in the trace)."""
        self.keep = False


def span(name: str, args: Optional[dict] = None):
    """A context manager marking host work `name` (module docstring):
    the shared no-op unless a torch profiler records. `args`: attributes
    the record keeps."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, args, time.thread_time())


class _Tagged:
    __slots__ = ("tag", "outer")

    def __init__(self, tag):
        self.tag = tag

    def __enter__(self):
        self.outer = getattr(_local, "tag", None)
        _local.tag = self.tag

    def __exit__(self, *exc):
        _local.tag = self.outer
        return False


def tagged(tag):
    """A context manager under which this thread's spans carry `tag`: the
    shared no-op unless a torch profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Tagged(tag)


def stamp() -> Optional[float]:
    """The host clock now while a profiler records, else None: the start
    of a span that `record` closes later, maybe on another thread."""
    return time.perf_counter() if recording() else None


def record(name: str, start: Optional[float]):
    """Keep a span `name` from `start` (a `stamp`) to now on this thread,
    under its open span and tag; nothing where `start` is None. It has no
    `record_function`: the trace cannot open one in the past."""
    if start is None:
        return
    closing = time.thread_time()
    stack = _stack()
    _store.add(_store.records, Record(
        name, start, time.perf_counter(), threading.get_ident(), next(_ids),
        stack[-1] if stack else None, getattr(_local, "tag", None), None))
    _spent(closing)


def spans():
    """The records kept since the last `clear`, in the order they ended."""
    with _store.lock:
        return list(_store.records)


def dropped() -> int:
    """Records not kept since the last `clear` (past MAX_RECORDS)."""
    return _store.dropped


def clear():
    """Drop every record, device spans' included."""
    with _store.lock:
        _store.records = []
        _store.device = []
        _store.events.extend(e for p in _store.pending for e in p[3:])
        _store.pending = []
        _store.dropped = 0


class _DeviceSpan:
    __slots__ = ("name", "start", "opened", "begin")

    def __init__(self, name, opened):
        self.name, self.opened = name, opened

    def __enter__(self):
        self.start = time.perf_counter()
        self.begin = _store.event()
        self.begin.record()
        _spent(self.opened)
        return self

    def __exit__(self, *exc):
        closing = time.thread_time()
        end = _store.event()
        end.record()
        _store.add(_store.pending, (self.name, self.start,
                                    getattr(_local, "tag", None),
                                    self.begin, end))
        _spent(closing)
        return False


def device_span(name: str, device):
    """A context manager timing the device work it encloses on the current
    stream of `device` (module docstring): the shared no-op unless a
    torch profiler records, `device` is a card and its current stream is
    not being captured. Its events' CPU seconds count as bookkeeping."""
    if not _autograd_profiler._is_profiler_enabled \
            or device.type != "cuda":
        return _OFF
    opened = time.thread_time()
    from .. import graphs
    if graphs.capturing(device):
        return _OFF
    return _DeviceSpan(name, opened)


def device_spans():
    """The device spans kept since the last `clear`, each pair waited for
    and read (its events go back to the pool)."""
    with _store.lock:
        pending, _store.pending = _store.pending, []
    for pair in pending:
        pair[4].synchronize()
    with _store.lock:
        for pair in pending:
            _store.read(pair)
        return list(_store.device)


# --- step times -------------------------------------------------------------

class StepTimer:
    """Wall-clock step statistics; call tick() once per step."""

    def __init__(self, skip_first: int = 2):
        self.skip_first = skip_first
        self._times = []
        self._last: Optional[float] = None
        self._seen = 0

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._seen += 1
            if self._seen > self.skip_first:
                self._times.append(now - self._last)
        self._last = now

    def stats(self) -> dict:
        if not self._times:
            return {"steps": 0}
        arr = np.asarray(self._times)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "steps_per_s": float(1.0 / arr.mean()),
        }
