"""What the drivers share: the run's inputs from the seed, the outcome a
driver hands to `run.py`, the readings per-layer metrics take, and the
reservoir that samples the answers to judge."""

import gc
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .. import costs


def make_inputs(torch, cfg, n_batches, batch, seed, device):
    """`n_batches` batches {task: (batch, H, W, C) float32 NHWC} made on
    the device from the seed: U[0, 1) values, semantic labels 0..16."""
    from ..reference.codec import TASKS
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    size = cfg["image_size"]
    out = []
    for _ in range(n_batches):
        b = {}
        for task in cfg["tasks"]:
            x = torch.rand((batch, size, size, TASKS[task][0]),
                           generator=gen, device=device)
            b[task] = torch.floor(x * 16.99) if task == "semantic" else x
        out.append(b)
    return out


class Stages:
    """Host seconds of the set-up's stages, printed to standard error."""

    def __init__(self, t_start):
        self.last, self.parts = t_start, []

    def mark(self, name):
        now = time.perf_counter()
        self.parts.append(f"{name} {now - self.last:.3f} s")
        self.last = now

    def report(self):
        print("set-up: " + ", ".join(self.parts), file=sys.stderr)


class Reservoir:
    """k items drawn uniformly from a stream, by a generator from the
    seed (reservoir sampling): each item's (index, value) kept."""

    def __init__(self, k, seed):
        self.k, self.items = k, []
        self.rng = np.random.default_rng(seed)

    def offer(self, index, value):
        if len(self.items) < self.k:
            self.items.append((index, value))
            return
        j = int(self.rng.integers(0, index + 1))
        if j < self.k:
            self.items[j] = (index, value)


@dataclass
class Reading:
    """What a per-layer metric's reader takes (`metrics/*.py`)."""
    units: int                     # batches or steps in the window
    window_s: float                # the window, less the profiler's stalls
    launches: dict                 # kernel -> [bound s of each launch a unit]
    products: float                # product FLOPs a unit
    peak_flops: float
    spans: object = None           # trace.Spans
    slice: object = None           # trace.Slice
    capture_s: float = 0.0
    loader_wait_s: Optional[float] = None
    latencies_s: list = field(default_factory=list)

    def kernel_records(self, patterns, exclude=()):
        def match(name):
            return (any(p in name for p in patterns)
                    and not any(x in name for x in exclude))
        return self.slice.records(match) if self.slice is not None else []

    def slice_units(self):
        """Units the slice's records cover: its GDN records over the GDN
        launches of a unit."""
        n = len(self.kernel_records(("gdn_kernel",),
                                    ("gdn_backward", "deconv_igdn")))
        per = len(self.launches.get("gdn", ()))
        return n / per if per and n else None

    def roofline(self, kernel, patterns, exclude=(), time_patterns=None):
        """100 x the mean bound of the kernel's launches over the mean
        device time of its records in the slice (time_patterns: the
        records the op's time takes in, where it has helper kernels)."""
        bounds = self.launches.get(kernel)
        recs = self.kernel_records(patterns, exclude)
        if not bounds or not recs:
            return None
        timed = (recs if time_patterns is None
                 else self.kernel_records(time_patterns, exclude))
        t = sum(e["dur"] for e in timed) / 1e6
        if t <= 0:
            return None
        return 100.0 * (sum(bounds) / len(bounds)) / (t / len(recs))

    def device_s_per_unit(self, match=None):
        units = self.slice_units()
        if units is None:
            return None
        return self.slice.seconds(match) / units

    def mfu(self):
        return 100.0 * self.products * self.units / self.window_s \
            / self.peak_flops

    def idle_share(self):
        if self.slice is None or self.slice.wall_s <= 0:
            return None
        return 100.0 * (1.0 - self.slice.busy_s() / self.slice.wall_s)


@dataclass
class Outcome:
    """A driver's result: end-to-end values, the readings, the compared
    numbers ({name: (value, limit)}), counts and the device's peak."""
    end_to_end: dict
    reading: Reading
    checks: dict
    attempted: int
    failed: int
    memory_peak_bytes: int


def reading_for(cfg, traffic, program, units, window_s, **kw):
    elt = costs.elt_of(traffic.get("dtype", "float32"))
    b = traffic["batch"]
    return Reading(
        units=units, window_s=window_s,
        launches=costs.launches(cfg, b, program, elt),
        products=costs.model_products(cfg, b, program)
        * (1 if program == "trip" else 3),
        peak_flops=costs.peak_flops(elt), **kw)


def release(torch, device):
    """Give the program's memory back before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()

