"""The readers of the port's spans (`metrics/*.py` whose source is
`program_span` over `mmnc_tpu_torch/utils/profiling.py`), each on a
hand-made reading: a slice from host second 100 to 101 and the port's
span records. They keep what starts inside the slice, count batches by
the tags of `stream.compress` spans and steps by the train calls, take
the spans' own bookkeeping (`Record.cost`) out of the host times, and
return None where the port keeps no spans (a program without them
included) or dropped some past its cap."""

import pytest
import torch

from mmnc_tpu_torch.utils import profiling
from portbench import registry, trace
from portbench.drivers import common

T0, WALL = 100.0, 1.0
OFFSET_US = 5e6  # the trace's clock less the host's
MAIN, CODER = 1, 2
NEW = ("lock_wait_ms.stream", "coder_queue_ms.stream",
       "replay_host_ms.stream", "signature_ms.stream",
       "compress_device_ms.stream", "synthesis_device_ms.stream",
       "call_host_ms.train", "call_idle_ms.train")


def reader(name):
    return registry.Cell("rgb.stream64").reader(name)


def reading(events=()):
    s = trace.Slice(torch, torch.device("cpu"), 0)
    s.t0, s.wall_s, s.offset_us = T0, WALL, OFFSET_US
    s.events = list(events)
    return common.Reading(units=50, window_s=10.0, launches={},
                          products=0.0, peak_flops=1.0, slice=s)


def rec(name, start, ms, thread=MAIN, id=0, parent=None, tag=None,
        args=None, cost_ms=0.0):
    return profiling.Record(name, start, start + ms / 1e3, thread, id,
                            parent, tag, args, cost_ms / 1e3)


def batches():
    """stream.compress of batches 0-3 in the slice, 4 and 5 outside, and
    one in the slice without a tag (its batch began before the profiler
    did), which counts as no batch."""
    return ([rec("stream.compress", T0 + 0.1 * (k + 1), 3.0, tag=k)
             for k in range(4)]
            + [rec("stream.compress", T0 - 0.5, 3.0, tag=4),
               rec("stream.compress", T0 + WALL + 0.1, 3.0, tag=5),
               rec("stream.compress", T0 + 0.01, 3.0)])


@pytest.fixture
def port(monkeypatch):
    """port(spans, device_spans=()): the records the readers see."""
    def give(spans, device=()):
        monkeypatch.setattr(profiling, "spans", lambda: list(spans))
        monkeypatch.setattr(profiling, "device_spans", lambda: list(device))
    return give


@pytest.mark.parametrize("metric, span", [
    ("lock_wait_ms.stream", "stream.lock_wait"),
    ("coder_queue_ms.stream", "stream.queued"),
    ("signature_ms.stream", "graphs.signature"),
])
def test_a_stream_wait_over_the_slices_batches(port, metric, span):
    inside = [rec(span, T0 + 0.2, 2.0, MAIN, tag=1),
              rec(span, T0 + 0.3, 2.0, CODER, tag=0),
              rec(span, T0 + 0.9, 1.0, CODER, tag=3)]
    outside = [rec(span, T0 - 0.2, 50.0), rec(span, T0 + WALL, 50.0)]
    port(batches() + inside + outside)
    assert reader(metric).read(reading()) == pytest.approx(5.0 / 4)


def test_replay_host_leaves_out_each_runs_own_launch(port):
    spans = batches() + [
        rec("graphs.run", T0 + 0.2, 3.0, id=10, tag=0,
            args={"program": "_compress_device_fused"}),
        rec("graphs.launch", T0 + 0.201, 1.0, id=11, parent=10, tag=0),
        rec("graphs.run", T0 + 0.4, 1.0, CODER, id=12, tag=0),
        # a launch under a run that kept no record (a capture's)
        rec("graphs.launch", T0 + 0.5, 9.0, id=13, parent=99),
        rec("graphs.run", T0 + WALL + 0.2, 40.0, id=14),
    ]
    port(spans)
    assert reader("replay_host_ms.stream").read(reading()) == \
        pytest.approx((2.0 + 1.0) / 4)


@pytest.mark.parametrize("metric, program, other", [
    ("compress_device_ms.stream", "_compress_device_fused",
     "_synthesize_from_symbols"),
    ("synthesis_device_ms.stream", "_synthesize_from_symbols",
     "_compress_device_fused"),
])
def test_a_programs_device_ms_over_the_slices_batches(port, metric,
                                                      program, other):
    device = [profiling.DeviceRecord(program, T0 + 0.1 * k, 8.0, k)
              for k in range(4)]
    device += [profiling.DeviceRecord(other, T0 + 0.2, 100.0, 1),
               profiling.DeviceRecord(program, T0 - 0.1, 100.0, 9),
               profiling.DeviceRecord(program, T0 + WALL, 100.0, 9)]
    port(batches(), device)
    assert reader(metric).read(reading()) == pytest.approx(8.0)


def test_call_host_leaves_out_the_replay(port):
    spans = [rec("train.call", T0 + 0.1, 10.0, id=1, tag=7,
                 args={"steps": 1}),
             rec("train.replay", T0 + 0.102, 7.0, id=2, parent=1, tag=7),
             rec("train.call", T0 + 0.2, 6.0, id=3, tag=8,
                 args={"steps": 1}),
             rec("train.replay", T0 + 0.201, 5.0, id=4, parent=3, tag=8),
             rec("train.call", T0 - 0.1, 50.0, id=5, args={"steps": 1})]
    port(spans)
    assert reader("call_host_ms.train").read(reading()) == \
        pytest.approx((3.0 + 1.0) / 2)


def test_the_host_readers_take_out_the_spans_bookkeeping(port):
    port(batches() + [
        rec("graphs.run", T0 + 0.2, 3.0, id=10, tag=0, cost_ms=0.5),
        rec("graphs.signature", T0 + 0.2005, 0.8, id=11, parent=10, tag=0),
        rec("graphs.launch", T0 + 0.202, 1.0, id=12, parent=10, tag=0),
        rec("train.call", T0 + 0.3, 10.0, id=20, args={"steps": 2},
            cost_ms=1.0),
        rec("train.replay", T0 + 0.302, 7.0, id=21, parent=20,
            cost_ms=0.25)])
    r = reading()
    assert reader("replay_host_ms.stream").read(r) == \
        pytest.approx((3.0 - 0.5 - 1.0) / 4)
    assert reader("signature_ms.stream").read(r) == pytest.approx(0.8 / 4)
    assert reader("call_host_ms.train").read(r) == \
        pytest.approx((10.0 - 1.0 - (7.0 - 0.25)) / 2)


def device(ts_s, ms, correlation):
    """A kernel record at host second `ts_s` on the trace's clock."""
    return {"cat": "kernel", "name": "k", "ts": ts_s * 1e6 + OFFSET_US,
            "dur": ms * 1e3, "args": {"correlation": correlation}}


def test_call_idle_counts_dry_gaps_the_host_parts_cover(port):
    c = T0 + 0.1
    parts = [("train.inputs", 0.0, 2.0), ("train.noise", 2.0, 2.0),
             ("train.replay", 4.0, 3.0), ("train.outputs", 7.0, 2.0)]
    spans = [rec("train.call", c, 10.0, id=1, tag=0, args={"steps": 1})]
    spans += [rec(n, c + a / 1e3, ms, id=2 + i, parent=1, tag=0)
              for i, (n, a, ms) in enumerate(parts)]
    # a span of another thread's or outside the call covers nothing
    spans += [rec("train.inputs", c + 0.03, 10.0, CODER, id=9)]
    events = [
        device(c - 0.01, 10.5, 100),        # the last step's replay
        device(c + 0.0010, 0.5, 101),       # copy: dry 0.5 ms (inputs)
        device(c + 0.0026, 1.0, 102),       # dry 1.1 ms, most in noise
        device(c + 0.0043, 0.5, 103),       # dry 0.7 ms, most in noise
        device(c + 0.0052, 0.3, 104),       # dry 0.4 ms (replay)
        device(c + 0.0060, 0.2, 104),       # same launch: left out
        device(c + 0.0085, 0.5, 105),       # dry 2.3 ms, most in outputs
        device(c + 0.0300, 0.5, 106),       # dry 21 ms, no part: left out
        device(T0 + WALL + 0.1, 1.0, 107),  # a gap past the slice's end
    ]
    port(spans)
    r = reading(events)
    by, steps = reader("call_idle_ms.train").split(r)
    assert steps == 1
    assert by == pytest.approx({"train.inputs": 0.5, "train.noise": 1.8,
                                "train.replay": 0.4, "train.outputs": 2.3})
    assert reader("call_idle_ms.train").read(r) == pytest.approx(4.6)


@pytest.mark.parametrize("metric", NEW)
def test_no_spans_no_reading(port, metric, monkeypatch):
    port([])
    events = [device(T0 + 0.1, 1.0, 1), device(T0 + 0.2, 1.0, 2)]
    assert reader(metric).read(reading(events)) is None
    port(batches() + [rec("train.call", T0 + 0.1, 1.0, args={"steps": 1})])
    assert reader(metric).read(common.Reading(
        units=5, window_s=1.0, launches={}, products=0.0,
        peak_flops=1.0)) is None  # no slice (an untraced or CPU run)
    # a program without spans (the commit before them): nothing, no raise
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "device_spans")
    assert reader(metric).read(reading(events)) is None


def every_reading():
    """Records, device records and kernel records from which each reader
    reads a number."""
    c = T0 + 0.5
    spans = batches() + [
        rec("stream.lock_wait", T0 + 0.2, 1.0, tag=0),
        rec("stream.queued", T0 + 0.2, 5.0, CODER, tag=0),
        rec("graphs.run", T0 + 0.2, 3.0, id=10, tag=0),
        rec("graphs.signature", T0 + 0.2005, 0.8, id=11, parent=10, tag=0),
        rec("graphs.launch", T0 + 0.202, 1.0, id=12, parent=10, tag=0),
        rec("train.call", c, 10.0, id=20, args={"steps": 1}),
        rec("train.inputs", c, 4.0, id=21, parent=20),
        rec("train.replay", c + 0.004, 6.0, id=22, parent=20)]
    programs = [profiling.DeviceRecord(p, T0 + 0.2, 8.0, 0) for p in
                ("_compress_device_fused", "_synthesize_from_symbols")]
    events = [device(c - 0.001, 1.0, 1), device(c + 0.002, 1.0, 2)]
    return spans, programs, events


@pytest.mark.parametrize("metric", NEW)
def test_a_dropped_record_gives_no_reading(port, metric, monkeypatch):
    spans, programs, events = every_reading()
    port(spans, programs)
    assert reader(metric).read(reading(events)) > 0
    monkeypatch.setattr(profiling, "dropped", lambda: 1)
    assert reader(metric).read(reading(events)) is None


def test_a_reader_sees_a_drop_the_port_counts(monkeypatch):
    """The cap of the real store, not a stand-in: past it the readers
    give nothing."""
    monkeypatch.setattr(profiling, "MAX_RECORDS", 3)
    profiling.clear()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            for k in range(4):
                with profiling.tagged(k), profiling.span("stream.compress"):
                    with profiling.span("stream.lock_wait"):
                        pass
        assert profiling.dropped() == 5
        r = reading()
        r.slice.t0 = min(s.start for s in profiling.spans()) - 1.0
        r.slice.wall_s = 1e6
        assert reader("lock_wait_ms.stream").read(r) is None
        monkeypatch.setattr(profiling, "MAX_RECORDS", 1_000_000)
        profiling.clear()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            with profiling.tagged(0), profiling.span("stream.compress"):
                with profiling.span("stream.lock_wait"):
                    pass
        r.slice.t0 = min(s.start for s in profiling.spans()) - 1.0
        assert reader("lock_wait_ms.stream").read(r) is not None
    finally:
        profiling.clear()
