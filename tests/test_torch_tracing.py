"""The port's spans (`mmnc_tpu_torch/utils/profiling.py`) on the CPU.

* With no profiler recording, `span` is one shared no-op: it records
  nothing and opens no `record_function`; under a profiler's schedule
  only the active steps' spans are kept.
* A streamed round trip keeps, for every batch, one `stream.queued`, a
  `stream.lock_wait` on each thread and one tag shared by its
  main-thread and coder-thread spans; the benchmark's hook of
  `streaming._span` still times its five stages.
* An eager train call keeps `train.call` with its children, parents and
  tag; the graphs keep `graphs.run` for replayed signatures only, with
  `graphs.signature` and `graphs.launch` under it.
* Threads at a short switch interval lose no record, and each record
  keeps its own thread's parent and tag.
* A span's `cost` holds the bookkeeping of the spans inside it (their
  `record_function`s and records), and not the work it encloses.
* Each span shows in the profiler's own trace at one host-clock offset.
* `device_span` records no CUDA event while the stream is captured (a
  stand-in for `graphs.capturing` and for torch.cuda's events).
"""

import collections
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from mmnc_tpu_torch import build_model, graphs
from mmnc_tpu_torch.models import streaming
from mmnc_tpu_torch.train import create_train_state, make_multi_train_step
from mmnc_tpu_torch.utils import profiling

STAGES = {"stream.compress", "stream.d2h_wait", "stream.rans_encode",
          "stream.rans_decode", "stream.synthesize"}


@pytest.fixture(autouse=True)
def fresh():
    """Two torch threads, and no records from another test."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    profiling.clear()
    yield
    profiling.clear()
    torch.set_num_threads(before)


def recorder():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def codec():
    model = build_model(1, ["rgb"], latent_channels=8, conv_channels=4,
                        device="cpu")
    model.update_bottleneck_values()
    gen = torch.Generator().manual_seed(3)
    batches = [{"rgb": torch.rand(1, 256, 256, 3, generator=gen)}
               for _ in range(4)]
    return model, batches


def test_without_a_profiler_a_span_is_the_shared_no_op(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function opened")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not profiling.recording()
    a, b = profiling.span("x"), profiling.span("y", {"k": 1})
    assert a is b and profiling.tagged(7) is a
    with a as s, profiling.tagged(7):
        s.drop()
    assert profiling.stamp() is None
    profiling.record("x", profiling.stamp())
    with profiling.device_span("p", torch.device("cuda", 0)) as d:
        assert d is a
    assert profiling.spans() == [] and profiling.device_spans() == []


def test_under_a_schedule_only_the_active_steps_keep_spans():
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=1, warmup=1, active=2,
                                   repeat=1)) as prof:
        for i in range(6):
            with profiling.span(f"step{i}"):
                pass
            prof.step()
    assert [r.name for r in profiling.spans()] == ["step2", "step3"]


def test_records_keep_thread_parent_tag_and_attributes():
    with recorder():
        with profiling.tagged(5), profiling.span("outer", {"a": 1}):
            with profiling.span("inner"):
                pass
            with profiling.span("dropped") as s:
                s.drop()
        with profiling.span("untagged"):
            pass
    inner, outer, untagged = profiling.spans()
    assert (outer.name, outer.parent, outer.tag, outer.args) == \
        ("outer", None, 5, {"a": 1})
    assert (inner.parent, inner.tag, inner.args) == (outer.id, 5, None)
    assert untagged.tag is None and untagged.parent is None
    assert inner.thread == outer.thread == threading.get_ident()
    assert outer.start <= inner.start <= inner.end <= outer.end


def test_threads_lose_no_record_and_keep_their_own_parents_and_tags():
    n, each = 32, 100

    def work(i):
        with profiling.tagged(i):
            for _ in range(each):
                with profiling.span("outer"), profiling.span("inner"):
                    pass

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with recorder():
            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(before)
    recs = profiling.spans()
    assert len(recs) == 2 * n * each
    assert len({r.id for r in recs}) == len(recs)
    assert collections.Counter(r.tag for r in recs) == \
        {i: 2 * each for i in range(n)}
    outer = {r.id: r for r in recs if r.name == "outer"}
    for r in recs:
        if r.name == "inner":
            assert (outer[r.parent].thread, outer[r.parent].tag) == \
                (r.thread, r.tag)
        else:
            assert r.parent is None


def _burn(seconds):
    """Spend `seconds` of this thread's CPU."""
    start = time.thread_time()
    while time.thread_time() - start < seconds:
        pass


class _SlowFunction:
    """A `record_function` that takes 5 ms of CPU to open and 5 to close."""

    def __init__(self, name):
        pass

    def __enter__(self):
        _burn(0.005)

    def __exit__(self, *exc):
        _burn(0.005)


def test_a_span_counts_the_bookkeeping_inside_it_not_the_work(
        monkeypatch):
    with recorder():
        monkeypatch.setattr(torch.profiler, "record_function", _SlowFunction)
        with profiling.span("outer"):
            with profiling.span("a"):
                time.sleep(0.02)
            with profiling.span("b"):
                pass
            profiling.record("late", profiling.stamp())
        monkeypatch.undo()
    a, b, late, outer = profiling.spans()
    assert a.cost == b.cost == late.cost == 0.0
    # two children's enter and exit, 4 x 5 ms of CPU; the 20 ms the work
    # sleeps is no bookkeeping
    assert 0.02 <= outer.cost < 0.03
    assert outer.end - outer.start - outer.cost >= 0.02
    # a span's own record_function (10 ms) lies outside its own time
    assert b.end - b.start < 0.01


def test_past_the_cap_records_are_counted_not_kept(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_RECORDS", 2)
    with recorder():
        for i in range(5):
            with profiling.span(f"s{i}"):
                pass
    assert [r.name for r in profiling.spans()] == ["s0", "s1"]
    assert profiling.dropped() == 3
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_start_trace_drops_the_records(tmp_path):
    with recorder():
        with profiling.span("before"):
            pass
    handle = profiling.start_trace(str(tmp_path))
    try:
        assert profiling.spans() == []
        with profiling.span("inside"):
            pass
    finally:
        path = profiling.stop_trace(handle)
    assert [r.name for r in profiling.spans()] == ["inside"]
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "inside" in names


def test_a_stream_tags_every_batch_on_both_threads(codec):
    model, batches = codec
    with recorder():
        out = list(streaming.stream_roundtrip(model, batches))
    assert len(out) == 4
    recs = profiling.spans()
    main = threading.get_ident()
    coder = {r.thread for r in recs if r.name == "stream.queued"}
    assert len(coder) == 1 and main not in coder
    for k in range(4):
        mine = [r for r in recs if r.tag == k]
        names = {(r.name, r.thread == main) for r in mine}
        assert [r.name for r in mine].count("stream.queued") == 1
        assert {("stream.lock_wait", True), ("stream.lock_wait", False),
                ("stream.compress", True), ("stream.queued", False),
                ("stream.synthesize", False)} <= names
        assert STAGES <= {r.name for r in mine}
    queued = {r.tag: r for r in recs if r.name == "stream.queued"}
    compress = {r.tag: r for r in recs if r.name == "stream.compress"}
    for k in range(4):  # submitted after its compress, before its coding
        assert compress[k].end <= queued[k].start <= queued[k].end
    assert all(r.tag in range(4) for r in recs)


def test_the_benchmarks_hook_still_times_the_five_stages(codec):
    from portbench import trace

    model, batches = codec
    spans = trace.Spans()
    with recorder(), spans.hooked(streaming):
        list(streaming.stream_roundtrip(model, batches[:2]))
    assert set(spans.totals) == STAGES
    assert streaming._span("x") is profiling.span("x")  # hook undone
    assert STAGES <= {r.name for r in profiling.spans()}


def _train_call():
    model = build_model(1, ["mono"], latent_channels=8, conv_channels=4,
                        device="cpu")
    state = create_train_state(model, 10)
    state.step = 4
    rng = np.random.default_rng(0)
    batch = {"mono": rng.random((1, 256, 256, 1)).astype(np.float32)}
    return make_multi_train_step(model, 1), state, batch


def test_an_eager_train_call_keeps_its_parts_under_train_call():
    multi, state, batch = _train_call()
    with recorder():
        multi(state, [batch], torch.Generator(), 9)
    recs = profiling.spans()
    (call,) = [r for r in recs if r.name == "train.call"]
    assert (call.parent, call.tag, call.args) == (None, 4, {"steps": 1})
    children = {r.name for r in recs if r.parent == call.id}
    assert children == {"train.inputs", "train.noise"}
    (noise,) = [r for r in recs if r.name == "train.noise"]
    assert call.start <= noise.start <= noise.end <= call.end
    assert all(r.tag == 4 for r in recs)


def test_port_spans_show_in_the_trace_at_one_clock_offset(codec, tmp_path):
    multi, state, batch = _train_call()
    model, batches = codec
    with recorder() as prof:
        # a process's first record_function spends up to ~1 ms setting
        # itself up after the trace's timestamp: leave it out
        with profiling.span("warm-up"):
            pass
        multi(state, [batch], torch.Generator(), 9)
        with profiling.span("outer"), profiling.span("inner"):
            pass
        list(streaming.stream_roundtrip(model, batches[:2]))
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    main_only = ("train.call", "train.inputs", "train.noise", "outer",
                 "inner", "stream.compress")
    offsets = []
    for name in main_only:
        mine = sorted(r.start for r in profiling.spans() if r.name == name)
        shown = sorted(e["ts"] for e in events if e.get("name") == name
                       and e.get("cat") == "user_annotation")
        assert mine and len(shown) == len(mine), name
        offsets += [ts - 1e6 * t for ts, t in zip(shown, mine)]
    assert max(offsets) - min(offsets) < 100.0


class _Event:
    """torch.cuda.Event's stand-in: elapsed_time is 2.5 ms."""
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _Event.made += 1

    def record(self, stream=None):
        pass

    def synchronize(self):
        pass

    def query(self):
        return True

    def elapsed_time(self, end):
        return 2.5


@pytest.mark.parametrize("captured", [True, False])
def test_a_device_span_records_no_event_into_a_captured_graph(
        monkeypatch, captured):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(graphs, "capturing", lambda device: captured)
    _Event.made = 0
    card = torch.device("cuda", 0)
    with recorder():
        with profiling.tagged(3):
            for _ in range(2):
                with profiling.device_span("_compress_device_fused", card):
                    pass
        with profiling.device_span("eager", torch.device("cpu")):
            pass
    got = profiling.device_spans()
    if captured:
        assert _Event.made == 0 and got == []
    else:
        assert [(d.name, d.ms, d.tag) for d in got] == \
            [("_compress_device_fused", 2.5, 3)] * 2
        assert _Event.made == 2  # the first pair, run, lent the second
        profiling.clear()
        with recorder():
            with profiling.device_span("again", card):
                pass
        assert _Event.made == 2 and len(profiling.device_spans()) == 1


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(3))
        self.device, self.dtype = torch.device("cpu"), torch.float32

    @graphs.program
    def double(self, x):
        return {"y": x * self.w * 2}


@pytest.fixture
def fake_card(monkeypatch):
    """The graph path on the CPU: a warm-up runs the body, a capture runs
    it once into static outputs, a replay runs it again into them."""
    class FakeGraph:
        def __init__(self, fn):
            self.fn, self.outputs = fn, fn()

        def replay(self):
            for k, v in self.fn().items():
                self.outputs[k].copy_(v)

        def pool(self):
            return "pool"

    def capture(fn, stream, pool=None):
        graph = FakeGraph(fn)
        return graph, graph.outputs

    monkeypatch.setattr(graphs, "_on_card", lambda model: True)
    monkeypatch.setattr(graphs, "capture_stream", lambda device: None)
    monkeypatch.setattr(graphs, "warm_up",
                        lambda body, *args, stream: body(*args))
    monkeypatch.setattr(graphs, "capture", capture)


def test_graphs_keep_a_run_span_for_replayed_signatures_only(fake_card):
    model = _Tiny()
    with recorder():
        outs = [model.double(torch.full((3,), float(i))) for i in range(4)]
    assert torch.equal(outs[3]["y"], torch.full((3,), 6.0))
    assert graphs.stats(model, "double")["replays"] == 3
    recs = profiling.spans()
    runs = [r for r in recs if r.name == "graphs.run"]
    assert len(runs) == 2  # the capture's call and the warm-up's keep none
    assert all(r.args == {"program": "double"} for r in runs)
    ids = {r.id for r in runs}
    assert len([r for r in recs if r.name == "graphs.signature"]) == 4
    kept = [r for r in recs if r.name in ("graphs.signature", "graphs.launch")
            and r.parent in ids]
    assert sorted(r.name for r in kept) == ["graphs.launch"] * 2 \
        + ["graphs.signature"] * 2


def test_fits_profile_window_shows_the_train_calls(tmp_path):
    """`fit(profile_dir=...)` traces steps 5-10: their train calls are the
    spans kept, and its Chrome trace shows them by name."""
    from mmnc_tpu_torch.data import (BatchLoader, SyntheticMultiTaskDataset,
                                     prerender)
    from mmnc_tpu_torch.train import fit

    model = build_model(1, ["mono"], latent_channels=8, conv_channels=4,
                        device="cpu")
    data = prerender(SyntheticMultiTaskDataset(["mono"], size=11, seed=0))
    stats = {}
    fit(model, BatchLoader(data, 1, shuffle=False), epochs=1,
        out_dir=str(tmp_path), run_name="run", log_images=False,
        compute_metrics=False, profile_dir=str(tmp_path / "trace"),
        stats=stats)
    calls = [r for r in profiling.spans() if r.name == "train.call"]
    assert [r.tag for r in calls] == [5, 6, 7, 8, 9, 10]
    with open(stats["trace"]) as f:
        shown = [e for e in json.load(f)["traceEvents"]
                 if e.get("name") == "train.call"]
    assert len(shown) == 6
