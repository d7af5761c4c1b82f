"""chip_smoke.py's profiler windows (`chip_smoke.profiled`), checked on the
CPU with a stand-in for torch.cuda's synchronisation.

CUPTI now and then loses the device records of the first launches of a
torch.profiler window, which would make a check of a trace's kernel or
graph records fail with the program right. So a window stays open
`PROFILE_WAIT_S` on the host before the profiled call and after it, and a
trace in which a kernel or graph launch call has no device record
(`lost_launches`) and that fails the caller's check of its records
(`complete`) is taken again, up to `tries` times in all.
"""

import types

import pytest
import torch

import chip_smoke


def _call(name, correlation, cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": name, "ts": 0.0, "dur": 1.0,
            "args": {"correlation": correlation}}


def _record(correlation, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": "k", "ts": 0.0, "dur": 1.0,
            "args": {"correlation": correlation}}


def test_lost_launches_counts_launch_calls_without_a_device_record():
    events = [_call("cudaLaunchKernel", 1), _record(1),
              _call("cudaLaunchKernelExC", 2),
              _call("cuLaunchKernel", 3, "cuda_driver"),
              _call("cudaGraphLaunch", 4), _record(4), _record(4),
              _call("cudaGraphLaunch", 5),
              # not a launch: a copy call's record is not asked for
              _call("cudaMemcpyAsync", 6),
              _call("cudaLaunchKernel", 7), _record(7, "gpu_memset")]
    assert chip_smoke.lost_launches(events) == 3
    assert chip_smoke.lost_launches([_call("cudaLaunchKernel", 1),
                                     _record(1)]) == 0


class _Cuda:
    def __init__(self):
        self.syncs = 0

    def synchronize(self):
        self.syncs += 1


FAILS, PASSES = (lambda events: False), (lambda events: True)


@pytest.mark.parametrize("lost, complete, tries, calls, kept", [
    ([0], FAILS, 3, 1, 0),        # nothing lost: kept, the check fails
    ([5, 2, 0], FAILS, 3, 3, 0),  # taken again until nothing is lost
    ([5, 2, 1], FAILS, 3, 3, 1),  # the last of `tries` is returned
    ([4], FAILS, 1, 1, 4),        # one try where fn must run once
    ([4], PASSES, 3, 1, 4),       # lost, but what is checked is there
    ([4], None, 3, 1, 4),         # lost, but the caller checks nothing
])
def test_profiled_takes_a_trace_again_while_it_lost_what_is_checked(
        monkeypatch, lost, complete, tries, calls, kept):
    seen = iter(lost)
    monkeypatch.setattr(chip_smoke, "lost_launches", lambda events: next(seen))
    monkeypatch.setattr(chip_smoke, "lost_where", lambda events: {})
    fake = types.SimpleNamespace(cuda=_Cuda())
    ran = []

    def fn():
        ran.append(1)
        return torch.ones(2).sum().item()

    run = chip_smoke.profiled(fake, fn, tries=tries, complete=complete)
    assert len(ran) == calls
    assert run["out"] == 2.0 and run["lost"] == kept
    assert isinstance(run["events"], list) and run["events"]
    assert run["wall"] >= 0
    assert fake.cuda.syncs == 2 * calls


def test_profiled_holds_the_window_open_around_the_call(monkeypatch):
    slept = []
    monkeypatch.setattr(chip_smoke.time, "sleep", slept.append)
    run = chip_smoke.profiled(types.SimpleNamespace(cuda=_Cuda()),
                              lambda: slept.append("fn"))
    assert slept == [chip_smoke.PROFILE_WAIT_S, "fn",
                     chip_smoke.PROFILE_WAIT_S]
    assert run["lost"] == 0


def test_lost_where_names_the_cpu_span_that_launched():
    op = {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 1,
          "tid": 2, "ts": 0.0, "dur": 10.0}
    outer = dict(op, name="train_step", cat="user_annotation", dur=50.0)
    lost = dict(_call("cudaLaunchKernel", 9), pid=1, tid=2, ts=5.0)
    elsewhere = dict(_call("cudaGraphLaunch", 8), pid=1, tid=3, ts=5.0)
    assert chip_smoke.lost_where([outer, op, lost, elsewhere]) == {
        "cudaLaunchKernel in aten::add": 1, "cudaGraphLaunch in -": 1}
