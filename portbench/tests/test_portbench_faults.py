"""The comparison that decides `correct` fails what it must: a whole run
on the CPU (tiny widths, the look for a card skipped) with the timed path
broken underneath reads `correct` false, once for each fault a cell can
have; the sound run reads true; and the control (the reference in the
program's place one precision below) is judged not correct."""

import pytest
import torch

from mmnc_tpu_torch.entropy import rans
from mmnc_tpu_torch.models import codecs
from mmnc_tpu_torch.train import state as train_state

STREAM_CELLS = ("rgb.stream64", "shared4.stream64", "rgb.stream256.bf16")


def _wrap_synthesis(monkeypatch, change):
    base = codecs.MultiTaskCompressorBase
    original = base._synthesize_from_symbols
    memory = {}

    def synthesize(self, y_sym):
        return change(self, dict(original(self, y_sym)), memory)

    monkeypatch.setattr(base, "_synthesize_from_symbols", synthesize)


def answer_altered(self, out, memory):
    t = self.tasks[0]
    out[t] = out[t].clone()
    out[t][0, 0, 0, 0] += 0.25
    return out


def half_left_out(self, out, memory):
    for t in out:
        half = len(out[t]) // 2
        out[t] = torch.cat([out[t][:half], out[t][:len(out[t]) - half]])
    return out


def stale(self, out, memory):
    last = memory.get("last", out)
    memory["last"] = out
    return last


STREAM_FAULTS = {"answer_altered": answer_altered,
                 "half_left_out": half_left_out, "stale_answer": stale}


@pytest.mark.parametrize("cell", STREAM_CELLS)
def test_sound_stream_runs_are_correct(run_tiny, cell):
    res = run_tiny(cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(STREAM_FAULTS))
@pytest.mark.parametrize("cell", STREAM_CELLS)
def test_stream_faults_are_caught(run_tiny, monkeypatch, cell, fault):
    _wrap_synthesis(monkeypatch, STREAM_FAULTS[fault])
    res = run_tiny(cell)
    assert not res["correct"], res["checks"]


def test_stream_bytes_altered_are_caught(run_tiny, monkeypatch):
    original = rans.encode_with_indexes

    def padded(*args, **kwargs):
        return original(*args, **kwargs) + bytes(4)

    monkeypatch.setattr(rans, "encode_with_indexes", padded)
    res = run_tiny("rgb.stream64")
    assert not res["correct"]
    assert res["checks"]["answer_gap"]["value"] == 1.0
    res = run_tiny("rgb.stream256.bf16")
    assert not res["correct"]
    assert res["checks"]["bytes_gap"]["value"] > res["checks"][
        "bytes_gap"]["limit"]


def test_sound_train_run_is_correct(run_tiny):
    res = run_tiny("shared4.train16")
    assert res["correct"], res["checks"]


def unchanged(self, lr=None):
    self.step += 1
    return self


def doubled_leaf(original):
    def apply(self, lr=None):
        params = self.optimizer.param_groups[0]["params"]
        if params[3].grad is not None:
            params[3].grad.mul_(2.0)
        return original(self, lr)
    return apply


def test_train_state_unchanged_is_caught(run_tiny, monkeypatch):
    monkeypatch.setattr(train_state.TrainState, "apply_gradients", unchanged)
    res = run_tiny("shared4.train16")
    assert not res["correct"]
    assert res["checks"]["update_gap"]["value"] > 0.9
    assert res["checks"]["update_worst"]["value"] > 0.9


def test_train_semantic_head_frozen_is_caught(run_tiny, monkeypatch):
    """The last task's output head (shared4's semantic head, whose
    gradient is some 1e-8 of the median leaf's) given no gradient: every
    other leaf steps as it should."""
    made = {}
    create = train_state.create_train_state

    def remember(model, *args, **kwargs):
        made["head"] = {id(p) for n, p in model.named_parameters()
                        if "output_heads.3." in n}
        return create(model, *args, **kwargs)

    original = train_state.TrainState.apply_gradients

    def frozen(self, lr=None):
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if id(p) in made["head"] and p.grad is not None:
                    p.grad.zero_()
        return original(self, lr)

    monkeypatch.setattr(train_state, "create_train_state", remember)
    monkeypatch.setattr(train_state.TrainState, "apply_gradients", frozen)
    res = run_tiny("shared4.train16")
    assert made["head"]
    assert not res["correct"]
    assert res["checks"]["grad_gap"]["value"] > 0.9
    assert res["checks"]["update_worst"]["value"] > 0.9


def test_train_half_batch_is_caught(run_tiny, monkeypatch):
    base = codecs.MultiTaskCompressorBase
    original = base.loss_and_logs

    def twice(x):
        half = x[:len(x) // 2]
        return torch.cat([half, half])

    def half(self, batch, training=True, noise=None):
        # the second half replaced by the first: the mean over the rest
        batch = {t: twice(torch.as_tensor(x)) for t, x in batch.items()}
        if noise is not None:
            noise = {k: twice(v) for k, v in noise.items()}
        return original(self, batch, training, noise)

    monkeypatch.setattr(base, "loss_and_logs", half)
    res = run_tiny("shared4.train16")
    assert not res["correct"]


def test_train_leaf_altered_is_caught(run_tiny, monkeypatch):
    monkeypatch.setattr(train_state.TrainState, "apply_gradients",
                        doubled_leaf(train_state.TrainState.apply_gradients))
    res = run_tiny("shared4.train16")
    assert not res["correct"]
    assert res["checks"]["grad_gap"]["value"] > res["checks"]["grad_gap"][
        "limit"]


@pytest.mark.parametrize("cell", STREAM_CELLS + ("shared4.train16",))
def test_the_control_is_not_correct(small, cell):
    """At the cells' widths (batches of 2): at cut widths TF32's rounding
    moves too few symbols to show."""
    from portbench import control, registry
    c = registry.Cell(cell, data_dir=small)
    cpu = torch.device("cpu")
    if c.traffic["driver"] == "train":
        checks = control.train_control(torch, c, 2 ** 31 + 3, cpu, "control")
    else:
        checks = control.stream_control(torch, c, 2 ** 31 + 3, cpu)
    assert any(v > lim for v, lim in checks.values()), checks


def test_no_train_leaf_is_nought_to_rounding(small):
    """At the train cell's widths (batches of 2), the float32 reference's
    first gradient of every leaf lies within 1e-3 of the float64 one on
    the leaf's own scale, the semantic head's smallest leaves too: no
    leaf is left out of the comparison."""
    from portbench import control, registry
    c = registry.Cell("shared4.train16", data_dir=small)
    checks = control.train_control(torch, c, 2 ** 31 + 5,
                                   torch.device("cpu"), "wide")
    assert checks["own_rounding_worst"][0] < 1e-3, checks
    assert checks["smallest_leaf"][0] < 1e-3, checks
    assert all(v <= lim for v, lim in checks.values() if lim is not None)
