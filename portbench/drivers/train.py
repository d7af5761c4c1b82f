"""The trainer's path: the graphed train call fed by the loader's prefetch.

Set-up: the codec at the configuration's sizes (float32), the weights
from the seed loaded into it, its train state (Adam over the main and
aux groups, the cosine schedule over `total_steps`), the K-step call
`train.make_multi_train_step(model, steps_per_call, compute_metrics)` as
`train.fit` builds it, a pool of `pool` distinct host batches made from
the seed, fed through `data/loader.prefetch_to_device` (a pinned copy on
a side stream, `prefetch` batches ahead), and the call's first
`checked_steps` steps on the pool's first batches through that feed:
the eager warm-up, the capture and the first replay. What they did is
read there, before the window: each step's loss, the first gradient as
Adam holds it after one step (its first moment over 1 - b1), and the
parameters' change after them. The window goes on with the same object:
one call a step, the logs pulled every `log_every` steps as `fit` pulls
them, for `seconds`, closed by a synchronise. `train_img_per_s` is the
window's images over its wall.

Once the window has closed and the program's memory is released, the
reference takes the same steps from the same weights, batches and noise
(`reference/train.py`), and four numbers are compared, every leaf on
its own scale:
* `loss_gap`: the widest relative gap of a checked step's loss;
* `grad_gap`: the worst leaf's gap between the norms of its first
  gradient, over the reference's norm of that leaf;
* `update_gap` and `update_worst`: the median and the worst leaf's gap
  between the norms of the parameters' change after the checked steps,
  over the reference's norm of that change.
No leaf is left out: against the float64 reference (`control.py --fault
wide`) every leaf's float32 gradient is real, none nought to rounding,
the smallest (the semantic head's, some 1e-8 of the median leaf's) too.
"""

import itertools
import statistics
import sys
import time

from .. import trace
from ..reference import codec as ref_codec
from ..reference import train as ref_train
from ..weights import make_weights
from . import common


def run(cell, seed, seconds, traced, device, t_start):
    import torch

    from mmnc_tpu_torch import graphs
    from mmnc_tpu_torch.data.loader import prefetch_to_device
    from mmnc_tpu_torch.models.codecs import build_model
    from mmnc_tpu_torch.train.state import create_train_state
    from mmnc_tpu_torch.train.step import make_multi_train_step

    cfg, tr = cell.config, cell.traffic
    cuda = device.type == "cuda"
    run_seed = seed % 2 ** 31
    stages = common.Stages(t_start)
    stages.mark("start and imports")
    if cuda:
        torch.cuda.init()
        stages.mark("CUDA initialised")
    model = build_model(cfg["model"], cfg["tasks"], cfg["latent_channels"],
                        cfg["conv_channels"], lmbda=cfg["lmbda"],
                        learning_rate_main=cfg["learning_rate_main"],
                        learning_rate_aux=cfg["learning_rate_aux"],
                        legacy_broadcast=cfg["legacy_broadcast"],
                        device=device)
    stages.mark("codec built")
    start = make_weights(cfg, seed, device)
    model.load_state_dict(start)
    stages.mark("weights")
    state = create_train_state(model, tr["total_steps"])
    k_steps = tr["steps_per_call"]
    call = make_multi_train_step(model, k_steps,
                                 compute_metrics=tr["compute_metrics"])
    stages.mark("train state")
    pool = common.make_inputs(torch, cfg, tr["pool"], tr["batch"], seed,
                              device)
    if cuda:
        torch.cuda.synchronize(device)
    stages.mark("inputs")
    pool = [{t: x.cpu().numpy() for t, x in b.items()} for b in pool]
    stages.mark("inputs to the host")
    loader = {}
    feed = prefetch_to_device(itertools.cycle(pool), size=tr["prefetch"],
                              device=device, stats=loader)
    generator = torch.Generator(device=device)
    names = {p: n for n, p in model.named_parameters()}
    stages.mark("feed")

    def step():
        batches = [next(feed) for _ in range(k_steps)]
        return call(state, batches, generator, run_seed)

    losses, first = [], None
    for i in range(tr["checked_steps"]):
        _, logs = step()
        losses.append(float(logs["train/loss"]))
        if first is None:
            first = {names[p]: _norm(s["exp_avg"] / (1 - 0.9))
                     for p, s in state.optimizer.state.items()}
    change = {n: _norm(p.detach() - start[n])
              for n, p in model.named_parameters()}
    if cuda:
        torch.cuda.synchronize(device)
    stages.mark("checked steps (warm-up, capture, replay)")
    plan = trace.SlicePlan(torch, device, tr["trace_start_s"],
                           tr["trace_slice_s"])
    if traced and cuda:
        plan.warm()
        stages.mark("profiler started")
    stages.report()

    spans = trace.Spans()
    wait0 = loader["wait_s"]
    t0 = time.perf_counter()
    steps = 0
    while True:
        now = time.perf_counter()
        if steps and now - t0 >= seconds:
            break
        if traced and cuda:
            plan.step(now - t0, steps)
        due = state.step % tr["log_every"] == 0
        with spans.span("train.call"):
            _, logs = step()
        steps += k_steps
        if due:
            with spans.span("train.log_pull"):
                float(logs["train/loss"])
    if cuda:
        torch.cuda.synchronize(device)
    t_end = time.perf_counter()
    window_s = t_end - t0
    busy_window_s = window_s - plan.overhead_s
    plan.close(steps)
    feed.close()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    capture_s = sum(call.stats["capture_s"]) + sum(
        sum(st["capture_s"]) for st in graphs.all_stats(model).values())
    reading = common.reading_for(
        cfg, tr, "train", steps, busy_window_s, spans=spans,
        slice=plan.best(), capture_s=capture_s,
        loader_wait_s=loader["wait_s"] - wait0)
    print(f"window: {steps} steps in {window_s:.3f} s, waited "
          f"{1e3 * (loader['wait_s'] - wait0) / max(steps, 1):.3f} ms a step "
          f"for batches", file=sys.stderr)
    del model, state, call, feed, start
    common.release(torch, device)
    checks = judge(torch, cell, seed, device, pool, losses, first, change)
    return common.Outcome(
        end_to_end={"train_img_per_s": steps * tr["batch"] / window_s,
                    "setup_s": t0 - t_start},
        reading=reading, checks=checks, attempted=steps, failed=0,
        memory_peak_bytes=int(peak))


TINY = 1e-30    # a norm's floor: an unmoved leaf of the reference reads 0


def _norm(t):
    return float(t.double().norm())


def reference_steps(torch, cell, seed, device, pool, num=None, alter=None):
    """The reference's losses, first gradients' and changes' leaf norms
    over the checked steps (`alter`: a fault planted by the control)."""
    cfg, tr = cell.config, cell.traffic
    params = make_weights(cfg, seed, device)
    batches = [{t: torch.as_tensor(x, device=device) for t, x in
                pool[i % len(pool)].items()}
               for i in range(tr["checked_steps"])]
    losses, first, change = ref_train.run_steps(
        cfg, params, batches, seed % 2 ** 31, tr["total_steps"], num, alter)
    return (losses, {k: _norm(v) for k, v in first.items()},
            {k: _norm(v) for k, v in change.items()})


def judge(torch, cell, seed, device, pool, losses, first, change):
    lim = cell.limits
    ref_losses, ref_first, ref_change = reference_steps(
        torch, cell, seed, device, pool, ref_codec.Numerics())
    return compare(lim, (losses, first, change),
                   (ref_losses, ref_first, ref_change))


def compare(lim, got, want):
    """{"loss_gap", "grad_gap", "update_gap", "update_worst": (value,
    limit)}."""
    losses, first, change = got
    ref_losses, ref_first, ref_change = want
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    grad = {k: abs(first.get(k, 0.0) - g) / max(g, TINY)
            for k, g in ref_first.items()}
    gaps = {k: abs(change[k] - c) / max(c, TINY)
            for k, c in ref_change.items()}
    worst_g, worst = max(grad, key=grad.get), max(gaps, key=gaps.get)
    print(f"checked steps' losses {losses} (reference {ref_losses}); the "
          f"worst leaf's gradient gap {grad[worst_g]:.3e} ({worst_g}: "
          f"{first.get(worst_g, 0.0):.6e}, reference "
          f"{ref_first[worst_g]:.6e}); the worst leaf's change gap "
          f"{gaps[worst]:.3e} ({worst}: {change[worst]:.6e}, reference "
          f"{ref_change[worst]:.6e})", file=sys.stderr)
    return {"loss_gap": (loss_gap, lim["loss_gap"]),
            "grad_gap": (grad[worst_g], lim["grad_gap"]),
            "update_gap": (statistics.median(gaps.values()),
                           lim["update_gap"]),
            "update_worst": (gaps[worst], lim["update_worst"])}
