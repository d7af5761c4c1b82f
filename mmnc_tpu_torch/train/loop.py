"""Experiment harness: the epoch loop with validation, checkpointing,
resume, qualitative dumps and optional profiling (mmnc_tpu/train/loop.py).

Per-epoch validation, a checkpoint every N epochs carrying the model's
hyper_parameters and the schedule's horizon, auto-resume from the latest
local checkpoint, image grids per validation epoch and torch.profiler
traces on request, with batches staged onto the device ahead of use by
`prefetch_to_device`.

Where it differs from the JAX loop, and why:
* the model already holds its weights (the port's constructor draws them
  from a seed), so `fit` does not initialise it;
* the step's noise comes from a generator on the model's device reseeded
  from (seed + 1, step) before every step, as the JAX step folds the step
  into its key: a resumed run draws the noise of an uninterrupted one;
* data parallelism (`n_devices > 1`) runs one process per device
  (`parallel.launch` starts them, each calling `fit`): every rank reads
  the same shuffled batches and stages its own rows, its steps reduce the
  gradients and the logs (`train/step.py`), and rank 0 alone writes the
  metrics, image grids and checkpoints. Every early exit (`max_steps`,
  the divergence guard on the reduced loss, a SIGTERM) is taken by all
  ranks together: a rank that left alone would hang the others in their
  next collective;
* every call of the train step is one of `make_multi_train_step`, on
  `steps_per_call` K consecutive batches (a rank its own rows) handed
  over as a list of the K staged batches rather than a stacked copy; K =
  1 is a group of one, so one path serves both. On a card, without a
  mesh or under an NCCL one, each call after the first two (a warm-up, a
  capture) replays one CUDA graph of its K steps, the ranks' all-reduces
  inside it (`train/step.py`), and so does each validation step of a
  shape after its first two; its staged batches are copied into the
  graph's inputs on the card. Under a gloo mesh both stay eager. What
  the ranks agree on through the host (the stop flag, the checkpoint
  barrier), rank 0's files and the log pulls stay outside the graphs,
  and every rank makes the same calls, so the ranks warm up, capture and
  replay together. The loop's cadences are
  the JAX loop's, read at the step before the call: logs are pulled, and
  the profiler window opened and closed, on calls whose first step is a
  multiple of `log_every` or equals 5 / 10; `max_steps`, the divergence
  guard, SIGTERM and the stop flag are checked after each call.
"""

import json
import os
import signal
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.loader import prefetch_to_device
from ..parallel import make_mesh, shard_train_state
from ..utils.checkpoint import (find_last_checkpoint, restore_checkpoint,
                                save_checkpoint)
from ..utils.logging import MetricLogger, save_image_grid
from ..utils.profiling import StepTimer, start_trace, stop_trace
from .state import create_train_state
from .step import make_eval_step, make_multi_train_step


def _superbatches(it, k: int):
    """Group k consecutive batches of `it` into lists of k, for the
    K-step call; drops a trailing incomplete group (mmnc_tpu/train/loop.py:
    30-39, which stacks them)."""
    group = []
    for batch in it:
        group.append(batch)
        if len(group) == k:
            yield group
            group = []


def _host_values(logs: dict) -> dict:
    """{name: 0-d device tensor} -> {name: float}, with one host sync."""
    keys = list(logs)
    values = torch.stack([logs[k].detach().reshape(()).double()
                          for k in keys]).cpu().tolist()
    return dict(zip(keys, values))


def _numpy(batch: dict) -> dict:
    return {t: np.asarray(torch.as_tensor(x).cpu()) for t, x in batch.items()}


def fit(
    model,
    train_loader,
    val_loader=None,
    epochs: int = 1,
    run_name: str = "run",
    out_dir: str = "runs",
    seed: int = 21,
    resume: bool = False,
    checkpoint_every_epochs: int = 100,
    compute_metrics: bool = True,
    train_metrics: Optional[bool] = None,
    log_images: bool = True,
    use_wandb: bool = False,
    n_devices: Optional[int] = None,
    profile_dir: Optional[str] = None,
    max_steps: Optional[int] = None,
    log_every: int = 10,
    steps_per_call: int = 1,
    val_every_epochs: int = 1,
    extend_schedule: bool = False,
    clip_norm: Optional[float] = None,
    remat: bool = False,
    schedule_total_steps: Optional[int] = None,
    stats: Optional[dict] = None,
):
    """Train `model` (in place); returns (state, last_val_logs).

    `stats`, if given, is filled with the run's timings: "step_timer"
    (StepTimer.stats() over the train calls, each `steps_per_call` steps,
    the first two left out),
    "loader" (seconds the loop waited for prefetched batches and how many
    it took), "save_ms" (one entry per checkpoint written), "restore_ms"
    (the resume's load, if any) and "trace" (the profiler's file, if
    any).

    `n_devices > 1` trains on a mesh of that many ranks, each running
    this `fit` in its own process (`parallel.launch`) with its own model
    on its own device: the batch size is the global batch's, which the
    ranks split. Outside such a process group it raises. A rank of a
    process group of one (`launch(fn, 1, ...)`, `n_devices` 1) trains on
    its mesh of one too: its steps take the mesh path, collectives
    included."""
    stats = {} if stats is None else stats
    device = model.device
    mesh = None
    if n_devices is not None and (n_devices > 1 or dist.is_initialized()):
        mesh = make_mesh(n_devices, device)
        if mesh.device != device:
            raise ValueError(f"rank {mesh.rank}: the model is on {device}, "
                             f"the rank's device is {mesh.device}")
    lead = mesh is None or mesh.lead  # writes the run's files
    run_dir = os.path.join(out_dir, run_name)
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    logger = MetricLogger(run_dir, run_name, use_wandb=use_wandb) \
        if lead else None

    steps_per_epoch = len(train_loader)
    total_steps = min(epochs * steps_per_epoch, max_steps or 10 ** 12)
    if schedule_total_steps is not None:
        # the LR horizon decoupled from this invocation's stop point: a
        # staged run re-horizons the cosine once to the final target, so
        # later stages resume on the same schedule
        total_steps = max(total_steps, schedule_total_steps)

    # a resumed run keeps the horizon saved with its checkpoints unless
    # asked to extend it (deriving it from this invocation's --epochs
    # would reshape the LR schedule mid-run)
    last = find_last_checkpoint(ckpt_dir) if resume else None
    if last is not None:
        with open(os.path.join(last, "hyper_parameters.json")) as f:
            saved_total = json.load(f).get("total_steps")
        if saved_total is not None and saved_total != total_steps:
            if extend_schedule and total_steps > saved_total:
                print(f"resume: extending the LR-schedule horizon "
                      f"{saved_total} -> {total_steps} steps")
            else:
                print(f"resume: keeping the original LR-schedule horizon "
                      f"({saved_total} steps, this invocation implies "
                      f"{total_steps})")
                total_steps = saved_total

    state = create_train_state(model, total_steps)
    start_epoch = 0
    if last is not None:
        t0 = time.perf_counter()
        payload, _ = restore_checkpoint(last, device)
        model.load_state_dict(payload["model"])
        state.load_state_dict(payload["optimizer"])
        state.total_steps = total_steps
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stats["restore_ms"] = (time.perf_counter() - t0) * 1e3
        start_epoch = state.step // steps_per_epoch
        print(f"resumed from {last} (step {state.step})")
    if mesh is not None:
        shard_train_state(state, model, mesh)

    tm = compute_metrics if train_metrics is None else train_metrics
    if steps_per_call > steps_per_epoch:
        # _superbatches drops trailing incomplete groups; a group larger
        # than the epoch would silently train zero steps per epoch
        print(f"steps_per_call {steps_per_call} > {steps_per_epoch} "
              f"batches/epoch — clamping")
        steps_per_call = steps_per_epoch
    steps_per_call = max(steps_per_call, 1)  # as JAX's loop takes 0
    train_step = make_multi_train_step(
        model, steps_per_call, compute_metrics=tm, clip_norm=clip_norm,
        remat=remat, mesh=mesh)
    eval_step = make_eval_step(model, compute_metrics=compute_metrics,
                               mesh=mesh)

    generator = torch.Generator(device=device)
    timer = StepTimer()
    loader_stats = stats.setdefault("loader", {})
    stats.setdefault("save_ms", [])
    last_val_logs = {}
    t_start = time.time()
    done = False
    last_saved_step = -1
    diverged_checks = 0
    warned_no_loss_key = False
    tracing = None  # the profiler's handle while steps 5-10 run

    def _save():
        nonlocal last_saved_step
        if state.step != last_saved_step:
            if lead:
                t0 = time.perf_counter()
                save_checkpoint(ckpt_dir, state.step, model, state,
                                {**model.hyper_parameters,
                                 "total_steps": int(total_steps)})
                stats["save_ms"].append((time.perf_counter() - t0) * 1e3)
            if mesh is not None:
                mesh.barrier()
            last_saved_step = state.step

    # SIGTERM (scheduler preemption, `timeout`) -> SystemExit, so the
    # interrupt-save below fires; the previous handler comes back on exit.
    # A rank only notes it: the ranks agree on it after every step and
    # save and exit together
    sigterm = []

    def _sigterm(*_):
        if mesh is None:
            raise SystemExit(143)
        sigterm.append(1)

    prev_handler = None
    try:
        prev_handler = signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:
        pass  # not the main thread

    # a device-resident dataset gathers its batches on the device already
    # (a rank fetches and stages its rows only)
    def _staged(loader, epoch, count=False):
        rows = slice(None) if mesh is None else mesh.rows(loader.batch_size)
        if getattr(getattr(loader, "dataset", None), "device_resident",
                   False):
            return loader.epoch(epoch, rows)
        return prefetch_to_device(loader.epoch(epoch, rows), device=device,
                                  stats=loader_stats if count else None)

    try:
        for epoch in range(start_epoch, epochs):
            if done:
                break
            for group in _superbatches(_staged(train_loader, epoch,
                                               count=True), steps_per_call):
                step_no = state.step
                if profile_dir and lead and step_no == 5:
                    tracing = start_trace(profile_dir)
                state, logs = train_step(state, group, generator, seed)
                if tracing and step_no == 10:
                    stats["trace"] = stop_trace(tracing)
                    tracing = None
                # pull logs every log_every steps only, with one host sync:
                # in between, steps are queued without waiting for the card
                if step_no % log_every == 0:
                    host_logs = _host_values(logs)
                    if lead:
                        logger.log(step_no, host_logs)
                    # divergence guard: a blown-up run never recovers, so
                    # abort after three consecutive bad checks
                    if ("train/loss" not in host_logs
                            and "loss" not in host_logs
                            and not warned_no_loss_key):
                        warned_no_loss_key = True
                        print("WARNING: divergence guard found neither "
                              "'train/loss' nor 'loss' in logs — the "
                              "guard is inert for this run")
                    loss_now = float(host_logs.get(
                        "train/loss", host_logs.get("loss", 0.0)) or 0.0)
                    if not np.isfinite(loss_now) or abs(loss_now) > 1e12:
                        diverged_checks += 1
                        if diverged_checks >= 3:
                            raise RuntimeError(
                                f"diverged: train loss {loss_now:.3g} at "
                                f"step {step_no} (3 consecutive checks)")
                    else:
                        diverged_checks = 0
                timer.tick()
                if mesh is not None and mesh.any(bool(sigterm)):
                    print(f"rank {mesh.rank}: SIGTERM — saving checkpoint")
                    _save()
                    raise SystemExit(143)
                if max_steps is not None and state.step >= max_steps:
                    done = True
                    break

            run_val = (val_loader is not None
                       and ((epoch + 1) % val_every_epochs == 0
                            or epoch == epochs - 1 or done))
            if run_val:
                rows, keys = [], None
                for batch in _staged(val_loader, 0):
                    logs = eval_step(batch)
                    keys = keys or list(logs)
                    rows.append(torch.stack([logs[k].reshape(()).double()
                                             for k in keys]))
                if rows:
                    table = torch.stack(rows).cpu().numpy()
                    last_val_logs = {k: float(np.mean(table[:, i].tolist()))
                                     for i, k in enumerate(keys)}
                    if lead:
                        logger.log(state.step, last_val_logs)

                if log_images and lead:
                    # one val batch and one train batch per val epoch, as
                    # the reference callback does
                    for split, loader in (("val", val_loader),
                                          ("train", train_loader)):
                        batch = next(iter(loader.epoch(0)))
                        x_hats, _ = model(batch)
                        save_image_grid(
                            os.path.join(run_dir,
                                         f"samples_epoch{epoch}_{split}"),
                            _numpy(x_hats), _numpy(batch))

            if ((epoch + 1) % checkpoint_every_epochs == 0
                    or epoch == epochs - 1 or done):
                _save()
    except (KeyboardInterrupt, SystemExit):
        # interrupt safety: persist the latest weights before exiting (a
        # rank saved with the others above; alone it could only hang)
        if mesh is None:
            print("interrupted — saving checkpoint")
            _save()
        raise
    finally:
        if tracing:
            stats["trace"] = stop_trace(tracing)
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
        stats["step_timer"] = timer.stats()
        dt = time.time() - t_start
        if lead:
            print(f"training done: {state.step} steps in {dt:.1f}s "
                  f"({state.step / max(dt, 1e-9):.2f} steps/s)")
            logger.close()
    return state, last_val_logs
