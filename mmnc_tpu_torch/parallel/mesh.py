"""Data parallelism with one process per device (mmnc_tpu/parallel/mesh.py).

The JAX package drives a 1-D "data" mesh from one controller: the batch
is sharded along its leading axis, the parameters are replicated, and
XLA inserts the gradient sums. PyTorch runs one process per device over
`torch.distributed` instead:

* `launch` spawns the ranks (one per card, or CPU ranks over gloo) and
  initialises their process group;
* `make_mesh` gives a rank its context: rank, world size, device,
  process groups and the device group's backend;
* every rank reads the same global batches and keeps its contiguous rows
  (`shard_batch`, `Mesh.rows`), as `P("data")` splits the leading axis;
* `shard_train_state` broadcasts rank 0's parameters and Adam state, so
  every replica starts equal; the train step (`train/step.py`) all-reduces
  the gradients, so every replica stays equal.
"""

import datetime
import os
import pickle
import queue
import shutil
import signal
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclass
class Mesh:
    """A rank's view of the data-parallel mesh.

    `group` carries the device collectives (gradients, logs), over
    `backend`; `control` is a gloo group for host values (the stop flag),
    so that agreeing on a stop costs no device sync."""
    rank: int
    world_size: int
    device: torch.device
    group: object
    control: object
    backend: str = "gloo"

    @property
    def captures(self) -> bool:
        """Whether the device collectives can be captured in a CUDA graph:
        NCCL's run on the card and can; gloo's go through the host and
        cannot, so a gloo mesh's steps run eagerly (`train/step.py`)."""
        return self.backend == "nccl"

    @property
    def lead(self) -> bool:
        """Rank 0 writes the run's files (metrics, grids, checkpoints)."""
        return self.rank == 0

    def rows(self, batch_size: int) -> slice:
        """This rank's rows of a global batch of `batch_size`."""
        if batch_size % self.world_size:
            raise ValueError(f"a batch of {batch_size} does not split into "
                             f"{self.world_size} equal shards")
        per = batch_size // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)

    def all_reduce_sum(self, values: dict) -> dict:
        """{name: tensor on the device} summed over the ranks in one
        all-reduce of their float64 concatenation; shapes kept."""
        names = list(values)
        flat = torch.cat([values[k].double().reshape(-1) for k in names])
        dist.all_reduce(flat, group=self.group)
        out = {}
        for k, chunk in zip(names, flat.split([values[k].numel()
                                              for k in names])):
            out[k] = chunk.view(values[k].shape)
        return out

    def all_gather(self, tensor: torch.Tensor) -> torch.Tensor:
        """Every rank's `tensor` (equal shapes) concatenated along dim 0
        in rank order. The ranks exchange the tensors' bytes (a uint8
        view), so every dtype goes through NCCL and gloo bit for bit
        (NCCL has no int16)."""
        t = tensor.contiguous()
        raw = t.reshape(-1).view(torch.uint8)
        parts = [torch.empty_like(raw) for _ in range(self.world_size)]
        dist.all_gather(parts, raw, group=self.group)
        return torch.cat([p.view(t.dtype).view(t.shape) for p in parts])

    def any(self, flag: bool) -> bool:
        """True on every rank if `flag` is true on any."""
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.control)
        return bool(t.item())

    def barrier(self):
        dist.barrier(group=self.control)


def make_mesh(n_devices: int, device=None) -> Mesh:
    """The calling rank's mesh of `n_devices` ranks. Its device is
    `device`, else `cuda:<rank>` under NCCL and the CPU under gloo.

    Raises unless a process group of `n_devices` ranks is initialised
    (`launch` starts one)."""
    if not dist.is_initialized() or dist.get_world_size() != n_devices:
        size = dist.get_world_size() if dist.is_initialized() else None
        raise RuntimeError(
            f"a mesh of {n_devices} devices needs a process group of "
            f"{n_devices} ranks (this process has "
            f"{'none' if size is None else size}): start the ranks with "
            f"mmnc_tpu_torch.parallel.launch")
    rank = dist.get_rank()
    backend = dist.get_backend()
    if device is None:
        device = f"cuda:{rank}" if backend == "nccl" else "cpu"
    device = resolve_device(device)
    control = (dist.group.WORLD if backend == "gloo"
               else dist.new_group(backend="gloo"))
    return Mesh(rank, n_devices, device, dist.group.WORLD, control,
                str(backend))


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """{task: (B, ...) array or tensor} -> this rank's rows r*B/N to
    (r+1)*B/N of each (raises where N does not divide B)."""
    b = len(next(iter(batch.values())))
    rows = mesh.rows(b)
    return {t: x[rows] for t, x in batch.items()}


@torch.no_grad()
def shard_train_state(state, model, mesh: Mesh):
    """Broadcast rank 0's parameters and Adam state (moments and step
    counts) to every rank, in one collective. Returns `state`."""
    params = list(model.parameters())
    tensors = params + [v for p in params
                        for v in state.optimizer.state.get(p, {}).values()
                        if torch.is_tensor(v)]
    flat = torch.cat([t.reshape(-1).to(mesh.device, torch.float32)
                      for t in tensors])
    dist.broadcast(flat, src=0, group=mesh.group)
    for t, chunk in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(chunk.view(t.shape))
    return state


def _rank_main(rank, n_devices, device, backend, init_method, threads,
               timeout, fn, args, results):
    """One spawned rank: join the process group, run fn(mesh, *args) and
    report (rank, "ok", pickled result), (rank, "exit", code) for a
    SystemExit, or (rank, "error", traceback)."""
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            torch.set_num_threads(threads)
        dist.init_process_group(
            backend, init_method=init_method, rank=rank,
            world_size=n_devices,
            timeout=None if timeout is None
            else datetime.timedelta(seconds=timeout))
        out = fn(make_mesh(n_devices, device), *args)
        results.put((rank, "ok", pickle.dumps(out)))
    except SystemExit as e:
        results.put((rank, "exit", e.code))
    except BaseException:  # noqa: BLE001 -- reported to the parent
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _placement(n_devices: int, device, backend):
    """-> ([device of each rank], backend). "cuda" puts rank r on card r;
    a named card ("cuda:0") holds every rank, which only gloo allows."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if device.index is None:
            cards = torch.cuda.device_count()
            if n_devices > cards:
                raise RuntimeError(f"{n_devices} CUDA ranks, but this "
                                   f"machine has {cards} CUDA devices")
            devices = [torch.device("cuda", r) for r in range(n_devices)]
        else:
            devices = [device] * n_devices
        backend = backend or "nccl"
        if backend == "nccl" and len(set(devices)) < n_devices:
            raise ValueError("NCCL takes one rank per card; pass "
                             "backend='gloo' to put ranks on one card")
    else:
        devices = [device] * n_devices
        backend = backend or "gloo"
    return devices, backend


def launch(fn, n_devices: int, device=None, *args, backend=None,
           timeout: Optional[float] = None):
    """Run fn(mesh, *args) on `n_devices` spawned ranks; returns each
    rank's result, in rank order.

    `device`: "cuda" (the default) puts rank r on card r over NCCL and
    raises where the ranks outnumber the cards; "cpu" runs CPU ranks over
    gloo (each with this process's torch threads split among them); a
    named card ("cuda:0") holds every rank, under `backend="gloo"`, which
    reduces CUDA tensors through the host (NCCL refuses two ranks on one
    card). `fn` and its arguments and result are pickled: `fn` is a
    module-level function, and its result holds no CUDA tensor.

    The ranks meet through a file store in a fresh temporary directory,
    which needs no port. A rank that fails makes `launch` stop the others
    and raise with its traceback. `timeout` (seconds) bounds the whole
    run: past it `launch` stops the ranks and raises, so a rank hung in a
    collective fails rather than waits (it also bounds each collective;
    with None, torch.distributed's default bounds those). A SIGTERM to
    this process is
    passed on to the ranks (the train loop saves and exits, all ranks
    together), and `launch` then exits with the ranks' code."""
    devices, backend = _placement(n_devices, device, backend)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = tempfile.mkdtemp(prefix="mmnc_launch_")
    init_method = "file://" + os.path.join(store, "rendezvous")
    threads = max(1, torch.get_num_threads() // n_devices)
    procs = [ctx.Process(target=_rank_main, args=(
        r, n_devices, devices[r], backend, init_method, threads,
        timeout, fn, args, results)) for r in range(n_devices)]

    def forward_sigterm(*_):
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signal.SIGTERM)

    prev = None
    try:
        prev = signal.signal(signal.SIGTERM, forward_sigterm)
    except ValueError:
        pass  # not the main thread
    deadline = None if timeout is None else time.monotonic() + timeout
    done, exits = {}, {}
    finished = False
    try:
        for p in procs:
            p.start()
        while len(done) + len(exits) < n_devices:
            try:
                rank, status, payload = results.get(timeout=1.0)
            except queue.Empty:
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"the ranks ran past {timeout} s")
                lost = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in done
                        and r not in exits]
                if lost and results.empty():
                    time.sleep(1.0)  # a report may still be in the pipe
                    if results.empty():
                        raise RuntimeError(
                            f"rank {lost[0]} exited with code "
                            f"{procs[lost[0]].exitcode} without a report")
                continue
            if status == "error":
                raise RuntimeError(f"rank {rank} of {n_devices} failed:\n"
                                   f"{payload}")
            if status == "exit":
                exits[rank] = payload
            else:
                done[rank] = pickle.loads(payload)
        finished = True
        if exits:
            raise SystemExit(next(iter(exits.values())))
        return [done[r] for r in range(n_devices)]
    finally:
        # ranks that reported leave by themselves; after a failure the
        # others may wait in a collective for the failed one: stop them
        for p in procs:
            if p.pid is not None:
                p.join(timeout=30 if finished else 0)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
        results.close()
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
        shutil.rmtree(store, ignore_errors=True)
