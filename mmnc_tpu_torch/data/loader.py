"""Batching, shuffling and device prefetch for task-dict datasets
(mmnc_tpu/data/loader.py).

`BatchLoader` is a copy of the JAX package's: the same epoch order from
`np.random.default_rng(seed + epoch)`, drop_last, the `get_batch` fast
path and the thread pool, so both packages see the same batches.

`prefetch_to_device` keeps the next batches' host-to-device copies in
flight on a background thread while the current step runs. On CUDA each
batch is copied into pinned host memory, then to the device with
`non_blocking=True` on a side stream, and an event is recorded after the
copy. The consumer makes its current stream wait on that event before it
hands the batch out (a device-side wait: the host does not block), and
`record_stream` marks each device tensor as used on the consumer's
stream, so the caching allocator does not hand its memory to the side
stream while the step still reads it. The pinned buffers come from
torch's caching host allocator, which records an event on the copy's
stream and reuses a block only after that event, so a buffer is neither
reused nor freed while its copy is in flight. A train call that the
consumer captures into a CUDA graph meanwhile (`train/step.py`) captures
in torch's "thread_local" mode, so this thread's pinned allocations and
copies on its own stream neither join nor break the capture.
"""

import queue
import threading
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ..device import resolve_device


class BatchLoader:
    """Iterates {task: (B, H, W, C) np.float32} batches.

    drop_last is always on (every step sees the same shapes).

    Fast paths, in order of preference:
    * datasets exposing `get_batch(indices)` (e.g. PrerenderedDataset) are
      fetched with one vectorized call per batch — no per-sample Python;
    * `num_workers > 0` fetches samples on a thread pool (the reference's
      DataLoader num_workers analog — useful for IO-bound datasets like
      CLEVR-on-disk; numpy/PIL release the GIL).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 21, num_epochs: Optional[int] = 1,
                 num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_epochs = num_epochs
        self.num_workers = num_workers
        self._pool = None

    def close(self):
        """Shut down the worker pool (idempotent)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def __del__(self):
        self.close()

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def _epoch_order(self, epoch: int):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        return order

    def _fetch(self, idx):
        if hasattr(self.dataset, "get_batch"):
            return self.dataset.get_batch(idx)
        if self.num_workers > 0:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(self.num_workers)
            samples = list(self._pool.map(
                lambda i: self.dataset[int(i)], idx))
        else:
            samples = [self.dataset[int(i)] for i in idx]
        return {t: np.stack([s[t] for s in samples])
                for t in samples[0].keys()}

    def epoch(self, epoch: int = 0, rows: slice = slice(None)
              ) -> Iterator[dict]:
        """The batches of `epoch`. `rows` fetches only those rows of each
        batch (a data-parallel rank's share): the order of the samples
        and the members of each batch stay the whole loader's."""
        order = self._epoch_order(epoch)
        n_batches = len(self)
        for b in range(n_batches):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            yield self._fetch(idx[rows])

    def __iter__(self):
        epoch = 0
        while self.num_epochs is None or epoch < self.num_epochs:
            yield from self.epoch(epoch)
            epoch += 1


def _to_device(batch, device, stream):
    """One host batch -> ({task: device tensor}, the copy's end event), the
    copies issued on `stream` from pinned buffers."""
    out = {}
    with torch.cuda.stream(stream):
        for task, x in batch.items():
            host = torch.as_tensor(x)
            pinned = torch.empty(host.shape, dtype=host.dtype,
                                 pin_memory=True)
            pinned.copy_(host)
            out[task] = pinned.to(device, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return out, done


def prefetch_to_device(iterator, size: int = 2, device=None,
                       stats: Optional[dict] = None):
    """Wrap a host batch iterator ({task: array}) so batches arrive as
    tensors on `device` (CUDA unless given; raises with no card and no
    device, as every entry point of the port) ahead of use.

    On a CUDA device a background thread stages up to `size` batches
    (pinned copy, side stream, event; see the module docstring). On the
    CPU (device "cpu") it yields the batches as torch tensors sharing the
    host arrays' memory: no thread and no copy.

    `stats`, if given, gains "wait_s" (seconds the consumer waited for
    its batches, summed: on the queue, or on the host iterator where
    there is no thread), "waits_s" (each batch's wait, in order) and
    "batches" (batches handed out)."""
    device = resolve_device(device)
    if stats is not None:
        stats.setdefault("wait_s", 0.0)
        stats.setdefault("waits_s", [])
        stats.setdefault("batches", 0)
    if device.type != "cuda":
        return _host_batches(iterator, stats)
    return _prefetched(iterator, size, device, stats)


def _handed_out(stats, t0):
    if stats is not None:
        waited = time.perf_counter() - t0
        stats["wait_s"] += waited
        stats["waits_s"].append(waited)
        stats["batches"] += 1


def _host_batches(iterator, stats):
    iterator = iter(iterator)
    while True:
        t0 = time.perf_counter()
        batch = next(iterator, None)
        if batch is None:
            return
        batch = {t: torch.as_tensor(x) for t, x in batch.items()}
        _handed_out(stats, t0)
        yield batch


def _prefetched(iterator, size, device, stats):
    q = queue.Queue(maxsize=size)
    end = object()
    stop = threading.Event()

    def producer():
        try:
            stream = torch.cuda.Stream(device)
            for batch in iterator:
                item = _to_device(batch, device, stream)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        pass
                if stop.is_set():
                    return
        except Exception as e:  # noqa: BLE001 -- raised by the consumer
            q.put(e)
        finally:
            q.put(end)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            t0 = time.perf_counter()
            item = q.get()
            if item is end:
                return
            if isinstance(item, Exception):
                raise item
            batch, done = item
            current = torch.cuda.current_stream(device)
            current.wait_event(done)
            for x in batch.values():
                x.record_stream(current)
            _handed_out(stats, t0)
            yield batch
    finally:
        # a consumer that stops early (max_steps, an exception) releases
        # the producer, which may be blocked on a full queue
        stop.set()
        while thread.is_alive():
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
