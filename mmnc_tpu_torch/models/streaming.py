"""Software-pipelined streaming round trip (mmnc_tpu/models/streaming.py:
56-190): compress + decompress a stream of batches with the device and the
host coder at work at once.

* The main thread dispatches the compress program of up to `depth` batches
  ahead of the coder: PyTorch's CUDA calls return before the device is
  done, so the card's queue does not drain.
* Each batch's outputs go device-to-host into a slot of pinned host
  buffers on a side CUDA stream, which first waits for the compute stream;
  `record_stream` keeps the caching allocator from handing the source
  memory to later work before the copy has read it, and a CUDA event marks
  the copy done.
* A pool of `coder_threads` threads (kept for the process: cuDNN keeps
  its convolution plans per thread, and a new thread rebuilds them on its
  first synthesis) takes each batch: it waits for the
  event, runs the rANS calls (ctypes releases the GIL, so coding overlaps
  device work), uploads y from pinned memory and dispatches the synthesis
  on the compute stream. A slot is reused only after its batch's result
  was taken, which orders its next copy after this batch's upload.
* One thread at a time dispatches device work (a lock around each
  program's dispatch; the waits for copies are outside it). Every eager
  PyTorch op releases and retakes the GIL, so two threads dispatching at
  once hand the GIL back and forth at every op. On an H100's host the
  lock took batches of 8 from 21-27 to 37-41 MP/s and left batches of 64
  where they were (PERF.md, PR 6).
* Results come out in order.

Layouts ("impl"), as in the JAX package:
  v2: `_compress_device_fused` returns y and z symbols (int16), y's CDF-row
      indexes (uint8) and max_abs: two device programs and one
      device-to-host wait per batch. The indexes come from the encoder's
      quantized z; z's coding is lossless, so they equal what a decoder
      computes from the decoded z. That is checked per batch
      (z_dec == z_sym) before the stream is used, and on a mismatch the
      indexes are recomputed from the decoded z as in v1.
  v1: `_compress_device_lean` (symbols and max_abs), then the indexes from
      the decoded z (`_decompress_indexes_u8`): three programs.
Where max_abs says int16 wrapped (>= 2^15 - 1), the batch goes through
`_roundtrip_one_wide`: the int32 `compress` program and coder. Streams equal
`compress(packed=True)`'s bytes, and x_hats its `decompress`, for each of
the four codecs: the device programs are the base class's, and the x_hats
are a dict with one NHWC tensor per task.

On a card each device program is a CUDA graph of the model
(`graphs.py`): the main thread replays the compress program under the
dispatch lock, the coder thread the index and synthesis programs (the
first time a signature comes, it warms the program up, and the second
time captures it, there, under the same lock; torch's "thread_local"
capture mode lets the other thread wait on events and pin memory
meanwhile). A replay returns clones of the graph's outputs, fresh
allocations of the compute stream like an eager program's, so
`record_stream` covers the slot's copies of them as before and a later
replay never overwrites x_hats a caller still holds.

While a torch profiler records, the pipeline keeps spans
(`utils/profiling.py`), each tagged with its batch's index on both
threads: the stages stream.compress, stream.d2h_wait, stream.rans_encode,
stream.rans_decode and stream.synthesize (through `_span`), the wait for
the dispatch lock (stream.lock_wait, every thread) and a batch's wait in
the coder queue, from its submission to the coder's start
(stream.queued); the graphs add their replays' (`graphs.py`). On the CPU
(`device="cpu"` models) the same pipeline runs without streams, events or
pinned memory.
"""

import contextlib
import functools
import threading
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Iterable, Iterator, Tuple

import numpy as np
import torch

from ..entropy import rans
from ..utils import profiling

_I16_LIMIT = 2 ** 15 - 1
IMPLS = ("v2", "v1")


def _span(name):
    """The span of one stage of the pipeline (`profiling.span`). Also the
    timing hook: chip_smoke.py's SpanTimer and the benchmark replace this
    function to time the stages of every thread whether or not a profiler
    records."""
    return profiling.span(name)


class _Slot:
    """Pinned host buffers for one batch in flight, kept while the shapes
    stay the same, and the event of the copy that last filled them."""

    def __init__(self):
        self.host = []
        self.y_dec = None
        self.event = None

    def fill(self, tensors, copy_stream, compute_stream):
        """Copy `tensors` (device; a graph replay's clones or an eager
        program's outputs, made on the compute stream) into this slot on
        `copy_stream`, after the compute stream's work so far; returns
        numpy views."""
        if [(h.shape, h.dtype) for h in self.host] != \
                [(t.shape, t.dtype) for t in tensors]:
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         for t in tensors]
        copy_stream.wait_stream(compute_stream)
        with torch.cuda.stream(copy_stream):
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
                t.record_stream(copy_stream)
            self.event = torch.cuda.Event()
            self.event.record(copy_stream)
        return [h.numpy() for h in self.host]

    def y_buffer(self, shape):
        """A pinned int16 buffer for the decoded y symbols."""
        if self.y_dec is None or tuple(self.y_dec.shape) != tuple(shape):
            self.y_dec = torch.empty(shape, dtype=torch.int16,
                                     pin_memory=True)
        return self.y_dec


class _Pipeline:
    """Per-call state: the model, its tables, the dispatch lock, the
    compute stream and the copy stream (CUDA only)."""

    def __init__(self, model):
        self.model = model
        self.tables = model._coding_tables()
        self.lock = threading.Lock()
        self.cuda = model.device.type == "cuda"
        if self.cuda:
            self.compute = torch.cuda.current_stream(model.device)
            self.copy = torch.cuda.Stream(model.device)

    def host(self, slot, tensors):
        """Device outputs -> host arrays (and the event to wait for)."""
        if not self.cuda:
            return [t.contiguous().numpy() for t in tensors], None
        tensors = [t.contiguous() for t in tensors]
        return slot.fill(tensors, self.copy, self.compute), slot.event

    @contextlib.contextmanager
    def device(self):
        """Device work of any thread: under the dispatch lock and on the
        compute stream (current streams are per thread)."""
        with profiling.span("stream.lock_wait"):
            self.lock.acquire()
        try:
            if self.cuda:
                with torch.cuda.stream(self.compute):
                    yield
            else:
                yield
        finally:
            self.lock.release()

    def indexes(self, z_dec, y_shape):
        """The decoder's y indexes (uint8, host) from decoded z symbols:
        z up from pinned memory, the index program, the indexes down into
        pinned memory, then the wait, outside the dispatch lock."""
        with self.device():
            z = torch.from_numpy(z_dec)
            if self.cuda:
                z = z.pin_memory().to(self.model.device, non_blocking=True)
            idx = self.model._decompress_indexes_u8(z, y_shape)
            if not self.cuda:
                return idx.numpy()
            host = torch.empty(idx.shape, dtype=idx.dtype, pin_memory=True)
            host.copy_(idx, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        with _span("stream.d2h_wait"):
            event.synchronize()
        return host.numpy()

    def upload_y(self, slot, y_dec):
        if not self.cuda:
            return torch.from_numpy(y_dec)
        return slot.y_dec.to(self.model.device, non_blocking=True)

    def decode_y(self, slot, ys, indexes, y_shape):
        """y's stream -> int16 symbols, in the slot's pinned buffer on the
        card."""
        out = slot.y_buffer(y_shape).numpy() if self.cuda else None
        with _span("stream.rans_decode"):
            return rans.decode_with_indexes(ys, indexes, self.tables.gc,
                                            out_dtype=np.int16,
                                            out=out).reshape(y_shape)


@functools.cache
def _coder_pool(threads: int) -> ThreadPoolExecutor:
    """The coder threads of every stream of `threads` coders."""
    return ThreadPoolExecutor(threads, thread_name_prefix="mmnc-coder")


def _z_indexes(z_shape):
    return np.broadcast_to(np.arange(z_shape[-1], dtype=np.int32),
                           z_shape).ravel()


def _coded(k, submitted, roundtrip, *args):
    """The coder's stages of batch `k` on a coder thread, its spans tagged
    k; `submitted`: the `profiling.stamp` of its submission."""
    with profiling.tagged(k):
        profiling.record("stream.queued", submitted)
        return roundtrip(*args)


def _wait(host, event):
    with _span("stream.d2h_wait"):
        if event is not None:
            event.synchronize()
    return host


def _roundtrip_one(pipe, slot, batch, host, event):
    """v1: the coder's stages for one batch (mmnc_tpu/models/streaming.py:
    63-89); y's indexes come from the decoded z."""
    y_sym, z_sym, max_abs = _wait(host, event)
    if int(max_abs) >= _I16_LIMIT:  # int16 narrowing would have wrapped
        return _roundtrip_one_wide(pipe, batch)
    return _code(pipe, slot, y_sym, z_sym, None)


def _roundtrip_one_v2(pipe, slot, batch, host, event):
    """v2: the coder's stages for one batch (mmnc_tpu/models/streaming.py:
    92-124); y's indexes came with the symbols."""
    y_sym, z_sym, dec_idx, max_abs = _wait(host, event)
    if int(max_abs) >= _I16_LIMIT:  # int16 narrowing would have wrapped
        return _roundtrip_one_wide(pipe, batch)
    return _code(pipe, slot, y_sym, z_sym, dec_idx)


def _code(pipe, slot, y_sym, z_sym, dec_idx):
    """Code z, decode it, take y's indexes (`dec_idx` where it was given
    and the decoded z equals z_sym, else computed from the decoded z), code
    and decode y, dispatch the synthesis -> (x_hats, n_bytes)."""
    tables = pipe.tables
    z_idx = _z_indexes(z_sym.shape)
    with _span("stream.rans_encode"):
        zs = rans.encode_with_indexes(z_sym, z_idx, tables.eb)
    with _span("stream.rans_decode"):
        z_dec = rans.decode_with_indexes(zs, z_idx, tables.eb,
                                         out_dtype=np.int16)
    # the v2 guard: z's coding is lossless, so this holds unless the coder
    # is broken, and then the indexes are recomputed as in v1
    if dec_idx is None or not np.array_equal(z_dec, z_sym.ravel()):
        dec_idx = pipe.indexes(z_dec.reshape(z_sym.shape), y_sym.shape[1:3])
    with _span("stream.rans_encode"):
        ys = rans.encode_with_indexes(y_sym, dec_idx, tables.gc)
    y_dec = pipe.decode_y(slot, ys, dec_idx, y_sym.shape)
    with pipe.device(), _span("stream.synthesize"):
        x_hats = pipe.model._synthesize_from_symbols(pipe.upload_y(slot,
                                                                   y_dec))
    return x_hats, len(ys) + len(zs)


def _roundtrip_one_wide(pipe, batch):
    """int32 fallback where a symbol overflows int16: the classic compress
    program with index planes (mmnc_tpu/models/streaming.py:127-151)."""
    model, tables = pipe.model, pipe.tables
    with pipe.device():
        y_sym, z_sym, indexes = (t.contiguous().cpu().numpy()
                                 for t in model._compress_device(batch))
    z_idx = _z_indexes(z_sym.shape)
    with _span("stream.rans_encode"):
        ys = rans.encode_with_indexes(y_sym, indexes, tables.gc)
        zs = rans.encode_with_indexes(z_sym, z_idx, tables.eb)
    with _span("stream.rans_decode"):
        z_dec = rans.decode_with_indexes(zs, z_idx, tables.eb
                                         ).reshape(z_sym.shape)
    with pipe.device():
        dec_idx = model._decompress_indexes(z_dec, y_sym.shape[1:3])
    with _span("stream.rans_decode"):
        y_hat = rans.decode_with_indexes(ys, dec_idx, tables.gc
                                         ).reshape(y_sym.shape)
    with pipe.device(), _span("stream.synthesize"):
        x_hats = model._decompress_synthesize(
            torch.from_numpy(y_hat).float())
    return x_hats, len(ys) + len(zs)


def stream_roundtrip(model, batches: Iterable, depth: int = 3,
                     coder_threads: int = 1, impl: str = "v2",
                     ) -> Iterator[Tuple[dict, int]]:
    """Compress + decompress each batch of `batches` ({task: NHWC}), with
    up to `depth` + 1 batches in flight; yields (x_hats {task: NHWC on the
    model's device}, n_bytes) per batch, in order. One coder thread: on an
    H100's host two were no faster at batch 8 or 64 (PERF.md, PR 6).

    Equivalent to `model.compress(batch)` + `model.decompress(ans)` per
    batch (same bytes). Call `model.update_bottleneck_values()` first.
    Batches already on the card keep the dispatch asynchronous; a host
    batch is uploaded by a synchronous copy. The x_hats are on the compute
    stream (the caller's current stream)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown stream impl {impl!r}")
    pipe = _Pipeline(model)
    compress = (model._compress_device_fused if impl == "v2"
                else model._compress_device_lean)
    roundtrip = _roundtrip_one_v2 if impl == "v2" else _roundtrip_one
    slots = [_Slot() for _ in range(depth + 1)]
    pool = _coder_pool(coder_threads)
    futures = []
    try:
        for k, batch in enumerate(batches):
            slot = slots[k % len(slots)]
            with profiling.tagged(k):
                with pipe.device(), _span("stream.compress"):
                    host, event = pipe.host(slot, compress(batch))
                futures.append(pool.submit(_coded, k, profiling.stamp(),
                                           roundtrip, pipe, slot, batch,
                                           host, event))
            while len(futures) > depth:
                yield futures.pop(0).result()
        while futures:
            yield futures.pop(0).result()
    finally:  # a stream closed early: its batches still in flight finish
        wait(futures)
