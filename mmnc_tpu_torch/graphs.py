"""CUDA graphs for the port's no-grad device programs: the counterpart of
the JAX package's `jax.jit` (it has no file of its own there).

The JAX package runs each device half of its serving path, and its eval
step, as one jitted program: one dispatch a call, a new trace for each new
shape (mmnc_tpu/models/codecs.py:281-499, 597; mmnc_tpu/train/step.py:
134-146). On a card the port runs the same programs (`program`, `run`) as
CUDA graphs:

* the first call of a signature runs the program eagerly on the capture
  stream (the warm-up: it builds the kernels, sets their launch
  attributes, lets cuDNN choose its algorithms and sets up what a stream
  makes lazily, so none of that happens inside a capture);
* the second captures it into a graph, in torch's "thread_local" capture
  mode (other threads, the stream's coder and the loader's prefetch, may
  pin memory and wait on events meanwhile), and replays it;
* every later call copies its inputs into the graph's static inputs on
  the current stream, replays the graph there and returns clones of its
  static outputs.

A signature is the program, its static arguments (every argument leaf
that is not an array: `y_shape`, `task_index`, `compute_metrics`), each
input's shape, strides and type, the model's dtype and likelihood
geometry (`legacy_broadcast`), the storage (`data_ptr`) of every parameter
and buffer, and the flags that pick cuDNN's and cuBLAS's algorithms
(cuDNN's `deterministic`, `benchmark` and `allow_tf32`, cuBLAS's
`allow_tf32`): a graph keeps the algorithms chosen at its capture. What
a body closes over is not in the signature, so a body that closes over
more than the model carries it in the program's name (the eval step under
a mesh: `train/step.py:eval_program`, one program a mesh size and rank).
Under an NCCL mesh a program's collectives are captured with it; every
rank runs the same programs in the same order, so each warms up, captures
and replays together with the others.
Parameters updated in place (an optimizer step, `load_state_dict`) keep
their storage, and so their graphs: nothing a graph reads is derived from
them at its capture (`ops/layers.py:_derived` derives inside the graph
while a stream captures, as a jitted program recomputes on every call).

Host inputs (numpy arrays, CPU tensors) are uploaded before the graph,
and each call returns fresh tensors (one device copy of the outputs), as
the eager program does: nothing a caller holds is overwritten by a later
replay. The graphs of one model share one memory pool; that is safe
because replays run one after another on the caller's stream and their
outputs are cloned at once (one thread at a time dispatches a model's
programs: the stream's dispatch lock, `models/streaming.py`). Each program
keeps at most MAX_GRAPHS signatures and drops the least recently used.

Nothing falls back: a capture or a replay that fails raises. A program
runs eagerly on the CPU, under `disabled()` (the counterpart of
`jax.disable_jit()`) and inside another program's body. The kernel
wrappers' launch counters see a warm-up and a capture once each and a
replay never. `stats(model, name)` counts a program's "eager" calls
(warm-ups included), "captures" and "replays" (a capture replays too)
and keeps each capture's host seconds ("capture_s").
"""

import collections
import contextlib
import functools
import itertools
import threading
import time

import numpy as np
import torch

MAX_GRAPHS = 8  # signatures kept a program
WARMED = "warmed"  # a signature warmed up, not yet captured

_disabled = [0]  # open `disabled()` contexts, in any thread
_disabled_lock = threading.Lock()
_local = threading.local()  # .depth: program bodies running on this thread


@contextlib.contextmanager
def disabled():
    """Run every program eagerly while this is open, in every thread (the
    stream's coder thread too): the counterpart of `jax.disable_jit()`,
    and the reference a graphed call is held to."""
    with _disabled_lock:
        _disabled[0] += 1
    try:
        yield
    finally:
        with _disabled_lock:
            _disabled[0] -= 1


@contextlib.contextmanager
def _inside():
    """Marks a program's body on this thread: programs it calls run
    eagerly within it."""
    _local.depth = getattr(_local, "depth", 0) + 1
    try:
        yield
    finally:
        _local.depth -= 1


def capturing(device) -> bool:
    """Whether the current stream of `device` is being captured."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _on_card(model) -> bool:
    return model.device.type == "cuda"


@functools.cache
def capture_stream(device):
    """The side stream a device's programs and train calls warm up and
    are captured on (one for the process: the port runs on one card a
    process)."""
    return torch.cuda.Stream(device)


def warm_up(body, *args, stream):
    """body(*args) eagerly on `stream`, the stream the graph is captured
    on, so that what it sets up lazily (per-stream cuBLAS workspaces among
    it) is there before the capture; ordered after the current stream's
    work so far, and before its work from now on."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = body(*args)
    current.wait_stream(stream)
    return out


def capture(fn, stream, pool=None):
    """fn() captured on `stream` into a new graph -> (graph, fn()'s
    outputs, which each replay rewrites). "thread_local": only this
    thread is barred from calls that are unsafe while a stream captures.
    `pool`: a memory pool to share (another graph's `pool()`)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, stream=stream,
                          capture_error_mode="thread_local"):
        out = fn()
    return graph, out


def _flatten(tree, arrays):
    """A hashable description of `tree` (dicts, lists and tuples of
    arrays and static values); its arrays are appended to `arrays`."""
    if isinstance(tree, dict):
        return ("dict", tuple(tree),
                tuple(_flatten(v, arrays) for v in tree.values()))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,
                tuple(_flatten(v, arrays) for v in tree))
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        arrays.append(tree)
        return ("array",)
    return ("static", tree)


def _unflatten(spec, arrays):
    """`_flatten`'s tree, its arrays taken in order from the iterator."""
    kind = spec[0]
    if kind == "dict":
        return {k: _unflatten(s, arrays) for k, s in zip(spec[1], spec[2])}
    if kind in ("list", "tuple"):
        items = [_unflatten(s, arrays) for s in spec[1]]
        return items if kind == "list" else tuple(items)
    return next(arrays) if kind == "array" else spec[1]


def _map(fn, tree):
    """fn on each tensor of an output tree (dicts, lists, tuples)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _algorithm_flags():
    return (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def signature(model, spec, inputs):
    """What a captured program depends on beside its body (the module
    docstring lists it)."""
    storage = tuple(t.data_ptr() for t in itertools.chain(
        model.parameters(), model.buffers()))
    return (spec, tuple((tuple(x.shape), x.stride(), x.dtype)
                        for x in inputs),
            model.dtype, getattr(model, "legacy_broadcast", None), storage,
            _algorithm_flags())


class _Graph:
    """A captured program: its static inputs, the graph and its static
    outputs."""

    def __init__(self, body, spec, inputs, stream, pool):
        t0 = time.perf_counter()
        self.inputs = [torch.zeros_like(x) for x in inputs]
        args = _unflatten(spec, iter(self.inputs))
        with _inside():
            self.graph, self.outputs = capture(lambda: body(*args), stream,
                                               pool)
        self.capture_s = time.perf_counter() - t0

    def replay(self, inputs):
        """Copy the inputs in, replay on the current stream, and return
        clones of the outputs."""
        for static, x in zip(self.inputs, inputs):
            static.copy_(x)
        self.graph.replay()
        return _map(torch.Tensor.clone, self.outputs)


class _Cache:
    """A model's graphs: per program an ordered {signature: _Graph or
    WARMED}, the programs' stats and the memory pool they share."""

    def __init__(self):
        self.graphs = {}
        self.stats = {}
        self.pool = None
        self.lock = threading.RLock()


def _cache(model) -> _Cache:
    cache = model.__dict__.get("_graph_cache")
    if cache is None:
        cache = model.__dict__["_graph_cache"] = _Cache()
    return cache


def stats(model, name):
    """The counts of program `name` on `model` (module docstring)."""
    return _cache(model).stats.setdefault(
        name, {"eager": 0, "captures": 0, "replays": 0, "capture_s": []})


def all_stats(model):
    """{program: its counts} of every program `model` has run."""
    return _cache(model).stats


def run(model, name, body, args):
    """body(*args), the device program `name` of `model`: on a card a
    graph (module docstring), else eagerly. `args` may hold host arrays;
    `body` gets them on the model's device."""
    if getattr(_local, "depth", 0) or capturing(model.device):
        return body(*args)  # inside another program: part of its body
    counts = stats(model, name)
    if not _on_card(model) or _disabled[0]:
        counts["eager"] += 1
        return body(*args)
    arrays = []
    spec = _flatten(args, arrays)
    # host arrays and tensors are copied to the device before any graph
    inputs = [torch.as_tensor(x, device=model.device) for x in arrays]
    key = signature(model, spec, inputs)
    cache = _cache(model)
    with cache.lock:
        table = cache.graphs.setdefault(name, collections.OrderedDict())
        entry = table.get(key)
        if entry is None:
            table[key] = WARMED
            while len(table) > MAX_GRAPHS:
                table.popitem(last=False)
            counts["eager"] += 1
            with _inside():
                return warm_up(body, *_unflatten(spec, iter(inputs)),
                               stream=capture_stream(model.device))
        table.move_to_end(key)
        if entry is WARMED:
            entry = _Graph(body, spec, inputs,
                           capture_stream(model.device), cache.pool)
            if cache.pool is None:
                cache.pool = entry.graph.pool()
            table[key] = entry
            counts["captures"] += 1
            counts["capture_s"].append(entry.capture_s)
        counts["replays"] += 1
        return entry.replay(inputs)


def program(fn):
    """Make the model method fn(self, *args) the model's device program
    of fn's name (`run`); positional arguments only."""
    @functools.wraps(fn)
    def call(model, *args):
        return run(model, fn.__name__, functools.partial(fn, model), args)

    return call
