"""Round-trip throughput of the port: the torch counterpart of bench.py's
`measure_tpu_mps` (bench.py:59-99).

    python -m mmnc_tpu_torch.bench [--batch 64] [--iters 8] [--latent 128]
                                   [--conv 100] [--image 256] [--device cuda]
                                   [--coder-threads N]

Builds `SingleTaskCompressor` (rgb) from a seed with its conv kernels
scaled (`weights.scale_conv_kernels`, so the coder has real symbols), puts
one batch of random images on the device, runs `stream_roundtrip` over 2
warm-up batches with each stream layout (v2, v1), then times `iters`
batches with each: wall seconds from the first dispatch to the last result
on the device. The same batches through a plain `compress` -> `decompress`
loop in one thread are the baseline the pipeline has to beat. Then the
same for the bf16 codec (`dtype=torch.bfloat16`, the same weights), as
bench.py measures bf16 beside f32. On a card the device programs run as
CUDA graphs (`graphs.py`; the warm-up batches warm them up and capture
them), and every figure is measured again with them eager, under
`graphs.disabled()` (the `*_eager` keys). Prints one JSON line: MP/s per
layout and the better one (`value`, `precision` "f32"), the loop's MP/s,
the same for bf16 (`mps_bf16`, ...), and for each codec and mode
(`modes`) the MP/s, the device ms and busy share of one profiled v2
stream of `iters` batches (torch.profiler; the busy share is the union
of the device records over the wall), the captures' host ms and the
peak device memory; batch size, iters, coder threads, stream bytes per
image, the device and, on a card, its name and power limit
(nvidia-smi). Runs on CUDA unless `--device cpu`; a CPU run measures the
CPU, not a card. An out-of-memory error raises.
"""

import argparse
import contextlib
import inspect
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from . import graphs
from .device import resolve_device
from .models.codecs import build_model
from .models.streaming import IMPLS, stream_roundtrip
from .weights import scale_conv_kernels

SEED = 0  # weights and images


def card() -> str:
    """`name, power.limit` of the first card, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mps(batch, seconds):
    b, h, w, _ = batch["rgb"].shape
    return b * h * w / 1e6 / seconds


def measure(model, batch, impl: str, iters: int, coder_threads: int):
    """(MP/s, bytes per image) of `iters` streamed round trips of `batch`."""
    _sync(model.device)
    t0 = time.perf_counter()
    results = list(stream_roundtrip(model, [batch] * iters, impl=impl,
                                    coder_threads=coder_threads))
    _sync(model.device)
    seconds = (time.perf_counter() - t0) / iters
    n_bytes = sum(n for _, n in results)
    return _mps(batch, seconds), n_bytes / (batch["rgb"].shape[0] * iters)


def measure_sequential(model, batch, iters: int):
    """MP/s of `iters` compress -> decompress calls of `batch` in turn,
    after two (on a card: the programs' warm-up and capture)."""
    for _ in range(2):
        model.decompress(model.compress(batch)[0])
    _sync(model.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        model.decompress(model.compress(batch)[0])
    _sync(model.device)
    return _mps(batch, (time.perf_counter() - t0) / iters)


def profile_stream(model, batch, iters: int, threads: int):
    """(device ms a batch, busy share) of one v2 stream of `iters`
    batches under torch.profiler: the summed durations of its kernel,
    copy and memset records, and their union over the wall. The window
    stays open 10 ms on the host before the stream and after it: CUPTI
    now and then loses the records of a window's first launches where the
    work starts right away."""
    from torch.profiler import ProfilerActivity, profile

    _sync(model.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        time.sleep(0.01)
        t0 = time.perf_counter()
        for _ in stream_roundtrip(model, [batch] * iters, impl="v2",
                                  coder_threads=threads):
            pass
        _sync(model.device)
        wall_us = (time.perf_counter() - t0) * 1e6
        time.sleep(0.01)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = sorted((e["ts"], e["ts"] + e["dur"]) for e in
                            json.load(f)["traceEvents"] if e.get("cat") in
                            ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, None
    for start, stop in events:
        if end is None or start > end:
            busy, end = busy + stop - start, stop
        elif stop > end:
            busy, end = busy + stop - end, stop
    device = sum(stop - start for start, stop in events)
    return device / 1e3 / iters, busy / wall_us


def measure_codec(model, batch, iters: int, threads: int):
    """({impl: MP/s}, {impl: bytes per image}, the loop's MP/s, {device
    ms a batch, busy share, capture ms, peak bytes}) of one codec, after
    2 warm-up batches of each layout (on a card: each program's warm-up
    and capture)."""
    model.update_bottleneck_values()
    on_card = model.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(model.device)
    for impl in IMPLS:  # 2 warm-up batches each: plans, pinned buffers
        for _ in stream_roundtrip(model, [batch] * 2, impl=impl,
                                  coder_threads=threads):
            pass
    mps, per_image = {}, {}
    for impl in IMPLS:
        mps[impl], per_image[impl] = measure(model, batch, impl, iters,
                                             threads)
    if len(set(per_image.values())) != 1:
        raise RuntimeError(f"stream bytes differ between layouts: {per_image}")
    sequential = measure_sequential(model, batch, iters)
    profiled = {}
    if on_card:
        device_ms, busy = profile_stream(model, batch, iters, threads)
        profiled = {
            "device_ms_per_batch": device_ms, "busy": busy,
            "capture_ms": 1e3 * sum(
                sum(st["capture_s"]) for st in
                graphs.all_stats(model).values()),
            "peak_bytes": torch.cuda.max_memory_allocated(model.device)}
    return mps, per_image, sequential, profiled


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--iters", type=int, default=8)
    parser.add_argument("--latent", type=int, default=128)
    parser.add_argument("--conv", type=int, default=100)
    parser.add_argument("--image", type=int, default=256)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--coder-threads", type=int,
                        default=inspect.signature(stream_roundtrip)
                        .parameters["coder_threads"].default,
                        help="stream_roundtrip's coder threads (default: "
                             "its own)")
    args = parser.parse_args(argv)
    threads = args.coder_threads

    device = resolve_device(args.device)
    rng = np.random.default_rng(SEED)
    batch = {"rgb": torch.from_numpy(rng.random(
        (args.batch, args.image, args.image, 3), dtype=np.float32)
    ).to(device)}
    results, modes = {}, {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for mode in ("graphed", "eager"):
            model = scale_conv_kernels(build_model(
                1, ["rgb"], latent_channels=args.latent,
                conv_channels=args.conv, device=device, seed=SEED,
                dtype=dtype))
            with (graphs.disabled() if mode == "eager"
                  else contextlib.nullcontext()):
                results[dtype, mode] = measure_codec(model, batch,
                                                     args.iters, threads)
            got_mps, _, got_seq, profiled = results[dtype, mode]
            modes[f"{tag}_{mode}"] = {"mps_by_stream_impl": got_mps,
                                      "mps_compress_decompress": got_seq,
                                      **profiled}
            del model
    mps, per_image, sequential, _ = results[torch.float32, "graphed"]
    mps_bf16, per_image_bf16, sequential_bf16, _ = results[
        torch.bfloat16, "graphed"]
    if (per_image != results[torch.float32, "eager"][1]
            or per_image_bf16 != results[torch.bfloat16, "eager"][1]):
        raise RuntimeError("stream bytes differ between graphed and eager")
    best = max(mps, key=mps.get)
    best_bf16 = max(mps_bf16, key=mps_bf16.get)
    print(json.dumps({
        "metric": "streamed compress+decompress throughput (single-task "
                  f"rgb, latent {args.latent}, conv {args.conv}, "
                  f"{args.image}px)",
        "unit": "MP/s", "value": mps[best], "stream_impl": best,
        "mps_by_stream_impl": mps, "mps_compress_decompress": sequential,
        "batch_size": args.batch, "iters": args.iters,
        "coder_threads": threads, "precision": "f32",
        "bytes_per_image": per_image[best],
        "mps_bf16": mps_bf16[best_bf16], "stream_impl_bf16": best_bf16,
        "mps_bf16_by_stream_impl": mps_bf16,
        "mps_bf16_compress_decompress": sequential_bf16,
        "bytes_per_image_bf16": per_image_bf16[best_bf16],
        "value_eager": max(modes["f32_eager"]["mps_by_stream_impl"].values()),
        "mps_bf16_eager": max(
            modes["bf16_eager"]["mps_by_stream_impl"].values()),
        "modes": modes,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "card": card() if device.type == "cuda" else None}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
