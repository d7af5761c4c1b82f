"""A closed loop of batches through the streamed round trip.

Set-up: the codec at the configuration's sizes and the traffic's
activation type, the weights from the seed loaded into it, the coding
tables built, a pool of `pool` distinct batches made on the device, and
one stream of `warmup_batches` (which warms up and captures the device
programs and the coder thread). The window: one call of
`models/streaming.stream_roundtrip` (layout `impl`, `depth`,
`coder_threads`) over batches handed from the pool in turn, for
`seconds`; the stream then finishes the batches in flight. `stream_mps`
counts every batch's images x H x W over the window's wall, to the last
batch's completion. A watcher thread stamps each batch's completion on
the device (an event recorded after its x_hats are yielded) without
draining the queue: the batch latency, from hand-over to completion.

The answers judged: `judge_batches` batches drawn from the seed among the
window's (reservoir sampling), each compared once the window has closed
with the reference on the same weights and inputs:
* `xhat_gap`: the widest gap of an image's x_hat (any task) from the
  reference's, over max(1, |reference|) of that image and task; where the
  reference's y lies within `y_ambiguity` of a rounding boundary, the
  image is held to the nearest of the reference's syntheses with those
  symbols rounded either way (a product's rounding may put a value there
  on either side);
* `bytes_gap`: the widest relative gap of a batch's stream bytes from
  the reference coder's byte count of the reference's symbols (those
  chosen above) and scale indexes.
"""

import contextlib
import queue
import sys
import threading
import time

from .. import trace
from ..reference import codec as ref_codec
from ..reference import coding
from ..weights import make_weights
from . import common


def run(cell, seed, seconds, traced, device, t_start):
    import torch

    from mmnc_tpu_torch import graphs
    from mmnc_tpu_torch.models import streaming
    from mmnc_tpu_torch.models.codecs import build_model

    cfg, tr = cell.config, cell.traffic
    dtype = getattr(torch, tr["dtype"])
    cuda = device.type == "cuda"
    stages = common.Stages(t_start)
    stages.mark("start and imports")
    if cuda:
        torch.cuda.init()
        stages.mark("CUDA initialised")
    model = build_model(cfg["model"], cfg["tasks"], cfg["latent_channels"],
                        cfg["conv_channels"], lmbda=cfg["lmbda"],
                        legacy_broadcast=cfg["legacy_broadcast"],
                        device=device, dtype=dtype)
    stages.mark("codec built")
    model.load_state_dict(make_weights(cfg, seed, device))
    stages.mark("weights")
    model.update_bottleneck_values()
    stages.mark("coding tables")
    pool = common.make_inputs(torch, cfg, tr["pool"], tr["batch"], seed,
                              device)
    stages.mark("inputs")
    opts = dict(depth=tr["depth"], coder_threads=tr["coder_threads"],
                impl=tr["impl"])
    for _ in streaming.stream_roundtrip(
            model, [pool[i % len(pool)] for i in range(tr["warmup_batches"])],
            **opts):
        pass
    if cuda:
        torch.cuda.synchronize(device)
    stages.mark("warm-up stream")
    plan = trace.SlicePlan(torch, device, tr["trace_start_s"],
                           tr["trace_slice_s"])
    if traced and cuda:
        plan.warm()
        stages.mark("profiler started")
    stages.report()

    spans = trace.Spans()
    hand, done = [], {}
    stamps = queue.Queue()

    def watch():
        while True:
            item = stamps.get()
            if item is None:
                return
            k, event = item
            event.synchronize()
            done[k] = time.perf_counter()

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()

    def feed():
        t0 = time.perf_counter()
        k = 0
        while True:
            now = time.perf_counter()
            if k and now - t0 >= seconds:
                return
            if traced and cuda:
                plan.step(now - t0, k)
            hand.append(time.perf_counter())
            yield pool[k % len(pool)]
            k += 1

    sample = common.Reservoir(tr["judge_batches"], seed + 2)
    n = 0
    with (spans.hooked(streaming) if traced
          else contextlib.nullcontext()):
        for k, (x_hats, n_bytes) in enumerate(
                streaming.stream_roundtrip(model, feed(), **opts)):
            if cuda:
                event = torch.cuda.Event()
                event.record()
                stamps.put((k, event))
            else:
                done[k] = time.perf_counter()
            sample.offer(k, (x_hats, n_bytes))
            n += 1
        if cuda:
            torch.cuda.synchronize(device)
        t_end = time.perf_counter()
        busy_window_s = t_end - hand[0] - plan.overhead_s
        plan.close(n)
    stamps.put(None)
    watcher.join()
    t0 = hand[0]
    window_s = t_end - t0
    b, size = tr["batch"], cfg["image_size"]
    near = plan.near(tr["depth"] + 1)
    latencies = [done[k] - hand[k] for k in range(n) if k not in near]
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    capture_s = sum(sum(st["capture_s"]) for st in
                    graphs.all_stats(model).values())
    reading = common.reading_for(
        cfg, tr, "trip", n, busy_window_s, spans=spans,
        slice=plan.best(), capture_s=capture_s,
        latencies_s=latencies)
    del model
    common.release(torch, device)
    checks = judge(torch, cell, seed, device, pool, sample.items)
    return common.Outcome(
        end_to_end={"stream_mps": n * b * size * size / 1e6 / window_s,
                    "setup_s": t0 - t_start},
        reading=reading, checks=checks, attempted=n, failed=0,
        memory_peak_bytes=int(peak))


def judge(torch, cell, seed, device, pool, items):
    """{number: (value, limit)} of the sampled batches against the
    reference, for each number the cell's limits name: `answer_gap` (the
    widest x_hat gap, or 1 where a batch's bytes are not the reference
    coder's), `xhat_gap` and `bytes_gap`."""
    cfg, tr, lim = cell.config, cell.traffic, cell.limits
    act = getattr(torch, tr["dtype"])
    params = make_weights(cfg, seed, device)
    ref = ref_codec.Codec(cfg, params, ref_codec.Numerics(act))
    gauss = coding.gaussian_table()
    prior, _ = coding.prior_table(params)
    width = lim["ambiguity"]
    worst = {"answer_gap": 0.0, "xhat_gap": 0.0, "bytes_gap": 0.0}
    for k, (x_hats, n_bytes) in sorted(items, key=lambda kv: kv[0]):
        batch = pool[k % len(pool)]
        with torch.no_grad():
            y, z = ref.analyze(batch)
            y_sym, z_sym, idx = ref.symbols(y, z)
            chosen, x_gap = _match_images(torch, ref, y.float(), y_sym,
                                          x_hats, width)
            want = _match_bytes(torch, ref, (chosen, z.float(), z_sym, idx),
                                n_bytes, (gauss, prior), width,
                                lim["bytes_candidates"])
        b_gap = abs(n_bytes - want) / want
        worst["xhat_gap"] = max(worst["xhat_gap"], x_gap)
        worst["bytes_gap"] = max(worst["bytes_gap"], b_gap)
        worst["answer_gap"] = max(worst["answer_gap"],
                                  x_gap if n_bytes == want else 1.0)
        print(f"judged batch {k}: bytes {n_bytes} (reference {want}), "
              f"widest x_hat gap {x_gap:.3e}", file=sys.stderr)
    return {k: (v, lim[k]) for k, v in worst.items() if k in lim}


def _image_gaps(x_port, x_ref, rows):
    """Each image's widest x_hat gap over max(1, |reference|), worst task;
    x_ref rows line up with `rows` of x_port."""
    worst = None
    for task, xr in x_ref.items():
        xp = x_port[task][rows].float()
        d = (xp - xr).abs().flatten(1).amax(1)
        s = xr.abs().flatten(1).amax(1).clamp_min(1.0)
        g = d / s
        worst = g if worst is None else worst.maximum(g)
    return worst


def _near_half(torch, v, width):
    """How far each value lies from a rounding boundary (k + 1/2), over
    max(1, |v|), and the integer on the boundary's other side."""
    floor = torch.floor(v)
    dist = (v - floor - 0.5).abs() / v.abs().clamp_min(1.0)
    other = torch.where(torch.round(v) == floor, floor + 1, floor)
    return dist, other


def _subsets(torch, order, limit=8):
    """Index sets to round the other way: every nonempty subset of the
    `limit` nearest values, or where more lie near, each alone and each
    pair."""
    n = len(order)
    if n <= limit:
        return [order[[j for j in range(n) if m >> j & 1]]
                for m in range(1, 1 << n)]
    singles = [order[j:j + 1] for j in range(n)]
    pairs = [order[[a, b]] for a in range(min(n, 16))
             for b in range(a + 1, min(n, 16))]
    return singles + pairs


def _match_images(torch, ref, y, y_sym, x_hats, width, chunk=16):
    """-> (the symbols each image is judged on, the widest gap): the
    reference's rounding, or where some of an image's y lie within
    `width` x max(1, |y|) of a rounding boundary, the nearest of the
    reference's syntheses with such values rounded the other way."""
    b = y.shape[0]
    gaps = []
    for lo in range(0, b, chunk):
        rows = slice(lo, min(b, lo + chunk))
        gaps.append(_image_gaps(x_hats, ref.synthesize(y_sym[rows]), rows))
    gaps = torch.cat(gaps)
    chosen = y_sym.clone()
    dist, other = _near_half(torch, y, width)
    for i in range(b):
        d = dist[i].flatten()
        near = (d < width).nonzero().flatten()
        if len(near) == 0:
            continue
        order = near[torch.argsort(d[near])]
        cands = []
        for sel in _subsets(torch, order):
            c = y_sym[i].flatten().clone()
            c[sel] = other[i].flatten()[sel]
            cands.append(c.view_as(y_sym[i]))
        for lo in range(0, len(cands), 256):
            part = torch.stack(cands[lo:lo + 256])
            x_rep = {t: v[i:i + 1].expand(len(part), *v.shape[1:])
                     for t, v in x_hats.items()}
            g = _image_gaps(x_rep, ref.synthesize(part), slice(None))
            best = int(torch.argmin(g))
            if g[best] < gaps[i]:
                gaps[i] = g[best]
                chosen[i] = part[best]
    return chosen, float(gaps.max())


def _match_bytes(torch, ref, latents, n_bytes, tables, width, tries):
    """The reference coder's bytes of the batch: of its symbols and
    indexes, or, where those miss `n_bytes` and z or a scale lies within
    `width` of a rounding or bucket boundary, the nearest of the counts
    with one such value on the other side (up to `tries` of each)."""
    y_sym, z, z_sym, idx = latents
    want = coding.batch_bytes(y_sym, z_sym, idx, *tables)
    if want == n_bytes or not tries:
        return want
    med = ref_codec.medians(ref.params).view(1, -1, 1, 1).float()
    cands = []
    dist, other = _near_half(torch, z - med, width)
    for pos in _nearest(torch, dist, width, tries):
        zc = z_sym.clone().flatten()
        zc[pos] = other.flatten()[pos]
        zc = zc.view_as(z_sym)
        img = pos // z_sym[0].numel()
        scales = ref.hyper_scales(zc[img:img + 1] + med)
        ic = idx.clone()
        ic[img] = ref_codec.scale_indexes(
            scales[:, :, :idx.shape[2], :idx.shape[3]])[0]
        cands.append((y_sym, zc, ic))
    scales = ref.hyper_scales(z_sym + med)[:, :, :idx.shape[2],
                                           :idx.shape[3]].float()
    table = ref_codec.scale_table().to(scales.device)
    s = scales.clamp_min(ref_codec.SCALE_BOUND)
    below = table[(idx - 1).clamp(0, len(table) - 1)]
    above = table[idx.clamp(max=len(table) - 1)]
    d_below = torch.where(idx > 0, (s - below) / s, torch.full_like(s, 1.0))
    d_above = torch.where(idx < len(table) - 1, (above - s) / s,
                          torch.full_like(s, 1.0))
    dist = torch.minimum(d_below, d_above)
    step = torch.where(d_below < d_above, -1, 1)
    for pos in _nearest(torch, dist, width, tries):
        ic = idx.clone().flatten()
        ic[pos] += step.flatten()[pos]
        cands.append((y_sym, z_sym, ic.view_as(idx)))
    for c in cands:
        got = coding.batch_bytes(*c, *tables)
        if abs(got - n_bytes) < abs(want - n_bytes):
            want = got
        if want == n_bytes:
            break
    return want


def _nearest(torch, dist, width, limit):
    d = dist.flatten()
    near = (d < width).nonzero().flatten()
    return near[torch.argsort(d[near])][:limit].tolist()
