#!/usr/bin/env python3
"""Drive mmnc_tpu_torch on one NVIDIA H100 end to end.

    python3 chip_smoke.py [--profile DIR]

Phases, each of which exits non-zero on failure:
  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the port (one nvcc per source, all at once)
     and the rANS coder;
  3. hold each kernel against its plain PyTorch version on the card at the
     shapes the serving path gives it, with its device time (torch.profiler)
     and host launch time (CUDA events over back-to-back calls), the plain
     version's, a library call's where one computes the same op, and the
     card's bound. Print each shape's launch plan. For GDN also check
     (and time) both plan variants at one large and one small shape, check
     extra shapes (ragged rows, C = 3 and 128, 5 rows, the other
     direction, C = 168) and that two launches are bitwise equal
     everywhere; for deconv+IGDN check the split kernel at extra shapes
     and that two of its launches are bitwise equal, and the tiled kernel
     too where the plan is the split one; for both, every launch shape of
     phase 6's models too;
  4. build SingleTaskCompressor(["rgb"], latent 128, conv 100) from a seed,
     run eval forward, then compress -> decompress on 3 batches of 8
     random 256x256 rgb images; check the decode equals the eval
     forward, the launch counts (9 GDN per compress, 2 GDN + 7 deconv+IGDN
     per decompress) and the port against its CPU plain path on one image;
  5. stream the same 3 batches through `stream_roundtrip` (v2, then v1):
     per batch the bytes of the packed compress and x_hats within 1e-5 of
     its decompress, 11 GDN and 7 deconv+IGDN launches a batch; a batch
     whose fused program reports max_abs = 2^15 takes the int32 path and
     still round-trips. Print each layout's wall time, device time and
     busy share (torch.profiler) and its host split by pipeline stage
     (the streaming module's record_function spans, timed);
  6. the widths past the first slice's limits: SingleTaskCompressor at
     conv 192 and at conv 300 (GDN at C = 96..300, deconv+IGDN at Cout =
     192 and 300), one batch of 8 compress -> decompress each, held
     against its eval forward, and the card's path against the CPU plain
     path on one image (phase 3 checks and times the kernels at every
     launch shape of these models among its extra shapes);
  7. print a {"kernels": [...]} line and, last,
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

With no CUDA device, or outside a checkout of the repo, it exits non-zero
and prints no result. `--profile DIR` also writes torch.profiler summaries
of one round trip and of each layout's streamed run to DIR.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12  # CUDA cores; the kernels use no tensor cores
F32 = 4
# chrome-trace categories of device work (torch.profiler / kineto)
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
# torch.profiler (CUPTI) on the H100 now and then keeps only part of a
# window's kernel records (5 of ~70 windows in one chip_smoke run); such a
# window is measured again, up to this many times
TIMING_TRIES = 10

IMAGE = 256
LATENT = 128
CONV = 100
BATCH, BATCHES, SEED = 8, 3, 0
WIDE_CONVS = (192, 300)  # phase 6: CompressAI's N, three tasks at bench width


def bound_ms(n_bytes, flops):
    """Least time for the work: the larger of bytes over HBM rate and
    operations over the f32 rate. Returns (ms, "bytes" | "operations")."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def gdn_cost(n, c):
    """Bytes (x read, out written, gamma, beta) and FLOPs (x^2, the
    C x C product as FMAs, (r)sqrt, multiply) of one (I)GDN on (n, c)."""
    return (2 * n * c + c * c + c) * F32, 2 * n * c * c + 3 * n * c


def deconv_igdn_cost(b, h, w, cin, cout, mode):
    """Bytes and FLOPs of one k5/s2 deconv (+ epilogue). Taps falling on
    the zero padding are not counted: (5H-3)(5W-3) input-tap pairs per
    image and channel pair, and of the weights only the kernel rows and
    columns that reach the image (2 of 5 along an axis of extent 1)."""
    taps = (5 * h - 3) * (5 * w - 3)
    kernel_taps = (2 if h == 1 else 5) * (2 if w == 1 else 5)
    out_pix = b * 4 * h * w
    flops = 2 * b * taps * cin * cout + out_pix * cout
    n_bytes = (b * h * w * cin + kernel_taps * cin * cout + cout
               + out_pix * cout) * F32
    if mode is not None:
        flops += 2 * out_pix * cout * cout + 3 * out_pix * cout
        n_bytes += (cout * cout + cout) * F32
    return n_bytes, flops


def device_records(torch, fn, calls):
    """The device-work records torch.profiler keeps of `calls` calls of fn,
    traced after a profiler warm-up step of as many calls (whose records
    it drops). The trace's categories tell device work apart from the
    profiler's own "overhead" entries (CUPTI's buffer requests)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)
                     ) as prof:
            for _ in range(2):  # warm-up step, then the kept step
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        with open(path) as f:
            return [e for e in json.load(f)["traceEvents"]
                    if e.get("cat") in DEVICE_WORK]


def time_ms(torch, fn, iters=20):
    """(device ms, host ms) of one call of fn, after 3 warm-up calls.

    Device ms: the summed durations of every device activity the calls
    launched (kernels, cuDNN's layout transforms, memsets, copies), as
    torch.profiler records them over `iters` calls, per call. A trace of
    one call gives the kernel records per call; a window of `iters` calls
    that does not hold exactly `iters` times as many lost or gained
    records, and both are measured again. Host ms: CUDA events around
    `iters` back-to-back calls, per call; where a call's device work is
    shorter than its Python and launch cost this is the launch rate the
    eager path pays, not the device's time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    host = start.elapsed_time(end) / iters

    def kernels(events):
        return sum(e["cat"] == "kernel" for e in events)

    for _ in range(TIMING_TRIES):
        per_call = kernels(device_records(torch, fn, 1))
        events = device_records(torch, fn, iters)
        if per_call and kernels(events) == iters * per_call:
            return sum(e["dur"] for e in events) / 1e3 / iters, host
        print(f"time_ms: the profiler kept {kernels(events)} kernel records "
              f"of {iters} calls against {per_call} of one; measuring again")
    raise RuntimeError(f"the profiler lost device records {TIMING_TRIES} "
                       f"times")


def max_err(torch, got, want):
    return (got - want).abs().max().item(), want.abs().max().item()


def gdn_path_shapes(b, conv=CONV):
    """(rows, C, inverse, launches per round trip) of every GDN launch of
    one compress + decompress of a batch of b images at 256 px."""
    enc = [(b * IMAGE ** 2, conv // 2)] + [
        (b * (IMAGE >> s) ** 2, conv) for s in range(1, 9)]  # head 5 + g_a 3
    dec = [(b * 32 ** 2, conv // 2), (b * 64 ** 2, conv // 2)]
    return ([(n, c, False, 1) for n, c in enc]
            + [(n, c, True, 1) for n, c in dec])


def deconv_path_shapes(b, conv=CONV):
    """(B, H, W, Cin, Cout, mode) of every deconv+IGDN launch of one
    decompress: g_s 1->2->4->8, then the decoder head 16->...->256."""
    return [(b, 1, 1, LATENT, conv, "igdn"), (b, 2, 2, conv, conv, "igdn"),
            (b, 4, 4, conv, conv, "igdn"), (b, 16, 16, conv, conv // 2, "igdn"),
            (b, 32, 32, conv // 2, conv // 2, "igdn"),
            (b, 64, 64, conv // 2, 3, "igdn"), (b, 128, 128, 3, 3, "igdn")]


def gdn_extra_shapes(path):
    """(rows, C, inverse) beyond the path: the other direction at three
    path shapes, ragged row counts, C = 3 and C = 128 (padded to 4, and
    the widest of the fixed-C instantiations), fewer rows than one
    warp's 32; then C above 128 (channel-sliced plans): 168 (four tasks
    of 42) and the other direction at 192 and 300; last every GDN launch
    of phase 6's models (conv 192, CompressAI's N, and conv 300, three
    tasks at bench width: C = 96 and 150 in the heads, 192 and 300)."""
    return ([(n, c, not inv) for n, c, inv, _ in (path[0], path[1], path[-2])]
            + [(4099, CONV // 2, False), (777, CONV, True), (1000, 3, False),
               (64, 128, True), (5, CONV, False)]
            + [(4099, 168, False), (777, 168, True),
               (BATCH * 8 ** 2, 192, True), (BATCH * 8 ** 2, 300, True)]
            + [(n, c, inv) for conv in WIDE_CONVS
               for n, c, inv, _ in gdn_path_shapes(BATCH, conv)])


def gdn_case(torch, gen, n, c):
    x = torch.randn(n, c, generator=gen).cuda()
    gamma = (0.1 * torch.eye(c) + 0.01 * torch.rand(c, c, generator=gen)).cuda()
    beta = (1 + 0.1 * torch.rand(c, generator=gen)).cuda()
    return x, gamma, beta


def check_gdn_launch(torch, x, gamma, beta, inverse, plan, tol_rel):
    """One plan against the plain version, and a second launch bitwise
    equal to the first. Returns (max abs err, |plain|max)."""
    from mmnc_tpu_torch.ops.gdn import gdn_cuda, gdn_plain

    got = gdn_cuda(x, gamma, beta, inverse, plan=plan)
    again = gdn_cuda(x, gamma, beta, inverse, plan=plan)
    want = gdn_plain(x, gamma, beta, inverse)
    torch.cuda.synchronize()
    err, scale = max_err(torch, got, want)
    where = f"gdn {tuple(x.shape)} inverse={inverse} plan {tuple(plan)}"
    if not err <= tol_rel * max(1.0, scale):
        raise RuntimeError(f"{where}: max abs err {err} > {tol_rel} x "
                           f"{max(1.0, scale)}")
    if not torch.equal(got, again):
        raise RuntimeError(f"{where}: two launches differ")
    return err, scale


def check_gdn(torch, b, gen):
    """Every path shape and the extra shapes under their launch plan, and
    first every plan variant forced at one large and one small path shape:
    each against the plain version and bitwise repeatable; then device
    time of the plan's launch, the plain version's and the bound."""
    from mmnc_tpu_torch.ops.gdn import gdn_cuda, gdn_plain, gdn_plan

    tol_rel = 1e-4
    path = gdn_path_shapes(b)
    for n, c in ((b * 128 ** 2, CONV), (b * 8 ** 2, CONV)):
        x, gamma, beta = gdn_case(torch, gen, n, c)
        for variant in ("rows", "split"):
            plan = gdn_plan(n, c, variant)
            err, _ = check_gdn_launch(torch, x, gamma, beta, False, plan,
                                      tol_rel)
            ms, host = time_ms(torch, lambda: gdn_cuda(x, gamma, beta, False,
                                                       plan=plan))
            print(f"kernel gdn variant={variant} rows={n} C={c} plan="
                  f"{tuple(plan)} max_abs_err={err:.3e} bitwise_repeat=ok "
                  f"ms={ms:.5f} host_ms={host:.5f}")
        del x, gamma, beta
    totals = {"ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
              "err": 0.0}
    bound_by = {}
    cases = path + [(*s, 0) for s in gdn_extra_shapes(path)]
    for n, c, inverse, per_trip in cases:
        x, gamma, beta = gdn_case(torch, gen, n, c)
        plan = gdn_plan(n, c)
        err, scale = check_gdn_launch(torch, x, gamma, beta, inverse, plan,
                                      tol_rel)
        ms, host = time_ms(torch, lambda: gdn_cuda(x, gamma, beta, inverse))
        plain, plain_host = time_ms(
            torch, lambda: gdn_plain(x, gamma, beta, inverse))
        bms, by = bound_ms(*gdn_cost(n, c))
        print(f"kernel gdn rows={n} C={c} inverse={inverse} per_round_trip="
              f"{per_trip} plan={tuple(plan)} max_abs_err={err:.3e} "
              f"(|ref|max {scale:.3g}) bitwise_repeat=ok "
              f"ms={ms:.5f} host_ms={host:.5f} plain_ms={plain:.5f} "
              f"plain_host_ms={plain_host:.5f} bound_ms={bms:.5f} "
              f"bound_by={by}")
        totals["err"] = max(totals["err"], err)
        if per_trip:
            totals["ms"] += per_trip * ms
            totals["host_ms"] += per_trip * host
            totals["plain_ms"] += per_trip * plain
            totals["bound_ms"] += per_trip * bms
            bound_by[by] = bound_by.get(by, 0.0) + bms
        del x, gamma, beta
    return totals, max(bound_by, key=bound_by.get), tol_rel


def split_extra_shapes():
    """Shapes beyond the path for the split kernel: a Cin the cluster size
    does not divide (100 over 8, 50 over 4), an odd input, batch 1."""
    return [(1, 3, 3, CONV, CONV, "igdn"), (2, 4, 4, CONV // 2, 64, "igdn"),
            (1, 1, 1, LATENT, CONV, "igdn"), (1, 2, 2, CONV, CONV, "igdn"),
            (1, 4, 4, CONV, CONV, "igdn")]


def wide_deconv_shapes():
    """Every deconv+IGDN launch of phase 6's models not on the main path:
    at conv 192 the tiled plans hold gamma beside 4x4 tiles in up to
    225 KB of shared memory, at conv 300 g_s's Cout x Cout of gamma does
    not fit and the plan is "tiled_l2"."""
    path = deconv_path_shapes(BATCH)
    return [s for conv in WIDE_CONVS for s in deconv_path_shapes(BATCH, conv)
            if s not in path]


def deconv_case(torch, gen, bb, h, w, cin, cout):
    """x NHWC, the torch-layout weight at init scale and its JAX tap
    layout, bias, gamma, beta; all on the card."""
    x = torch.randn(bb, h, w, cin, generator=gen).cuda()
    wt = ((torch.rand(cin, cout, 5, 5, generator=gen) * 2 - 1)
          / (25 * cin) ** 0.5).cuda()
    taps = wt.flip(2, 3).permute(2, 3, 0, 1).contiguous()
    bias = (0.1 * torch.randn(cout, generator=gen)).cuda()
    gamma = (0.1 * torch.eye(cout)
             + 0.01 * torch.rand(cout, cout, generator=gen)).cuda()
    beta = (1 + 0.1 * torch.rand(cout, generator=gen)).cuda()
    return x, wt, taps, bias, gamma, beta


def check_deconv(torch, b, gen):
    """Every path shape, g_s's last deconv (no epilogue) and the extra
    split shapes against the plain version. Where the launch plan is the
    split kernel it also checks that two launches are bitwise equal and
    that the tiled kernel, forced at the same shape, agrees too (its only
    check there)."""
    import torch.nn.functional as F

    from mmnc_tpu_torch.ops.deconv_igdn import (deconv_igdn_cuda,
                                                deconv_igdn_plain,
                                                launch_plan, tile_shape)

    tol_rel = 1e-4
    cases = [(s, 1) for s in deconv_path_shapes(b)]
    cases.append(((b, 8, 8, CONV, CONV, None), 0))  # g_s's last deconv, no epilogue
    cases += [(s, 0) for s in split_extra_shapes() + wide_deconv_shapes()]
    totals = {"ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
              "library_ms": 0.0, "err": 0.0}
    bound_by = {}
    for (bb, h, w, cin, cout, mode), per_trip in cases:
        x, wt, taps, bias, gamma, beta = deconv_case(torch, gen, bb, h, w,
                                                     cin, cout)
        plan = launch_plan(bb, h, w, cin, cout)
        plans = {plan}
        if plan[0] == "split":
            plans.add(("tiled", *tile_shape(bb, h, w, cout), 1))
        want = deconv_igdn_plain(x, taps, bias, gamma, beta, mode)
        err, scale = 0.0, want.abs().max().item()
        for p in plans:
            got = deconv_igdn_cuda(x, taps, bias, gamma, beta, mode, plan=p)
            torch.cuda.synchronize()
            e, _ = max_err(torch, got, want)
            if not e <= tol_rel * max(1.0, scale):
                raise RuntimeError(f"deconv_igdn {(bb, h, w, cin, cout, mode)}"
                                   f" plan {p}: max abs err {e} > {tol_rel} x"
                                   f" {max(1.0, scale)}")
            if p == plan:
                err = e
            if p[0] == "split" and not torch.equal(got, deconv_igdn_cuda(
                    x, taps, bias, gamma, beta, mode, plan=p)):
                raise RuntimeError(f"deconv_igdn {(bb, h, w, cin, cout)} "
                                   f"split: two launches differ")
        x_nchw = x.permute(0, 3, 1, 2)
        ms, host = time_ms(torch, lambda: deconv_igdn_cuda(
            x, taps, bias, gamma, beta, mode))
        plain, plain_host = time_ms(torch, lambda: deconv_igdn_plain(
            x, taps, bias, gamma, beta, mode))
        lib, lib_host = time_ms(torch, lambda: F.conv_transpose2d(
            x_nchw, wt, bias, stride=2, padding=2, output_padding=1))
        bms, by = bound_ms(*deconv_igdn_cost(bb, h, w, cin, cout, mode))
        print(f"kernel deconv_igdn x=({bb},{h},{w},{cin}) Cout={cout} "
              f"mode={mode} plan={plan} per_round_trip={per_trip} "
              f"max_abs_err={err:.3e} (|ref|max {scale:.3g}) "
              f"{'bitwise_repeat=ok ' if plan[0] == 'split' else ''}"
              f"ms={ms:.5f} host_ms={host:.5f} plain_ms={plain:.5f} "
              f"plain_host_ms={plain_host:.5f} library_ms={lib:.5f} "
              f"library_host_ms={lib_host:.5f} bound_ms={bms:.5f} "
              f"bound_by={by}")
        totals["err"] = max(totals["err"], err)
        if per_trip:
            totals["ms"] += ms
            totals["host_ms"] += host
            totals["plain_ms"] += plain
            totals["library_ms"] += lib
            totals["bound_ms"] += bms
            bound_by[by] = bound_by.get(by, 0.0) + bms
    return totals, max(bound_by, key=bound_by.get), tol_rel


def counts():
    from mmnc_tpu_torch.ops.deconv_igdn import deconv_igdn_cuda
    from mmnc_tpu_torch.ops.gdn import gdn_cuda
    return {"gdn": gdn_cuda.launches, "deconv_igdn": deconv_igdn_cuda.launches}


def reset_counts():
    from mmnc_tpu_torch.ops.deconv_igdn import deconv_igdn_cuda
    from mmnc_tpu_torch.ops.gdn import gdn_cuda
    gdn_cuda.launches = 0
    deconv_igdn_cuda.launches = 0


def seeded_model(device, seed, conv=CONV):
    """The bench config (at `conv` channels) from `seed`, its conv kernels
    scaled by `weights.scale_conv_kernels` (encoder 4, hyperprior 10,
    decoder 3): at the init scale every y of the untrained model rounds to
    0 and the decode is all zeros; scaled, 43% of y and 36% of z symbols
    are non-zero (on the CPU at conv 100)."""
    from mmnc_tpu_torch import build_model
    from mmnc_tpu_torch.weights import scale_conv_kernels

    model = scale_conv_kernels(build_model(
        1, ["rgb"], latent_channels=LATENT, conv_channels=conv,
        device=device, seed=seed))
    model.update_bottleneck_values()
    return model


def random_batches(torch, n, seed):
    rng = np.random.default_rng(seed)
    return [{"rgb": torch.from_numpy(rng.random(
        (BATCH, IMAGE, IMAGE, 3), dtype=np.float32)).cuda()}
        for _ in range(n)]


def run_model(torch, profile_dir):
    model = seeded_model("cuda", SEED)
    batches = random_batches(torch, BATCHES, SEED)

    refs = []
    for batch in batches:
        x_hats, liks = model(batch)
        rec = x_hats["rgb"]
        if rec.shape != (BATCH, IMAGE, IMAGE, 3):
            raise RuntimeError(f"eval forward shape {tuple(rec.shape)}")
        if liks["y"].shape != (BATCH, 4, 4, LATENT) or \
                liks["z"].shape != (BATCH, 1, 1, CONV):
            raise RuntimeError("likelihood shapes")
        for name, t in (("x_hat", rec), ("y", liks["y"]), ("z", liks["z"])):
            if not torch.isfinite(t).all():
                raise RuntimeError(f"eval forward: non-finite {name}")
        if not ((liks["y"] > 0).all() and (liks["z"] > 0).all()):
            raise RuntimeError("eval forward: likelihood <= 0")
        refs.append(rec)

    ans, _ = model.compress(batches[0])  # warm-up: cuDNN heuristics, coder
    model.decompress(ans)
    torch.cuda.synchronize()

    reset_counts()
    per_call, outs, n_bytes = [], [], 0
    t0 = time.perf_counter()
    for batch in batches:
        c0 = counts()
        ans, nb = model.compress(batch)
        c1 = counts()
        outs.append(model.decompress(ans)["rgb"])
        torch.cuda.synchronize()
        c2 = counts()
        per_call.append(({k: c1[k] - c0[k] for k in c0},
                         {k: c2[k] - c1[k] for k in c0}))
        n_bytes += nb
    seconds = time.perf_counter() - t0
    launches = counts()

    for enc, dec in per_call:
        if enc != {"gdn": 9, "deconv_igdn": 0} or \
                dec != {"gdn": 2, "deconv_igdn": 7}:
            raise RuntimeError(f"launch counts: compress {enc}, "
                               f"decompress {dec}")
    if n_bytes <= 0:
        raise RuntimeError("no bytes coded")
    # decode runs the same layers on the same y_hat as the eval forward, but
    # cuDNN's transposed conv (a backward-data algorithm) may sum in another
    # order from call to call: atol 1e-5 as tests/test_models.py
    dec_err = max((o - r).abs().max().item() for o, r in zip(outs, refs))
    if not dec_err <= 1e-5:
        raise RuntimeError(f"decode vs eval forward: max abs err {dec_err}")

    images = BATCH * BATCHES
    print(f"model rgb latent={LATENT} conv={CONV} {IMAGE}px batch={BATCH} "
          f"batches={BATCHES}: round trip {seconds:.4f} s, "
          f"{images * IMAGE * IMAGE / 1e6 / seconds:.3f} MP/s, "
          f"{n_bytes / images:.2f} bytes/image, decode vs eval forward max "
          f"abs err {dec_err:.3e}")
    check_against_cpu(torch, model, batches[0]["rgb"][:1])
    if profile_dir:
        profile_round_trip(torch, model, batches[0], profile_dir)
    return launches, model, batches


def check_against_cpu(torch, model, x, conv=CONV):
    """The card's path (kernels) against the port's CPU plain path on one
    image, same seed so the same weights. Tolerance: float32 sums in
    another order through ~20 layers, rtol 1e-3 / atol 1e-4 as
    tests/test_torch_import.py, relative to the largest value."""
    cpu = seeded_model("cpu", SEED, conv)
    with torch.no_grad():
        y_g, z_g = model.model.analyze([x.permute(0, 3, 1, 2)])
        y_c, z_c = cpu.model.analyze([x.cpu().permute(0, 3, 1, 2)])
        y_hat = torch.round(y_c)
        r_g = model.model.synthesize_from_y(y_hat.cuda())[0]
        r_c = cpu.model.synthesize_from_y(y_hat)[0]
    for name, g, c in (("y", y_g, y_c), ("z", z_g, z_c), ("x_hat", r_g, r_c)):
        err = (g.cpu() - c).abs().max().item()
        scale = max(1.0, c.abs().max().item())
        print(f"card vs cpu plain path, conv {conv}: {name} max abs err "
              f"{err:.3e} "
              f"(|cpu|max {c.abs().max().item():.3g})")
        if not err <= 1e-4 + 1e-3 * scale:
            raise RuntimeError(f"card vs cpu: {name} err {err}")


class SpanTimer:
    """Host seconds per label of the streaming module's record_function
    spans, summed over every thread (torch.profiler keeps only the spans
    of the thread that started it, not the coder threads')."""

    def __init__(self, streaming):
        self.streaming, self.span = streaming, streaming._span
        self.totals, self.lock = {}, threading.Lock()

    @contextlib.contextmanager
    def timed(self, name):
        t0 = time.perf_counter()
        with self.span(name):
            yield
        with self.lock:
            self.totals[name] = (self.totals.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def __enter__(self):
        self.streaming._span = self.timed
        return self

    def __exit__(self, *exc):
        self.streaming._span = self.span


def busy_us(events):
    """Microseconds in which the device ran at least one record (the
    copy stream overlaps the compute stream)."""
    total, end = 0.0, None
    for e in sorted(events, key=lambda e: e["ts"]):
        start, stop = e["ts"], e["ts"] + e["dur"]
        if end is None or start > end:
            total += e["dur"]
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def run_streaming(torch, model, batches, profile_dir):
    """Phase 5: both stream layouts against compress/decompress, their
    launch counts, the int32 fallback, and each layout's time split."""
    from torch.profiler import ProfilerActivity, profile

    from mmnc_tpu_torch.models import streaming

    refs = []
    for batch in batches:
        ans, n_bytes = model.compress(batch)
        refs.append((n_bytes, model.decompress(ans)["rgb"]))
    torch.cuda.synchronize()

    def check(impl, results, refs):
        if len(results) != len(refs):
            raise RuntimeError(f"stream {impl}: {len(results)} results")
        for k, ((x_hats, n_bytes), (n_ref, ref)) in enumerate(
                zip(results, refs)):
            if n_bytes != n_ref:
                raise RuntimeError(f"stream {impl} batch {k}: {n_bytes} "
                                   f"bytes, compress gave {n_ref}")
            err = (x_hats["rgb"] - ref).abs().max().item()
            if not err <= 1e-5:
                raise RuntimeError(f"stream {impl} batch {k}: x_hats vs "
                                   f"decompress max abs err {err}")

    for impl in streaming.IMPLS:
        # warm-up: every slot's pinned buffers, the coder thread's plans
        list(streaming.stream_roundtrip(model, batches, impl=impl))
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        results = list(streaming.stream_roundtrip(model, batches, impl=impl))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = counts()
        want = {"gdn": 11 * len(batches), "deconv_igdn": 7 * len(batches)}
        if launches != want:
            raise RuntimeError(f"stream {impl}: launches {launches}, want "
                               f"{want} (11 GDN + 7 deconv+IGDN a batch)")
        check(impl, results, refs)
        del results
        images = BATCH * len(batches)
        with SpanTimer(streaming) as spans, profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                ) as prof:
            t1 = time.perf_counter()
            results = list(streaming.stream_roundtrip(model, batches,
                                                      impl=impl))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        check(impl, results, refs)
        del results
        with tempfile.TemporaryDirectory() as tmp:
            trace = os.path.join(profile_dir or tmp, f"stream_{impl}_trace.json")
            if profile_dir:
                os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(trace)
            with open(trace) as f:
                events = [e for e in json.load(f)["traceEvents"]
                          if e.get("cat") in DEVICE_WORK]
        busy = busy_us(events) / 1e3
        split = {name.split(".", 1)[1]: round(t * 1e3 / len(batches), 5)
                 for name, t in sorted(spans.totals.items())}
        print(f"stream {impl} rgb latent={LATENT} conv={CONV} {IMAGE}px "
              f"batch={BATCH} batches={len(batches)}: {seconds:.4f} s, "
              f"{images * IMAGE * IMAGE / 1e6 / seconds:.3f} MP/s, launches "
              f"{launches}, bytes/image "
              f"{sum(n for n, _ in refs) / images:.2f}; profiled: wall "
              f"{wall * 1e3:.3f} ms, device busy {busy:.3f} ms "
              f"({busy / (wall * 1e3):.3f} of wall), device records "
              f"{sum(e['dur'] for e in events) / 1e3:.3f} ms in "
              f"{len(events)}")
        print(f"stream {impl} host ms per batch by stage (summed over "
              f"threads): {json.dumps(split)}")

    # the int32 fallback: the fused program's guard tripped by hand
    wide = []
    fused, real_wide = model._compress_device_fused, streaming._roundtrip_one_wide

    def tripped(batch):
        *outs, _ = fused(batch)
        return (*outs, torch.tensor(2 ** 15, dtype=torch.int32, device="cuda"))

    def counted(pipe, batch):
        wide.append(batch)
        return real_wide(pipe, batch)

    model._compress_device_fused = tripped
    streaming._roundtrip_one_wide = counted
    try:
        results = list(streaming.stream_roundtrip(model, batches[:1]))
        torch.cuda.synchronize()
    finally:
        del model._compress_device_fused
        streaming._roundtrip_one_wide = real_wide
    if len(wide) != 1:
        raise RuntimeError("stream: a max_abs of 2^15 did not take the "
                           "int32 path")
    check("v2 (int32 fallback)", results, refs[:1])
    print("stream v2 int32 fallback (max_abs forced to 2^15): bytes and "
          "x_hats equal compress/decompress")


def run_widths(torch):
    """Phase 6: compress -> decompress at conv 192 and 300 on the card,
    held against the eval forward, and the card's path against the CPU
    plain path on one image (phase 3 holds each kernel launch of these
    models against its plain version)."""
    for conv in WIDE_CONVS:
        model = seeded_model("cuda", SEED, conv)
        batch = random_batches(torch, 1, SEED + conv)[0]
        ref = model(batch)[0]["rgb"]
        reset_counts()
        ans, n_bytes = model.compress(batch)
        enc = counts()
        out = model.decompress(ans)["rgb"]
        torch.cuda.synchronize()
        dec = {k: v - enc[k] for k, v in counts().items()}
        if enc != {"gdn": 9, "deconv_igdn": 0} or \
                dec != {"gdn": 2, "deconv_igdn": 7}:
            raise RuntimeError(f"conv {conv}: launch counts compress {enc}, "
                               f"decompress {dec}")
        if out.shape != (BATCH, IMAGE, IMAGE, 3) or \
                not torch.isfinite(out).all():
            raise RuntimeError(f"conv {conv}: decode shape {tuple(out.shape)}"
                               " or non-finite values")
        err = (out - ref).abs().max().item()
        scale = max(1.0, ref.abs().max().item())
        if not err <= 1e-5 * scale:
            raise RuntimeError(f"conv {conv}: decode vs eval forward max abs "
                               f"err {err}")
        print(f"width conv={conv} latent={LATENT} {IMAGE}px batch={BATCH}: "
              f"{n_bytes / BATCH:.2f} bytes/image, decode vs eval forward "
              f"max abs err {err:.3e} (|ref|max {scale:.3g})")
        check_against_cpu(torch, model, batch["rgb"][:1], conv)
        del model


def profile_round_trip(torch, model, batch, out_dir):
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ans, _ = model.compress(batch)
        model.decompress(ans)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    trace = os.path.join(out_dir, "round_trip_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:  # device work only, as in time_ms
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") in DEVICE_WORK]
    busy_us = sum(e["dur"] for e in events)
    with open(os.path.join(out_dir, "round_trip_profile.txt"), "w") as f:
        f.write(f"wall {wall * 1e3:.3f} ms, device kernel time {busy_us / 1e3:.3f}"
                f" ms, {len(events)} device events (the table's \"Activity "
                f"Buffer Request\" row is the profiler's own)\n{table}\n")
    print(f"profile: wall {wall * 1e3:.3f} ms, device kernel time "
          f"{busy_us / 1e3:.3f} ms ({busy_us / 1e3 / (wall * 1e3):.3f} of wall)"
          f", {len(events)} device events -> {out_dir}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("--profile", default=None,
                        help="write a profiler summary of one round trip here")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mmnc_tpu_torch.device import resolve_device
    from mmnc_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    resolve_device("cuda")  # exact-f32 policy: TF32 off for matmul and cuDNN
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator().manual_seed(SEED)
    gdn_tot, gdn_by, gdn_tol = check_gdn(torch, BATCH, gen)
    dec_tot, dec_by, dec_tol = check_deconv(torch, BATCH, gen)

    launches, model, batches = run_model(torch, args.profile)
    for name, n in launches.items():
        if n == 0:
            raise RuntimeError(f"kernel {name} never launched on the main path")
    run_streaming(torch, model, batches, args.profile)
    del model, batches
    run_widths(torch)

    per_trip = (f"sum over one round trip of a batch of {BATCH}; ms, "
                f"plain_ms, library_ms: device time (torch.profiler); "
                f"host_ms: CUDA events over back-to-back calls")
    kernels = [
        {"name": "gdn", "route": "cuda", "source": "mmnc_tpu_torch/csrc/gdn.cu",
         "replaces": "mmnc_tpu/ops/gdn_pallas.py:52",
         "launches": launches["gdn"], "max_abs_err": gdn_tot["err"],
         "tolerance": f"{gdn_tol} x max(1, |plain|max)",
         "ms": gdn_tot["ms"], "host_ms": gdn_tot["host_ms"],
         "plain_ms": gdn_tot["plain_ms"],
         "bound_ms": gdn_tot["bound_ms"], "bound_by": gdn_by,
         "library_ms": None, "times": per_trip},
        {"name": "deconv_igdn", "route": "cuda",
         "source": "mmnc_tpu_torch/csrc/deconv_igdn.cu",
         "replaces": "mmnc_tpu/ops/deconv_igdn_pallas.py:66",
         "launches": launches["deconv_igdn"], "max_abs_err": dec_tot["err"],
         "tolerance": f"{dec_tol} x max(1, |plain|max)",
         "ms": dec_tot["ms"], "host_ms": dec_tot["host_ms"],
         "plain_ms": dec_tot["plain_ms"],
         "bound_ms": dec_tot["bound_ms"], "bound_by": dec_by,
         "library_ms": dec_tot["library_ms"], "times": per_trip},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
