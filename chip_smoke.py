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
     phase 6's and phase 8's models too, and for GDN every launch shape of
     phase 7's train step (batch 16, the IGDNs of g_s and the decoder head
     unfused) and of phase 8's shared4 train step (batch 2: C = 1, 10 and
     17 among them); for both, every launch shape of phase 9 (shared4's
     train step and eval forward at batch 16, its eval forward at 4), and
     of phase 10 (shared4's train step at a rank's batch of 8, and the
     encode and decode halves of its eval forward at 16 and 4).
     Each distinct shape is timed once; the kernels line sums its times
     over the launches of an rgb and a shared4 round trip. Then GDN's
     backward kernel (csrc/gdn_backward.cu) at every (I)GDN of phase 7's
     rgb train step, of shared4's train steps (phases 8, 9 and 10) and,
     in bf16, of the rgb step: dx, dgamma and dbeta against
     `gdn_backward_plain` within 1e-4 x max(1, |plain|max) each (a bf16
     dx 2^-7), two launches bitwise equal, timed with the plain version
     and the bound (`gdn_backward_cost`); also a strided gradient, ragged
     rows and C = 168 and 655 (gamma read from global memory), checked;
  4. build SingleTaskCompressor(["rgb"], latent 128, conv 100) from a seed,
     run eval forward, then compress -> decompress on 3 batches of 8
     random 256x256 rgb images, its device programs as CUDA graphs
     (`mmnc_tpu_torch/graphs.py`) beside eager (`graphs.disabled()`,
     `round_trips`): under deterministic cuDNN the graphed trips (a
     warm-up, a capture, a replay) give the eager trips' streams and
     bitwise their x_hats; then each mode's MP/s, a profiled trip's
     device ms and busy share, the captures' ms and the peak memory; the
     launch counts (9 GDN per compress, 2 GDN + 7 deconv+IGDN per
     decompress: through the wrappers for an eager call, a warm-up or a
     capture, none for a replay, whose profiled graph records hold them);
     check the decode equals the eval forward and the port against its
     CPU plain path on one image. The serving graphs' replays are counted
     as their captures counted them (`tally_graph_launches`: `counts()`
     adds them to the wrappers' counters);
stale. the stale-parameter hazard (`check_stale_parameters`): the rgb
     decompress's synthesis and the eval step captured, then an eager
     Adam step and a load_state_dict of another seed's weights; after
     each the next replays equal the eager programs on the new
     parameters bitwise (deterministic cuDNN);
  5. stream the same 3 batches through `stream_roundtrip` (v2, then v1),
     graphed beside eager (`stream_layouts`): the graphed stream bitwise
     equal to the eager one under deterministic cuDNN; per batch the
     bytes of the packed compress and x_hats within 1e-5 of its
     decompress, 11 GDN and 7 deconv+IGDN launches a batch (graphed: in
     the replays' graph records, none through the wrappers); a batch
     whose fused program reports max_abs = 2^15 takes the int32 path and
     still round-trips. Print each layout's and mode's wall time, device
     time and busy share (torch.profiler), captures' ms, peak memory and
     host split by pipeline stage (the streaming module's record_function
     spans, timed). After phase
     8 the same at shared4 on phase 8's 3 batches of 8 (every task's
     x_hat; 35 GDN and 28 deconv+IGDN launches a batch), its MP/s and
     busy share beside phase 8's compress -> decompress, the int32
     fallback, and one batch each of mixed and disjoint in both layouts;
  6. the widths past the first slice's limits: SingleTaskCompressor at
     conv 192 and at conv 300 (GDN at C = 96..300, deconv+IGDN at Cout =
     192 and 300), one batch of 8 compress -> decompress each, held
     against its eval forward, and the card's path against the CPU plain
     path on one image (phase 3 checks and times the kernels at every
     launch shape of these models among its extra shapes);
  7. train: the bench config from seed 0 at the init scale, lmbda 1e-2,
     learning rates 1e-4 / 1e-3, 20 scheduled steps, clip 5.0, one fixed
     batch of 16 random 256x256 rgb images.
     (a) one step on the card against one on the port's CPU plain path,
         same weights and noise, one image: every log within rtol 1e-4,
         every parameter's gradient within 1e-3 x max|g_cpu| of it;
     (b) 20 steps on the batch: every loss finite, the last below the
         first, 18 GDN, 0 deconv+IGDN and 18 GDN backward launches a
         step; the step's wall time (median of steps 3-20), images/s and
         MP/s, peak memory, and from torch.profiler on one more step its
         device time, busy share, the GDN kernel's 18 launches, the GDN
         backward (its kernel's 18 launches, and the device work of its
         18 autograd nodes: the kernel and the gradients' contiguous
         copies) and the convolutions' (cuDNN's) share;
     (c) one remat step from the same state and noise as a plain step
         (cuDNN deterministic for both): loss and parameters within 1e-5
         relative, 36 GDN and 18 GDN backward launches;
     (d) the eval step: finite logs, 11 GDN and 7 deconv+IGDN launches;
     (e) the K-step call as one CUDA graph (`make_multi_train_step` on the
         card): under deterministic cuDNN, from one seed state each, six
         calls (a warm-up, a capture, replays) at K = 4 and at K = 1
         against 6 x K eager `make_train_step` steps with the same
         per-step noise, train metrics on: each call's loss and every
         parameter within 1e-6 x max|p|; 18 x K GDN and 18 x K GDN
         backward launches counted for the warm-up and the capture and
         none for a replay, whose 18 x K records of each (0 deconv+IGDN)
         come from its graph in a profiled replay; a call's wall (median
         of the replays), a step's, images/s, a profiled call's device ms
         and busy share, the
         capture's ms and peak memory, graphed beside eager; at K = 1
         every update of both sides also held to the CPU port's Adam
         (not capturable) stepped on the card's gradients: parameters,
         moments and step counts within rtol 1e-4 / atol 1e-6; the K = 1
         pair again under cuDNN's default, timed only; then three remat
         calls at K = 2 against eager remat steps;
  8. multitask, the paper's configs (scripts/rd_paper_sweep.py:39-53) from
     seed 0, conv kernels scaled, random inputs in valid ranges. shared4
     (model 4; rgb, depth, normal, semantic; latent 300, conv 42), the main
     path: the non-zero share of y and z symbols (none may be all 0);
     compress -> decompress on 3 batches of 8, decode vs eval forward
     (atol 1e-5), 27 GDN a compress and 8 GDN + 28 deconv+IGDN a
     decompress, MP/s, and one profiled round trip's device time and busy
     share, graphed beside eager as phase 4's; compress_partial ->
     decompress_tasks(["rgb"]) (2 + 7 launches) and (["semantic",
     "depth_euclidean"]) (4 + 14), a warm-up, a capture and a replay each
     bitwise equal to the eager decode (deterministic cuDNN), against the
     full decode; the container (partial and full) written, read back and
     decoded as without the file; the card against the CPU plain path on
     one image; one train step at batch 2 against the CPU's (phase 7's
     tolerances; 63 GDN and 63 GDN backward launches). Then mixed (model
     2, latent 300, conv 32) and disjoint (model 3, latent 300, conv 42),
     one batch of 8 each: round trip, launch counts (21 GDN a compress; 6
     GDN + 15 and 21 deconv+IGDN a decompress), three graphed trips
     bitwise equal to the eager one, card against CPU. Then phase 5 at shared4
     (above) and the reference import: the seed-0 shared4 model's
     state_dict with CompressAI's buffers, as a Lightning checkpoint,
     imported into a model of another seed on the card; its round trip
     of a batch of 8 under deterministic cuDNN gives the source's bytes
     and bitwise its x_hats (35 + 28 launches); imported with
     raw_gdn=True, the card against the CPU plain path;
  9. cli, the user's flow at shared4 (all files in a temporary
     directory): CLI_TRAIN_SIZE + CLI_VAL_SIZE CLEVR-style synthetic scenes
     prerendered through the train CLI's `get_loaders`; `python -m
     mmnc_tpu_torch.cli.train` (called as `main`) for CLI_EPOCHS epochs at
     batch CLI_BATCH with validation, image grids, a checkpoint and the
     profiler over steps 5-10: finite, falling losses; a warm-up call, a
     capture, then graph replays, 63 GDN and 63 GDN backward launches
     counted for the first two and none for a replay, whose 63 + 63
     kernel records come from its graph (steps 5-10's trace); the eval
     forward's 35 GDN + 28 deconv+IGDN a validation step (MT_LAUNCHES;
     the eval step graphed: a warm-up, a capture, replays, whose graph
     records in steps 5-10's trace hold 35 + 28 each), steps/s and
     images/s
     (StepTimer p50),
     the loader's wait a step, the profiled steps' device time and busy
     share, peak memory, checkpoint save ms; `fit` to the middle and
     resumed, against an uninterrupted run (deterministic cuDNN;
     parameters and Adam moments within 1e-6 x max|p|), and a resume with
     more epochs keeping the saved horizon (restore ms); the training set
     as a DeviceResidentDataset (batches bitwise equal to the CPU port's,
     4 fit steps without the prefetch queue); the train CLI again under
     deterministic cuDNN as an eager reference (the loop's multi-step
     made of eager steps, the serving programs and the eval step under
     `graphs.disabled()`; the graphed runs' validation logs equal to its)
     and graphed at K = 1 and at --steps-per-call
     CLI_K (final parameters within 1e-6 x max|p| of the eager run's,
     logged steps 0, 4, 8, 12, 63 x K GDN a call counted or, replayed,
     from the profiler's graph records; StepTimer p50, images/s and the
     K = 1 runs' busy share of steps 5-10, graphed beside eager) and once
     at CLI_K_CLAMPED for one epoch (clamped to its 8 batches); every
     prefetched batch bitwise equal to its host batch; the compress CLI
     on the checkpoint
     (2 batches: finite bpps > 0, MP/s, launches), and its bytes on a batch
     of CLI_COMPARE_BATCH equal to the CPU port's;
 10. analysis, the RD sweep and data parallelism at shared4 (all files in
     a temporary directory): (a) `cli.rd_sweep`'s sweep over RD_LMBDAS,
     one epoch of 4 steps of 16 on CLEVR-style scenes with validation:
     a point per lambda with bpp > 0 and finite per-task PSNR and
     MS-SSIM, rd_points.json, 63 GDN and 63 GDN backward launches a
     train step and 35 + 28 a validation step; (b) on the first
     checkpoint `check_bpp`, `encode_eval`, `channel_bpp`,
     `swap_latent_slices` and `average_channels` on a batch of 4, card
     against the CPU plain path (bytes and symbols equal, floats within
     rtol 1e-3 / atol 1e-4, each call's launches), then
     `learned_baseline_rd` over both checkpoints (32 held-out scenes each;
     its points and wall); (c) `fit` on 2 ranks
     on cuda:0 over gloo (NCCL takes one rank per card) against one
     process, 4 steps at a global batch of 16 from the same seed weights
     and scenes, deterministic cuDNN (losses rtol 1e-4, parameters rtol
     2e-4 / atol 2e-6, the ranks' bitwise equal; the gloo ranks' calls
     all eager), then the same 4 steps over NCCL at world size 1 with a
     validation of 4 batches: its train calls and eval steps CUDA graphs
     with the all-reduces captured (a warm-up, a capture, replays; a
     profiled replay's graph records 63 GDN a step, the eval step's 35 +
     28), held bitwise to an eager run of the same rank (the loop's
     multi-step made of eager steps, the eval step under
     `graphs.disabled()`: losses, validation logs, parameters) and to the
     one process as the gloo ranks; each run's step p50 (one-step calls
     as its fit made them: replays or eager), images/s and busy share of
     a profiled step, an eager step's gradient all-reduce span (host ms,
     its device records, NCCL's kernels) and a replay's in-graph
     reduction (NCCL's kernels, and the cat, division and copy-back
     nodes, found by the eager span's records); the 2 gloo ranks again
     at DP_K steps a call against the one process (its losses at the
     calls' last steps); (d) then each of those ranks compresses its 8
     rows of a shared4 batch of 16 (`compress_device_fused_sharded`): the
     gathered symbols, indexes and max_abs bitwise equal one process's,
     the rANS bytes its compress's, 27 GDN a rank's call;
bf16. after phase 8 (before phase 5's shared4 part), the bf16 activation
     path (`build_model(..., dtype=torch.bfloat16)`): phase 3's checks with
     bf16 activations at every launch shape of an rgb round trip and a
     shared4 one (batch 8) and of phase 7's train step (batch 16), within
     2^-7 (GDN) and 2^-6 (deconv+IGDN) x max(1, |plain|max), bitwise
     repeatable, timed, the bound at 2 bytes an activation value; the
     rgb codec at bench width on phase 4's batches: decode bitwise
     equal to the eval forward (deterministic cuDNN), compress ->
     decompress graphed beside eager as phase 4's (`round_trips`), MP/s
     beside phase 4's float32 codec's and one profiled round trip's
     device ms, busy share and cuDNN's share beside it measured here, both
     stream layouts (bitwise equal to decompress under deterministic
     cuDNN; `stream_layouts`: graphed beside eager, bytes equal
     compress's, x_hats within 2^-4 of decompress's largest value), card
     vs CPU on one image (2^-4 of the largest value); shared4's round trip
     at batch 8 graphed beside eager, beside phase 8's;
     phase 7's train step in bf16 for BF16_TRAIN_STEPS steps on one batch
     (18 GDN a step, the loss falls, parameters and loss float32), its
     step wall, peak memory and one profiled step (device ms, GDN, its
     backward, cuDNN's share) beside phase 7's; a warm-up and a graphed
     call of the bf16 step at K = 2 against eager bf16 steps under
     deterministic cuDNN (parameters within 1e-6 x max|p|, losses finite
     and float32);
 11. print a {"kernels": [...]} line: gdn and deconv_igdn (launches:
     the shared4 run; times summed over a shared4 round trip, the rgb
     path's beside them; cli_*:
     phase 9's launches and phase 3's times at its train and validation
     steps' shapes; p10_*: phase 10's launches, every process's, and phase
     3's times summed over them; p5_shared4_*, cli_k4_*, p10_compress_*
     and import_launches: the same for phase 5's shared4 stream, phase
     9's K-step run, phase 10 (d) and the import's round trip; bf16: the
     bf16 phase's launches and sums; graphed_trip: phase 4's and phase 8's
     profiled replays' graph records and device ms), and gdn_backward
     (launches: phase 7 (b)'s steps; times: phase 3's summed over an rgb
     train step's launches, shared4's and the bf16 step's beside them, and
     the same phase 9 and 10 entries as gdn's) and, last, {"ok":
     true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

With no CUDA device, or outside a checkout of the repo, it exits non-zero
and prints no result. `--dp-cards N` runs only phase 10 (c) and (d)
across N cards (one NCCL rank a card, DP_BATCH rows each, fit graphed
and then eager, as phase 10's NCCL rank) against one process at the
global batch, on a machine with N cards. The single process's and the
NCCL ranks' fit replay CUDA graphs (launch totals add each replay's
graph launches, a call's count as a profiled replay's records show it);
gloo ranks' steps stay eager. `--time-deconv
TREE` runs only phase 3's deconv+IGDN checks and times, in float32 and
bf16, at every launch shape of an rgb and a shared4 round trip of a
batch of BATCH, on the `mmnc_tpu_torch` of the checkout at TREE ("." for
this one), and prints one JSON line of them: run it on two checkouts in
turns within one call to compare their kernels on one card.
`--profile-windows N` runs only N rounds of profiled rgb train steps
(phase 7's model and batch), each round one step in a window whose work
starts at once and one in a window held open PROFILE_WAIT_S first, and
prints one JSON line: the windows of each kind in which the profiler lost
launches' records (`lost_launches`). `--profile DIR`
also writes torch.profiler summaries
of one round trip, of each layout's streamed run, of one train step, of
a shared4 round trip and phase 9's trace of the CLI's steps 5-10 to DIR.
"""

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12  # CUDA cores
# TF32 products summed in float32 on the tensor cores (dense); GDN's
# backward takes its products there in 3xTF32, three TF32 products for a
# float32-accurate one (`gdn_backward_tc_bound`)
TF32_FLOP_PER_S = 495e12
# bf16 x bf16 products summed in float32 on the tensor cores (dense): the
# rate a bf16 deconv or GDN product could reach, so the bound of a bf16
# launch counts its operations at this rate
BF16_FLOP_PER_S = 989e12
F32 = 4
BF16 = 2  # bytes of a bf16 activation
# chrome-trace categories of device work (torch.profiler / kineto)
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
# torch.profiler (CUPTI) on the H100 now and then keeps only part of a
# window's kernel records (5 of ~70 windows in one chip_smoke run); such a
# window is measured again, up to this many times
TIMING_TRIES = 10
# CUPTI also loses, now and then, the records of the first launches of a
# window opened with fn's work right behind it (a train step's first 2-14
# launches; `--profile-windows` counts such windows); `profiled` holds the
# window open this long on the host before fn and after it
PROFILE_WAIT_S = 0.01

IMAGE = 256
LATENT = 128
CONV = 100
BATCH, BATCHES, SEED = 8, 3, 0
BENCH_BATCH = 64  # mmnc_tpu_torch.bench's batch (its widths are LATENT, CONV)
WIDE_CONVS = (192, 300)  # phase 6: CompressAI's N, three tasks at bench width
# phase 7: mmnc_tpu/cli/train.py's defaults (batch 16, lmbda 1e-2, learning
# rates 1e-4 / 1e-3) over a 20-step schedule, clipped at 5.0
TRAIN_BATCH, TRAIN_STEPS, LMBDA, LR_MAIN, LR_AUX, CLIP = (
    16, 20, 1e-2, 1e-4, 1e-3, 5.0)
# the port's kernels as the counts name them: GDN's forward, deconv+IGDN
# and GDN's backward; the serving path launches the first two
KERNELS = ("gdn", "deconv_igdn", "gdn_backward")
SERVING = KERNELS[:2]
# launches (GDN, deconv+IGDN, GDN backward) of a train step (9 GDN in the
# encoder head and g_a, 9 IGDN in g_s and the decoder head, all unfused,
# and a backward for each), of a remat step (the forward twice, the
# backward once) and of an eval step (decode fused)
TRAIN_LAUNCHES = {"train": {"gdn": 18, "deconv_igdn": 0, "gdn_backward": 18},
                  "remat": {"gdn": 36, "deconv_igdn": 0, "gdn_backward": 18},
                  "eval": {"gdn": 11, "deconv_igdn": 7, "gdn_backward": 0}}
# phase 7 (e): calls of a graphed run (a warm-up, a capture, replays; the
# last one profiled) at each K, and the remat run's
GRAPH_CALLS, GRAPH_KS = 6, (4, 1)
GRAPH_REMAT_CALLS, GRAPH_REMAT_K = 3, 2
# phase 8: the paper's configs (scripts/rd_paper_sweep.py:39-53), name ->
# (model number, tasks, latent M, conv C); shared4 is the main path
TASKS3 = ("rgb", "depth_euclidean", "normal")
PAPER = {"shared4": (4, TASKS3 + ("semantic",), 300, 42),
         "mixed": (2, TASKS3, 300, 32),
         "disjoint": (3, TASKS3, 300, 42)}
MT_TRAIN_BATCH = 2
# phase 9: the train and compress CLIs at shared4 on CLEVR-style synthetic
# scenes: 2 epochs of 8 batches of 16 (mmnc_tpu/cli/train.py's batch),
# validation on three batches (the eval step's warm-up, capture and a
# replay in the first validation); the compress CLI's bytes held against
# the CPU port's on a batch of 4
CLI_TRAIN_SIZE, CLI_VAL_SIZE, CLI_BATCH, CLI_EPOCHS = 128, 48, 16, 2
CLI_COMPARE_BATCH = 4
CLI_DEVICE = "cuda"
# phase 9: the train CLI with --steps-per-call CLI_K against K = 1, and
# with CLI_K_CLAMPED (more than an epoch's 8 batches: clamped to 8)
CLI_K, CLI_K_CLAMPED = 4, 12
# phase 9: the CLI's runs of the same steps: (run name, K, eager): the
# eager reference, and the graphed calls at K = 1 and CLI_K
CLI_RUNS = (("cli_eager", 1, True), ("cli_k1", 1, False),
            (f"cli_k{CLI_K}", CLI_K, False))
# phase 10: rd_sweep's sweep at shared4 on CLEVR-style scenes (two lambdas,
# one epoch of 4 steps of 16, validation on one batch), the analysis on
# its checkpoints (a batch of ANALYSIS_BATCH on the card and on the CPU;
# learned_baseline_rd over BASELINE_IMAGES held-out images a checkpoint),
# and data parallelism on the one card: DP_RANKS ranks of fit over gloo
# against one process, DP_STEPS steps at a global batch of DP_BATCH, then
# the same over NCCL at world size 1, graphed and eager, with a validation
# of DP_STEPS batches
RD_LMBDAS, RD_TRAIN_SIZE, RD_VAL_SIZE, RD_BATCH = (0.01, 0.001), 64, 16, 16
ANALYSIS_BATCH, BASELINE_IMAGES = 4, 32
DP_RANKS, DP_STEPS, DP_BATCH, DP_TIMED_STEPS = 2, 4, 16, 5
DP_CARD = "cuda:0"  # the card every gloo rank of phase 10 (c) shares
DP_K = 2  # phase 10 (c): the ranks' run at 2 steps a call
# launches (GDN, deconv+IGDN[, GDN backward: 0 where not given]) per call:
# compress runs every encoder-head GDN and g_a's; the eval forward (a
# validation step) compress's and decompress's; decompress the decoder
# heads' two conv3 IGDNs a task and every deconv->IGDN pair fused (mixed:
# g_s's 3 and 4 a head; disjoint and shared: an upsample stack's 3 and 4 a
# head); decompress_tasks(["rgb"]) one task's head; a train step runs every
# (I)GDN of the forward unfused and a backward for each
MT_LAUNCHES = {
    "shared4": {"compress": (27, 0), "decompress": (8, 28),
                "decompress_tasks_rgb": (2, 7),
                "decompress_tasks_semantic_depth": (4, 14),
                "train": (63, 0, 63), "eval": (35, 28)},
    "mixed": {"compress": (21, 0), "decompress": (6, 15)},
    "disjoint": {"compress": (21, 0), "decompress": (6, 21)},
}


def bound_ms(n_bytes, flops, flop_rate=F32_FLOP_PER_S):
    """Least time for the work: the larger of bytes over HBM rate and
    operations over `flop_rate` (the float32 rate, or BF16_FLOP_PER_S for
    bf16 inputs). Returns (ms, "bytes" | "operations")."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / flop_rate
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def gdn_cost(n, c, elt=F32):
    """Bytes (x read, out written, of `elt` bytes a value; gamma, beta in
    float32) and FLOPs (x^2, the C x C product as FMAs, (r)sqrt, multiply)
    of one (I)GDN on (n, c)."""
    return 2 * n * c * elt + (c * c + c) * F32, 2 * n * c * c + 3 * n * c


def deconv_igdn_cost(b, h, w, cin, cout, mode, elt=F32):
    """Bytes and FLOPs of one k5/s2 deconv (+ epilogue); x and out of
    `elt` bytes a value, the parameters float32. Taps falling on
    the zero padding are not counted: (5H-3)(5W-3) input-tap pairs per
    image and channel pair, and of the weights only the kernel rows and
    columns that reach the image (2 of 5 along an axis of extent 1)."""
    taps = (5 * h - 3) * (5 * w - 3)
    kernel_taps = (2 if h == 1 else 5) * (2 if w == 1 else 5)
    out_pix = b * 4 * h * w
    flops = 2 * b * taps * cin * cout + out_pix * cout
    n_bytes = ((b * h * w * cin + out_pix * cout) * elt
               + (kernel_taps * cin * cout + cout) * F32)
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


def gdn_path_shapes(b, conv=CONV):
    """(rows, C, inverse, launches per round trip) of every GDN launch of
    one compress + decompress of a batch of b images at 256 px."""
    enc = [(b * IMAGE ** 2, conv // 2)] + [
        (b * (IMAGE >> s) ** 2, conv) for s in range(1, 9)]  # head 5 + g_a 3
    dec = [(b * 32 ** 2, conv // 2), (b * 64 ** 2, conv // 2)]
    return ([(n, c, False, 1) for n, c in enc]
            + [(n, c, True, 1) for n, c in dec])


def gdn_train_shapes(b, conv=CONV):
    """(rows, C, inverse) of the 18 (I)GDN of a train step's forward on a
    batch of b rgb images at 256 px: GDN in the encoder head and g_a, then
    IGDN in g_s at 2x2 to 8x8 and in the decoder head from 32x32 to
    256x256 (unfused: the serving path fuses these into deconv+IGDN)."""
    enc = [(n, c, False) for n, c, _, _ in gdn_path_shapes(b, conv)[:9]]
    dec = ([(b * (IMAGE >> s) ** 2, conv) for s in (7, 6, 5)]
           + [(b * 32 ** 2, conv // 2)] * 2 + [(b * 64 ** 2, conv // 2)] * 2
           + [(b * 128 ** 2, 3), (b * IMAGE ** 2, 3)])
    return enc + [(n, c, True) for n, c in dec]


def gdn_backward_cost(n, c, elt=F32):
    """Bytes (x and the gradient read, dx written, of `elt` bytes a value;
    gamma and beta read, their gradients written, in float32) and FLOPs
    (the norm recomputed, u @ gamma and u^T @ x^2 as FMAs, ~12 elementwise
    operations a value) of the closed-form backward of one (I)GDN on
    (n, c)."""
    return (3 * n * c * elt + (2 * c * c + 2 * c) * F32,
            6 * n * c * c + 12 * n * c)


def gdn_backward_tc_bound(n, c, elt=F32):
    """The backward's bound with its products on the tensor cores in
    3xTF32: the larger of its bytes (`gdn_backward_cost`'s) over HBM's
    rate, its 6 n C^2 product FLOPs over a third of the TF32 rate and its
    ~12 elementwise operations a value over the CUDA cores' float32 rate
    (the two units run side by side). Returns (ms, "bytes" |
    "operations")."""
    n_bytes, _ = gdn_backward_cost(n, c, elt)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(6 * n * c * c / (TF32_FLOP_PER_S / 3),
                12 * n * c / F32_FLOP_PER_S)
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def deconv_path_shapes(b, conv=CONV):
    """(B, H, W, Cin, Cout, mode) of every deconv+IGDN launch of one
    decompress: g_s 1->2->4->8, then the decoder head 16->...->256."""
    return [(b, 1, 1, LATENT, conv, "igdn"), (b, 2, 2, conv, conv, "igdn"),
            (b, 4, 4, conv, conv, "igdn"), (b, 16, 16, conv, conv // 2, "igdn"),
            (b, 32, 32, conv // 2, conv // 2, "igdn"),
            (b, 64, 64, conv // 2, 3, "igdn"), (b, 128, 128, 3, 3, "igdn")]


def paper_layout(number, tasks, latent, conv):
    """The widths a codec of `build_model(number, tasks, latent, conv)`
    runs: its variant, the latent after `_adjust_latent`, the y block of a
    task, the upsample stacks' width and each task's output width."""
    from mmnc_tpu_torch.data.task_configs import task_parameters

    variant = {1: "mixed", 2: "mixed", 3: "disjoint", 4: "shared"}[number]
    n = len(tasks)
    blocks = {"mixed": 1, "disjoint": n, "shared": n + 1}[variant]
    return {"variant": variant, "n": n, "conv": conv, "total": conv * n,
            "latent": latent // blocks * blocks, "block": latent // blocks,
            "cc": conv // n,
            "outs": [task_parameters[t]["out_channels"] for t in tasks]}


def mt_gdn_shapes(lay, b, train=False):
    """(rows, C, inverse) of every GDN launch, in order, of one compress ->
    decompress of b images at 256 px by a codec of layout `lay`, or with
    train=True of one train step's forward (every IGDN unfused: mixed g_s
    at 2x2-8x8, else each task's upsample stack, then the heads' six)."""
    c, total = lay["conv"], lay["total"]
    head = [(b * IMAGE ** 2, c // 2)] + [
        (b * (IMAGE >> s) ** 2, c) for s in range(1, 6)]
    enc = head * lay["n"] + [(b * (IMAGE >> s) ** 2, total) for s in (6, 7, 8)]
    mixed = lay["variant"] == "mixed"
    mid = (total if mixed else c) // 2
    if not train:
        dec = [(b * 32 ** 2, mid), (b * 64 ** 2, mid)] * lay["n"]
    else:
        def front(width):
            return [(b * (IMAGE >> s) ** 2, width) for s in (7, 6, 5)]

        dec = front(total) if mixed else []
        for oc in lay["outs"]:
            dec += [] if mixed else front(lay["cc"])
            dec += ([(b * 32 ** 2, mid)] * 2 + [(b * 64 ** 2, mid)] * 2
                    + [(b * 128 ** 2, oc), (b * IMAGE ** 2, oc)])
    return ([(n, ch, False) for n, ch in enc]
            + [(n, ch, True) for n, ch in dec])


def mt_deconv_shapes(lay, b):
    """(B, H, W, Cin, Cout, mode) of every deconv+IGDN launch, in order, of
    one decompress of b images by a codec of layout `lay`: mixed g_s's
    three, or each task's upsample stack's three, then its head's four."""
    c, total = lay["conv"], lay["total"]
    mixed = lay["variant"] == "mixed"
    head_in = total if mixed else c
    mid = head_in // 2

    def front(cin, width):
        return [(b, 1, 1, cin, width, "igdn"), (b, 2, 2, width, width, "igdn"),
                (b, 4, 4, width, width, "igdn")]

    shapes = front(lay["latent"], total) if mixed else []
    width = lay["block"] * (2 if lay["variant"] == "shared" else 1)
    for oc in lay["outs"]:
        shapes += [] if mixed else front(width, lay["cc"])
        shapes += [(b, 16, 16, head_in, mid, "igdn"),
                   (b, 32, 32, mid, mid, "igdn"), (b, 64, 64, mid, oc, "igdn"),
                   (b, 128, 128, oc, oc, "igdn")]
    return shapes


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


def gdn_case(torch, gen, n, c, dtype=None):
    """x, gamma, beta on the card; for bf16 x in bf16 and gamma rounded to
    bf16 values held in float32, as the bf16 layer hands them over."""
    x = torch.randn(n, c, generator=gen).cuda()
    gamma = (0.1 * torch.eye(c) + 0.01 * torch.rand(c, c, generator=gen)).cuda()
    beta = (1 + 0.1 * torch.rand(c, generator=gen)).cuda()
    if dtype == torch.bfloat16:
        x, gamma = x.to(dtype), gamma.to(dtype).float()
    return x, gamma, beta


def type_costs(torch, dtype):
    """(bytes an activation value, peak rate of the operations) of x's
    type for the bound: float32 on the CUDA cores, bf16 on the tensor
    cores."""
    if dtype == torch.bfloat16:
        return BF16, BF16_FLOP_PER_S
    return F32, F32_FLOP_PER_S


def check_close(torch, got, want, tol_rel, where):
    """got (of want's type) against want within tol_rel x max(1,
    |want|max). Returns (max abs err, |want|max)."""
    torch.cuda.synchronize()
    if got.dtype != want.dtype:
        raise RuntimeError(f"{where}: output {got.dtype}, want {want.dtype}")
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if not err <= tol_rel * max(1.0, scale):
        raise RuntimeError(f"{where}: max abs err {err} > {tol_rel} x "
                           f"{max(1.0, scale)}")
    return err, scale


def check_deconv_bf16(torch, x, taps, bias, gamma, beta, mode, plan, where):
    """One launch plan of deconv+IGDN on bf16 x (the parameters float32
    holding bf16 values) held to its plain version stage by stage:

    The kernel's sum and y are read back through launches of the same
    plan and mode with gamma 0 and beta 1, whose (I)GDN multiplies by
    sqrt(1) = 1 exactly: the same staging and order of sums as the real
    launch (the split kernel's weight chunks depend on the mode).

    - the sum: the kernel's, rounded to bf16 (zero bias), equals cuDNN's (the plain version's) but where the exact sum s
      (float64: products of bf16 values are exact) lies within float32
      summation error E of a bf16 rounding boundary: E = (n - 1) u
      sum|terms| for n terms in any order (u = 2^-24; taken twice, n = 9
      Cin, for the tensor cores' truncated alignment). The two sum in
      other orders, and there either may round the other way: each of the
      two values v must be a rounding of a value within E of s, |v - s| -
      (half v's gap to its bf16 neighbour towards s) <= E;
    - y: the kernel's is its rounded sum plus the bias, rounded, bitwise
      (the chain's two roundings);
    - the output: within BF16_TOL x max(1, |.|max) of `gdn_plain` on the
      kernel's own y, and a second launch bitwise equal.

    Returns (max abs err against the whole plain version, its |max|,
    values past BF16_TOL x max(1, |max|) of it, sums rounding apart, the
    largest such excess over a half gap in u sum|terms|)."""
    import torch.nn.functional as F

    from mmnc_tpu_torch.ops.deconv_igdn import (deconv_igdn_cuda,
                                                deconv_igdn_plain)
    from mmnc_tpu_torch.ops.gdn import gdn_plain

    c = taps.shape[-1]
    unit_gdn = (torch.zeros(c, c, device=x.device),
                torch.ones(c, device=x.device))
    probe = "igdn" if mode is not None else None
    zero = torch.zeros_like(bias)
    acc = deconv_igdn_cuda(x, taps, zero, *unit_gdn, probe, plan=plan)
    acc_plain = deconv_igdn_plain(x, taps, zero, mode=None)
    torch.cuda.synchronize()
    apart = acc != acc_plain
    n_apart, reach = int(apart.sum().item()), 0.0
    if n_apart:
        weight = taps.double().permute(2, 3, 0, 1).flip(2, 3)
        xs = x.double().permute(0, 3, 1, 2)
        geometry = {"stride": 2, "padding": 2, "output_padding": 1}
        exact, size = (F.conv_transpose2d(a, w, **geometry).permute(
            0, 2, 3, 1)[apart].cpu() for a, w in ((xs, weight),
                                                  (xs.abs(), weight.abs())))
        unit = 2.0 ** -24 * size
        for v in (acc[apart].cpu(), acc_plain[apart].cpu()):
            towards = torch.where(exact > v.double(), float("inf"),
                                  float("-inf")).to(v.dtype)
            gap = (torch.nextafter(v, towards).double() - v.double()).abs()
            excess = ((v.double() - exact).abs() - gap / 2) / unit
            reach = max(reach, excess.max().item())
        if not reach <= 2 * 9 * x.shape[-1]:
            raise RuntimeError(f"{where}: a rounded sum {reach} u sum|terms| "
                               f"past half a bf16 gap from the exact sum")
    y = deconv_igdn_cuda(x, taps, bias, *unit_gdn, probe, plan=plan)
    if not torch.equal(y, (acc.float() + bias).to(x.dtype)):
        raise RuntimeError(f"{where}: y is not the rounded sum plus the "
                           f"bias, rounded")
    out = y
    if mode is not None:
        out = deconv_igdn_cuda(x, taps, bias, gamma, beta, mode, plan=plan)
        again = deconv_igdn_cuda(x, taps, bias, gamma, beta, mode, plan=plan)
        check_close(torch, out, gdn_plain(y.reshape(-1, c), gamma, beta,
                                          mode == "igdn").view(y.shape),
                    BF16_TOL, f"{where} (epilogue on its own y)")
        if not torch.equal(out, again):
            raise RuntimeError(f"{where}: two launches differ")
    want = deconv_igdn_plain(x, taps, bias, gamma, beta, mode)
    diff = (out.float() - want.float()).abs()
    scale = want.float().abs().max().item()
    beyond = int((diff > BF16_TOL * max(1.0, scale)).sum().item())
    return diff.max().item(), scale, beyond, n_apart, reach


def check_gdn_launch(torch, x, gamma, beta, inverse, plan, tol_rel):
    """One plan against the plain version, and a second launch bitwise
    equal to the first. Returns (max abs err, |plain|max)."""
    from mmnc_tpu_torch.ops.gdn import gdn_cuda, gdn_plain

    got = gdn_cuda(x, gamma, beta, inverse, plan=plan)
    again = gdn_cuda(x, gamma, beta, inverse, plan=plan)
    want = gdn_plain(x, gamma, beta, inverse)
    where = (f"gdn {x.dtype} {tuple(x.shape)} inverse={inverse} plan "
             f"{tuple(plan)}")
    err, scale = check_close(torch, got, want, tol_rel, where)
    if not torch.equal(got, again):
        raise RuntimeError(f"{where}: two launches differ")
    return err, scale


def shape_cases(groups):
    """[(shapes, count key or None)] -> {shape: {count key: launches}}, in
    first-seen order: each distinct shape is checked and timed once and
    its times summed into every key by its launches there."""
    cases = {}
    for shapes, key in groups:
        for shape in shapes:
            uses = cases.setdefault(tuple(shape), {})
            if key:
                uses[key] = uses.get(key, 0) + 1
    return cases


def add_times(totals, uses, times, by):
    """Add launches x (device ms, ...) of one shape into each key's sums."""
    for key, k in uses.items():
        tot = totals.setdefault(key, {"launches": 0, "by": {}})
        tot["launches"] += k
        for name, t in times.items():
            tot[name] = tot.get(name, 0.0) + k * t
        tot["by"][by] = tot["by"].get(by, 0.0) + k * times["bound_ms"]


def check_gdn(torch, b, gen):
    """Every path shape, every launch shape of phase 7's train step (batch
    TRAIN_BATCH) and of phase 8's codecs (round trips at batch b, shared4's
    train step at MT_TRAIN_BATCH) and the extra shapes under their launch
    plan, and first every plan variant forced at one large and one small
    path shape: each against the plain version and bitwise repeatable;
    then device time of the plan's launch, the plain version's and the
    bound. Returns the sums ({"ms", "plain_ms", "bound_ms", "host_ms",
    "launches", "by"}) over an rgb round trip ("trip"), an rgb train step's
    forward ("train"), a shared4 round trip ("shared4"), a shared4
    train step's forward ("shared4_train"), and phase 9's train step and
    validation step at CLI_BATCH ("cli_train", "cli_val"); the largest
    error; the tolerance."""
    from mmnc_tpu_torch.ops.gdn import gdn_cuda, gdn_plan

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
    shared4 = paper_layout(*PAPER["shared4"])
    totals, max_err_seen = check_gdn_cases(torch, gen,
        [([s[:3] for s in path], "trip"),
         (gdn_train_shapes(TRAIN_BATCH), "train"),
         (mt_gdn_shapes(shared4, b), "shared4"),
         (mt_gdn_shapes(shared4, MT_TRAIN_BATCH, train=True),
          "shared4_train"),
         (mt_gdn_shapes(shared4, CLI_BATCH, train=True), "cli_train"),
         (mt_gdn_shapes(shared4, CLI_BATCH), "cli_val"),
         (mt_gdn_shapes(shared4, CLI_COMPARE_BATCH), None)]
        + p10_gdn_groups(shared4)
        + [(mt_gdn_shapes(paper_layout(*PAPER[name]), b), None)
           for name in ("mixed", "disjoint")]
        + [(gdn_extra_shapes(path), None)], tol_rel)
    return totals, max_err_seen, tol_rel


def check_gdn_cases(torch, gen, groups, tol_rel, dtype=None):
    """Each distinct shape of `groups` ([(shapes, count key or None)])
    under its launch plan, x float32 or `dtype`: against the plain version
    within tol_rel and bitwise repeatable, then device ms of the kernel and
    of the plain version and the bound (x's bytes and rate), printed and
    summed by key (add_times). Returns (the sums, the largest error)."""
    from mmnc_tpu_torch.ops.gdn import gdn_cuda, gdn_plain, gdn_plan

    elt, rate = type_costs(torch, dtype)
    tag = " bf16" if dtype == torch.bfloat16 else ""
    totals, max_err_seen = {}, 0.0
    for (n, c, inverse), uses in shape_cases(groups).items():
        x, gamma, beta = gdn_case(torch, gen, n, c, dtype)
        plan = gdn_plan(n, c)
        err, scale = check_gdn_launch(torch, x, gamma, beta, inverse, plan,
                                      tol_rel)
        ms, host = time_ms(torch, lambda: gdn_cuda(x, gamma, beta, inverse))
        plain, plain_host = time_ms(
            torch, lambda: gdn_plain(x, gamma, beta, inverse))
        bms, by = bound_ms(*gdn_cost(n, c, elt), rate)
        print(f"kernel gdn{tag} rows={n} C={c} inverse={inverse} launches="
              f"{json.dumps(uses, separators=(',', ':'))} plan="
              f"{tuple(plan)} max_abs_err={err:.3e} "
              f"(|ref|max {scale:.3g}) bitwise_repeat=ok "
              f"ms={ms:.5f} host_ms={host:.5f} plain_ms={plain:.5f} "
              f"plain_host_ms={plain_host:.5f} bound_ms={bms:.5f} "
              f"bound_by={by}")
        max_err_seen = max(max_err_seen, err)
        add_times(totals, uses, {"ms": ms, "host_ms": host,
                                   "plain_ms": plain, "bound_ms": bms}, by)
        del x, gamma, beta
    return totals, max_err_seen


def p10_gdn_groups(lay):
    """Phase 10's GDN launch shapes by group: a train step's at each batch
    it trains at (the sweep's, the single process's and a rank's), the
    encode (compress's analysis) and decode halves of an eval forward at
    the sweep's and the analysis' batches, and a rank's compress of its
    rows (d)."""
    n_enc = MT_LAUNCHES["shared4"]["compress"][0]
    groups = p10_train_groups(lay)
    for b in sorted({RD_BATCH, ANALYSIS_BATCH, DP_BATCH}):
        shapes = mt_gdn_shapes(lay, b)
        groups += [(shapes[:n_enc], f"encode{b}"),
                   (shapes[n_enc:], f"decode{b}")]
    rows = DP_BATCH // DP_RANKS  # a rank's rows of the sharded compress
    return groups + [(mt_gdn_shapes(lay, rows)[:n_enc], f"encode{rows}")]


def gdn_backward_case(torch, gen, n, c, dtype=None):
    """x, the gradient g, gamma, beta on the card (`gdn_case`'s, g from
    the same generator); for bf16 x and g in bf16."""
    x, gamma, beta = gdn_case(torch, gen, n, c, dtype)
    g = torch.randn(n, c, generator=gen).cuda().to(x.dtype)
    return x, g, gamma, beta


def check_gdn_backward_launch(torch, x, g, gamma, beta, inverse, plan=None):
    """The backward kernel (its plan, or `plan`) against
    `gdn_backward_plain`: dx within GDN_BACKWARD_TOL (BF16_TOL for a bf16
    dx) x max(1, |plain|max), dgamma and dbeta within GDN_BACKWARD_TOL x
    max(1, |plain|max) each; a second launch bitwise equal to the first.
    Returns the largest error of each output and its share of its
    limit."""
    from mmnc_tpu_torch.ops.gdn import gdn_backward_cuda, gdn_backward_plain

    got = gdn_backward_cuda(x, g, gamma, beta, inverse, plan=plan)
    again = gdn_backward_cuda(x, g, gamma, beta, inverse, plan=plan)
    want = gdn_backward_plain(x, g, gamma, beta, inverse)
    where = (f"gdn_backward {x.dtype} {tuple(x.shape)} inverse={inverse} "
             f"plan {plan}")
    errs, shares = [], []
    for name, a, w in zip(("dx", "dgamma", "dbeta"), got, want):
        tol = (BF16_TOL if name == "dx" and x.dtype == torch.bfloat16
               else GDN_BACKWARD_TOL)
        err, scale = check_close(torch, a, w, tol, f"{where} {name}")
        errs.append(err)
        shares.append(err / (tol * max(1.0, scale)))
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise RuntimeError(f"{where}: two launches differ")
    return errs, shares


# the backward kernel against its plain version: float32 (and bf16 dgamma
# and dbeta, float32 in either) within this x max(1, |plain|max), as the
# forward; both sum dgamma's thousands of rows in float32, in other orders
GDN_BACKWARD_TOL = 1e-4


def p10_train_groups(lay):
    """Phase 10's train steps' GDN shapes, by the batch it trains at (the
    sweep's, the single process's and a rank's)."""
    return [(mt_gdn_shapes(lay, b, train=True), f"train{b}")
            for b in sorted({RD_BATCH, DP_BATCH, DP_BATCH // DP_RANKS})]


def path_name(plan):
    return "mma" if plan.mma else "cuda_core"


def backward_paths(n, c):
    """The plans phase 3 holds and times at (n, c): the plan's own first,
    then, where the tensor cores have a plan, the other path's."""
    from mmnc_tpu_torch.ops.gdn import gdn_backward_plan

    plan = gdn_backward_plan(n, c)
    try:
        return [plan, gdn_backward_plan(n, c, mma=not plan.mma)]
    except ValueError:  # no tensor-core plan at this C
        return [plan]


def time_backward_paths(torch, plans, x, g, gamma, beta, inverse):
    """Device and host ms of each plan's launch, the plans in turns
    (first, second, second, first) and each the mean of its two
    measurements."""
    from mmnc_tpu_torch.ops.gdn import gdn_backward_cuda

    order = [0] if len(plans) == 1 else [0, 1, 1, 0]
    got = [[] for _ in plans]
    for k in order:
        got[k].append(time_ms(torch, lambda: gdn_backward_cuda(
            x, g, gamma, beta, inverse, plan=plans[k])))
    return [tuple(sum(v) / len(t) for v in zip(*t)) for t in got]


def check_gdn_backward(torch, gen):
    """Phase 3's checks of the backward kernel: every (I)GDN of phase 7's
    rgb train step (batch TRAIN_BATCH), of shared4's train steps (phase 8
    at MT_TRAIN_BATCH, phase 9 at CLI_BATCH, phase 10 at each batch it
    trains at) in float32, and of the rgb step in bf16 (phase "bf16"'s),
    each distinct shape under its plan and, where the tensor cores have a
    plan, under the other path's too (`backward_paths`), against
    `gdn_backward_plain` and bitwise repeatable
    (`check_gdn_backward_launch`); then the device ms of each path in
    turns (`time_backward_paths`), the plain version's, the bound
    (`gdn_backward_cost`, x's bytes and rate) and the tensor-core bound
    (`gdn_backward_tc_bound`), summed by key (add_times) as check_gdn's:
    "ms" the plan's path, "cuda_core_ms" the CUDA cores' at every shape.
    Beyond the path: a strided gradient (the kernel's wrapper copies it
    contiguous), ragged rows, C = 168 at other row counts and C = 655
    (gamma from global memory), checked on the plan's path and the
    tensor cores' where they have a plan. Prints each check's errors as a
    share of their limits, and the largest share of each path. Returns
    (the sums: "train",
    "shared4_train", "cli_train", phase 10's "train<b>", "bf16_train"; the
    largest error of dx, dgamma and dbeta; the tolerance)."""
    from mmnc_tpu_torch.ops.gdn import gdn_backward_plain

    shared4 = paper_layout(*PAPER["shared4"])
    f32_groups = ([(gdn_train_shapes(TRAIN_BATCH), "train"),
                   (mt_gdn_shapes(shared4, MT_TRAIN_BATCH, train=True),
                    "shared4_train"),
                   (mt_gdn_shapes(shared4, CLI_BATCH, train=True),
                    "cli_train")]
                  + p10_train_groups(shared4))
    totals, worst = {}, [0.0, 0.0, 0.0]
    of_tol = {"mma": [0.0, 0.0, 0.0], "cuda_core": [0.0, 0.0, 0.0]}

    def check(x, g, gamma, beta, inverse, plan):
        errs, shares = check_gdn_backward_launch(torch, x, g, gamma, beta,
                                                 inverse, plan)
        worst[:] = [max(a, b) for a, b in zip(worst, errs)]
        path = of_tol[path_name(plan)]
        path[:] = [max(a, b) for a, b in zip(path, shares)]
        return (f"max_abs_err dx/dgamma/dbeta={errs[0]:.3e}/{errs[1]:.3e}/"
                f"{errs[2]:.3e} of_tol={shares[0]:.2e}/{shares[1]:.2e}/"
                f"{shares[2]:.2e}")

    for dtype, groups in ((None, f32_groups), (torch.bfloat16, [
            (gdn_train_shapes(TRAIN_BATCH), "bf16_train")])):
        elt, rate = type_costs(torch, dtype)
        tag = " bf16" if dtype == torch.bfloat16 else ""
        for (n, c, inverse), uses in shape_cases(groups).items():
            x, g, gamma, beta = gdn_backward_case(torch, gen, n, c, dtype)
            plans = backward_paths(n, c)
            errs = [check(x, g, gamma, beta, inverse, p) for p in plans]
            times = time_backward_paths(torch, plans, x, g, gamma, beta,
                                        inverse)
            plain, plain_host = time_ms(torch, lambda: gdn_backward_plain(
                x, g, gamma, beta, inverse))
            bms, by = bound_ms(*gdn_backward_cost(n, c, elt), rate)
            tc, tc_by = gdn_backward_tc_bound(n, c, elt)
            ms, host = times[0]
            core = next(t[0] for p, t in zip(plans, times) if not p.mma)
            other = ""
            if len(plans) > 1:
                name = path_name(plans[1])
                other = (f" {name}_plan={tuple(plans[1])} {name}_ms="
                         f"{times[1][0]:.5f} {name}_{errs[1]}")
            print(f"kernel gdn_backward{tag} rows={n} C={c} inverse="
                  f"{inverse} launches="
                  f"{json.dumps(uses, separators=(',', ':'))} path="
                  f"{path_name(plans[0])} plan="
                  f"{tuple(plans[0])} {errs[0]} "
                  f"bitwise_repeat=ok ms={ms:.5f} host_ms={host:.5f}{other} "
                  f"plain_ms={plain:.5f} plain_host_ms={plain_host:.5f} "
                  f"bound_ms={bms:.5f} bound_by={by} tc_bound_ms={tc:.5f} "
                  f"tc_bound_by={tc_by}")
            add_times(totals, uses, {"ms": ms, "host_ms": host,
                                     "cuda_core_ms": core, "plain_ms": plain,
                                     "bound_ms": bms, "tc_bound_ms": tc,
                                     "mma_launches": float(plans[0].mma)},
                      by)
            del x, g, gamma, beta
    extra = [(4099, 50, False), (777, 100, True), (5, 100, False),
             (4099, 168, False), (777, 168, True), (4099, 655, False),
             (333, 655, True), (1031, 127, False), (37, 42, True)]
    for dtype in (None, torch.bfloat16):
        for n, c, inverse in extra:
            x, g, gamma, beta = gdn_backward_case(torch, gen, n, c, dtype)
            for plan in backward_paths(n, c):
                errs = check(x, g, gamma, beta, inverse, plan)
                print(f"kernel gdn_backward{' bf16' if dtype else ''} extra "
                      f"rows={n} C={c} inverse={inverse} path="
                      f"{path_name(plan)} plan={tuple(plan)} {errs} "
                      f"bitwise_repeat=ok")
        # a strided gradient, as the next layer's backward may give it
        x, g, gamma, beta = gdn_backward_case(torch, gen, 4099, 100, dtype)
        g = g.t().contiguous().t()
        for plan in backward_paths(4099, 100):
            errs = check(x, g, gamma, beta, False, plan)
            print(f"kernel gdn_backward{' bf16' if dtype else ''} strided "
                  f"gradient rows=4099 C=100 path={path_name(plan)} {errs} "
                  f"bitwise_repeat=ok")
    print("kernel gdn_backward largest share of its limit, dx/dgamma/dbeta, "
          f"by path: {json.dumps(of_tol)}")
    return totals, worst, GDN_BACKWARD_TOL


def time_gdn_backward(torch, tree, card):
    """`--time-gdn-backward TREE`: phase 3's backward checks and times on
    the kernel of the checkout at TREE (`check_gdn_backward`); then one
    JSON line of the sums."""
    from mmnc_tpu_torch.ops import gdn

    if not gdn.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {gdn.__file__}, not {tree}'s")
    gen = torch.Generator().manual_seed(SEED)
    totals, worst, tol = check_gdn_backward(torch, gen)
    print(json.dumps({"tree": tree, "card": card, "max_abs_err": worst,
                      "tolerance": tol, "sums": totals}))


def split_extra_shapes():
    """Shapes beyond the path for the split kernel: a Cin the cluster size
    does not divide (100 over 8, 50 over 4), an odd input, batch 1."""
    return [(1, 3, 3, CONV, CONV, "igdn"), (2, 4, 4, CONV // 2, 64, "igdn"),
            (1, 1, 1, LATENT, CONV, "igdn"), (1, 2, 2, CONV, CONV, "igdn"),
            (1, 4, 4, CONV, CONV, "igdn")]


def wide_deconv_shapes():
    """Every deconv+IGDN launch of phase 6's models not on the main path:
    at conv 192 the tiled plans hold gamma and two weight stages of 4
    channels beside the tile in up to 217 KB of shared memory, at conv 300
    g_s's Cout x Cout of gamma does not fit and the plan is "tiled_l2"."""
    path = deconv_path_shapes(BATCH)
    return [s for conv in WIDE_CONVS for s in deconv_path_shapes(BATCH, conv)
            if s not in path]


def deconv_case(torch, gen, bb, h, w, cin, cout, dtype=None):
    """x NHWC, the torch-layout weight at init scale and its JAX tap
    layout, bias, gamma, beta; all on the card. For bf16 x in bf16 and
    the weight, bias and gamma rounded to bf16 values held in float32, as
    the bf16 layers hand them over."""
    x = torch.randn(bb, h, w, cin, generator=gen).cuda()
    wt = ((torch.rand(cin, cout, 5, 5, generator=gen) * 2 - 1)
          / (25 * cin) ** 0.5).cuda()
    bias = (0.1 * torch.randn(cout, generator=gen)).cuda()
    gamma = (0.1 * torch.eye(cout)
             + 0.01 * torch.rand(cout, cout, generator=gen)).cuda()
    beta = (1 + 0.1 * torch.rand(cout, generator=gen)).cuda()
    if dtype == torch.bfloat16:
        x = x.to(dtype)
        wt, bias, gamma = (t.to(dtype).float() for t in (wt, bias, gamma))
    taps = wt.flip(2, 3).permute(2, 3, 0, 1).contiguous()
    return x, wt, taps, bias, gamma, beta


def check_deconv(torch, b, gen):
    """Every path shape, g_s's last deconv (no epilogue), every launch
    shape of phase 8's codecs (a decompress of b images) and the extra
    split shapes against the plain version. Where the launch plan is the
    split kernel it also checks that two launches are bitwise equal and
    that the tiled kernel, forced at the same shape, agrees too (its only
    check there). Also every launch shape of phase 9's eval forwards
    (CLI_BATCH and CLI_COMPARE_BATCH). Returns the sums as check_gdn does
    ("trip": an rgb round trip, "shared4": a shared4 one, "cli_val": phase
    9's validation step), the largest error, the tolerance."""
    tol_rel = 1e-4
    totals, max_err_seen = check_deconv_cases(torch, gen,
        [(deconv_path_shapes(b), "trip"),
         (mt_deconv_shapes(paper_layout(*PAPER["shared4"]), b), "shared4"),
         (mt_deconv_shapes(paper_layout(*PAPER["shared4"]), CLI_BATCH),
          "cli_val"),
         (mt_deconv_shapes(paper_layout(*PAPER["shared4"]),
                           CLI_COMPARE_BATCH), None),
         *((mt_deconv_shapes(paper_layout(*PAPER["shared4"]), bb),
            f"decode{bb}") for bb in sorted({RD_BATCH, ANALYSIS_BATCH,
                                             DP_BATCH})),
         ([(b, 8, 8, CONV, CONV, None)], None)]  # g_s's last deconv
        + [(mt_deconv_shapes(paper_layout(*PAPER[name]), b), None)
           for name in ("mixed", "disjoint")]
        + [(split_extra_shapes() + wide_deconv_shapes(), None)], tol_rel)
    return totals, max_err_seen, tol_rel


def plan_note(b, h, w, cin, cout, plan):
    """A tiled plan's blocks and `tiled_config` (positions a thread, Cin
    slices, Cin chunk, threads, shared memory), a tensor-core plan's blocks
    and `tiled_mma_config` (n8 tiles a warp, N groups, Cin chunk, threads,
    shared memory), else "" (the split and L2 kernels, and a checkout
    without those configs)."""
    from mmnc_tpu_torch.ops import deconv_igdn

    blocks = f"blocks={deconv_igdn.tiled_blocks(b, h, w, *plan[1:3], cout)} "
    if plan[0] == "tiled_mma":
        c = deconv_igdn.tiled_mma_config(h, w, cin, cout, plan[1], plan[2])
        return (f"{blocks}nt={c.nt} ng={c.ng} chunk={c.chunk} "
                f"threads={c.threads} smem={c.smem_bytes}")
    config = getattr(deconv_igdn, "tiled_config", None)
    if plan[0] != "tiled" or config is None:
        return ""
    c = config(b, h, w, cin, cout, plan[1], plan[2])
    return (f"{blocks}p={c.p} slices={c.slices} chunk={c.chunk} "
            f"threads={c.threads} smem={c.smem_bytes}")


def check_deconv_cases(torch, gen, groups, tol_rel, dtype=None, forced=True,
                       rows=None):
    """Each distinct shape of `groups` under its launch plan, x float32 or
    `dtype`: float32 against the plain version within tol_rel, bf16 stage
    by stage (check_deconv_bf16; the error reported is against the whole
    plain version), two launches bitwise equal; where the plan is the
    split kernel the tiled kernel forced at the same shape likewise
    (unless forced=False), and where it is the tensor-core kernel
    ("tiled_mma", bf16) the CUDA-core tiled kernel at `tile_shape`'s tiles
    likewise, always. Then device ms of the kernel, the plain version and
    the library call (F.conv_transpose2d in x's type) and the bound (x's
    bytes and rate), printed with the plan (`plan_note`) and summed by key;
    where the plan is "tiled_mma" the two paths are timed in turns (plan,
    other, other, plan; each side's mean), and "cuda_core_ms" sums the
    CUDA-core path's time at every shape, "mma_launches" the launches the
    plan gives the tensor cores. Each shape's numbers also go to the list
    `rows` if one is given. Returns (the sums, the largest error)."""
    import torch.nn.functional as F

    from mmnc_tpu_torch.ops.deconv_igdn import (deconv_igdn_cuda,
                                                deconv_igdn_plain,
                                                launch_plan, tile_shape)

    elt, rate = type_costs(torch, dtype)
    bf16 = dtype == torch.bfloat16
    totals, max_err_seen = {}, 0.0
    for (bb, h, w, cin, cout, mode), uses in shape_cases(groups).items():
        x, wt, taps, bias, gamma, beta = deconv_case(torch, gen, bb, h, w,
                                                     cin, cout, dtype)
        plan = launch_plan(bb, h, w, cin, cout, dtype=x.dtype)
        mma = plan[0] == "tiled_mma"
        plans = [plan] + ([("tiled", *tile_shape(bb, h, w, cin, cout), 1)]
                          if mma or (forced and plan[0] == "split") else [])
        for p in plans:
            where = (f"deconv_igdn {x.dtype} {(bb, h, w, cin, cout, mode)} "
                     f"plan {p}")
            if bf16:
                e, scale, *stages = check_deconv_bf16(
                    torch, x, taps, bias, gamma, beta, mode, p, where)
            else:
                got = deconv_igdn_cuda(x, taps, bias, gamma, beta, mode,
                                       plan=p)
                e, scale = check_close(torch, got, deconv_igdn_plain(
                    x, taps, bias, gamma, beta, mode), tol_rel, where)
                if not torch.equal(got, deconv_igdn_cuda(
                        x, taps, bias, gamma, beta, mode, plan=p)):
                    raise RuntimeError(f"{where}: two launches differ")
                del got
            if p == plan:
                err = e
                note = (f"; {stages[0]} values beyond {tol_rel}, {stages[1]} "
                        f"sums rounding apart from cuDNN's, at most "
                        f"{stages[2]:.3g} u sum|terms| from their boundary"
                        if bf16 else "")
        x_nchw = x.permute(0, 3, 1, 2)
        wt_x, bias_x = wt.to(x.dtype), bias.to(x.dtype)

        def timed(p):
            return time_ms(torch, lambda: deconv_igdn_cuda(
                x, taps, bias, gamma, beta, mode, plan=p))

        if mma:  # in turns: plan, other, other, plan
            turns = [timed(p) for p in (plan, plans[1], plans[1], plan)]
            ms, host = ((turns[0][i] + turns[3][i]) / 2 for i in (0, 1))
            cc_ms = (turns[1][0] + turns[2][0]) / 2
            other = (f" other_path={plans[1]} other_ms={cc_ms:.5f} "
                     f"turns_ms={[round(t[0], 5) for t in turns]}")
        else:
            (ms, host), cc_ms, other = timed(plan), None, ""
        plain, plain_host = time_ms(torch, lambda: deconv_igdn_plain(
            x, taps, bias, gamma, beta, mode))
        lib, lib_host = time_ms(torch, lambda: F.conv_transpose2d(
            x_nchw, wt_x, bias_x, stride=2, padding=2, output_padding=1))
        bms, by = bound_ms(*deconv_igdn_cost(bb, h, w, cin, cout, mode, elt),
                           rate)
        detail = plan_note(bb, h, w, cin, cout, plan)
        print(f"kernel deconv_igdn{' bf16' if bf16 else ''} x=({bb},{h},{w},"
              f"{cin}) Cout={cout} mode={mode} plan={plan} {detail} launches="
              f"{json.dumps(uses, separators=(',', ':'))} "
              f"max_abs_err={err:.3e} (|ref|max {scale:.3g}{note}) "
              f"bitwise_repeat=ok ms={ms:.5f} host_ms={host:.5f}{other} "
              f"plain_ms={plain:.5f} plain_host_ms={plain_host:.5f} "
              f"library_ms={lib:.5f} library_host_ms={lib_host:.5f} "
              f"bound_ms={bms:.5f} bound_by={by}")
        max_err_seen = max(max_err_seen, err)
        add_times(totals, uses, {"ms": ms, "host_ms": host,
                                   "plain_ms": plain, "library_ms": lib,
                                   "bound_ms": bms,
                                   "cuda_core_ms": ms if cc_ms is None
                                   else cc_ms,
                                   "mma_launches": float(mma)}, by)
        if rows is not None:
            rows.append({"shape": [bb, h, w, cin, cout], "mode": mode,
                         "dtype": "bf16" if bf16 else "f32",
                         "plan": list(plan), "detail": detail, "uses": uses,
                         "ms": ms, "library_ms": lib, "plain_ms": plain,
                         "bound_ms": bms, "max_abs_err": err,
                         "other_plan": list(plans[1]) if mma else None,
                         "other_ms": cc_ms})
        del x, wt, taps, bias, gamma, beta
    return totals, max_err_seen


# the port's kernel launches that the serving programs' CUDA graphs made in
# their replays, which the wrappers never see (`tally_graph_launches`), and
# of the deconv+IGDN ones those on the tensor cores ("deconv_mma")
REPLAYED = {k: 0 for k in KERNELS + ("deconv_mma",)}


def wrapper_counts():
    """The kernel wrappers' launch counters: a graph's capture counts its
    kernels once, a replay never."""
    from mmnc_tpu_torch.ops.deconv_igdn import deconv_igdn_cuda
    from mmnc_tpu_torch.ops.gdn import gdn_backward_cuda, gdn_cuda
    return {"gdn": gdn_cuda.launches, "deconv_igdn": deconv_igdn_cuda.launches,
            "gdn_backward": gdn_backward_cuda.launches}


def counts():
    """The kernels' launches: the wrappers' counters plus the launches the
    serving programs' graphs made in their replays (REPLAYED). The train
    call's graphs are not in them: their replays are added from the
    counted calls (`graph_launched`)."""
    return {k: n + REPLAYED[k] for k, n in wrapper_counts().items()}


def mma_count():
    """The deconv+IGDN launches on the tensor cores: the wrapper's counter
    where it launches that kernel, plus the serving graphs' replays of
    it (REPLAYED)."""
    from mmnc_tpu_torch.ops.deconv_igdn import deconv_igdn_cuda
    return deconv_igdn_cuda.mma_launches + REPLAYED["deconv_mma"]


def reset_counts():
    from mmnc_tpu_torch.ops.deconv_igdn import deconv_igdn_cuda
    from mmnc_tpu_torch.ops.gdn import gdn_backward_cuda, gdn_cuda
    gdn_cuda.launches = 0
    deconv_igdn_cuda.launches = deconv_igdn_cuda.mma_launches = 0
    gdn_backward_cuda.launches = 0
    for k in REPLAYED:
        REPLAYED[k] = 0


def tally_graph_launches():
    """Make each serving graph (`graphs._Graph`) keep the kernel launches
    the wrappers counted during its capture, which are the kernels its
    graph holds, and add them to REPLAYED at each replay but the one that
    follows the capture in the same call (a capture call counts once, as
    the train call's: `graph_launched`). Profiled replays hold that count
    to the graph's kernel records (`graph_launches`). The tensor-core
    deconv+IGDN launches are tallied likewise (`mma_count`)."""
    from mmnc_tpu_torch import graphs
    from mmnc_tpu_torch.ops.deconv_igdn import deconv_igdn_cuda

    cls = graphs._Graph
    if getattr(cls, "tallied", False):
        return
    init, replay = cls.__init__, cls.replay

    def counters():
        return dict(wrapper_counts(),
                    deconv_mma=deconv_igdn_cuda.mma_launches)

    def counted_init(self, *args, **kwargs):
        before = counters()
        init(self, *args, **kwargs)
        after = counters()
        self.launched = {k: after[k] - before[k] for k in after}
        self.captured = True

    def counted_replay(self, *args, **kwargs):
        out = replay(self, *args, **kwargs)
        if self.captured:
            self.captured = False
        else:
            for k, n in self.launched.items():
                REPLAYED[k] += n
        return out

    cls.__init__, cls.replay, cls.tallied = counted_init, counted_replay, True


def seeded_model(device, seed, conv=CONV, dtype=None):
    """The bench config (at `conv` channels) from `seed`, its conv kernels
    scaled by `weights.scale_conv_kernels` (encoder 4, hyperprior 10,
    decoder 3): at the init scale every y of the untrained model rounds to
    0 and the decode is all zeros; scaled, 43% of y and 36% of z symbols
    are non-zero (on the CPU at conv 100). `dtype`: the activations'
    (float32 unless given)."""
    from mmnc_tpu_torch import build_model
    from mmnc_tpu_torch.weights import scale_conv_kernels

    kwargs = {} if dtype is None else {"dtype": dtype}
    model = scale_conv_kernels(build_model(
        1, ["rgb"], latent_channels=LATENT, conv_channels=conv,
        device=device, seed=seed, **kwargs))
    model.update_bottleneck_values()
    return model


def random_batches(torch, n, seed):
    rng = np.random.default_rng(seed)
    return [{"rgb": torch.from_numpy(rng.random(
        (BATCH, IMAGE, IMAGE, 3), dtype=np.float32)).cuda()}
        for _ in range(n)]


def run_model(torch, profile_dir, card):
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

    trips = round_trips(torch, model, batches,
                        {"compress": (9, 0), "decompress": (2, 7)}, "rgb")
    outs = [o["rgb"] for o in trips["outs"]]
    n_bytes, launches = trips["n_bytes"], trips["graphed"]["launches"]
    seconds = BATCH * BATCHES * IMAGE * IMAGE / 1e6 / trips["graphed"]["mps"]
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
          f"batches={BATCHES}: round trip {seconds:.4f} s (graphed replays), "
          f"{images * IMAGE * IMAGE / 1e6 / seconds:.3f} MP/s, "
          f"{n_bytes / images:.2f} bytes/image, decode vs eval forward max "
          f"abs err {dec_err:.3e}; graphed trips equal the eager ones "
          f"(deterministic cuDNN: streams, bytes, x_hats bitwise); launches "
          f"{launches} (a warm-up and a capture counted, replays in graphs: "
          f"{trips['graphed']['profile']['graph']} a profiled replay)")
    print_modes(f"model rgb batch={BATCH} x {BATCHES}", trips, card)
    check_against_cpu(torch, model, seeded_model("cpu", SEED),
                      {"rgb": batches[0]["rgb"][:1]}, f"conv {CONV}")
    if profile_dir:
        profile_round_trip(torch, model, batches[0], profile_dir)
    return launches, model, batches, trips


def check_against_cpu(torch, model, cpu, batch, what, rtol=1e-3, atol=1e-4):
    """The card's path (kernels) against the port's CPU plain path on one
    image: `cpu` is the same codec on the CPU (same seed, so the same
    weights), `batch` {task: NHWC, one image on the card}. y and z from
    the encoder, and each task's decode of the CPU's rounded y.
    Tolerance: float32 sums in another order through ~20 layers, rtol
    1e-3 / atol 1e-4 as tests/test_torch_import.py, relative to the
    largest value (the bf16 phase passes its own)."""
    with torch.no_grad():
        y_g, z_g = model.model.analyze(model._inputs(batch))
        y_c, z_c = cpu.model.analyze(cpu._inputs(
            {t: x.cpu() for t, x in batch.items()}))
        y_hat = torch.round(y_c)
        r_g = model.model.synthesize_from_y(y_hat.cuda())
        r_c = cpu.model.synthesize_from_y(y_hat)
    for name, g, c in ([("y", y_g, y_c), ("z", z_g, z_c)]
                       + [(f"x_hat {t}", g, c)
                          for t, g, c in zip(model.tasks, r_g, r_c)]):
        g, c = g.cpu().float(), c.float()
        err = (g - c).abs().max().item()
        scale = max(1.0, c.abs().max().item())
        print(f"card vs cpu plain path, {what}: {name} max abs err "
              f"{err:.3e} "
              f"(|cpu|max {c.abs().max().item():.3g})")
        if not err <= atol + rtol * scale:
            raise RuntimeError(f"card vs cpu, {what}: {name} err {err}")


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


def lost_calls(events):
    """The kernel or graph launch calls of a chrome trace that no device
    record shares a correlation id with (CUPTI lost their records)."""
    kept = {e.get("args", {}).get("correlation") for e in events
            if e.get("cat") in DEVICE_WORK}
    return [e for e in events if e.get("cat", "").startswith("cuda_")
            and ("LaunchKernel" in e["name"] or "GraphLaunch" in e["name"])
            and e.get("args", {}).get("correlation") not in kept]


def lost_launches(events):
    """How many launch calls of a chrome trace lost their records."""
    return len(lost_calls(events))


def lost_where(events):
    """{"<call> in <innermost CPU span of its thread>": n} of the launch
    calls whose records were lost."""
    spans = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation")]
    out = {}
    for call in lost_calls(events):
        inner = [e for e in spans if (e["pid"], e["tid"]) == (
            call["pid"], call["tid"]) and e["ts"] <= call["ts"] <= e["ts"]
            + e["dur"]]
        where = min(inner, key=lambda e: e["dur"])["name"] if inner else "-"
        key = f"{call['name']} in {where}"
        out[key] = out.get(key, 0) + 1
    return out


def profiled(torch, fn, trace=None, tries=TIMING_TRIES, wait=PROFILE_WAIT_S,
             complete=None):
    """fn() once under torch.profiler (CPU and CUDA) -> {"out": fn's
    result, "wall": its seconds (synchronised), "events": the chrome
    trace's, "prof": the profiler, "lost": `lost_launches`}; the trace is
    written to `trace` if given. The window stays open `wait` seconds on
    the host before fn and after it. A trace that lost launches' records
    and fails `complete(events)`, the caller's check of its records, is
    taken again, up to `tries` times in all (1 where running fn again
    would change what the caller checks); the last is returned, and the
    caller's check then fails with "lost" beside it. A trace that lost
    records but passes the check, or whose records the caller does not
    check, is kept: some windows lose one launch's records in every take.
    Each lost launch is printed with the CPU span that made it."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                     ) as prof:
            time.sleep(wait)
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(wait)
        with tempfile.TemporaryDirectory() as tmp:
            path = trace or os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        lost = lost_launches(events)
        if lost:
            print(f"profiled: the trace lost the records of {lost} launch "
                  f"calls ({json.dumps(lost_where(events))})")
        if (not lost or complete is None or complete(events)
                or attempt == tries - 1):
            return {"out": out, "wall": wall, "events": events, "prof": prof,
                    "lost": lost}
        print("profiled: the caller's check fails on it; measuring again")


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


def stream_refs(torch, model, batches):
    """(bytes, x_hats) of each batch's packed compress and decompress."""
    refs = []
    for batch in batches:
        ans, n_bytes = model.compress(batch)
        refs.append((n_bytes, model.decompress(ans)))
    torch.cuda.synchronize()
    return refs


def check_stream(what, results, refs, tol=1e-5):
    """Each batch's stream bytes are compress's, and each task's x_hat
    within `tol` of decompress's. Returns the largest error."""
    if len(results) != len(refs):
        raise RuntimeError(f"stream {what}: {len(results)} results")
    worst = 0.0
    for k, ((x_hats, n_bytes), (n_ref, ref)) in enumerate(zip(results,
                                                              refs)):
        if n_bytes != n_ref:
            raise RuntimeError(f"stream {what} batch {k}: {n_bytes} bytes, "
                               f"compress gave {n_ref}")
        err = task_err(x_hats, ref, list(ref))
        if not err <= tol:
            raise RuntimeError(f"stream {what} batch {k}: x_hats vs "
                               f"decompress max abs err {err}")
        worst = max(worst, err)
    return worst


def stream_layouts(torch, model, batches, refs, per_batch, label,
                   profile_dir, card, tol=1e-5):
    """Each stream layout over `batches`, graphed beside eager
    (`graphs.disabled()`). First, under deterministic cuDNN, the graphed
    stream (a warm-up, a capture, a replay) against the eager stream:
    the same bytes and bitwise the same x_hats. Then, for each mode under
    cuDNN's default, after a warm-up stream (graphed: the programs' warm-up,
    capture and a replay): a timed run (MP/s counting each 256 x 256 image
    once; `per_batch` launches a batch: eager through the wrappers,
    graphed none through them and as many in the replays' graphs), then a
    profiled run (device ms and busy share; host ms by pipeline stage;
    graphed: `per_batch` graph records a batch, eager: none), both
    against compress/decompress (`refs`, x_hats within `tol`), the
    captures' host ms and the peak memory. Returns {impl: {mode: {"mps",
    "busy", "device_ms", "capture_ms", "peak", "launches", "err"}}}:
    "err" the timed and profiled runs' largest x_hat error, "launches"
    the timed run's (`counts()`, replays included)."""
    from mmnc_tpu_torch import graphs
    from mmnc_tpu_torch.models import streaming

    out = {}
    for impl in streaming.IMPLS:
        with cudnn_deterministic(torch):
            with graphs.disabled():
                eager = list(streaming.stream_roundtrip(model, batches,
                                                        impl=impl))
            graphed = list(streaming.stream_roundtrip(model, batches,
                                                      impl=impl))
            torch.cuda.synchronize()
        for k, ((x, n), (ex, en)) in enumerate(zip(graphed, eager)):
            if n != en:
                raise RuntimeError(f"stream {impl} {label} batch {k}: "
                                   f"graphed {n} bytes, eager {en}")
            same_outputs(torch, x, ex, f"stream {impl} {label} batch {k} "
                                       f"graphed against eager")
        del eager, graphed
        want = {k: n * len(batches) for k, n in per_batch.items()}
        out[impl] = {}
        for mode in ("graphed", "eager"):
            with (graphs.disabled() if mode == "eager"
                  else contextlib.nullcontext()):
                marks = capture_marks(graphs, model)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                # warm-up: every slot's pinned buffers, the coder thread's
                # plans, the programs' warm-up and capture
                list(streaming.stream_roundtrip(model, batches, impl=impl))
                torch.cuda.synchronize()
                reset_counts()
                t0 = time.perf_counter()
                results = list(streaming.stream_roundtrip(model, batches,
                                                          impl=impl))
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launches, wrapped = counts(), wrapper_counts()
                if launches != want or wrapped != (
                        want if mode == "eager" else ZERO):
                    raise RuntimeError(
                        f"stream {impl} {label} {mode}: launches {launches}"
                        f" ({wrapped} through the wrappers), want {want} "
                        f"({per_batch} a batch)")
                err = check_stream(impl, results, refs, tol)
                del results
                images = BATCH * len(batches)

                def timed_stream():
                    with SpanTimer(streaming) as spans:
                        return list(streaming.stream_roundtrip(
                            model, batches, impl=impl)), spans

                trace = None
                if profile_dir:
                    os.makedirs(profile_dir, exist_ok=True)
                    trace = os.path.join(profile_dir,
                                         f"stream_{label.split()[0]}_{impl}_"
                                         f"{mode}_trace.json")
                expect = want if mode == "graphed" else ZERO
                run = profiled(torch, timed_stream, trace, complete=lambda ev:
                               graph_launches(ev) == expect)
                (results, spans), wall = run["out"], run["wall"]
                err = max(err, check_stream(impl, results, refs, tol))
                del results
                peak = torch.cuda.max_memory_allocated()
                captured = capture_ms(graphs, model, marks)
            trace_events = run["events"]
            events = [e for e in trace_events
                      if e.get("cat") in DEVICE_WORK]
            graph = graph_launches(trace_events)
            if graph != expect:
                raise RuntimeError(f"stream {impl} {label} {mode}: the "
                                   f"profiled run's graph records {graph}, "
                                   f"want {expect} (the profiler lost the "
                                   f"records of {run['lost']} launch calls)")
            busy = busy_us(events) / 1e3
            device = sum(e["dur"] for e in events) / 1e3
            split = {name.split(".", 1)[1]: round(t * 1e3 / len(batches), 5)
                     for name, t in sorted(spans.totals.items())}
            mps = images * IMAGE * IMAGE / 1e6 / seconds
            print(f"stream {impl} {label} {mode} {IMAGE}px batch={BATCH} "
                  f"batches={len(batches)} ({card}): {seconds:.4f} s, "
                  f"{mps:.3f} MP/s, launches {launches} ({wrapped} through "
                  f"the wrappers), bytes/image "
                  f"{sum(n for n, _ in refs) / images:.2f}; profiled: wall "
                  f"{wall * 1e3:.3f} ms, device busy {busy:.3f} ms "
                  f"({busy / (wall * 1e3):.3f} of wall), device records "
                  f"{device:.3f} ms in {len(events)}, graph records {graph};"
                  f" captures {captured:.3f} ms, peak memory "
                  f"{peak / 2 ** 30:.3f} GiB; x_hats vs decompress max abs "
                  f"err {err:.4g}; graphed stream equal to the eager one "
                  f"(deterministic cuDNN: bytes, x_hats bitwise)")
            print(f"stream {impl} {label.split()[0]} {mode} host ms per batch "
                  f"by stage (summed over threads): {json.dumps(split)}")
            out[impl][mode] = {"mps": mps, "busy": busy / (wall * 1e3),
                               "device_ms": device, "capture_ms": captured,
                               "peak": peak, "launches": launches,
                               "err": err}
    return out


def stream_fallback(torch, model, batches, refs, label):
    """A batch whose fused program reports max_abs = 2^15 takes the int32
    path and still gives compress's bytes and decompress's x_hats."""
    from mmnc_tpu_torch.models import streaming

    wide = []
    fused, real_wide = model._compress_device_fused, streaming._roundtrip_one_wide

    def tripped(batch):
        *outs, max_abs = fused(batch)
        return (*outs, torch.full_like(max_abs, 2 ** 15))

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
        raise RuntimeError(f"stream {label}: a max_abs of 2^15 did not take "
                           f"the int32 path")
    check_stream(f"v2 {label} (int32 fallback)", results, refs[:1])
    print(f"stream v2 {label} int32 fallback (max_abs forced to 2^15): "
          f"bytes and x_hats equal compress/decompress")


def run_streaming(torch, model, batches, profile_dir, card):
    """Phase 5: both stream layouts of the rgb codec, graphed beside
    eager, against compress/decompress, their launch counts, the int32
    fallback, and each layout's time split."""
    refs = stream_refs(torch, model, batches)
    runs = stream_layouts(torch, model, batches, refs,
                          as_counts((11, 7)),
                          f"rgb latent={LATENT} conv={CONV}", profile_dir,
                          card)
    stream_fallback(torch, model, batches, refs, "rgb")
    return runs


def run_mt_streaming(torch, profile_dir, mt, card):
    """Phase 5 at shared4 (after phase 8, whose compress -> decompress it
    is printed beside): both layouts on phase 8's 3 batches of 8
    (`stream_layouts`: a compress's and a decompress's launches a batch,
    MT_LAUNCHES), the int32 fallback; then one batch each of mixed and
    disjoint, its bytes and x_hats against compress/decompress. Returns
    the v2 run's launches."""
    from mmnc_tpu_torch.models import streaming

    t0 = time.perf_counter()
    name = "shared4"
    model = paper_model(name, "cuda")
    batches = paper_batches(torch, model, BATCHES, SEED)
    refs = stream_refs(torch, model, batches)
    per_batch = add_counts(MT_LAUNCHES[name]["compress"],
                           MT_LAUNCHES[name]["decompress"])
    runs = stream_layouts(torch, model, batches, refs, per_batch,
                          f"{name} {PAPER[name]}", profile_dir, card)
    stream_fallback(torch, model, batches, refs, name)
    for mode in ("graphed", "eager"):
        trip = mt["trips"][mode]
        print(f"p5 {name} batch={BATCH} x {BATCHES} {mode}: stream v2 "
              f"{runs['v2'][mode]['mps']:.3f} MP/s (busy "
              f"{runs['v2'][mode]['busy']:.3f}), v1 "
              f"{runs['v1'][mode]['mps']:.3f} MP/s (busy "
              f"{runs['v1'][mode]['busy']:.3f}); phase 8's compress -> "
              f"decompress {trip['mps']:.3f} MP/s (busy {trip['busy']:.3f} "
              f"of one profiled round trip)")
    del model, batches, refs
    for other in ("mixed", "disjoint"):
        m = paper_model(other, "cuda")
        batches = paper_batches(torch, m, 1, SEED + 10)
        refs = stream_refs(torch, m, batches)
        for impl in streaming.IMPLS:
            err = check_stream(f"{impl} {other}", list(
                streaming.stream_roundtrip(m, batches, impl=impl)), refs)
            print(f"stream {impl} {other} {PAPER[other]} batch={BATCH}: "
                  f"bytes equal compress's, x_hats vs decompress max abs "
                  f"err {err:.3e}")
        del m
    print(f"p5 multi-task streams: {time.perf_counter() - t0:.3f} s")
    return runs["v2"]["graphed"]["launches"], runs


def check_stale_parameters(torch, card):
    """The stale-parameter hazard, under deterministic cuDNN: phase 4's
    rgb codec, its decompress's synthesis (`_decompress_synthesize` on a
    batch's y_hat) and its eval step warmed up and captured; then one
    eager Adam step (`make_train_step`) and one `load_state_dict` of
    another seed's weights change the parameters in place. After each,
    the next call of each replays its graph (no new warm-up), equals the
    eager program on the new parameters bitwise and differs from the
    call before the change."""
    from mmnc_tpu_torch import graphs
    from mmnc_tpu_torch.train import (create_train_state, make_eval_step,
                                      make_train_step)

    t0 = time.perf_counter()
    model = seeded_model("cuda", SEED)
    batch = random_batches(torch, 1, SEED + 3)[0]
    with cudnn_deterministic(torch):
        with graphs.disabled():
            y_hat = model._compress_device(batch)[0].float()
        step = make_eval_step(model)
        calls = {"_decompress_synthesize":
                 lambda: model._decompress_synthesize(y_hat),
                 "eval_step": lambda: step(batch)}
        previous = {}
        for name, call in calls.items():
            for _ in range(2):  # a warm-up, a capture
                previous[name] = call()
        state = create_train_state(model, TRAIN_STEPS)
        train = make_train_step(model, clip_norm=CLIP)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        other = seeded_model("cpu", SEED + 1).state_dict()
        for update in ("an eager Adam step", "load_state_dict"):
            if update == "load_state_dict":
                model.load_state_dict(other)
            else:
                train(state, batch, gen)
            for name, call in calls.items():
                stats = graphs.stats(model, name)
                before = dict(stats)
                got = call()
                torch.cuda.synchronize()
                if call_kind(stats, before) != "replay":
                    raise RuntimeError(f"{name} after {update}: not a "
                                       f"replay ({before} -> {stats})")
                with graphs.disabled():
                    want = call()
                same_outputs(torch, got, want,
                             f"{name} replayed after {update}")
                if all(torch.equal(a, b) for a, b in
                       zip(leaves(got), leaves(previous[name]))):
                    raise RuntimeError(f"{name} after {update}: the same "
                                       f"result as before it")
                previous[name] = got
    print(f"stale parameters ({card}; deterministic cuDNN): the rgb "
          f"decompress's synthesis and the eval step, captured, replay "
          f"after an eager Adam step and after a load_state_dict bitwise "
          f"equal to the eager programs on the new parameters; "
          f"{time.perf_counter() - t0:.3f} s")


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
        if enc != as_counts((9, 0)) or dec != as_counts((2, 7)):
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
        check_against_cpu(torch, model, seeded_model("cpu", SEED, conv),
                          {"rgb": batch["rgb"][:1]}, f"conv {conv}")
        del model


def train_model(device, dtype=None):
    """The bench config from SEED at the init scale (what training starts
    from), lmbda LMBDA, learning rates LR_MAIN / LR_AUX; the same weights
    on any device; `dtype` the activations' (float32 unless given)."""
    from mmnc_tpu_torch import build_model

    kwargs = {} if dtype is None else {"dtype": dtype}
    return build_model(1, ["rgb"], latent_channels=LATENT, conv_channels=CONV,
                       lmbda=LMBDA, learning_rate_main=LR_MAIN,
                       learning_rate_aux=LR_AUX, device=device, seed=SEED,
                       **kwargs)


def train_setup(model, remat=False):
    from mmnc_tpu_torch.train import create_train_state, make_train_step

    return (create_train_state(model, TRAIN_STEPS),
            make_train_step(model, clip_norm=CLIP, remat=remat))


def check_launches(torch, what, fn):
    """Run fn with the counts at 0 and check them against TRAIN_LAUNCHES.
    Returns (fn's result, the counts measured)."""
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    launched = counts()
    if launched != TRAIN_LAUNCHES[what]:
        raise RuntimeError(f"{what} step: launches {launched}, want "
                           f"{TRAIN_LAUNCHES[what]}")
    return out, launched


def rel_err(got, want):
    """max|got - want| / max|want| over a tensor; where want is all 0 (h_s
    at the init scale: every scale is below the 0.11 bound and the rate's
    gradient does not push it up, so its gradients and updates are 0),
    0 if got is all 0 too, else inf."""
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    return err / scale if scale else (float("inf") if err else 0.0)


def check_train_against_cpu(torch, build, batch, what):
    """One step of a fresh state on the card and on the port's CPU plain
    path: the codec from build(device) (same weights on both), the same
    numpy noise, `batch` {task: NHWC}. Every log within rtol 1e-4 (a log
    of 0 equal), each gradient within 1e-3 x max|g_cpu| of its tensor.
    Returns the card step's launches."""
    got = {}
    for device in ("cpu", "cuda"):
        model = build(device)
        state, step = train_setup(model)
        inputs = {t: x.to(device) for t, x in batch.items()}
        rng = np.random.default_rng(SEED + 2)
        noise = {k: torch.from_numpy(rng.uniform(-0.5, 0.5, s).astype(
            np.float32)).to(device)
            for k, s in model.latent_shapes(inputs).items()}
        reset_counts()
        _, logs = step(state, inputs, noise=noise)
        if device == "cuda":
            torch.cuda.synchronize()
            launches = counts()
        got[device] = ({k: v.item() for k, v in logs.items()},
                       {n: p.grad.cpu() for n, p in model.named_parameters()})
        del model, state, step
    (logs_c, grads_c), (logs_g, grads_g) = got["cpu"], got["cuda"]
    if set(logs_c) != set(logs_g):
        raise RuntimeError(f"train logs: {sorted(logs_g)} vs {sorted(logs_c)}")
    log_err = 0.0
    for k, want in logs_c.items():
        err = abs(logs_g[k] - want)
        if not err <= 1e-4 * abs(want):
            raise RuntimeError(f"train step card vs cpu, {what}: {k} "
                               f"{logs_g[k]} vs {want}")
        log_err = max(log_err, err / abs(want) if want else 0.0)
    grad_err = 0.0
    for name, want in grads_c.items():
        err = rel_err(grads_g[name], want)
        if not err <= 1e-3:
            raise RuntimeError(f"train step card vs cpu, {what}: grad {name} "
                               f"max abs err {err} x max|g_cpu|, over 1e-3")
        grad_err = max(grad_err, err)
    print(f"train card vs cpu plain path ({what}, batch "
          f"{len(next(iter(batch.values())))}): logs max rel err "
          f"{log_err:.3e}, grads max err {grad_err:.3e} x max|g_cpu| over "
          f"{len(grads_c)} tensors; loss {logs_c['train/loss']:.6g}; card "
          f"launches {launches}")
    return launches


def launched_records(events, match):
    """The device records launched inside a CPU span (torch op or
    record_function) whose name passes `match`: the runtime call that
    shares a record's correlation id lies in the span, on the span's
    thread (the autograd engine's thread for backward ops)."""
    spans = [(e["pid"], e["tid"], e["ts"], e["ts"] + e["dur"])
             for e in events if e.get("cat") in ("cpu_op", "user_annotation")
             and match(e["name"])]
    # the CUDA API call records ("cuda_runtime" and its lower-level kin)
    calls = {e["args"]["correlation"]: (e["pid"], e["tid"], e["ts"])
             for e in events if e.get("cat", "").startswith("cuda_")
             and "correlation" in e.get("args", {})}
    out = []
    for e in events:
        if e.get("cat") not in DEVICE_WORK:
            continue
        call = calls.get(e.get("args", {}).get("correlation"))
        if call and any(p == call[0] and t == call[1] and s <= call[2] <= f
                        for p, t, s, f in spans):
            out.append(e)
    return out


def launched_in_spans(events, match):
    """Microseconds of the device records launched inside a CPU span whose
    name passes `match` (`launched_records`)."""
    return sum(e["dur"] for e in launched_records(events, match))


def outermost_spans(events, match):
    """How many CPU spans whose name passes `match` lie in no other such
    span of their thread (the autograd engine records a node both as
    "autograd::engine::evaluate_function: <node>" and as "<node>")."""
    spans = sorted(((e["pid"], e["tid"]), e["ts"], e["ts"] + e["dur"])
                   for e in events if e.get("cat") == "cpu_op"
                   and match(e["name"]))
    n, end = 0, {}
    for thread, start, finish in spans:
        if start >= end.get(thread, -1.0):
            n += 1
            end[thread] = finish
        else:
            end[thread] = max(end[thread], finish)
    return n


def profile_train_step(torch, step, state, batch, gen, profile_dir):
    """torch.profiler over one train step -> (wall ms, device ms, busy ms,
    GDN kernel ms and launches, the backward's device ms and autograd
    nodes, its kernel's launches and ms, conv ms, the launch calls whose
    records the profiler lost). The backward's device records are those
    launched inside the GDNFunction node's span on the autograd engine's
    thread: the backward kernel's (its rows kernel, one a launch, and the
    sum of the blocks' partials) and a strided gradient's contiguous
    copy. A trace that lost records and misses a GDN kernel record, a
    backward kernel record or a node is taken again with one more step
    (the state is not checked after this)."""
    def gdn_backward(name):
        return name.endswith("GDNFunctionBackward")

    def gdn_kernels(events):
        return [e for e in events if e.get("cat") == "kernel"
                and kernel_kind(e["name"]) == "gdn"]

    def backward_kernels(events, kinds=("gdn_backward",)):
        return [e for e in events if e.get("cat") == "kernel"
                and kernel_kind(e["name"]) in kinds]

    want = TRAIN_LAUNCHES["train"]["gdn"]
    want_backward = TRAIN_LAUNCHES["train"]["gdn_backward"]
    trace = None
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        trace = os.path.join(profile_dir, "train_step_trace.json")
    run = profiled(torch, lambda: step(state, batch, gen), trace,
                   complete=lambda ev: len(gdn_kernels(ev)) == want
                   == outermost_spans(ev, gdn_backward)
                   and len(backward_kernels(ev)) == want_backward)
    events, wall = run["events"], run["wall"]
    if profile_dir:
        with open(os.path.join(profile_dir, "train_step_profile.txt"),
                  "w") as f:
            f.write(run["prof"].key_averages().table(
                sort_by="cuda_time_total", row_limit=50))
    device = [e for e in events if e.get("cat") in DEVICE_WORK]
    gdn = gdn_kernels(device)
    backward = launched_in_spans(events, gdn_backward)
    spans = outermost_spans(events, gdn_backward)
    bwd = backward_kernels(device, ("gdn_backward", "gdn_backward_aux"))
    conv = launched_in_spans(events, lambda n: n.startswith(
        ("aten::cudnn_convolution", "aten::convolution_backward")))
    return {"wall_ms": wall * 1e3,
            "device_ms": sum(e["dur"] for e in device) / 1e3,
            "busy_ms": busy_us(device) / 1e3, "records": len(device),
            "gdn_ms": sum(e["dur"] for e in gdn) / 1e3, "gdn_kernels": len(gdn),
            "gdn_backward_ms": backward / 1e3, "gdn_backward_spans": spans,
            "gdn_backward_kernels": len(backward_kernels(device)),
            "gdn_backward_kernel_ms": sum(e["dur"] for e in bwd) / 1e3,
            "conv_ms": conv / 1e3, "lost": run["lost"]}


def run_train(torch, profile_dir):
    """Phase 7: (a) card vs CPU, (b) 20 steps with their times and launch
    counts, (c) remat, (d) the eval step. Returns the step's profile, the
    GDN bounds and the launches measured per train, remat and eval step."""
    from mmnc_tpu_torch.train import make_eval_step

    rng = np.random.default_rng(SEED + 1)
    batch = {"rgb": torch.from_numpy(rng.random(
        (TRAIN_BATCH, IMAGE, IMAGE, 3), dtype=np.float32)).cuda()}
    check_train_against_cpu(torch, train_model, {"rgb": batch["rgb"][:1]},
                            "rgb")

    # (c) first, from a fresh state: a plain and a remat step, same noise
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results, measured = [], {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for what, remat in (("train", False), ("remat", True)):
            model = train_model("cuda")
            state, step = train_setup(model, remat)
            if not results:
                noise = model.draw_noise(batch, gen)
            (_, logs), measured[what] = check_launches(
                torch, what, lambda: step(state, batch, noise=noise))
            results.append((logs["train/loss"].item(),
                            {n: p.detach().clone()
                             for n, p in model.named_parameters()}))
            del model, state, step
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (loss_p, params_p), (loss_r, params_r) = results
    remat_err = abs(loss_r - loss_p) / abs(loss_p)
    for name, p in params_p.items():
        remat_err = max(remat_err, rel_err(params_r[name], p))
    if not remat_err <= 1e-5:
        raise RuntimeError(f"remat step vs plain step: max rel err {remat_err}")
    print(f"train remat step vs plain step (same state and noise): loss "
          f"{loss_r:.6g} vs {loss_p:.6g}, max rel err {remat_err:.3e}; "
          f"launches {measured['remat']} vs {measured['train']}")
    del results, params_p, params_r

    # (b) TRAIN_STEPS steps on the batch, the noise drawn by the step
    model = train_model("cuda")
    state, step = train_setup(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    run_launches = dict(ZERO)
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        (_, logs), measured["train"] = check_launches(
            torch, "train", lambda: step(state, batch, gen))
        walls.append(time.perf_counter() - t0)
        losses.append(logs["train/loss"])
        for k, n in measured["train"].items():
            run_launches[k] += n
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).cpu().tolist()
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"train: non-finite loss in {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"train: loss did not fall: {losses}")
    wall = float(np.median(walls[2:]))
    shapes = gdn_train_shapes(TRAIN_BATCH)
    fwd_bound = sum(bound_ms(*gdn_cost(n, c))[0] for n, c, _ in shapes)
    bwd_bound = sum(bound_ms(*gdn_backward_cost(n, c))[0]
                    for n, c, _ in shapes)
    print(f"train rgb latent={LATENT} conv={CONV} {IMAGE}px batch="
          f"{TRAIN_BATCH}: {TRAIN_STEPS} steps, loss {losses[0]:.6g} -> "
          f"{losses[-1]:.6g}, launches per step {measured['train']}; "
          f"step wall (median of steps 3-{TRAIN_STEPS}, synchronised) "
          f"{wall * 1e3:.4f} ms, {TRAIN_BATCH / wall:.3f} images/s, "
          f"{TRAIN_BATCH * IMAGE * IMAGE / 1e6 / wall:.4f} MP/s; peak memory "
          f"{peak / 2 ** 30:.3f} GiB")
    print(f"train losses: {json.dumps(losses)}")
    prof = profile_train_step(torch, step, state, batch, gen, profile_dir)
    want = TRAIN_LAUNCHES["train"]["gdn"]
    if prof["gdn_kernels"] != want or prof["gdn_backward_spans"] != want \
            or prof["gdn_backward_kernels"] != want:
        raise RuntimeError(f"train profile: {prof['gdn_kernels']} GDN kernel "
                           f"records, {prof['gdn_backward_kernels']} GDN "
                           f"backward kernel records and "
                           f"{prof['gdn_backward_spans']} GDNFunction "
                           f"backward nodes, want {want} each (the profiler "
                           f"lost the records of {prof['lost']} launch "
                           f"calls)")
    print(f"train step profile: wall {prof['wall_ms']:.3f} ms, device "
          f"{prof['device_ms']:.3f} ms in {prof['records']} records, busy "
          f"{prof['busy_ms']:.3f} ms ({prof['busy_ms'] / prof['wall_ms']:.3f}"
          f" of wall); GDN kernel ({prof['gdn_kernels']} launches) "
          f"{prof['gdn_ms']:.4f} ms "
          f"(bound {fwd_bound:.4f}); GDN backward "
          f"{prof['gdn_backward_ms']:.4f} ms in {prof['gdn_backward_spans']} "
          f"autograd nodes (bound {bwd_bound:.4f}; its kernel's "
          f"{prof['gdn_backward_kernels']} launches "
          f"{prof['gdn_backward_kernel_ms']:.4f} ms with their sums, the "
          f"rest the gradients' contiguous copies); "
          f"convolutions (cuDNN) {prof['conv_ms']:.3f} ms "
          f"({prof['conv_ms'] / prof['device_ms']:.3f} of device)")

    # (d) the eval step on the trained model
    logs, measured["eval"] = check_launches(
        torch, "eval", lambda: make_eval_step(model)(batch))
    logs = {k: v.item() for k, v in logs.items()}
    if not all(np.isfinite(list(logs.values()))):
        raise RuntimeError(f"eval step: non-finite logs {logs}")
    print(f"eval step: {json.dumps(logs)}")
    return dict(prof, bound_ms=fwd_bound, backward_bound_ms=bwd_bound,
                launches=measured, run_launches=run_launches,
                peak_bytes=peak, step_wall_ms=wall * 1e3)


def cpu_adam_twin(build, model):
    """A CPU copy of `model` (build("cpu"), the card's parameters loaded)
    under the CPU port's Adam (`create_train_state` on the CPU: not
    capturable, the rate a float): the reference the card's updates are
    held to on the card's own gradients."""
    from mmnc_tpu_torch.train import create_train_state

    twin = build("cpu")
    twin.load_state_dict(model.state_dict())
    return twin, create_train_state(twin, TRAIN_STEPS)


def hold_update_to_cpu(model, state, twin, twin_state, what):
    """After a card update: step the twin's CPU Adam once on the gradients
    that update read (the card parameters' .grad, clipped in place), at
    the twin's schedule, and hold every parameter, Adam moment and step
    count of the card's state to the twin's within rtol 1e-4 / atol 1e-6
    (the CPU tests' bound against optax). The twin carries on from its
    own values, so the differences add up over the calls. -> the worst
    |card - cpu| / (1e-6 + 1e-4 |cpu|) (at most 1)."""
    for p, q in zip(model.parameters(), twin.parameters()):
        q.grad = None if p.grad is None else p.grad.detach().cpu()
    twin_state.apply_gradients()
    if twin_state.step != state.step:
        raise RuntimeError(f"{what}: the card's state at step {state.step}, "
                           f"the CPU twin's at {twin_state.step}")
    worst = 0.0
    for (name, p), q in zip(model.named_parameters(), twin.parameters()):
        got_state, want_state = state.optimizer.state[p], \
            twin_state.optimizer.state[q]
        if got_state.keys() != want_state.keys():
            raise RuntimeError(f"{what}: {name}'s Adam state "
                               f"{sorted(got_state)} vs the CPU's "
                               f"{sorted(want_state)}")
        for key, got, want in [("param", p, q), *(
                (k, got_state[k], want_state[k]) for k in sorted(got_state))]:
            got = got.detach().cpu().double()
            want = want.detach().double()
            ratio = ((got - want).abs()
                     / (1e-6 + 1e-4 * want.abs())).max().item()
            if not ratio <= 1.0:
                raise RuntimeError(f"{what}: {name} {key} differs from the "
                                   f"CPU port's Adam by {ratio} x (1e-6 + "
                                   f"1e-4 |cpu|)")
            worst = max(worst, ratio)
    return worst


def graphed_vs_eager(torch, build, batch, k, calls, remat=False,
                     timed=False, checked=True, cpu_adam=False):
    """Under deterministic cuDNN, from one seed state each (build(device),
    TRAIN_STEPS scheduled, clip CLIP, train metrics on): `calls` calls of
    `make_multi_train_step` at K = k on `batch` (a warm-up, a capture,
    replays) against as many calls of `eager_multi_step` (k eager
    `make_train_step` steps, the generator reseeded at step_seed(SEED,
    step) before each, which is what the multi-step draws). Checks the calls' kinds (`multi_step.stats`),
    each call's loss (its last step's) within 1e-6 relative of the eager
    one, every parameter within 1e-6 x max|p| of its tensor, the losses
    finite and float32, and the counted launches: TRAIN_LAUNCHES x k for
    each eager call, the warm-up and the capture, 0 for a replay. With
    `timed`, the last call of each side runs under torch.profiler, and
    the replay's kernel records launched by its graph must be TRAIN_
    LAUNCHES x k. Not `checked`: cuDNN as it is set (by default free to
    pick nondeterministic algorithms), and the losses and parameters are
    compared but not held to the bound (a timing run). With `cpu_adam`
    (k = 1: a call's gradients are its one update's) every update of both
    sides is held to the CPU port's Adam on the card's gradients
    (`hold_update_to_cpu`). -> {side: {walls (synchronised call seconds),
    launches (a call's counts), peak (bytes), profile, cpu_adam (the
    worst ratio)}}, the graph's capture seconds and the worst loss and
    parameter differences."""
    from mmnc_tpu_torch.train import (create_train_state,
                                      make_multi_train_step)

    per_call = {n: k * c for n, c in
                TRAIN_LAUNCHES["remat" if remat else "train"].items()}
    zero = {n: 0 for n in per_call}
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = checked or deterministic
    try:
        for side in ("eager", "graphed"):
            model = build("cuda")
            state = create_train_state(model, TRAIN_STEPS)
            gen = torch.Generator(device="cuda")
            if side == "graphed":
                multi = make_multi_train_step(model, k, compute_metrics=True,
                                              clip_norm=CLIP, remat=remat)
            else:
                multi = eager_multi_step(model, k, compute_metrics=True,
                                         clip_norm=CLIP, remat=remat)

            def call():
                return multi(state, [batch] * k, gen, SEED)[1]

            twin = cpu_adam_twin(build, model) if cpu_adam else None
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            run = {"walls": [], "launches": [], "hows": [], "losses": [],
                   "profile": None, "cpu_adam": None}
            stats = getattr(multi, "stats", None)
            for i in range(calls):
                before = dict(stats) if stats is not None else None
                out = []
                if timed and i == calls - 1:
                    reset_counts()
                    run["profile"] = profile_device(
                        torch, lambda: out.append(call()), tries=1)
                    run["launches"].append(counts())
                else:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    logs, got = launched(torch, call)
                    run["walls"].append(time.perf_counter() - t0)
                    out.append(logs)
                    run["launches"].append(got)
                run["hows"].append(call_kind(stats, before))
                run["losses"].append(out[0]["train/loss"])
                if twin is not None:
                    run["cpu_adam"] = max(run["cpu_adam"] or 0.0,
                                          hold_update_to_cpu(
                                              model, state, *twin,
                                              f"{side} K={k} call {i}"))
            run["peak"] = torch.cuda.max_memory_allocated()
            run["params"] = {n: p.detach().clone()
                             for n, p in model.named_parameters()}
            run["capture_s"] = stats["capture_s"] if stats else []
            runs[side] = run
            del model, state, multi, call, twin
            torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    eager, graphed = runs["eager"], runs["graphed"]
    want_hows = ["eager", "capture"] + ["replay"] * (calls - 2)
    if graphed["hows"] != want_hows[:calls]:
        raise RuntimeError(f"graphed K={k}: calls {graphed['hows']}, want "
                           f"{want_hows[:calls]}")
    for side, run in runs.items():
        for how, got in zip(run["hows"], run["launches"]):
            want = zero if how == "replay" else per_call
            if got != want:
                raise RuntimeError(f"{side} K={k}: a {how} call launched "
                                   f"{got} through the wrappers, want {want}")
    if timed and graphed["profile"]["graph"] != per_call:
        raise RuntimeError(f"graphed K={k}: the profiled replay's graph "
                           f"launched {graphed['profile']['graph']} (all "
                           f"kernel records "
                           f"{graphed['profile']['kernels']}), want "
                           f"{per_call}; the profiler lost the records of "
                           f"{graphed['profile']['lost']} launch calls")
    losses = torch.stack([torch.stack(r["losses"]) for r in
                          (eager, graphed)]).cpu()
    if losses.dtype != torch.float32 or not torch.isfinite(losses).all():
        raise RuntimeError(f"graphed K={k}: losses {losses.tolist()}")
    loss_err = ((losses[1] - losses[0]).abs()
                / losses[0].abs()).max().item()
    param_err = max(rel_err(graphed["params"][n], p)
                    for n, p in eager["params"].items())
    if checked and not (loss_err <= 1e-6 and param_err <= 1e-6):
        raise RuntimeError(f"graphed K={k} vs eager: losses max rel diff "
                           f"{loss_err}, parameters {param_err} x max|p| "
                           f"(bound 1e-6)")
    for run in runs.values():
        del run["params"]
    return {"eager": eager, "graphed": graphed, "loss_err": loss_err,
            "param_err": param_err, "losses": losses[1].tolist(),
            "capture_s": graphed["capture_s"]}


def backward_ms(prof):
    """A `profile_device` window's device ms of GDN's backward kernel:
    its rows kernel's records and its sums' (`kernel_kind`)."""
    return sum(prof["by_kernel"].get(k, 0.0)
               for k in ("gdn_backward", "gdn_backward_aux"))


def run_graph_train(torch, card):
    """Phase 7 (e): the K-step call as one CUDA graph against eager steps
    on phase 7's batch (`graphed_vs_eager`) at each of GRAPH_KS, timed and
    checked under deterministic cuDNN, at K = 1 with every update of both
    sides held to the CPU port's Adam on the card's gradients; then K = 1
    timed only under cuDNN's default (what a user runs: the CLI's default
    K); then GRAPH_REMAT_CALLS remat calls at K = GRAPH_REMAT_K. Prints,
    the graphed beside the eager: a call's wall (median of the replays)
    and a step's, images/s, a profiled call's device ms and busy share,
    the capture's ms and the peak memory; the GDN forward's and
    backward's device ms a step. Returns {K: the graphed profiled
    replay's graph launches}."""
    rng = np.random.default_rng(SEED + 1)
    batch = {"rgb": torch.from_numpy(rng.random(
        (TRAIN_BATCH, IMAGE, IMAGE, 3), dtype=np.float32)).cuda()}
    out = {}
    for k, checked in [(k, True) for k in GRAPH_KS] + [(1, False)]:
        r = graphed_vs_eager(torch, train_model, batch, k, GRAPH_CALLS,
                             timed=True, checked=checked,
                             cpu_adam=checked and k == 1)
        e, g = r["eager"], r["graphed"]
        line = []
        for name, run in (("graphed", g), ("eager", e)):
            call = float(np.median(run["walls"][2:]))
            prof = run["profile"]
            line.append(
                f"{name}: call {call * 1e3:.4f} ms ({call * 1e3 / k:.4f} "
                f"a step, {k * TRAIN_BATCH / call:.3f} images/s), profiled "
                f"call device {prof['device_ms']:.3f} ms, busy "
                f"{prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} "
                f"({prof['busy_ms'] / prof['wall_ms']:.3f}), its GDN kernel "
                f"{prof['by_kernel'].get('gdn', 0.0) / k:.4f} ms a step, "
                f"its GDN backward kernel (with its sums) "
                f"{backward_ms(prof) / k:.4f} ms a step, "
                f"peak memory {run['peak'] / 2 ** 30:.3f} GiB")
        mode = ("deterministic cuDNN" if checked else
                "default cuDNN, timing only")
        print(f"train graph K={k} rgb batch={TRAIN_BATCH} ({card}; "
              f"{mode}, metrics on): {GRAPH_CALLS} calls (a "
              f"warm-up, a capture, replays) vs {GRAPH_CALLS * k} eager "
              f"steps: losses max rel diff {r['loss_err']:.3e}, parameters "
              f"max diff {r['param_err']:.3e} x max|p|; launches a call "
              f"through the wrappers {[c['gdn'] for c in g['launches']]} "
              f"GDN; the profiled replay's graph launched "
              f"{g['profile']['graph']}; capture "
              f"{r['capture_s'][0] * 1e3:.3f} ms; "
              + (f"every update against the CPU port's Adam on the card's "
                 f"gradients: worst |diff| {g['cpu_adam']:.3e} (graphed), "
                 f"{e['cpu_adam']:.3e} (eager) x (1e-6 + 1e-4 |cpu|); "
                 if g["cpu_adam"] is not None else "") + "; ".join(line)
              + f"; call walls (s) graphed "
              f"{json.dumps([round(w, 6) for w in g['walls']])}, eager "
              f"{json.dumps([round(w, 6) for w in e['walls']])}")
        out[k] = g["profile"]["graph"]
    r = graphed_vs_eager(torch, train_model, batch, GRAPH_REMAT_K,
                         GRAPH_REMAT_CALLS, remat=True)
    print(f"train graph remat K={GRAPH_REMAT_K} ({card}; deterministic "
          f"cuDNN): {GRAPH_REMAT_CALLS} calls vs "
          f"{GRAPH_REMAT_CALLS * GRAPH_REMAT_K} eager remat steps: losses "
          f"max rel diff {r['loss_err']:.3e}, parameters max diff "
          f"{r['param_err']:.3e} x max|p|; launches a call through the "
          f"wrappers {[c['gdn'] for c in r['graphed']['launches']]} GDN; "
          f"capture {r['capture_s'][0] * 1e3:.3f} ms")
    return out


def paper_model(name, device, seed=SEED, dtype=None):
    """Phase 8's codec `name` (PAPER) from `seed`, its conv kernels scaled
    as `seeded_model`'s (at the init scale y rounds to 0), lmbda and
    learning rates of phase 7, coding tables built; `dtype` the
    activations' (float32 unless given)."""
    from mmnc_tpu_torch import build_model
    from mmnc_tpu_torch.weights import scale_conv_kernels

    number, tasks, latent, conv = PAPER[name]
    kwargs = {} if dtype is None else {"dtype": dtype}
    model = scale_conv_kernels(build_model(
        number, tasks, latent, conv, lmbda=LMBDA, learning_rate_main=LR_MAIN,
        learning_rate_aux=LR_AUX, device=device, seed=seed, **kwargs))
    model.update_bottleneck_values()
    return model


def paper_batches(torch, model, n, seed):
    """n batches of BATCH random 256x256 images of every task on the card,
    in valid ranges (`example_batch`: semantic labels 0..16)."""
    return [{t: torch.from_numpy(x).cuda() for t, x in model.example_batch(
        BATCH, IMAGE, seed=seed + k).items()} for k in range(n)]


def launched(torch, fn):
    """(fn(), launches): the counts set to 0 just before fn and read just
    after it, on a synchronised card."""
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, counts()


def want_launches(name, call, got):
    want = as_counts(MT_LAUNCHES[name][call])
    if got != want:
        raise RuntimeError(f"{name} {call}: launches {got}, want {want}")


def task_err(got, want, tasks):
    """Max abs difference of the reconstructions of `tasks`."""
    if sorted(got) != sorted(tasks):
        raise RuntimeError(f"decoded {sorted(got)}, want {sorted(tasks)}")
    return max((got[t] - want[t]).abs().max().item() for t in tasks)


def kernel_kind(name):
    """The port's kernel a device record belongs to, by its name: one of
    KERNELS (GDN's backward by its rows kernel, on the CUDA cores or the
    tensor cores, one record a launch), "gdn_backward_aux" (the
    backward's fixed-order sum of the blocks' partials and its padding of
    a wide gamma), or "other" (cuDNN, cuBLAS, elementwise, copies)."""
    if "deconv_igdn" in name:
        return "deconv_igdn"
    if "gdn_backward_kernel" in name or "gdn_backward_mma_kernel" in name:
        return "gdn_backward"
    if "gdn_backward" in name:
        return "gdn_backward_aux"
    return "gdn" if "gdn_kernel" in name else "other"


def graph_launch_groups(events):
    """[{kernel: n} of every one of KERNELS, ...]: the port's kernel
    records in a chrome trace, one entry for each CUDA graph launch (a
    cudaGraphLaunch call) that started them, in the order of the
    launches."""
    graph = sorted((e["ts"], e["args"]["correlation"]) for e in events
                   if e.get("cat", "").startswith("cuda_")
                   and "GraphLaunch" in e.get("name", "")
                   and "correlation" in e.get("args", {}))
    out = {c: {k: 0 for k in KERNELS} for _, c in graph}
    for e in events:
        group = out.get(e.get("args", {}).get("correlation"))
        if e.get("cat") == "kernel" and group is not None:
            kind = kernel_kind(e["name"])
            if kind in group:
                group[kind] += 1
    return [out[c] for _, c in graph]


def graph_launches(events):
    """{kernel: n} of KERNELS: the port's kernel records in a chrome
    trace that a CUDA graph launch started (their correlation id is that
    of a cudaGraphLaunch call). A replayed graph launches its kernels
    without the wrappers, whose counters so never see them."""
    out = {k: 0 for k in KERNELS}
    for group in graph_launch_groups(events):
        for k in out:
            out[k] += group[k]
    return out


def profile_device(torch, fn, trace=None, tries=TIMING_TRIES, graph=None):
    """One call of fn under torch.profiler (`profiled`, `tries`; where
    given, `graph` is the `graph_launches` the caller checks) ->
    {wall_ms, device_ms (the sum of its device records), busy_ms (their
    union), records, by_kernel (ms of the device records of each
    `kernel_kind`), conv_ms (the records launched by cuDNN's
    convolutions), graph (`graph_launches`), kernels (kernel records of
    each `kernel_kind`), deconv_mma (the tensor-core deconv+IGDN kernel's
    kernel records), lost (`lost_launches`)}; the chrome trace goes to
    `trace` if given."""
    run = profiled(torch, fn, trace, tries, complete=None if graph is None
                   else lambda ev: graph_launches(ev) == graph)
    wall, trace_events = run["wall"], run["events"]
    events = [e for e in trace_events if e.get("cat") in DEVICE_WORK]
    conv = launched_in_spans(trace_events, lambda n: n.startswith(
        "aten::cudnn_convolution"))
    by_kernel, kernels = {}, {}
    mma = sum(e.get("cat") == "kernel" and "deconv_igdn_mma" in e["name"]
              for e in events)
    for e in events:
        kind = kernel_kind(e["name"])
        by_kernel[kind] = by_kernel.get(kind, 0.0) + e["dur"] / 1e3
        if e.get("cat") == "kernel":
            kernels[kind] = kernels.get(kind, 0) + 1
    return {"wall_ms": wall * 1e3,
            "device_ms": sum(e["dur"] for e in events) / 1e3,
            "busy_ms": busy_us(events) / 1e3, "records": len(events),
            "by_kernel": by_kernel, "conv_ms": conv / 1e3,
            "graph": graph_launches(trace_events), "kernels": kernels,
            "deconv_mma": mma, "lost": run["lost"]}


# --- the serving programs as CUDA graphs (graphs.py) -------------------------

ZERO = {k: 0 for k in KERNELS}
# the device programs a call runs, whose stats tell its kind
TRIP_PROGRAMS = {"compress": ("_compress_device",),
                 "decompress": ("_decompress_indexes_device",
                                "_decompress_synthesize"),
                 "decompress_tasks": ("_decompress_indexes_device",
                                      "_synthesize_task")}


def as_counts(pair):
    """(GDN, deconv+IGDN[, GDN backward]) -> {kernel: n} of KERNELS; the
    backward 0 where not given (a serving call launches none)."""
    return dict(zip(KERNELS, tuple(pair) + (0,) * (len(KERNELS)
                                                   - len(pair))))


def add_counts(*pairs):
    """The sum of `as_counts` of each of `pairs`."""
    out = dict(ZERO)
    for pair in pairs:
        for k, n in as_counts(pair).items():
            out[k] += n
    return out


def program_call(torch, model, programs, fn):
    """fn(), a call that runs the device `programs` of `model` -> (its
    result, the launches the wrappers counted in it, its kind: "capture"
    where a program captured, "replay" where every one replayed, else
    "eager": a warm-up, or under `graphs.disabled()`)."""
    from mmnc_tpu_torch import graphs

    before = [dict(graphs.stats(model, p)) for p in programs]
    w0 = wrapper_counts()
    out = fn()
    torch.cuda.synchronize()
    w1 = wrapper_counts()
    kinds = [call_kind(graphs.stats(model, p), b)
             for p, b in zip(programs, before)]
    kind = ("capture" if "capture" in kinds else
            "replay" if all(k == "replay" for k in kinds) else "eager")
    return out, {k: w1[k] - w0[k] for k in w1}, kind


def capture_ms(graphs, model, before):
    """Host ms of the captures of `model`'s programs since `before` (each
    program's count of captures then)."""
    return 1e3 * sum(sum(st["capture_s"][before.get(name, 0):])
                     for name, st in graphs.all_stats(model).items())


def capture_marks(graphs, model):
    return {name: len(st["capture_s"])
            for name, st in graphs.all_stats(model).items()}


@contextlib.contextmanager
def cudnn_deterministic(torch):
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def same_trip(torch, a, b, tasks, what):
    """Two (ans, n_bytes, x_hats) of one batch: the same streams and bytes,
    bitwise the same x_hats."""
    (ans, n, x), (ans_b, n_b, x_b) = a, b
    if ans["strings"] != ans_b["strings"] or n != n_b:
        raise RuntimeError(f"{what}: streams differ ({n} against {n_b} "
                           f"bytes)")
    for t in tasks:
        if x[t].dtype != x_b[t].dtype or not torch.equal(x[t], x_b[t]):
            raise RuntimeError(f"{what}: x_hat {t} not bitwise equal")


def round_trips(torch, model, batches, want, label):
    """compress -> decompress of each batch (`want`: {"compress",
    "decompress"}: (GDN, deconv+IGDN) a call), graphed beside eager
    (`graphs.disabled()`):
    (1) under deterministic cuDNN, the graphed trips (a warm-up, a
        capture, a replay) give the eager trips' streams and bytes and,
        bitwise, their x_hats;
    (2) each mode under cuDNN's default: a warm-up trip of the first batch
        (graphed: the programs' warm-up; the first counted trip then
        captures, or replays a graph an earlier call captured, and the
        others replay), a trip of each batch counted call by call (`want`
        through the wrappers for an eager call, a warm-up or a capture,
        none for a replay; the run's `counts()`, replays included, `want`
        for every call), the same trips timed (graphed: replays), one
        profiled trip (graphed: a replay, whose graph records are one
        compress's and one decompress's launches; eager: no graph
        records), the captures' host ms and the peak memory.
    Returns {mode: {"mps", "device_ms", "busy", "wall_ms", "capture_ms",
    "peak", "profile", "launches", "mma_launches" (a counted trip's
    deconv+IGDN launches on the tensor cores, `mma_count`)}, "outs",
    "answers", "n_bytes"}: the graphed mode's counted trips' outputs."""
    from mmnc_tpu_torch import graphs

    per = {c: as_counts(want[c]) for c in ("compress", "decompress")}
    trip_sum = {k: per["compress"][k] + per["decompress"][k] for k in ZERO}

    def trip(batch):
        ans, n = model.compress(batch)
        return ans, n, model.decompress(ans)

    with cudnn_deterministic(torch):
        with graphs.disabled():
            eager = [trip(b) for b in batches]
        graphed = [trip(b) for b in batches]
        torch.cuda.synchronize()
    for k, (g, e) in enumerate(zip(graphed, eager)):
        same_trip(torch, g, e, model.tasks, f"{label} batch {k}, graphed "
                  f"against eager (deterministic cuDNN)")
    del eager, graphed
    out = {}
    for mode in ("graphed", "eager"):
        with (graphs.disabled() if mode == "eager"
              else contextlib.nullcontext()):
            marks = capture_marks(graphs, model)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            trip(batches[0])  # the warm-up
            torch.cuda.synchronize()
            reset_counts()
            kinds, outs, answers, n_bytes = [], [], [], 0
            for batch in batches:
                (ans, nb), enc, k1 = program_call(
                    torch, model, TRIP_PROGRAMS["compress"],
                    lambda: model.compress(batch))
                x, dec, k2 = program_call(
                    torch, model, TRIP_PROGRAMS["decompress"],
                    lambda: model.decompress(ans))
                for call, got, kind in (("compress", enc, k1),
                                        ("decompress", dec, k2)):
                    expect = ZERO if kind == "replay" else per[call]
                    if got != expect:
                        raise RuntimeError(
                            f"{label} {mode} {call} ({kind}): launches {got} "
                            f"through the wrappers, want {expect}")
                    kinds.append(kind)
                outs.append(x)
                answers.append(ans)
                n_bytes += nb
            launches, mma = counts(), mma_count()
            # graphed: the first trip captures what the warm-up did not
            # (an earlier call may have), the rest replay
            good = (all(k in ("capture", "replay") for k in kinds[:2])
                    and kinds[2:] == ["replay"] * (len(kinds) - 2)
                    if mode == "graphed" else
                    kinds == ["eager"] * len(kinds))
            if not good or launches != {
                    k: len(batches) * n for k, n in trip_sum.items()}:
                raise RuntimeError(f"{label} {mode}: calls {kinds}, "
                                   f"launches {launches}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for batch in batches:
                model.decompress(model.compress(batch)[0])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            expect = trip_sum if mode == "graphed" else ZERO
            prof = profile_device(
                torch, lambda: model.decompress(model.compress(batches[0])[0]),
                graph=expect)
            if prof["graph"] != expect:
                raise RuntimeError(f"{label} {mode}: a profiled trip's graph "
                                   f"records {prof['graph']}, want {expect} "
                                   f"(the profiler lost the records of "
                                   f"{prof['lost']} launch calls)")
            out[mode] = {
                "mps": len(batches) * BATCH * IMAGE * IMAGE / 1e6 / seconds,
                "device_ms": prof["device_ms"],
                "busy": prof["busy_ms"] / prof["wall_ms"],
                "wall_ms": prof["wall_ms"],
                "capture_ms": capture_ms(graphs, model, marks),
                "peak": torch.cuda.max_memory_allocated(), "profile": prof,
                "launches": launches, "mma_launches": mma / len(batches)}
            if mode == "graphed":
                out.update(outs=outs, answers=answers, n_bytes=n_bytes)
    return out


def print_modes(label, runs, card):
    """One line: each mode's MP/s, a profiled trip's device ms and busy
    share, the captures' ms and the peak memory, graphed beside eager."""
    parts = []
    for mode in ("graphed", "eager"):
        r = runs[mode]
        parts.append(f"{mode} {r['mps']:.3f} MP/s, device {r['device_ms']:.3f}"
                     f" ms, wall {r['wall_ms']:.3f} ms, busy {r['busy']:.3f}, "
                     f"capture {r['capture_ms']:.3f} ms, peak "
                     f"{r['peak'] / 2 ** 30:.3f} GiB")
    print(f"{label} graphed vs eager ({card}): " + "; ".join(parts))


def repeated_calls(torch, model, programs, fn, want, what, calls=3):
    """`calls` calls of fn (a warm-up, a capture, replays) against one
    under `graphs.disabled()`: each result bitwise the eager one's (the
    caller sets deterministic cuDNN where its kernels need it), `want`
    launches through the wrappers for the warm-up and the capture and
    none for a replay; then a profiled replay, whose graph records must be
    `want`. Returns the results and the profiled replay's profile."""
    from mmnc_tpu_torch import graphs

    with graphs.disabled():
        ref = fn()
    results, kinds = [], []
    for i in range(calls):
        got, launched_, kind = program_call(torch, model, programs, fn)
        if launched_ != (ZERO if kind == "replay" else want):
            raise RuntimeError(f"{what} call {i} ({kind}): launches "
                               f"{launched_} through the wrappers, want "
                               f"{ZERO if kind == 'replay' else want}")
        same_outputs(torch, got, ref, f"{what} call {i} against eager")
        results.append(got)
        kinds.append(kind)
    if kinds[:3] != ["eager", "capture", "replay"]:
        raise RuntimeError(f"{what}: calls {kinds}")
    prof = profile_device(torch, fn, graph=want)
    if prof["graph"] != want:
        raise RuntimeError(f"{what}: a profiled replay's graph records "
                           f"{prof['graph']}, want {want} (the profiler lost "
                           f"the records of {prof['lost']} launch calls)")
    return results, prof


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def same_outputs(torch, got, want, what):
    got, want = leaves(got), leaves(want)
    if len(got) != len(want) or not all(
            g.dtype == w.dtype and torch.equal(g, w)
            for g, w in zip(got, want)):
        raise RuntimeError(f"{what}: not bitwise equal")


def run_multitask(torch, profile_dir, card):
    """Phase 8: the paper's shared4 end to end (round trips, partial
    decode, the container, launch counts, card vs CPU, one train step),
    then the mixed and disjoint configs' round trip. Decodes of the same
    y_hat agree within atol 1e-5 (cuDNN's transposed conv may sum in
    another order from call to call, as phase 4 says)."""
    from mmnc_tpu_torch import bitstream, graphs

    name = "shared4"
    model = paper_model(name, "cuda")
    tasks = list(model.tasks)
    batches = paper_batches(torch, model, BATCHES, SEED)
    refs = []
    for batch in batches:
        x_hats, liks = model(batch)
        for t, oc in zip(tasks, model.output_channels):
            if x_hats[t].shape != (BATCH, IMAGE, IMAGE, oc) or \
                    not torch.isfinite(x_hats[t]).all():
                raise RuntimeError(f"{name} eval forward {t}: shape "
                                   f"{tuple(x_hats[t].shape)} or non-finite")
        if not ((liks["y"] > 0).all() and (liks["z"] > 0).all()):
            raise RuntimeError(f"{name} eval forward: likelihood <= 0")
        refs.append(x_hats)
    y_sym, z_sym, _ = model._compress_device(batches[0])
    y_nz = (y_sym != 0).float().mean().item()
    z_nz = (z_sym != 0).float().mean().item()
    print(f"{name}: non-zero symbols y {y_nz:.4f} of {y_sym.numel()}, z "
          f"{z_nz:.4f} of {z_sym.numel()}")
    if not (y_nz > 0 and z_nz > 0):
        raise RuntimeError(f"{name}: all y or all z symbols are 0, the "
                           f"coder would code nothing")

    trips = round_trips(torch, model, batches,
                        {k: MT_LAUNCHES[name][k]
                         for k in ("compress", "decompress")}, name)
    outs, answers, n_bytes = trips["outs"], trips["answers"], trips["n_bytes"]
    total = trips["graphed"]["launches"]
    mps = trips["graphed"]["mps"]
    seconds = BATCH * BATCHES * IMAGE * IMAGE / 1e6 / mps
    dec_err = max(task_err(o, r, tasks) for o, r in zip(outs, refs))
    if not dec_err <= 1e-5:
        raise RuntimeError(f"{name} decode vs eval forward: max abs err "
                           f"{dec_err}")
    trace = None
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        trace = os.path.join(profile_dir, "shared4_round_trip_trace.json")
    prof = profile_device(
        torch, lambda: model.decompress(model.compress(batches[0])[0]), trace)
    images = BATCH * BATCHES
    print(f"{name} {PAPER[name]} {IMAGE}px batch={BATCH} batches={BATCHES}: "
          f"round trip {seconds:.4f} s (graphed replays), {mps:.3f} MP/s, "
          f"{n_bytes / images:.2f} bytes/image, launches {total}, decode vs "
          f"eval forward max abs err {dec_err:.3e}; profiled round trip "
          f"(a replay): wall {prof['wall_ms']:.3f} ms, device "
          f"{prof['device_ms']:.3f} ms in {prof['records']} records (ms by "
          f"kernel {json.dumps(prof['by_kernel'])}), busy "
          f"{prof['busy_ms']:.3f} ms ({prof['busy_ms'] / prof['wall_ms']:.3f}"
          f" of wall), graph records {prof['graph']}; graphed trips equal "
          f"the eager ones (deterministic cuDNN: streams, bytes, x_hats "
          f"bitwise)")
    print_modes(f"{name} batch={BATCH} x {BATCHES}", trips, card)

    # partial coding: one task, then two, from the per-slice streams, each
    # decode graphed (a warm-up, a capture, a replay) against eager
    # (deterministic cuDNN)
    ans_p, bytes_p = model.compress_partial(batches[0])
    for call, subset in (("decompress_tasks_rgb", ["rgb"]),
                         ("decompress_tasks_semantic_depth",
                          ["semantic", "depth_euclidean"])):
        with cudnn_deterministic(torch):
            results, part_prof = repeated_calls(
                torch, model, TRIP_PROGRAMS["decompress_tasks"],
                lambda: model.decompress_tasks(ans_p, subset),
                as_counts(MT_LAUNCHES[name][call]), f"{name} {call}")
        err = task_err(results[-1], outs[0], subset)
        if not err <= 1e-5:
            raise RuntimeError(f"{name} {call} vs full decode: {err}")
        print(f"{name} {call} ({card}): a warm-up, a capture and a replay "
              f"bitwise equal to the eager decode (deterministic cuDNN), "
              f"launches {as_counts(MT_LAUNCHES[name][call])} counted for "
              f"the first two, a profiled replay's graph records "
              f"{part_prof['graph']} (device {part_prof['device_ms']:.3f} "
              f"ms, wall {part_prof['wall_ms']:.3f} ms); vs full decode max "
              f"abs err {err:.3e} ({bytes_p} bytes in "
              f"{len(ans_p['task_streams'])} slice streams + z)")

    # the container, partial and full layouts
    with tempfile.TemporaryDirectory() as tmp:
        for partial, ans in ((True, ans_p), (False, answers[0])):
            path = os.path.join(tmp, f"{name}_{partial}.mmnc")
            bitstream.save_bitstream(path, ans, model.hyper_parameters,
                                     partial)
            if bitstream.load_bitstream(path)[0] != ans:
                raise RuntimeError(f"container (partial={partial}): loaded "
                                   f"streams differ from the written")
            err = task_err(bitstream.decompress_file(path, model), outs[0],
                           tasks)
            if partial:
                err = max(err, task_err(bitstream.decompress_file(
                    path, model, ["normal"]), outs[0], ["normal"]))
            if not err <= 1e-5:
                raise RuntimeError(f"container (partial={partial}) decode "
                                   f"vs decode without the file: {err}")
            print(f"{name} container partial={partial}: "
                  f"{os.path.getsize(path)} bytes, decode vs decode without "
                  f"the file max abs err {err:.3e}")

    check_against_cpu(torch, model, paper_model(name, "cpu"),
                      {t: x[:1] for t, x in batches[0].items()}, name)
    train = check_train_against_cpu(
        torch, lambda device: paper_model(name, device),
        {t: x[:MT_TRAIN_BATCH] for t, x in batches[0].items()}, name)
    want_launches(name, "train", train)
    del model, batches, refs, outs

    for other in ("mixed", "disjoint"):
        m = paper_model(other, "cuda")
        batch = paper_batches(torch, m, 1, SEED + 10)[0]
        ref = m(batch)[0]
        (ans, nb), enc = launched(torch, lambda: m.compress(batch))
        out, dec = launched(torch, lambda: m.decompress(ans))
        want_launches(other, "compress", enc)
        want_launches(other, "decompress", dec)
        err = task_err(out, ref, list(m.tasks))
        if not err <= 1e-5:
            raise RuntimeError(f"{other} decode vs eval forward: {err}")
        # the batch's round trip graphed (a warm-up, a capture, a replay)
        # against eager, deterministic cuDNN
        with cudnn_deterministic(torch):
            with graphs.disabled():
                ans_e, nb_e = m.compress(batch)
                eager = (ans_e, nb_e, m.decompress(ans_e))
            for i in range(3):
                ans_g, nb_g = m.compress(batch)
                same_trip(torch, (ans_g, nb_g, m.decompress(ans_g)), eager,
                          m.tasks, f"{other} graphed trip {i}")
        kinds = {p: (graphs.stats(m, p)["captures"],
                     graphs.stats(m, p)["replays"])
                 for p in TRIP_PROGRAMS["compress"]
                 + TRIP_PROGRAMS["decompress"]}
        if any(c < 1 or r < 2 for c, r in kinds.values()):
            raise RuntimeError(f"{other}: captures and replays {kinds}")
        print(f"{other} {PAPER[other]} batch={BATCH}: {nb / BATCH:.2f} "
              f"bytes/image, launches compress {enc} decompress {dec}, "
              f"decode vs eval forward max abs err {err:.3e}; three graphed "
              f"trips equal the eager one (deterministic cuDNN: streams, "
              f"bytes, x_hats bitwise)")
        check_against_cpu(torch, m, paper_model(other, "cpu"),
                          {t: x[:1] for t, x in batch.items()}, other)
        del m
    return {"launches": total, "mps": mps, "seconds": seconds,
            "bytes_per_image": n_bytes / images, "y_nonzero": y_nz,
            "z_nonzero": z_nz, "train_launches": train, "trips": trips,
            **prof}


# --- phase "bf16": the bf16 activation path ---------------------------------

# GDN computes in float32 and rounds once at the store; its plain version,
# the JAX package's bf16 chain, rounds at four points: at most one ulp
# apart, 2^-7 of max(1, |plain|max). deconv+IGDN's epilogue is held to
# the same on the kernel's own y; its sums are held to cuDNN's, which run
# in another order, stage by stage (check_deconv_bf16;
# tests/test_torch_cuda.py holds the kernels to the same)
BF16_TOL = 2.0 ** -7
# the card against the port's CPU plain path in bf16 on one image: the
# kernels round once where the CPU's chain rounds 3-4 times, and such
# one-ulp differences pass through up to ~20 bf16 layers; 2^-4 of the
# largest value (the first card run measured 1.2-2.8% for x_hat, y and z,
# too near 2^-5's 3.1% for a check whose two sides sum in other orders).
# A timed stream's x_hats against decompress's take the same limit
# (cuDNN may sum in another order from call to call); under deterministic
# cuDNN the stream is held to decompress bitwise first
BF16_CPU_RTOL = 2.0 ** -4
BF16_TRAIN_STEPS = 6
BF16_GRAPH_K = 2  # the bf16 step as a graph: K of a graphed call


def check_decode_bitwise(torch, model, batch, what):
    """In bf16 decompress equals the eval forward bitwise: both run on the
    same y_hat, under deterministic cuDNN (its transposed conv may
    otherwise sum in another order from call to call)."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        x_hats, liks = model(batch)
        decoded = model.decompress(model.compress(batch)[0])
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for t in model.tasks:
        if x_hats[t].dtype != torch.bfloat16 or not torch.isfinite(
                x_hats[t]).all():
            raise RuntimeError(f"bf16 {what} eval forward {t}: "
                               f"{x_hats[t].dtype} or non-finite")
        if not torch.equal(decoded[t], x_hats[t]):
            raise RuntimeError(f"bf16 {what}: decompress {t} differs from "
                               f"the eval forward")
    if any(v.dtype != torch.float32 or not (v > 0).all()
           for v in liks.values()):
        raise RuntimeError(f"bf16 {what}: likelihoods not float32 and > 0")


def run_bf16(torch, f32_model, batches, train, mt, f32_trips, profile_dir,
             card):
    """Phase "bf16": the kernels in bf16 at every launch shape of this
    phase; the rgb codec at bench width in bf16 (compress -> decompress
    of phase 4's batches graphed beside eager (`round_trips`: bitwise
    under deterministic cuDNN), both stream layouts likewise, decode
    bitwise equal to the eval forward, MP/s, device ms and busy share
    beside the float32 codec's, `f32_model` profiled here, `f32_trips`
    phase 4's, card vs CPU on one image); shared4's round trip in bf16
    graphed beside eager; phase 7's train step in bf16 and
    BF16_TRAIN_STEPS steps on one batch (the loss falls) with peak memory
    beside phase 7's (`train`). Returns the kernels' sums and errors and
    the path's launches."""
    from mmnc_tpu_torch import graphs
    from mmnc_tpu_torch.models import streaming

    t_start = time.perf_counter()
    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 7)
    shared4 = paper_layout(*PAPER["shared4"])
    path = gdn_path_shapes(BATCH)
    sums, worst = {}, {}
    sums["gdn"], worst["gdn"] = check_gdn_cases(
        torch, gen, [([s[:3] for s in path], "trip"),
                     (gdn_train_shapes(TRAIN_BATCH), "train"),
                     (mt_gdn_shapes(shared4, BATCH), "shared4")],
        BF16_TOL, bf16)
    sums["deconv_igdn"], worst["deconv_igdn"] = check_deconv_cases(
        torch, gen, [(deconv_path_shapes(BATCH), "trip"),
                     (mt_deconv_shapes(shared4, BATCH), "shared4")],
        BF16_TOL, bf16)
    t_kernels = time.perf_counter() - t_start

    # the rgb codec at bench width
    model = seeded_model("cuda", SEED, dtype=bf16)
    check_decode_bitwise(torch, model, batches[0], "rgb")
    rgb_calls = {"compress": (9, 0), "decompress": (2, 7)}
    trips = round_trips(torch, model, batches, rgb_calls, "bf16 rgb")
    n_bytes, launches = trips["n_bytes"], trips["graphed"]["launches"]
    outs = trips["outs"]
    mps, f32_mps = trips["graphed"]["mps"], f32_trips["graphed"]["mps"]
    f32_bytes = f32_trips["n_bytes"]
    images = BATCH * len(batches)
    # eager, so that each cuDNN convolution's records lie in its op's span
    # (a replay's records have no op span: `launched_in_spans`)
    profs = {}
    with graphs.disabled():
        for name, m in (("f32", f32_model), ("bf16", model)):
            profs[name] = profile_device(
                torch, lambda: m.decompress(m.compress(batches[0])[0]))
    for name, p in profs.items():
        print(f"bf16 phase rgb round trip ({name}) profiled (eager): wall "
              f"{p['wall_ms']:.3f} ms, device {p['device_ms']:.3f} ms in "
              f"{p['records']} records, busy {p['busy_ms']:.3f} ms "
              f"({p['busy_ms'] / p['wall_ms']:.3f} of wall), ms by kernel "
              f"{json.dumps(p['by_kernel'])}, cuDNN convolutions "
              f"{p['conv_ms']:.3f} ms ({p['conv_ms'] / p['device_ms']:.3f} "
              f"of device)")
    print(f"bf16 rgb latent={LATENT} conv={CONV} {IMAGE}px batch={BATCH} "
          f"batches={len(batches)}: {mps:.3f} MP/s graphed (phase 4's f32 "
          f"{f32_mps:.3f}), {n_bytes / images:.2f} bytes/image (f32 "
          f"{f32_bytes / images:.2f}), launches {launches}; decode bitwise "
          f"equal to the eval forward; graphed trips equal the eager ones "
          f"(deterministic cuDNN: streams, bytes, x_hats bitwise)")
    print_modes(f"bf16 rgb batch={BATCH} x {BATCHES}", trips, card)
    mma = {"trip": check_mma_records(sums, "trip", "bf16 rgb", trips)}
    refs = stream_refs(torch, model, batches)
    with cudnn_deterministic(torch):
        exact_refs = stream_refs(torch, model, batches)
        for impl in streaming.IMPLS:
            results = list(streaming.stream_roundtrip(model, batches,
                                                      impl=impl))
            torch.cuda.synchronize()
            check_stream(f"{impl} bf16 (deterministic cuDNN)", results,
                         exact_refs, 0.0)
    scale = max(max(x.float().abs().max().item() for x in r.values())
                for _, r in refs)
    streams = stream_layouts(torch, model, batches, refs,
                             as_counts((11, 7)),
                             f"bf16 rgb latent={LATENT} conv={CONV}",
                             profile_dir, card,
                             BF16_CPU_RTOL * max(1.0, scale))
    check_against_cpu(torch, model, seeded_model("cpu", SEED, dtype=bf16),
                      {"rgb": batches[0]["rgb"][:1]}, "bf16 rgb",
                      rtol=BF16_CPU_RTOL, atol=0.0)
    del model, refs, exact_refs, outs, results

    # shared4's round trip
    name = "shared4"
    model = paper_model(name, "cuda", dtype=bf16)
    mt_batches = paper_batches(torch, model, BATCHES, SEED)
    check_decode_bitwise(torch, model, mt_batches[0], name)
    s4_trips = round_trips(torch, model, mt_batches,
                           {k: MT_LAUNCHES[name][k]
                            for k in ("compress", "decompress")},
                           f"bf16 {name}")
    s4_mps, s4_bytes = s4_trips["graphed"]["mps"], s4_trips["n_bytes"]
    s4_launches = s4_trips["graphed"]["launches"]
    s4_seconds = BATCH * BATCHES * IMAGE * IMAGE / 1e6 / s4_mps
    s4_prof = s4_trips["graphed"]["profile"]
    s4_conv = s4_trips["eager"]["profile"]["conv_ms"]
    mma["shared4"] = check_mma_records(sums, "shared4", f"bf16 {name}",
                                       s4_trips)
    print_modes(f"bf16 {name} batch={BATCH} x {BATCHES}", s4_trips, card)
    print(f"bf16 {name} {PAPER[name]} batch={BATCH} batches={BATCHES}: "
          f"round trip {s4_seconds:.4f} s, {s4_mps:.3f} MP/s (phase 8's f32 "
          f"{mt['mps']:.3f}), {s4_bytes / (BATCH * BATCHES):.2f} bytes/image "
          f"(f32 {mt['bytes_per_image']:.2f}), launches {s4_launches}; "
          f"profiled: device {s4_prof['device_ms']:.3f} ms (f32 "
          f"{mt['device_ms']:.3f}), busy {s4_prof['busy_ms']:.3f} ms "
          f"({s4_prof['busy_ms'] / s4_prof['wall_ms']:.3f} of wall), cuDNN "
          f"convolutions {s4_conv:.3f} ms (eager); decode bitwise equal "
          f"to the eval forward")
    del model, mt_batches

    # phase 7's train step in bf16, then steps on one batch
    rng = np.random.default_rng(SEED + 1)
    batch = {"rgb": torch.from_numpy(rng.random(
        (TRAIN_BATCH, IMAGE, IMAGE, 3), dtype=np.float32)).cuda()}
    model = train_model("cuda", dtype=bf16)
    state, step = train_setup(model)
    train_gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for _ in range(BF16_TRAIN_STEPS):
        t0 = time.perf_counter()
        (_, logs), measured = check_launches(
            torch, "train", lambda: step(state, batch, train_gen))
        walls.append(time.perf_counter() - t0)
        losses.append(logs["train/loss"])
    peak = torch.cuda.max_memory_allocated()
    if any(p.dtype != torch.float32 for p in model.parameters()) or \
            logs["train/loss"].dtype != torch.float32:
        raise RuntimeError("bf16 train: parameters or loss not float32")
    losses = torch.stack(losses).cpu().tolist()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"bf16 train: losses {losses} not finite or not "
                           f"falling")
    wall = float(np.median(walls[2:]))
    print(f"bf16 train rgb batch={TRAIN_BATCH}: {BF16_TRAIN_STEPS} steps, "
          f"loss {losses[0]:.6g} -> {losses[-1]:.6g}, launches per step "
          f"{measured}; step wall (median of steps 3-{BF16_TRAIN_STEPS}) "
          f"{wall * 1e3:.4f} ms (f32 {train['step_wall_ms']:.4f}), "
          f"{TRAIN_BATCH / wall:.3f} images/s; peak memory "
          f"{peak / 2 ** 30:.3f} GiB (f32 "
          f"{train['peak_bytes'] / 2 ** 30:.3f})")
    print(f"bf16 train losses: {json.dumps(losses)}")
    prof = profile_train_step(torch, step, state, batch, train_gen, None)
    if prof["gdn_kernels"] != TRAIN_LAUNCHES["train"]["gdn"] or \
            prof["gdn_backward_kernels"] != \
            TRAIN_LAUNCHES["train"]["gdn_backward"]:
        raise RuntimeError(f"bf16 train profile: {prof['gdn_kernels']} GDN "
                           f"and {prof['gdn_backward_kernels']} GDN "
                           f"backward kernel records (the profiler lost the "
                           f"records of {prof['lost']} launch calls)")
    print(f"bf16 train step profile: wall {prof['wall_ms']:.3f} ms, device "
          f"{prof['device_ms']:.3f} ms (f32 {train['device_ms']:.3f}) in "
          f"{prof['records']} records (f32 {train['records']}), busy "
          f"{prof['busy_ms'] / prof['wall_ms']:.3f} of wall; GDN kernel "
          f"{prof['gdn_ms']:.4f} ms (f32 {train['gdn_ms']:.4f}), its "
          f"backward {prof['gdn_backward_ms']:.4f} ms in its nodes (f32 "
          f"{train['gdn_backward_ms']:.4f}; the backward kernel's "
          f"{prof['gdn_backward_kernels']} launches "
          f"{prof['gdn_backward_kernel_ms']:.4f} ms, f32 "
          f"{train['gdn_backward_kernel_ms']:.4f}), cuDNN convolutions "
          f"{prof['conv_ms']:.3f} ms "
          f"({prof['conv_ms'] / prof['device_ms']:.3f} of device; f32 "
          f"{train['conv_ms'] / train['device_ms']:.3f})")
    del model, state, step
    # the bf16 step as a graph: a warm-up call and a graphed one (a capture
    # and its replay) of K = BF16_GRAPH_K against eager bf16 steps
    graph = graphed_vs_eager(torch, lambda d: train_model(d, dtype=bf16),
                             batch, BF16_GRAPH_K, 2)
    print(f"bf16 train graph K={BF16_GRAPH_K} (deterministic cuDNN): a "
          f"warm-up and a graphed call vs {2 * BF16_GRAPH_K} eager bf16 "
          f"steps: losses {json.dumps(graph['losses'])} (float32), max rel "
          f"diff {graph['loss_err']:.3e}, parameters max diff "
          f"{graph['param_err']:.3e} x max|p|; launches a call through the "
          f"wrappers {[c['gdn'] for c in graph['graphed']['launches']]} GDN;"
          f" capture {graph['capture_s'][0] * 1e3:.3f} ms")
    print(f"bf16 phase: {time.perf_counter() - t_start:.1f} s (kernel checks "
          f"{t_kernels:.1f} s)")
    return {"sums": sums, "worst": worst, "launches": launches,
            "mps": mps, "f32_mps": f32_mps, "shared4_mps": s4_mps,
            "shared4_launches": s4_launches, "train_launches": measured,
            "profiles": profs, "shared4_profile": s4_prof,
            "streams": streams, "peak_bytes": peak, "step_wall_ms": wall * 1e3,
            "train_profile": prof, "trips": trips, "shared4_trips": s4_trips,
            "mma": mma}


def check_mma_records(sums, key, what, trips):
    """The tensor-core deconv+IGDN kernel in an eager and a graphed round
    trip (`round_trips`): its launches a counted trip (`mma_count`: the
    wrapper's counter where it launches that kernel, the graphs' replays
    added) and its kernel records in the profiled trip, each held to the
    launches the plan gives it at the trip's shapes (phase "bf16"'s sums
    under `key`); the records may be short by the launches whose records
    the profiler lost. Returns {mode: {"launches", "records"}}, as
    measured."""
    want = round(sums["deconv_igdn"][key]["mma_launches"])
    got = {m: {"launches": trips[m]["mma_launches"],
               "records": trips[m]["profile"]["deconv_mma"]}
           for m in ("eager", "graphed")}
    if want == 0 or any(
            g["launches"] != want or not want - trips[m]["profile"]["lost"]
            <= g["records"] <= want for m, g in got.items()):
        raise RuntimeError(f"{what}: tensor-core deconv+IGDN launches and "
                           f"records a trip {got}, the plan gives {want}")
    print(f"{what}: deconv+IGDN launches a trip on the tensor cores, counted "
          f"and profiled {json.dumps(got)} (the plan gives {want})")
    return got


def bf16_sums(bf, kernel):
    """The kernels line's bf16 entry of `kernel`: the rgb path's launches
    (its round trips, counted) and phase "bf16"'s sums over an rgb round
    trip, a shared4 round trip and a train step."""
    def part(key):
        t = bf["sums"][kernel][key]
        out = {"launches_per_call": t["launches"], "ms": t["ms"],
               "host_ms": t["host_ms"], "plain_ms": t["plain_ms"],
               "bound_ms": t["bound_ms"],
               "bound_by": max(t["by"], key=t["by"].get),
               "library_ms": t.get("library_ms")}
        if kernel == "deconv_igdn":
            out.update(cuda_core_ms=t["cuda_core_ms"],
                       mma_launches_per_call=bf["mma"][key]["graphed"][
                           "launches"])
        return out

    tolerance = f"{BF16_TOL} x max(1, |plain|max)"
    if kernel == "deconv_igdn":
        tolerance += (" of the plain epilogue on the kernel's y; the sums "
                      "round as cuDNN's but at a boundary within float32 "
                      "summation error; max_abs_err is against the whole "
                      "plain version; cuda_core_ms: the CUDA-core tiled "
                      "path at every launch (timed in turns with the "
                      "tensor cores' where the plan is theirs); "
                      "mma_launches_per_call: a graphed trip's launches on "
                      "the tensor cores, counted; mma: each mode's, counted, "
                      "and the profiled trip's records of them")
    out = {"launches": bf["launches"][kernel],
           "max_abs_err": bf["worst"][kernel], "tolerance": tolerance,
           **part("trip"), "shared4": dict(
               part("shared4"), launches=bf["shared4_launches"][kernel])}
    if "train" in bf["sums"][kernel]:
        out["train"] = dict(part("train"),
                            launches=bf["train_launches"][kernel])
    if kernel == "deconv_igdn":
        out["mma"] = bf["mma"]
    return out


def compressai_state_dict(torch, model):
    """`model`'s state_dict as a reference (CompressAI / Lightning)
    checkpoint holds it: CPU tensors plus the buffers the importer skips
    (the entropy bottleneck's and the Gaussian conditional's CDF tables,
    each GDN's reparametriser constants), in {"state_dict": ...}."""
    from mmnc_tpu_torch.ops.layers import GDN

    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    eb = "model.compressor.entropy_bottleneck."
    n = model.conv_channels * model.n_tasks
    for prefix, rows in ((eb, n), ("model.compressor.gaussian_conditional.",
                                   64)):
        sd[prefix + "_offset"] = torch.zeros(rows, dtype=torch.int32)
        sd[prefix + "_quantized_cdf"] = torch.zeros(rows, 40,
                                                    dtype=torch.int32)
        sd[prefix + "_cdf_length"] = torch.zeros(rows, dtype=torch.int32)
    sd["model.compressor.gaussian_conditional.scale_table"] = \
        torch.linspace(0.11, 256, 64)
    for name, module in model.named_modules():
        if isinstance(module, GDN):
            for p in ("beta", "gamma"):
                sd[f"{name}.{p}_reparam.pedestal"] = torch.tensor([2.0 ** -36])
                sd[f"{name}.{p}_reparam.lower_bound.bound"] = \
                    torch.tensor([2.0 ** -18])
    return {"state_dict": sd, "epoch": 0, "global_step": 0}


def run_import(torch):
    """Reference-checkpoint import at shared4: the seed-0 model's
    state_dict as a CompressAI/Lightning checkpoint (`compressai_state_dict`)
    imported into a model drawn from another seed on the card; a round
    trip of one batch of 8 by both under deterministic cuDNN: the bytes
    equal and the x_hats bitwise equal, the imported model's launches a
    compress and a decompress. Then raw_gdn=True into a card model and a
    CPU one: the card's path against the CPU plain path on one image
    (`check_against_cpu`). Returns the imported model's launches."""
    from mmnc_tpu_torch.utils.torch_import import import_reference_state_dict

    t0 = time.perf_counter()
    name = "shared4"
    source = paper_model(name, "cuda")
    ckpt = compressai_state_dict(torch, source)
    model = import_reference_state_dict(ckpt, paper_model(name, "cuda",
                                                          seed=SEED + 1))
    model.update_bottleneck_values()
    batch = paper_batches(torch, source, 1, SEED + 30)[0]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ans_s, n_s = source.compress(batch)
        x_s = source.decompress(ans_s)
        (ans, n_bytes), enc = launched(torch, lambda: model.compress(batch))
        x_hats, dec = launched(torch, lambda: model.decompress(ans))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    want_launches(name, "compress", enc)
    want_launches(name, "decompress", dec)
    if ans != ans_s or n_bytes != n_s:
        raise RuntimeError("imported model: its bytes differ from the "
                           "source model's")
    for t in model.tasks:
        if not torch.equal(x_hats[t], x_s[t]):
            raise RuntimeError(f"imported model: x_hat {t} differs from the "
                               f"source model's")
    raw = [import_reference_state_dict(ckpt, paper_model(name, device),
                                       raw_gdn=True)
           for device in ("cuda", "cpu")]
    check_against_cpu(torch, *raw, {t: x[:1] for t, x in batch.items()},
                      f"{name} imported with raw_gdn")
    print(f"import {name}: a CompressAI/Lightning state_dict "
          f"({len(ckpt['state_dict'])} keys, {len(model.state_dict())} read) "
          f"into a model from seed {SEED + 1}: {n_bytes} bytes and x_hats "
          f"bitwise equal the source model's round trip of {BATCH}; "
          f"launches compress {enc}, decompress {dec}; "
          f"{time.perf_counter() - t0:.3f} s")
    return {k: enc[k] + dec[k] for k in enc}


def cli_argv(tmp, *extra):
    """The train CLI's flags for phase 9: shared4 (PAPER) on CLEVR-style
    synthetic scenes, prerendered into `tmp`."""
    number, tasks, latent, conv = PAPER["shared4"]
    return ["-d", "synthetic", "--data-style", "clevr", "-t", *tasks,
            "-m", str(number), "-l", str(latent), "-c", str(conv),
            "-w", "cli", "--lmbda", str(LMBDA), "-lrm", str(LR_MAIN),
            "-lra", str(LR_AUX), "--batch-size", str(CLI_BATCH),
            "--train-size", str(CLI_TRAIN_SIZE),
            "--val-size", str(CLI_VAL_SIZE), "--out-dir",
            os.path.join(tmp, "runs"), "--data-cache-dir",
            os.path.join(tmp, "cache"), "--device", CLI_DEVICE, *extra]


def call_kind(stats, before):
    """What a call of a multi-step did, from its `stats` before and after:
    "replay" (a graph replayed: its launches bypass the counters),
    "capture" (captured, then replayed) or "eager" (a warm-up, or eager
    steps: the mesh path, the CPU, or no stats at all)."""
    if stats is None or before is None:
        return "eager"
    if stats["captures"] != before["captures"]:
        return "capture"
    return "replay" if stats["replays"] != before["replays"] else "eager"


def eager_multi_step(model, steps_per_call, compute_metrics=False,
                     clip_norm=None, remat=False, mesh=None):
    """The loop's multi-step as `steps_per_call` eager `make_train_step`
    calls, the generator reseeded at step_seed(seed, step) before each:
    the reference a graphed call is held to."""
    from mmnc_tpu_torch.train import make_train_step
    from mmnc_tpu_torch.train.step import step_seed

    one = make_train_step(model, compute_metrics=compute_metrics,
                          clip_norm=clip_norm, remat=remat, mesh=mesh)

    def multi(state, group, generator, seed):
        logs = None
        for batch in group:
            generator.manual_seed(step_seed(seed, state.step))
            state, logs = one(state, batch, generator)
        return state, logs

    return multi


@contextlib.contextmanager
def counted_steps(torch, per_step, eager=False, profile_replay=False):
    """Wrap the train loop's train call (`steps_per_call` steps) and eval
    step so each appends {"kind": "train" or "eval", "launches",
    "wrapped", "how", "step", "graph", "wall"} to `per_step`: the launch
    counts read just before the call and just after it, on a synchronised
    card, and subtracted (the run's totals keep counting): "launches"
    `counts()`'s (a replayed eval step's graph launches included),
    "wrapped" the wrappers' own; `call_kind` of the call's stats (an eval
    step's are its program's, `graphs.stats`); the state's step before a
    train call; the call's synchronised wall seconds. A replayed graph
    launches its kernels without the wrappers: with `profile_replay` (for
    a run without the loop's own profiler window: profilers do not nest)
    the first replayed train call and the first replayed eval step run
    under torch.profiler (their wall None), "graph" holds the graph's
    kernel records (`graph_launches`) and "kernel_ms" the device ms of
    each `kernel_kind`'s records. With `eager` the
    loop's multi-step is `eager_multi_step`; otherwise the steps
    themselves are unchanged."""
    from mmnc_tpu_torch.train import loop

    names = {"train": "make_multi_train_step", "eval": "make_eval_step"}
    originals = {kind: getattr(loop, name) for kind, name in names.items()}
    makers = dict(originals, **({"train": eager_multi_step} if eager
                                else {}))
    pending = {"train": profile_replay, "eval": profile_replay}

    def wrap(make, kind):
        def made(*args, **kwargs):
            step = make(*args, **kwargs)
            stats = getattr(step, "stats", None)

            def counted(*a, **k):
                before_stats = dict(stats) if stats is not None else None
                entry = {"kind": kind, "step": a[0].step if kind == "train"
                         else None, "graph": None}
                # an eval step's next call replays once it has captured
                profile = (pending[kind] and stats is not None
                           and stats["captures"] > 0)
                torch.cuda.synchronize()
                before, wrapped = counts(), wrapper_counts()
                t0 = time.perf_counter()
                if profile:
                    holder = []
                    prof = profile_device(
                        torch, lambda: holder.append(step(*a, **k)), tries=1)
                    out = holder[0]
                    entry["graph"] = prof["graph"]
                    entry["kernel_ms"] = prof["by_kernel"]
                else:
                    out = step(*a, **k)
                torch.cuda.synchronize()
                after = counts()
                entry["wall"] = None if profile else time.perf_counter() - t0
                entry["launches"] = {n: after[n] - before[n] for n in after}
                entry["wrapped"] = {n: c - wrapped[n]
                                    for n, c in wrapper_counts().items()}
                entry["how"] = call_kind(stats, before_stats)
                if profile and entry["how"] == "replay":
                    pending[kind] = False
                elif profile:
                    entry["graph"] = None  # not a replay: nothing to hold
                per_step.append(entry)
                return out
            return counted
        return made

    for kind, name in names.items():
        setattr(loop, name, wrap(makers[kind], kind))
    try:
        yield
    finally:
        for kind, name in names.items():
            setattr(loop, name, originals[kind])


def check_calls(per_step, want, what, k=1, profiled=False):
    """Each counted call of a run against its launches: a train call's
    counts are `want["train"]` x k unless it replayed (0: its kernels run
    in its graph), and a profiled replay's graph records are that; an
    eval step's `want["eval"]` (`counts()`: a replay's graph launches
    included), none of them through the wrappers where it replayed, and a
    profiled replay's graph records `want["eval"]`. With `profiled`, a run
    whose train calls (eval steps) replayed must have profiled a replay of
    them. Raises on a mismatch."""
    per_call = {n: k * c for n, c in want["train"].items()}
    zero = {n: 0 for n in per_call}
    for kind in ("train", "eval"):
        replays = [e for e in per_step
                   if e["kind"] == kind and e["how"] == "replay"]
        if profiled and replays and not any(e["graph"] for e in replays):
            raise RuntimeError(f"{what}: {len(replays)} {kind} replays, none "
                               f"profiled")
    for e in per_step:
        if e["kind"] == "eval":
            expect, graph = want["eval"], want["eval"]
            wrapped = zero if e["how"] == "replay" else want["eval"]
        else:
            expect = zero if e["how"] == "replay" else per_call
            graph, wrapped = per_call, expect
        if e["launches"] != expect or e["wrapped"] != wrapped or \
                e["graph"] not in (None, graph):
            raise RuntimeError(f"{what}: a {e['kind']} {e['how']} call at "
                               f"step {e['step']} launched {e['launches']} "
                               f"({e['wrapped']} through the wrappers; want "
                               f"{expect}, {wrapped}), its graph "
                               f"{e['graph']} (want {graph})")


def graph_launched(per_step, per_call):
    """The port's kernel launches that a run's replayed train calls made
    in their graphs, which the wrappers' counters never see: `per_call`
    (a call's counts, as a profiled replay's or a trace's graph records
    showed them) for each replay among `per_step` (`counted_steps`'
    entries), the profiled one included."""
    n = sum(e["kind"] == "train" and e["how"] == "replay" for e in per_step)
    return {k: n * c for k, c in per_call.items()}


def check_window_graphs(groups, per_train, replayed, per_eval, what):
    """A profiled window's graph launches (`graph_launch_groups`): the
    replayed train calls' (`per_train` records each, `replayed` of them)
    and any serving graphs' of the validation and the image grids (each
    one eval step's or eval forward's `per_eval`, which differ from a
    train call's in their deconv+IGDN records); raises otherwise. Returns
    (the train calls' records, the serving graph launches)."""
    train = [g for g in groups if g == per_train]
    serving = [g for g in groups if g != per_train]
    total = {k: sum(g[k] for g in train) for k in per_train}
    if len(train) != replayed or any(g != per_eval for g in serving):
        raise RuntimeError(f"{what}: graph launches {groups}, want "
                           f"{replayed} of {per_train} and serving ones of "
                           f"{per_eval}")
    return total, len(serving)


def trace_summary(path):
    """A profiler trace of the loop's steps 5-10 -> (device ms, busy ms,
    wall ms: the span of every record in it, `graph_launch_groups`)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    graph = graph_launch_groups(events)
    events = [e for e in events if "dur" in e and "ts" in e]
    device = [e for e in events if e.get("cat") in DEVICE_WORK]
    wall = (max(e["ts"] + e["dur"] for e in events)
            - min(e["ts"] for e in events))
    return (sum(e["dur"] for e in device) / 1e3, busy_us(device) / 1e3,
            wall / 1e3, graph)


def cli_model(device):
    from mmnc_tpu_torch import build_model

    number, tasks, latent, conv = PAPER["shared4"]
    return build_model(number, tasks, latent, conv, lmbda=LMBDA,
                       learning_rate_main=LR_MAIN, learning_rate_aux=LR_AUX,
                       device=device, seed=SEED)


def max_rel_diff(a, b):
    """max |a - b| over max |b| of one tensor (0 where both are all 0)."""
    err, scale = (a - b).abs().max().item(), b.abs().max().item()
    return err / scale if scale else (float("inf") if err else 0.0)


def check_resume(torch, train_set, tmp):
    """Phase 9 (3): under deterministic cuDNN, CLI_EPOCHS // 2 epochs with
    the horizon set to the whole run, resumed to the end, against an
    uninterrupted run: parameters and Adam's moments within 1e-6 x max|p|
    per tensor. Then a resume with more --epochs keeps the saved
    horizon. Returns (save ms, restore ms)."""
    from mmnc_tpu_torch.data import BatchLoader
    from mmnc_tpu_torch.train import fit

    steps = CLI_EPOCHS * (CLI_TRAIN_SIZE // CLI_BATCH)
    runs, stats = {}, {}

    def run(name, epochs, **kw):
        model = cli_model(CLI_DEVICE)
        st = stats.setdefault(name, {})
        state, _ = fit(model, BatchLoader(train_set, CLI_BATCH), epochs=epochs,
                       run_name=name, out_dir=os.path.join(tmp, "resume"),
                       log_images=False, compute_metrics=False, log_every=4,
                       stats=st, **kw)
        runs[name] = (model, state)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        run("cut", CLI_EPOCHS // 2, schedule_total_steps=steps)
        run("cut", CLI_EPOCHS, resume=True)
        run("whole", CLI_EPOCHS)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (m_r, s_r), (m_w, s_w) = runs["cut"], runs["whole"]
    if not (s_r.step == s_w.step == steps
            and s_r.total_steps == s_w.total_steps == steps):
        raise RuntimeError(f"resume: steps {s_r.step}/{s_w.step}, horizons "
                           f"{s_r.total_steps}/{s_w.total_steps}, want {steps}")
    worst = 0.0
    for (name, p), q in zip(m_w.named_parameters(), m_r.parameters()):
        worst = max(worst, max_rel_diff(q.detach(), p.detach()))
        adam_w, adam_r = (s.optimizer.state[t] for s, t in ((s_w, p),
                                                            (s_r, q)))
        for k in ("exp_avg", "exp_avg_sq"):
            worst = max(worst, max_rel_diff(adam_r[k], adam_w[k]))
    if not worst <= 1e-6:
        raise RuntimeError(f"resumed run vs uninterrupted: max rel diff "
                           f"{worst} over 1e-6")
    # a resume asking for more epochs keeps the saved horizon (one step)
    run("cut", CLI_EPOCHS + 1, resume=True, max_steps=steps + 1)
    if runs["cut"][1].total_steps != steps:
        raise RuntimeError(f"resume with --epochs {CLI_EPOCHS + 1}: horizon "
                           f"{runs['cut'][1].total_steps}, want {steps}")
    save_ms = stats["cut"]["save_ms"] + stats["whole"]["save_ms"]
    print(f"cli resume: {steps // 2} steps + resumed {steps // 2} vs "
          f"{steps} uninterrupted (deterministic cuDNN): max rel diff of "
          f"parameters and Adam moments {worst:.3e}; a resume with --epochs "
          f"{CLI_EPOCHS + 1} kept the horizon {steps}; checkpoint save ms "
          f"{json.dumps([round(t, 3) for t in save_ms])}, restore ms "
          f"{stats['cut']['restore_ms']:.3f}")
    return save_ms, stats["cut"]["restore_ms"]


def check_device_cache(torch, train_set, tmp):
    """Phase 9 (4): the training set as a DeviceResidentDataset on the
    card: gathered batches bitwise equal to the CPU port's and within half
    a quantization step (plus a few float32 ulps) of the host arrays;
    four fit steps from it take the no-prefetch path."""
    from mmnc_tpu_torch.data import BatchLoader, DeviceResidentDataset
    from mmnc_tpu_torch.train import fit

    t0 = time.perf_counter()
    cache = DeviceResidentDataset(train_set.arrays, device=CLI_DEVICE)
    torch.cuda.synchronize()
    upload = time.perf_counter() - t0
    n_bytes = sum(x.numel() * x.element_size() for x in cache._dev.values())
    cpu = DeviceResidentDataset(train_set.arrays, device="cpu")
    worst = 0.0
    rng = np.random.default_rng(SEED)
    for _ in range(2):
        idx = rng.permutation(len(cache))[:CLI_BATCH]
        got, want = cache.get_batch(idx), cpu.get_batch(idx)
        for t in cache.tasks:
            if not torch.equal(got[t].cpu(), want[t]):
                raise RuntimeError(f"device cache {t}: card batch differs "
                                   f"from the CPU port's")
            lo, hi = cache._scales[t]
            err = np.abs(want[t].numpy() - train_set.arrays[t][idx]).max()
            ulps = 4 * np.finfo(np.float32).eps * max(abs(lo), abs(hi))
            if not err <= (hi - lo) / 65535 / 2 + ulps:
                raise RuntimeError(f"device cache {t}: {err} from the host "
                                   f"data, over half a step")
            worst = max(worst, err / ((hi - lo) / 65535))
    stats = {}
    state, _ = fit(cli_model(CLI_DEVICE), BatchLoader(cache, CLI_BATCH),
                   max_steps=4, out_dir=os.path.join(tmp, "cache_fit"),
                   log_images=False, compute_metrics=False, stats=stats)
    if state.step != 4 or stats["loader"].get("batches", 0) != 0:
        raise RuntimeError(f"device-cache fit: {state.step} steps, "
                           f"{stats['loader']} through the prefetch queue")
    print(f"cli device cache: {n_bytes / 1e6:.1f} MB of 16-bit data on the "
          f"card (upload + quantize {upload:.3f} s); card batches equal the "
          f"CPU port's bitwise, at most {worst:.4f} steps from the host "
          f"data; 4 fit steps without the prefetch queue")


def check_prefetch(torch, train_set):
    """Phase 9 (5): every batch prefetch_to_device yields on the card is
    bitwise equal to its host batch, with the consumer's stream kept busy
    (a matmul chain) while the next copies are in flight."""
    from mmnc_tpu_torch.data import BatchLoader, prefetch_to_device

    loader = BatchLoader(train_set, CLI_BATCH)
    a = torch.randn(2048, 2048, device=CLI_DEVICE)
    n, stats = 0, {}
    for host, dev in zip(loader.epoch(0), prefetch_to_device(
            loader.epoch(0), device=CLI_DEVICE, stats=stats)):
        for _ in range(8):
            a = torch.tanh(a @ a / 2048.0)
        for t, x in host.items():
            if not torch.equal(dev[t].cpu(), torch.from_numpy(x)):
                raise RuntimeError(f"prefetch batch {n} {t} differs from "
                                   f"the host batch")
        n += 1
    print(f"cli prefetch: {n} batches of {CLI_BATCH} bitwise equal to the "
          f"host batches (consumer wait {stats['wait_s'] * 1e3:.3f} ms)")


def cli_k_run(torch, tmp, name, k, *extra, eager=False,
              profile_replay=False):
    """The train CLI at --steps-per-call k as run `name` under
    deterministic cuDNN, each train call counted and timed
    (`counted_steps`, which `eager` and `profile_replay` are handed to;
    with `eager` the serving programs, the eval step among them, run
    under `graphs.disabled()` too) -> (state, the counted calls, run
    launches, stdout, fit's stats)."""
    from mmnc_tpu_torch import graphs
    from mmnc_tpu_torch.cli import train as train_cli

    per_step, out, stats = [], io.StringIO(), {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        torch.cuda.synchronize()
        reset_counts()
        with counted_steps(torch, per_step, eager, profile_replay), \
                contextlib.redirect_stdout(out), \
                (graphs.disabled() if eager else contextlib.nullcontext()):
            state = train_cli.main(cli_argv(
                tmp, "--log-every", "1", "--steps-per-call", str(k), "-w",
                name, *extra), stats=stats)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return state, per_step, counts(), out.getvalue(), stats


def shared4_launches():
    """MT_LAUNCHES' shared4 train and eval steps as {kind: counts}."""
    return {kind: as_counts(MT_LAUNCHES["shared4"][kind])
            for kind in ("train", "eval")}


def check_steps_per_call(torch, tmp, card):
    """Phase 9 (3b): the same 16 steps, seed and scenes through the train
    CLI under deterministic cuDNN, three ways (CLI_RUNS): an eager
    reference (the loop's multi-step made of eager `make_train_step`
    calls, `eager_multi_step`), and graphed at K = 1 and at
    --steps-per-call CLI_K (a warm-up, a capture, replays). Both graphed
    runs' final parameters within 1e-6 x max|p| of the eager run's
    (check_resume's bound); the logged steps JAX's cadence gives (the
    first step of each call); each call's launches (`check_calls`: 63 x K
    through the wrappers unless replayed; the K = CLI_K run's first replay
    profiled, its graph's records 63 x K; the K = 1 runs' traces of steps
    5-10 hold 63 graph-launched GDN records a replayed step in them).
    Prints each run's StepTimer p50 and images/s, its synchronised call
    p50, and for the K = 1 runs the busy share of steps 5-10, graphed
    beside eager. Then --steps-per-call CLI_K_CLAMPED for one epoch:
    clamped to its 8 batches, one call (the warm-up, eager). Returns the
    K = CLI_K run's launches and its launches a call."""
    t0 = time.perf_counter()
    steps = CLI_EPOCHS * (CLI_TRAIN_SIZE // CLI_BATCH)
    per_epoch = CLI_TRAIN_SIZE // CLI_BATCH
    want = shared4_launches()
    runs = {}
    for name, k, eager in CLI_RUNS:
        extra = ["--epochs", str(CLI_EPOCHS)]
        if k == 1:
            extra += ["--profile-dir", os.path.join(tmp, f"profile_{name}")]
        state, per_step, launches, _, stats = cli_k_run(
            torch, tmp, name, k, *extra, eager=eager, profile_replay=k > 1)
        calls = [e for e in per_step if e["kind"] == "train"]
        hows = [e["how"] for e in calls]
        want_hows = ["eager"] * len(calls) if eager else (
            ["eager", "capture"] + ["replay"] * len(calls))[:len(calls)]
        if state.step != steps or len(calls) != steps // k or \
                hows != want_hows:
            raise RuntimeError(f"cli {name}: {state.step} steps, calls "
                               f"{hows}, want {want_hows}")
        check_calls(per_step, want, f"cli {name}", k, profiled=k > 1)
        per_call = {n: k * c for n, c in want["train"].items()}
        graph = graph_launched(per_step, per_call)
        with open(os.path.join(tmp, "runs", name,
                               f"{name}.metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        logged = [r["step"] for r in records if "train/loss" in r]
        if logged != list(range(0, steps, k)):
            raise RuntimeError(f"cli {name}: logged steps {logged}")
        evals = [e["how"] for e in per_step if e["kind"] == "eval"]
        per_val = CLI_VAL_SIZE // CLI_BATCH
        want_evals = ["eager"] * (CLI_EPOCHS * per_val) if eager else (
            ["eager", "capture"] + ["replay"] * CLI_EPOCHS * per_val)[
                :CLI_EPOCHS * per_val]
        if evals != want_evals:
            raise RuntimeError(f"cli {name}: eval steps {evals}, want "
                               f"{want_evals}")
        row = {"params": [p.detach() for g in state.optimizer.param_groups
                          for p in g["params"]],
               # the steady calls: replays, or an eager run's from its
               # third (as StepTimer), the profiled replay left out
               "call_p50": float(np.median([
                   e["wall"] for e in calls[2:] if e["wall"] is not None])),
               "launches": {n: c + graph[n] for n, c in launches.items()},
               "graph_launches": graph, "per_call": per_call, "k": k,
               "p50": stats["step_timer"]["p50_s"],
               "val": [{key: v for key, v in r.items() if key != "time"}
                       for r in records
                       if any(key.startswith("val/") for key in r)],
               "eval_graph": next((e["graph"] for e in per_step
                                   if e["kind"] == "eval" and e["graph"]),
                                  None)}
        if k == 1:
            dev_ms, busy_ms, wall_ms, groups = trace_summary(stats["trace"])
            replayed = sum(e["how"] == "replay" for e in calls
                           if 5 <= e["step"] <= 10)
            _, serving = check_window_graphs(
                groups, want["train"], replayed,
                dict(ZERO) if eager else want["eval"],
                f"cli {name}: steps 5-10's trace")
            row.update(busy=busy_ms / wall_ms, device_ms=dev_ms / 6,
                       serving_graphs=serving)
        runs[name] = row
    ref = runs["cli_eager"]["params"]
    worst = {name: max(max_rel_diff(q, p) for p, q in
                       zip(ref, runs[name]["params"]))
             for name, _, eager in CLI_RUNS if not eager}
    if not all(w <= 1e-6 for w in worst.values()):
        raise RuntimeError(f"cli graphed vs eager: parameters max rel diff "
                           f"{worst} over 1e-6")
    # the validation of each graphed run (its eval step graphed) against
    # the eager reference's: the same logs where the parameters are
    # bitwise the same
    ref_val = runs["cli_eager"]["val"]
    for name, _, eager in CLI_RUNS:
        got = runs[name]["val"]
        if len(got) != CLI_EPOCHS or (worst.get(name, 0.0) == 0.0
                                      and got != ref_val):
            raise RuntimeError(f"cli {name}: validation logs {got} against "
                               f"the eager reference's {ref_val}")
    state, per_step, _, out, _ = cli_k_run(
        torch, tmp, f"cli_k{CLI_K_CLAMPED}", CLI_K_CLAMPED, "--epochs", "1",
        "--no-metrics")
    calls = [e for e in per_step if e["kind"] == "train"]
    note = f"steps_per_call {CLI_K_CLAMPED} > {per_epoch} batches/epoch"
    if state.step != per_epoch or len(calls) != 1 or note not in out or \
            calls[0]["launches"]["gdn"] != per_epoch * want["train"]["gdn"]:
        raise RuntimeError(f"cli --steps-per-call {CLI_K_CLAMPED}: "
                           f"{state.step} steps, calls {calls}, output "
                           f"{out!r}")
    for name, row in runs.items():
        k = row["k"]
        busy = (f", steps 5-10: device {row['device_ms']:.3f} ms a step, "
                f"busy {row['busy']:.3f}" if "busy" in row else "")
        print(f"cli {name} ({card}, deterministic cuDNN, K = {k}): "
              f"{steps} steps in {steps // k} calls ({row['per_call']} a "
              f"call); StepTimer p50 {row['p50'] * 1e3:.3f} ms a call "
              f"({k * CLI_BATCH / row['p50']:.3f} images/s), synchronised "
              f"call p50 (from the third call) {row['call_p50'] * 1e3:.3f} ms "
              f"({k * CLI_BATCH / row['call_p50']:.3f} images/s){busy}; "
              f"launches {row['launches']}, {row['graph_launches']} of them "
              f"in replayed train graphs; eval steps "
              f"{'eager' if name == 'cli_eager' else 'graphed'}, "
              f"validation logs "
              f"{'bitwise equal to' if row['val'] == ref_val else 'off'}"
              f" the eager reference's"
              + (f", a profiled eval replay's graph records "
                 f"{row['eval_graph']}" if row["eval_graph"] else "")
              + (f", {row['serving_graphs']} serving graph launches in steps"
                 f" 5-10's trace" if "serving_graphs" in row else "")
              + (f"; final parameters vs the eager run max rel diff "
                 f"{worst[name]:.3e}" if name in worst else ""))
    print(f"cli --steps-per-call {CLI_K_CLAMPED}: clamped to {per_epoch} "
          f"({note}), one call of {calls[0]['launches']} launches; "
          f"{time.perf_counter() - t0:.3f} s")
    k_run = runs[f"cli_k{CLI_K}"]
    return {"launches": k_run["launches"], "per_call": k_run["per_call"],
            "graph_launches": k_run["graph_launches"]}


def run_cli(torch, profile_dir, card):
    """Phase 9: the train CLI (prerendered CLEVR-style scenes, validation,
    image grids, checkpoints, the profiler over steps 5-10), resume, the
    device cache, prefetch, and the compress CLI on the checkpoint.
    `card` is nvidia-smi's name and power limit, printed beside the
    timings. Returns the launches of the train CLI's run and per step, and
    the timings."""
    from mmnc_tpu_torch.cli import compress as compress_cli
    from mmnc_tpu_torch.cli import train as train_cli

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        t0 = time.perf_counter()
        train_loader, _ = train_cli.get_loaders(
            train_cli.parse_args(cli_argv(tmp)))
        train_set = train_loader.dataset
        print(f"cli data: {CLI_TRAIN_SIZE} + {CLI_VAL_SIZE} CLEVR-style "
              f"scenes at {IMAGE} px rendered in "
              f"{time.perf_counter() - t0:.3f} s")

        # (2) the train CLI
        prof_dir = profile_dir or os.path.join(tmp, "profile")
        per_step, stats = [], {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with counted_steps(torch, per_step):
            state = train_cli.main(cli_argv(
                tmp, "--epochs", str(CLI_EPOCHS), "--log-every", "1",
                "--profile-dir", prof_dir), stats=stats)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        steps = CLI_EPOCHS * (CLI_TRAIN_SIZE // CLI_BATCH)
        if state.step != steps:
            raise RuntimeError(f"train CLI: {state.step} steps, want {steps}")
        want = shared4_launches()
        kinds = [e["kind"] for e in per_step]
        hows = [e["how"] for e in per_step if e["kind"] == "train"]
        if kinds.count("train") != steps or kinds.count("eval") != \
                CLI_EPOCHS * (CLI_VAL_SIZE // CLI_BATCH) or \
                hows != ["eager", "capture"] + ["replay"] * (steps - 2):
            raise RuntimeError(f"train CLI ran {kinds}, its train calls "
                               f"{hows}")
        check_calls(per_step, want, "train CLI")
        run_dir = os.path.join(tmp, "runs", "cli")
        with open(os.path.join(run_dir, "cli.metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        losses = [r["train/loss"] for r in recs if "train/loss" in r]
        if len(losses) != steps or not all(np.isfinite(losses)):
            raise RuntimeError(f"train CLI losses: {losses}")
        if not np.mean(losses[-4:]) < np.mean(losses[:4]):
            raise RuntimeError(f"train CLI: losses did not fall: {losses}")
        if not any("val/loss" in r for r in recs):
            raise RuntimeError("train CLI: no val record")
        ckpt = os.path.join(run_dir, "checkpoints", f"step_{steps}")
        for f in ("hyper_parameters.json", "state.pt"):
            if not os.path.exists(os.path.join(ckpt, f)):
                raise RuntimeError(f"train CLI: no {f} in {ckpt}")
        tasks = PAPER["shared4"][1]
        grids = [os.path.join(run_dir, f"samples_epoch{e}_{s}", f"{t}.png")
                 for e in range(CLI_EPOCHS) for s in ("val", "train")
                 for t in tasks]
        missing = [g for g in grids if not os.path.exists(g)]
        if missing:
            raise RuntimeError(f"train CLI: missing image grids {missing}")
        launches = counts()
        grid_evals = 2 * CLI_EPOCHS  # one val and one train batch an epoch
        for k in launches:
            expect = sum(e["launches"][k] for e in per_step) \
                + grid_evals * want["eval"][k]
            if launches[k] == 0 or launches[k] != expect:
                raise RuntimeError(f"train CLI: {launches[k]} {k} launches, "
                                   f"want {expect}")
        timer = stats["step_timer"]
        waits = stats["loader"]["waits_s"]
        wait = stats["loader"]["wait_s"] / max(stats["loader"]["batches"], 1)
        per_epoch = CLI_TRAIN_SIZE // CLI_BATCH
        firsts = [w for i, w in enumerate(waits) if i % per_epoch == 0]
        rest = [w for i, w in enumerate(waits) if i % per_epoch]
        ckpt_mb = os.path.getsize(os.path.join(ckpt, "state.pt")) / 1e6
        dev_ms, busy_ms, wall_ms, groups = trace_summary(stats["trace"])
        # the profiler's window, steps 5-10: train replays all, and the
        # end of the first epoch: its validation's eval steps (a capture
        # and a replay launch their graphs) and the image grids' eval
        # forwards (the second, a capture)
        graph, serving = check_window_graphs(
            groups, want["train"], 6, want["eval"],
            "train CLI: steps 5-10's trace")
        if serving == 0:
            raise RuntimeError("train CLI: no eval step or eval forward "
                               "replayed in steps 5-10's trace")
        in_graphs = graph_launched(per_step, want["train"])
        counted = launches
        wrapped = wrapper_counts()
        launches = {k: n + in_graphs[k] for k, n in counted.items()}
        print(f"cli train {PAPER['shared4']} batch={CLI_BATCH} "
              f"{CLI_EPOCHS} epochs ({card}): {steps} steps in "
              f"{seconds:.3f} s "
              f"(with validation, image grids, checkpoints and the "
              f"profiler); step p50 {timer['p50_s'] * 1e3:.4f} ms over steps "
              f"3-{steps} ({timer['steps']}): {1 / timer['p50_s']:.4f} "
              f"steps/s, {CLI_BATCH / timer['p50_s']:.3f} images/s; loader "
              f"wait {wait * 1e3:.4f} ms a step (an epoch's first batch "
              f"{json.dumps([round(w * 1e3, 3) for w in firsts])} ms, the "
              f"others' median {np.median(rest) * 1e3:.4f} ms); launches a "
              f"train step "
              f"{want['train']}, a val step {want['eval']}, run {launches} "
              f"({wrapped} through the wrappers, {in_graphs} in replayed "
              f"train graphs, the rest in replayed eval graphs); "
              f"peak memory {peak / 2 ** 30:.3f} GiB; checkpoint "
              f"({ckpt_mb:.3f} MB) save ms "
              f"{json.dumps([round(t, 3) for t in stats['save_ms']])}")
        counted = [e["launches"]["gdn"] for e in per_step
                   if e["kind"] == "train"]
        evals = [e["how"] for e in per_step if e["kind"] == "eval"]
        print(f"cli profiled steps 5-10 (graph replays): device "
              f"{dev_ms:.3f} ms ({dev_ms / 6:.3f} a step), busy "
              f"{busy_ms:.3f} ms of {wall_ms:.3f} ms "
              f"({busy_ms / wall_ms:.3f}); the train graphs' kernel records "
              f"{graph}, {serving} serving graph launches of "
              f"{want['eval']} records each (the validation's eval steps, "
              f"an image grid's eval forward); GDN launches a train call "
              f"through the wrappers {counted} (a warm-up, a capture, "
              f"replays); eval steps {evals}")
        print(f"cli losses: {json.dumps(losses)}")

        save_ms, restore_ms = check_resume(torch, train_set, tmp)
        k_calls = check_steps_per_call(torch, tmp, card)
        check_device_cache(torch, train_set, tmp)
        check_prefetch(torch, train_set)

        # (6) the compress CLI on the checkpoint
        out = os.path.join(tmp, "first_batch.bin")
        n_batches = 2
        reset_counts()
        t0 = time.perf_counter()
        bpp, est = compress_cli.main(
            ["-p", ckpt, "-d", "synthetic", "--batch-size", str(CLI_BATCH),
             "--num-batches", str(n_batches), "--out", out, "--device",
             CLI_DEVICE])
        torch.cuda.synchronize()
        c_seconds = time.perf_counter() - t0
        c_launches = counts()
        # a batch: compress, and the eval forward of the model and its twin
        expect = {k: n_batches * n for k, n in add_counts(
            MT_LAUNCHES["shared4"]["compress"], MT_LAUNCHES["shared4"]["eval"],
            MT_LAUNCHES["shared4"]["eval"]).items()}
        if c_launches != expect:
            raise RuntimeError(f"compress CLI: launches {c_launches}, want "
                               f"{expect}")
        if not (np.isfinite(bpp) and bpp > 0 and np.isfinite(est)
                and est > 0):
            raise RuntimeError(f"compress CLI: bpp {bpp}, estimate {est}")
        small = {}
        for device in (CLI_DEVICE, "cpu"):
            path = os.path.join(tmp, f"batch_of_{CLI_COMPARE_BATCH}_"
                                f"{device}.bin")
            compress_cli.main(["-p", ckpt, "-d", "synthetic", "--batch-size",
                               str(CLI_COMPARE_BATCH), "--num-batches", "1",
                               "--out", path, "--device", device])
            with open(path, "rb") as f:
                small[device] = f.read()
        if small[CLI_DEVICE] != small["cpu"]:
            raise RuntimeError(f"compress CLI, a batch of "
                               f"{CLI_COMPARE_BATCH}: the card's bytes differ "
                               f"from the CPU port's")
        images = n_batches * CLI_BATCH
        print(f"cli compress ({card}): {images} images in "
              f"{c_seconds:.3f} s (the "
              f"CLI's wall: rebuild, load, tables, render, coding and both "
              f"estimates), {images * IMAGE * IMAGE / 1e6 / c_seconds:.4f} "
              f"MP/s; actual bpp {bpp:.6f}, estimated (corrected geometry) "
              f"{est:.6f}; launches {c_launches}; first batch "
              f"{os.path.getsize(out)} bytes; a batch of {CLI_COMPARE_BATCH}: "
              f"{len(small['cpu'])} bytes, card equal to the CPU port's")
        return {"launches": launches, "graph_launches": in_graphs,
                "per_step": want, "timer": timer,
                "wait_ms": wait * 1e3, "device_ms": dev_ms,
                "busy": busy_ms / wall_ms, "peak": peak,
                "save_ms": save_ms, "restore_ms": restore_ms,
                "compress_launches": c_launches, "k_calls": k_calls}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def sweep_argv(tmp):
    """rd_sweep's flags for phase 10 (a): shared4 (PAPER) on CLEVR-style
    scenes rendered by the loader, the phase's lambdas, one epoch."""
    number, tasks, latent, conv = PAPER["shared4"]
    return ["-d", "synthetic", "--data-style", "clevr", "-t", *tasks,
            "-m", str(number), "-l", str(latent), "-c", str(conv),
            "-w", "sweep", "--lmbdas", *map(str, RD_LMBDAS), "--epochs", "1",
            "--batch-size", str(RD_BATCH), "--train-size", str(RD_TRAIN_SIZE),
            "--val-size", str(RD_VAL_SIZE), "-lrm", str(LR_MAIN),
            "-lra", str(LR_AUX), "--out-dir", os.path.join(tmp, "runs"),
            "--device", CLI_DEVICE]


def run_sweep(torch, tmp, card):
    """Phase 10 (a): rd_sweep's sweep on the card: a point per lambda with
    bpp > 0 and finite per-task PSNR and MS-SSIM, rd_points.json written,
    63 GDN and 0 deconv+IGDN launches a train step and 35 + 28 a
    validation step. Returns the checkpoints, the launches and the steps
    taken."""
    from mmnc_tpu_torch.cli import rd_sweep

    tasks = PAPER["shared4"][1]
    args = rd_sweep.parse_args(sweep_argv(tmp))
    per_step = []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with counted_steps(torch, per_step, profile_replay=True):
        points = rd_sweep.sweep(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counted = counts()
    want = shared4_launches()
    n = {"train": len(RD_LMBDAS) * (RD_TRAIN_SIZE // RD_BATCH),
         "eval": len(RD_LMBDAS) * (RD_VAL_SIZE // RD_BATCH)}
    kinds = [e["kind"] for e in per_step]
    if {k: kinds.count(k) for k in n} != n or len(kinds) != sum(n.values()):
        raise RuntimeError(f"sweep ran {kinds}, want {n}")
    check_calls(per_step, want, "sweep", profiled=True)
    for k in counted:
        if counted[k] != sum(e["launches"][k] for e in per_step):
            raise RuntimeError(f"sweep: {counted[k]} {k} launches outside "
                               f"its steps' {per_step}")
    in_graphs = graph_launched(per_step, want["train"])
    launches = {k: c + in_graphs[k] for k, c in counted.items()}
    if [p["lmbda"] for p in points] != list(RD_LMBDAS):
        raise RuntimeError(f"sweep points {points}")
    for p in points:
        values = [p[f"{t}/{m}"] for t in tasks for m in ("psnr", "ms-ssim")]
        if not (p["bpp"] > 0 and np.isfinite(p["bpp"])
                and np.all(np.isfinite(values))):
            raise RuntimeError(f"sweep point {p}")
    with open(os.path.join(tmp, "runs", "sweep", "rd_points.json")) as f:
        if json.load(f) != points:
            raise RuntimeError("sweep: rd_points.json differs from the "
                               "returned points")
    steps = RD_TRAIN_SIZE // RD_BATCH
    ckpts = [os.path.join(tmp, "runs", f"sweep-l{lmbda:g}", "checkpoints",
                          f"step_{steps}") for lmbda in RD_LMBDAS]
    missing = [c for c in ckpts if not os.path.exists(
        os.path.join(c, "state.pt"))]
    if missing:
        raise RuntimeError(f"sweep: no checkpoint {missing}")
    print(f"p10 sweep {PAPER['shared4']} lambdas {list(RD_LMBDAS)}, "
          f"{n['train'] // len(RD_LMBDAS)} steps of {RD_BATCH} and "
          f"{n['eval'] // len(RD_LMBDAS)} validation step each ({card}): "
          f"{seconds:.3f} s (rendering, model builds, train steps with "
          f"metrics, validation, checkpoints); launches {launches} "
          f"({in_graphs} of them in replayed graphs, a profiled replay's "
          f"records showing a call's), a train step {want['train']}, a val "
          f"step {want['eval']}")
    for p in points:
        print(f"p10 sweep point: {json.dumps(p)}")
    return {"ckpts": ckpts, "launches": launches, "n": n,
            "seconds": seconds}


def restored(path, device):
    """The codec of a checkpoint, loaded on `device`, tables built."""
    from mmnc_tpu_torch.utils.checkpoint import (
        rebuild_model_from_checkpoint, restore_checkpoint)

    model, _ = rebuild_model_from_checkpoint(path, device)
    payload, _ = restore_checkpoint(path, model.device)
    model.load_state_dict(payload["model"])
    model.update_bottleneck_values()
    return model


def close_or_raise(got, want, what, rtol=1e-3, atol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.allclose(got, want, rtol=rtol,
                                                  atol=atol):
        raise RuntimeError(f"{what}: card {got.ravel()[:8]} vs CPU "
                           f"{want.ravel()[:8]} (rtol {rtol}, atol {atol})")


# launches (GDN, deconv+IGDN) of each analysis call on a shared4 batch:
# check_bpp compresses and runs the eval forward of the model and its
# twin; encode_eval is compress's analysis; channel_bpp one eval forward;
# swap_latent_slices two encodes and a decode; average_channels one of
# each. As phase 3's keys: encodes and decodes of the batch
ANALYSIS_CALLS = {"check_bpp": {"encode": 3, "decode": 2},
                  "encode_eval": {"encode": 1},
                  "channel_bpp": {"encode": 1, "decode": 1},
                  "swap_latent_slices": {"encode": 2, "decode": 1},
                  "average_channels": {"encode": 1, "decode": 1}}


def part_launches(calls):
    """{"encode": n, "decode": m} -> {kernel: launches}."""
    enc = as_counts(MT_LAUNCHES["shared4"]["compress"])
    full = as_counts(MT_LAUNCHES["shared4"]["eval"])
    return {k: calls.get("encode", 0) * enc[k] + calls.get("decode", 0)
            * (full[k] - enc[k]) for k in KERNELS}


def run_analysis(torch, ckpt, card):
    """Phase 10 (b): check_bpp, encode_eval, channel_bpp,
    swap_latent_slices and average_channels on a batch of ANALYSIS_BATCH
    CLEVR-style held-out scenes, on the card and on the port's CPU plain
    path from the same checkpoint: bytes and symbols equal, floats within
    rtol 1e-3 / atol 1e-4, each call's launches on the card. Four steps
    from the init scale leave every y at 0, so both copies get the conv
    kernel gains of `seeded_model` first: the symbols, the swapped and
    averaged slices and the decodes are then not all zeros."""
    from mmnc_tpu_torch import analysis
    from mmnc_tpu_torch.data import BatchLoader, SyntheticMultiTaskDataset
    from mmnc_tpu_torch.weights import scale_conv_kernels

    tasks = PAPER["shared4"][1]
    scenes = SyntheticMultiTaskDataset(tasks, size=2 * ANALYSIS_BATCH,
                                       image_size=IMAGE, seed=10 ** 6 + 1,
                                       style="clevr")
    batch_a, batch_b = BatchLoader(scenes, ANALYSIS_BATCH,
                                   shuffle=False).epoch(0)
    block = restored(ckpt, "cpu").channels_per_task
    calls = {
        "check_bpp": lambda m: analysis.check_bpp(m, batch_a),
        "encode_eval": lambda m: m.encode_eval(batch_a),
        "channel_bpp": lambda m: analysis.channel_bpp(m, batch_a),
        "swap_latent_slices": lambda m: analysis.swap_latent_slices(
            m, batch_a, batch_b, range(block)),
        "average_channels": lambda m: analysis.average_channels(
            m, batch_a, range(block, 2 * block))}
    out, seconds, launches = {}, {}, {}
    for where, device in (("card", CLI_DEVICE), ("cpu", "cpu")):
        model = scale_conv_kernels(restored(ckpt, device))
        model.update_bottleneck_values()
        for name, call in calls.items():
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            got = call(model)
            torch.cuda.synchronize()
            seconds[where, name] = time.perf_counter() - t0
            launches[where, name] = counts()
            out[where, name] = got
    total = dict(ZERO)
    for name, parts in ANALYSIS_CALLS.items():
        want = part_launches(parts)
        if launches["card", name] != want or any(
                launches["cpu", name].values()):
            raise RuntimeError(f"analysis {name}: launches card "
                               f"{launches['card', name]} CPU "
                               f"{launches['cpu', name]}, want {want} on "
                               f"the card")
        for k in total:
            total[k] += want[k]
    card_bpp, cpu_bpp = out["card", "check_bpp"], out["cpu", "check_bpp"]
    if (card_bpp["bytes"], card_bpp["actual_bpp"]) != (
            cpu_bpp["bytes"], cpu_bpp["actual_bpp"]) or card_bpp["bytes"] <= 0:
        raise RuntimeError(f"check_bpp: card {card_bpp}, CPU {cpu_bpp}")
    for k in ("estimated_bpp", "estimated_bpp_legacy"):
        close_or_raise(card_bpp[k], cpu_bpp[k], f"check_bpp {k}")
    for i, name in enumerate(("y", "z")):
        sym = out["card", "encode_eval"][i].cpu()
        if not torch.equal(sym, out["cpu", "encode_eval"][i]):
            raise RuntimeError(f"encode_eval {name}: card symbols differ "
                               f"from the CPU port's")
        close_or_raise(out["card", "channel_bpp"][name],
                       out["cpu", "channel_bpp"][name], f"channel_bpp {name}")
    y_nz = float((out["cpu", "encode_eval"][0] != 0).float().mean())
    for name in ("swap_latent_slices", "average_channels"):
        for t in tasks:
            close_or_raise(out["card", name][t].cpu(), out["cpu", name][t],
                           f"{name} {t}")
    card_ms = {n: round(seconds["card", n] * 1e3, 3) for n in calls}
    card_s = sum(v for (d, _), v in seconds.items() if d == "card")
    cpu_s = sum(v for (d, _), v in seconds.items() if d == "cpu")
    print(f"p10 analysis on a batch of {ANALYSIS_BATCH} ({card}): card "
          f"equal to the CPU port (bytes {card_bpp['bytes']}, symbols; "
          f"floats rtol 1e-3 / atol 1e-4); actual bpp "
          f"{card_bpp['actual_bpp']:.6f}, estimated "
          f"{card_bpp['estimated_bpp']:.6f} (legacy "
          f"{card_bpp['estimated_bpp_legacy']:.6f}); y non-zero {y_nz:.4f}; "
          f"card ms {json.dumps(card_ms)} ({card_s:.3f} s), CPU "
          f"{cpu_s:.3f} s; launches {total}")
    return {"launches": total, "card_s": card_s}


def run_baseline(torch, ckpts, card):
    """Phase 10 (b): learned_baseline_rd over each checkpoint, on
    BASELINE_IMAGES CLEVR-style held-out scenes in batches of RD_BATCH:
    finite points with actual bpp > 0, the launches of check_bpp and an
    eval forward a batch, each point's wall time."""
    from mmnc_tpu_torch import analysis

    tasks = PAPER["shared4"][1]
    per_batch = {"encode": ANALYSIS_CALLS["check_bpp"]["encode"] + 1,
                 "decode": ANALYSIS_CALLS["check_bpp"]["decode"] + 1}
    batches = BASELINE_IMAGES // RD_BATCH
    want = {k: v * batches for k, v in part_launches(per_batch).items()}
    total = dict(ZERO)
    for path in ckpts:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        (point,) = analysis.learned_baseline_rd(
            [path], batch_size=RD_BATCH, n_images=BASELINE_IMAGES,
            data_style="clevr", device=CLI_DEVICE)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = counts()
        if got != want:
            raise RuntimeError(f"learned_baseline_rd: launches {got}, want "
                               f"{want}")
        for k in total:
            total[k] += got[k]
        values = [point[k] for k in point if "/" in k] + [
            point["estimated_bpp"], point["estimated_bpp_legacy"]]
        if not (point["bpp"] > 0 and point["n_images"] == BASELINE_IMAGES
                and np.all(np.isfinite(values))):
            raise RuntimeError(f"learned_baseline_rd point {point}")
        print(f"p10 learned_baseline_rd lambda {point['lmbda']:g} "
              f"({BASELINE_IMAGES} images, {card}): wall {seconds:.3f} s "
              f"(rebuild, load, tables, render, coding, forwards); actual "
              f"bpp {point['actual_bpp']:.6f}, estimated "
              f"{point['estimated_bpp']:.6f} (legacy "
              f"{point['estimated_bpp_legacy']:.6f}); "
              + ", ".join(f"{t} PSNR {point[f'{t}/psnr']:.4f} MS-SSIM "
                          f"{point[f'{t}/ms-ssim']:.5f}" for t in tasks))
    return {"launches": total, "batches": batches * len(ckpts),
            "per_batch": per_batch}


def graph_records(events):
    """The device records a CUDA graph launch started (their correlation
    id is that of a cudaGraphLaunch call), in the order they started."""
    graph = {e["args"]["correlation"] for e in events
             if e.get("cat", "").startswith("cuda_")
             and "GraphLaunch" in e.get("name", "")
             and "correlation" in e.get("args", {})}
    return sorted((e for e in events if e.get("cat") in DEVICE_WORK
                   and e.get("args", {}).get("correlation") in graph),
                  key=lambda e: e["ts"])


def is_nccl(record):
    return "nccl" in record["name"].lower()


def record_kind(record):
    """A device record's name, with a device-to-device copy called
    "memcpy" whether it ran as a copy (eager) or as the kernel a graph's
    memcpy node becomes ("memcpy32_post", ...)."""
    name = record["name"]
    if (record.get("cat") == "gpu_memcpy" and "DtoD" in name) or \
            name.startswith("memcpy"):
        return "memcpy"
    return name


def in_graph_reduction(replay_events, span_records):
    """The gradient all-reduce's nodes in a replayed step's graph records:
    the run of records whose kinds (`record_kind`) are, in order, those an
    eager step launched inside its `train.all_reduce` span
    (`span_records`: the flattening copies and the cat, NCCL's kernels,
    the division and the copy-backs) -> {"nodes", "nccl_ms", "copy_ms"
    (the other nodes)}, or None where no such run is found (the profiler
    lost records)."""
    names = [record_kind(e) for e in sorted(span_records,
                                            key=lambda e: e["ts"])]
    records = graph_records(replay_events)
    got = [record_kind(e) for e in records]
    for i in range(len(got) - len(names) + 1):
        if names and got[i:i + len(names)] == names:
            run = records[i:i + len(names)]
            return {"nodes": len(run),
                    "nccl_ms": sum(e["dur"] for e in run if is_nccl(e)) / 1e3,
                    "copy_ms": sum(e["dur"] for e in run
                                   if not is_nccl(e)) / 1e3}
    return None


def profile_dp_step(torch, call):
    """torch.profiler over one train call (`call()`) -> wall ms, device
    busy ms, the host ms of the gradient all-reduce's record_function
    spans and their device records, NCCL's kernels' device ms and the
    graph records (a replay's). One try: under a mesh every rank must
    take the same steps."""
    run = profiled(torch, call, tries=1)
    events, wall = run["events"], run["wall"] * 1e3
    device = [e for e in events if e.get("cat") in DEVICE_WORK]
    spans = [e["dur"] for e in events if e.get("cat") == "user_annotation"
             and e["name"] == "train.all_reduce"]
    in_span = launched_records(events, lambda n: n == "train.all_reduce")
    return {"wall_ms": wall, "busy_ms": busy_us(device) / 1e3,
            "all_reduce_ms": sum(spans) / 1e3, "all_reduce_spans": len(spans),
            "span_records": in_span,
            "span_device_ms": sum(e["dur"] for e in in_span) / 1e3,
            "nccl_kernel_ms": sum(e["dur"] for e in device
                                  if is_nccl(e)) / 1e3,
            "graph": graph_launches(events), "events": events}


def dp_fit(mesh, cache_dir, out_dir, steps, batch_size, steps_per_call=1,
           eager=False, val=False):
    """Phase 10 (c): `steps` steps of fit at shared4 from seed-0 weights at
    the init scale on `batch_size` scenes a step (under a mesh the rank's
    rows of them), `steps_per_call` steps a call, deterministic cuDNN,
    train metrics on, with `val` a validation over the scenes (an eval
    step a batch); then DP_TIMED_STEPS synchronised one-step calls and one
    profiled call, each as fit made them (graph replays on a card without
    a mesh or under an NCCL one; eager under gloo). With `eager` the
    loop's multi-step is made of eager steps and the eval step and the
    serving programs run under `graphs.disabled()` (the reference a
    graphed run is held to). A graphed mesh run also profiles one eager
    step after it: its `train.all_reduce` span names the nodes of the
    reduction in the replay's graph records (`in_graph_reduction`). A
    rank of `parallel.launch`, or (mesh None) the single process. ->
    {"trace": rank 0's logged train losses (one a call: the last step's),
    "val": the validation's logs, "params": the parameters after fit,
    "launches": fit's train calls' (counted through the wrappers: none of
    a replayed call's), "replayed": fit's steps in replayed graph calls,
    "calls": each of fit's train calls' kind, "all_launches": with the
    replayed calls' graph launches (`graph_launched`; the first replay
    profiled, `check_calls`) and the timed and profiled calls',
    "replay_kernel_ms" ({"train"/"eval": device ms of each `kernel_kind`
    in fit's profiled replay}), "step_ms", "profile", "eager_profile" (a
    graphed mesh run's eager step), "reduction" (`in_graph_reduction` of
    its profiled replay)}."""
    import torch

    from mmnc_tpu_torch import graphs
    from mmnc_tpu_torch.data import (BatchLoader, SyntheticMultiTaskDataset,
                                     prerender)
    from mmnc_tpu_torch.device import resolve_device
    from mmnc_tpu_torch.train import (fit, make_multi_train_step,
                                      make_train_step)
    from mmnc_tpu_torch.train.step import step_seed

    tally_graph_launches()  # a spawned rank: its eval replays are counted
    device = mesh.device if mesh is not None else resolve_device(CLI_DEVICE)
    tasks = PAPER["shared4"][1]
    data = prerender(SyntheticMultiTaskDataset(
        tasks, size=DP_STEPS * batch_size, image_size=IMAGE, seed=0,
        style="clevr"), cache_dir)
    name = ("single" if mesh is None else f"ranks{mesh.world_size}") + (
        f"_k{steps_per_call}" if steps_per_call > 1 else "") + (
        "_eager" if eager else "")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        model = cli_model(device)
        torch.cuda.synchronize(device)
        reset_counts()
        per_step = []
        with counted_steps(torch, per_step, eager, profile_replay=True), \
                (graphs.disabled() if eager else contextlib.nullcontext()):
            state, val_logs = fit(
                model, BatchLoader(data, batch_size),
                BatchLoader(data, batch_size, shuffle=False) if val else None,
                epochs=1, max_steps=steps, run_name=name, out_dir=out_dir,
                log_every=1, log_images=False,
                steps_per_call=steps_per_call,
                n_devices=None if mesh is None else mesh.world_size)
        torch.cuda.synchronize(device)
        train = [e for e in per_step if e["kind"] == "train"]
        launches = {k: sum(e["launches"][k] for e in train) for k in KERNELS}
        # steps whose launches ran in a replayed graph (on a card, but for
        # the eager reference and gloo ranks)
        replayed = steps_per_call * sum(e["how"] == "replay" for e in train)
        want = shared4_launches()
        check_calls(per_step, want, name, steps_per_call, profiled=True)
        in_graphs = graph_launched(per_step, {
            k: steps_per_call * c for k, c in want["train"].items()})
        # copied: on the CPU a tensor's numpy() shares its memory, which
        # the timed steps below update
        params = {k: v.detach().cpu().numpy().copy()
                  for k, v in model.state_dict().items()}
        trace = []
        if mesh is None or mesh.lead:
            with open(os.path.join(out_dir, name,
                                   f"{name}.metrics.jsonl")) as f:
                trace = [r["train/loss"] for r in map(json.loads, f)
                         if "train/loss" in r]
        multi = (eager_multi_step if eager else make_multi_train_step)(
            model, 1, compute_metrics=True, mesh=mesh)
        rows = slice(None) if mesh is None else mesh.rows(batch_size)
        batch = model.to_device(next(BatchLoader(data, batch_size).epoch(
            0, rows)))
        gen = torch.Generator(device=device)
        walls = []
        for _ in range(DP_TIMED_STEPS):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            multi(state, [batch], gen, 21)
            torch.cuda.synchronize(device)
            walls.append((time.perf_counter() - t0) * 1e3)
        prof = profile_dp_step(torch, lambda: multi(state, [batch], gen, 21))
        timed_replays = getattr(multi, "stats", {}).get("replays", 0)
        eager_prof, reduction = None, None
        if timed_replays and mesh is not None:
            gen.manual_seed(step_seed(21, state.step))
            step = make_train_step(model, mesh=mesh)
            eager_prof = profile_dp_step(torch, lambda: step(state, batch,
                                                             gen))
            reduction = in_graph_reduction(prof["events"],
                                           eager_prof["span_records"])
        torch.cuda.synchronize(device)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for p in (prof, eager_prof):
        if p is not None:
            del p["events"], p["span_records"]
    timed = {k: timed_replays * c for k, c in want["train"].items()}
    # the port's kernels' device ms in fit's profiled replays
    replay_ms = {e["kind"]: e["kernel_ms"] for e in per_step
                 if e.get("kernel_ms") is not None and e["how"] == "replay"}
    return {"trace": trace, "val": val_logs, "params": params,
            "replay_kernel_ms": replay_ms,
            "launches": launches, "replayed": replayed,
            "calls": [e["how"] for e in train],
            "all_launches": {k: c + in_graphs[k] + timed[k]
                             for k, c in counts().items()},
            "step_ms": float(np.median(walls)), "profile": prof,
            "eager_profile": eager_prof, "reduction": reduction}


def compress_batch(torch, model, batch_size, device):
    """Phase 10 (d)'s batch: `batch_size` random 256 px images of every
    task (seeded) on `device`."""
    return {t: torch.from_numpy(x).to(device) for t, x in
            model.example_batch(batch_size, IMAGE, seed=SEED + 20).items()}


def dp_compress(mesh, batch_size):
    """Phase 10 (d), a rank: shared4 (kernels scaled, from seed 0)
    compresses its rows of `batch_size` images with
    `compress_device_fused_sharded`: a warm-up call, one counted call
    (the program's capture: its gathered outputs, as numpy, and its
    launches) and DP_TIMED_STEPS synchronised calls (replays; their median
    ms). "all_launches": the counted and the timed calls' ("calls" of
    them), the replays' graph launches included."""
    import torch

    from mmnc_tpu_torch.parallel import compress_device_fused_sharded

    tally_graph_launches()  # a spawned rank: its replays are counted too
    model = paper_model("shared4", mesh.device)
    batch = compress_batch(torch, model, batch_size, mesh.device)
    compress_device_fused_sharded(model, batch, mesh)
    torch.cuda.synchronize(mesh.device)
    reset_counts()
    outs = compress_device_fused_sharded(model, batch, mesh)
    torch.cuda.synchronize(mesh.device)
    launches = counts()
    walls = []
    for _ in range(DP_TIMED_STEPS):
        t0 = time.perf_counter()
        compress_device_fused_sharded(model, batch, mesh)
        torch.cuda.synchronize(mesh.device)
        walls.append((time.perf_counter() - t0) * 1e3)
    return {"outs": [t.cpu().numpy() for t in outs], "launches": launches,
            "all_launches": counts(), "calls": 1 + DP_TIMED_STEPS,
            "ms": float(np.median(walls))}


def dp_fit_and_compress(mesh, cache_dir, out_dir, steps, batch_size,
                        ks=(1,), compress=True):
    """A rank of phase 10 (c), `dp_fit` at each number of steps a call in
    `ks` (under an NCCL mesh, whose calls are graphs, with validation, and
    then its eager reference at one step a call, "eager"), and then, with
    `compress`, of (d), `dp_compress` of `batch_size` images: one spawn
    for all of them."""
    fits = {k: dp_fit(mesh, cache_dir, out_dir, steps, batch_size, k,
                      val=mesh.captures) for k in ks}
    if mesh.captures:
        fits["eager"] = dp_fit(mesh, cache_dir, out_dir, steps, batch_size,
                               eager=True, val=True)
    out = {"fit": fits}
    if compress:
        out["compress"] = dp_compress(mesh, batch_size)
    return out


def check_sharded_compress(torch, ranks, batch_size, card, what):
    """Phase 10 (d): every rank's gathered symbols, indexes and max_abs
    bitwise equal one process's `_compress_device_fused` of the batch on
    the card, and the rANS streams coded from them are the bytes of its
    packed `compress`; 27 GDN launches a rank's call. Prints each side's
    synchronised ms."""
    from mmnc_tpu_torch.entropy import rans

    model = paper_model("shared4", CLI_DEVICE)
    batch = compress_batch(torch, model, batch_size, CLI_DEVICE)
    model._compress_device_fused(batch)
    torch.cuda.synchronize()
    walls = []
    for _ in range(DP_TIMED_STEPS):
        t0 = time.perf_counter()
        want = model._compress_device_fused(batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    want = [t.cpu().numpy() for t in want]
    n_enc = MT_LAUNCHES["shared4"]["compress"]
    for r, rank in enumerate(ranks):
        if rank["launches"] != as_counts(n_enc):
            raise RuntimeError(f"{what} rank {r}: launches "
                               f"{rank['launches']}, want {n_enc}")
        for name, got, w in zip(("y", "z", "indexes", "max_abs"),
                                rank["outs"], want):
            if got.dtype != w.dtype or not np.array_equal(got, w):
                raise RuntimeError(f"{what} rank {r}: {name} differs from "
                                   f"one process's")
    y_sym, z_sym, indexes, _ = ranks[0]["outs"]
    tables = model.tables
    b, zh, zw, _ = z_sym.shape
    ys = rans.encode_with_indexes(y_sym, indexes, tables.gc)
    zs = rans.encode_with_indexes(z_sym, model._z_index((b, zh, zw)),
                                  tables.eb)
    ans, n_bytes = model.compress(batch)
    if ans["strings"] != [[ys], [zs]]:
        raise RuntimeError(f"{what}: the gathered symbols code to other "
                           f"bytes than compress's")
    print(f"p10 sharded compress {what} ({card}): shared4 batch of "
          f"{batch_size} on {len(ranks)} ranks ({batch_size // len(ranks)} "
          f"rows each): symbols, indexes and max_abs bitwise equal one "
          f"process's, {n_bytes} bytes equal compress's; launches a rank "
          f"{ranks[0]['launches']}; synchronised call p50 "
          f"{json.dumps([round(r['ms'], 3) for r in ranks])} ms a rank vs "
          f"one process {float(np.median(walls)):.3f} ms")


def dp_scenes(tmp, n):
    """Render n CLEVR-style shared4 scenes into a cache under `tmp` (the
    ranks load it) -> (cache dir, seconds)."""
    from mmnc_tpu_torch.data import SyntheticMultiTaskDataset, prerender

    cache = os.path.join(tmp, "dp_cache")
    t0 = time.perf_counter()
    prerender(SyntheticMultiTaskDataset(
        PAPER["shared4"][1], size=n, image_size=IMAGE, seed=0,
        style="clevr"), cache)
    return cache, time.perf_counter() - t0


def check_dp(single, ranks, steps, what, k=1):
    """The ranks' fit (`k` steps a call) against the single process's (one
    a call): each run's launches (63 GDN a step, none counted for a
    replayed graph call's: the single process's and NCCL ranks'), the
    loss trace within rtol 1e-4 (a call logs its last step's loss), the
    parameters within rtol 2e-4 / atol 2e-6 (tests/test_train.py:95-103),
    every rank's bitwise equal. Returns the largest parameter diff."""
    train = as_counts(MT_LAUNCHES["shared4"]["train"])
    for name, run in [("single", single), *((f"rank {r}", run)
                                            for r, run in enumerate(ranks))]:
        counted = steps - run["replayed"]
        want = {k: counted * n for k, n in train.items()}
        if run["launches"] != want:
            raise RuntimeError(f"{what} {name}: launches {run['launches']}, "
                               f"want {want}")
    lead = ranks[0]
    single_trace = single["trace"][k - 1::k]
    if len(single["trace"]) != steps or len(lead["trace"]) != steps // k \
            or not np.all(np.isfinite(single["trace"])):
        raise RuntimeError(f"{what} traces {single['trace']} {lead['trace']}")
    if not np.allclose(lead["trace"], single_trace, rtol=1e-4, atol=0):
        raise RuntimeError(f"{what} loss trace: {len(ranks)} ranks "
                           f"{lead['trace']} vs one process "
                           f"{single_trace} (rtol 1e-4)")
    worst = 0.0
    for k, p in single["params"].items():
        for rank in ranks[1:]:
            if not np.array_equal(rank["params"][k], lead["params"][k]):
                raise RuntimeError(f"{what}: ranks' {k} differ")
        q = lead["params"][k]
        if not np.allclose(q, p, rtol=2e-4, atol=2e-6):
            raise RuntimeError(f"{what}: {k} max |diff| "
                               f"{np.abs(q - p).max()} (rtol 2e-4, "
                               f"atol 2e-6)")
        worst = max(worst, float(np.abs(q - p).max()))
    return worst


def check_eager_mesh(runs, what):
    """A gloo mesh's runs: every fit call eager, no step replayed."""
    for r, run in enumerate(runs):
        if run["replayed"] or set(run["calls"]) != {"eager"}:
            raise RuntimeError(f"{what} rank {r}: calls {run['calls']}, "
                               f"want eager calls only")


def check_graphed_mesh(graphed, eager, what):
    """NCCL ranks' graphed fit against their eager reference (the same
    rank, the loop's multi-step made of eager steps, the eval step under
    `graphs.disabled()`): each rank's calls a warm-up, a capture and at
    least two replays, its profiled replay's graph records (checked in
    `dp_fit`), and its loss trace, validation logs and parameters bitwise
    the eager run's (deterministic cuDNN)."""
    for r, (g, e) in enumerate(zip(graphed, eager)):
        calls = g["calls"]
        if calls[:2] != ["eager", "capture"] or \
                calls[2:] != ["replay"] * (len(calls) - 2) or len(calls) < 4:
            raise RuntimeError(f"{what} rank {r}: calls {calls}, want a "
                               f"warm-up, a capture and two replays or more")
        if g["trace"] != e["trace"] or g["val"] != e["val"] or not g["val"]:
            raise RuntimeError(f"{what} rank {r}: graphed losses "
                               f"{g['trace']} and validation {g['val']} vs "
                               f"eager {e['trace']}, {e['val']}")
        for k, p in e["params"].items():
            if not np.array_equal(g["params"][k], p):
                raise RuntimeError(f"{what} rank {r}: graphed {k} differs "
                                   f"from the eager run's (max |diff| "
                                   f"{np.abs(g['params'][k] - p).max()})")


def print_dp_run(prefix, name, run, batch, card):
    """A run's step p50 (images/s of its global batch) and a profiled
    step's busy share; an eager mesh step's all-reduce span (its share of
    the step, its device records' ms, NCCL's kernels'); a replayed one's
    graph records, NCCL's kernels' ms and the in-graph reduction's nodes
    (`in_graph_reduction`) beside the eager step's span."""
    prof = run["profile"]
    replays = prof["graph"] != ZERO
    line = (f"{prefix} {name} ({card}): step p50 {run['step_ms']:.3f} ms "
            f"(median of {DP_TIMED_STEPS} synchronised one-step calls, "
            f"{'graph replays' if replays else 'eager'}; "
            f"{batch / run['step_ms'] * 1e3:.3f} images/s at a global batch "
            f"of {batch}); profiled step wall {prof['wall_ms']:.3f} ms, busy "
            f"{prof['busy_ms']:.3f} ms "
            f"({prof['busy_ms'] / prof['wall_ms']:.4f})")
    if prof["all_reduce_spans"]:
        line += (f"; all-reduce span {prof['all_reduce_ms']:.3f} ms "
                 f"({prof['all_reduce_ms'] / prof['wall_ms']:.4f} of the "
                 f"step; its device records {prof['span_device_ms']:.3f} "
                 f"ms, NCCL kernels {prof['nccl_kernel_ms']:.3f} ms)")
    for kind, ms in run.get("replay_kernel_ms", {}).items():
        line += (f"; fit's profiled {kind} replay: GDN "
                 f"{ms.get('gdn', 0.0):.4f} ms, deconv+IGDN "
                 f"{ms.get('deconv_igdn', 0.0):.4f} ms, GDN backward "
                 f"{ms.get('gdn_backward', 0.0):.4f} ms (its sums "
                 f"{ms.get('gdn_backward_aux', 0.0):.4f} ms) of device")
    if replays:
        line += (f"; the replay's graph records {json.dumps(prof['graph'])}"
                 f", all-reduce spans {prof['all_reduce_spans']}, NCCL "
                 f"kernels {prof['nccl_kernel_ms']:.3f} ms")
    red, eager = run.get("reduction"), run.get("eager_profile")
    if eager is not None:
        line += (f"; in-graph gradient reduction: " + (
            "not measured (its nodes not found among the replay's "
            "records)" if red is None else
            f"{red['nodes']} nodes, NCCL {red['nccl_ms']:.3f} ms, "
            f"flattening, cat, division and copy-backs "
            f"{red['copy_ms']:.3f} ms") +
            f"; an eager step beside it: wall {eager['wall_ms']:.3f} ms, "
            f"span {eager['all_reduce_ms']:.3f} ms (device "
            f"{eager['span_device_ms']:.3f} ms, NCCL "
            f"{eager['nccl_kernel_ms']:.3f} ms)")
    print(line)


def run_parallel(torch, tmp, card):
    """Phase 10 (c): fit on DP_RANKS ranks on one card (DP_CARD) over gloo
    (NCCL takes one rank per card) against one process, the same seed
    weights and scenes under deterministic cuDNN (`check_dp`); the gloo
    ranks' calls stay eager. Then fit over NCCL at world size 1, whose
    calls and eval steps are graphs (a warm-up, a capture, replays),
    against its eager reference (`check_graphed_mesh`: bitwise) and the
    one process (`check_dp`). The gloo ranks also run fit at DP_K steps
    a call and then (d), the sharded compress of DP_BATCH images
    (`check_sharded_compress`). Prints each run's step p50, images/s,
    busy share and reduction (`print_dp_run`)."""
    from mmnc_tpu_torch.parallel import launch

    cache, render_s = dp_scenes(tmp, DP_STEPS * DP_BATCH)
    out = os.path.join(tmp, "dp")
    runs = {"single": dp_fit(None, cache, out, DP_STEPS, DP_BATCH)}
    t0 = time.perf_counter()
    gloo = launch(dp_fit_and_compress, DP_RANKS, DP_CARD, cache, out,
                  DP_STEPS, DP_BATCH, (1, DP_K), backend="gloo", timeout=600)
    gloo_s = time.perf_counter() - t0
    ranks = [r["fit"][1] for r in gloo]
    k2 = [r["fit"][DP_K] for r in gloo]
    compress = [r["compress"] for r in gloo]
    runs["gloo"] = ranks[0]
    t0 = time.perf_counter()
    (nccl,) = launch(dp_fit_and_compress, 1, CLI_DEVICE, cache, out,
                     DP_STEPS, DP_BATCH, (1,), False, timeout=600)
    nccl_s = time.perf_counter() - t0
    runs["nccl"], runs["nccl_eager"] = nccl["fit"][1], nccl["fit"]["eager"]
    check_eager_mesh(ranks + k2, "dp gloo")
    worst = check_dp(runs["single"], ranks, DP_STEPS, "dp")
    worst_k2 = check_dp(runs["single"], k2, DP_STEPS,
                        f"dp --steps-per-call {DP_K}", DP_K)
    print(f"p10 data parallel, {DP_K} steps a call ({card}): {DP_RANKS} "
          f"gloo ranks on {DP_CARD} vs one process at 1 a call: logged "
          f"losses {json.dumps(k2[0]['trace'])} vs "
          f"{json.dumps(runs['single']['trace'][DP_K - 1::DP_K])}, "
          f"parameters max |diff| {worst_k2:.3e}, ranks bitwise equal")
    check_sharded_compress(torch, compress, DP_BATCH, card,
                           f"{DP_RANKS} gloo ranks on {DP_CARD}")
    check_graphed_mesh([runs["nccl"]], [runs["nccl_eager"]], "dp nccl")
    worst_nccl = check_dp(runs["single"], [runs["nccl"]], DP_STEPS,
                          "dp nccl")
    print(f"p10 data parallel ({card}): {DP_STEPS} fit steps at a global "
          f"batch of {DP_BATCH}, {DP_RANKS} gloo ranks on {DP_CARD} "
          f"({DP_BATCH // DP_RANKS} rows each, eager calls) vs one process, "
          f"deterministic cuDNN: losses {json.dumps(runs['gloo']['trace'])} "
          f"vs {json.dumps(runs['single']['trace'])}, parameters max |diff| "
          f"{worst:.3e}, ranks bitwise equal; NCCL at world size 1: calls "
          f"{runs['nccl']['calls']} (graphs), losses "
          f"{json.dumps(runs['nccl']['trace'])}, validation "
          f"{len(runs['nccl']['val'])} logs, parameters bitwise its eager "
          f"reference's and max |diff| {worst_nccl:.3e} from one process's; "
          f"scenes rendered in {render_s:.3f} s; launch walls (spawn, CUDA "
          f"init, fit, timing) gloo {gloo_s:.3f} s (with the K = {DP_K} fit "
          f"and the sharded compress), nccl {nccl_s:.3f} s (graphed and "
          f"eager)")
    for name in ("single", "gloo", "nccl", "nccl_eager"):
        print_dp_run("p10 dp", name, runs[name], DP_BATCH, card)
    # every run's train steps (fit's, the timed and the profiled ones; the
    # graphed NCCL run's eager profiled step) and eval steps (the NCCL
    # runs' validation, a batch each of the DP_STEPS), and its launches,
    # counted in its process
    extra = DP_TIMED_STEPS + 1
    rows = DP_BATCH // DP_RANKS
    calls = {f"train{DP_BATCH}": 3 * (DP_STEPS + extra) + 1,
             f"train{rows}": 2 * DP_RANKS * (DP_STEPS + extra),
             f"encode{DP_BATCH}": 2 * DP_STEPS,
             f"decode{DP_BATCH}": 2 * DP_STEPS,
             f"encode{rows}": sum(c["calls"] for c in compress)}
    launches = {k: sum(r["all_launches"][k] for r in
                       [runs["single"], runs["nccl"], runs["nccl_eager"],
                        *ranks, *k2, *compress])
                for k in KERNELS}
    return {"calls": calls, "launches": launches,
            "compress": {"launches": {k: sum(c["launches"][k]
                                             for c in compress)
                                      for k in KERNELS},
                         "calls": len(compress), "key": f"encode{rows}"}}


def run_cards(torch, n, card):
    """`--dp-cards n`: phase 10 (c) and (d) across n cards, one rank a
    card over NCCL, DP_BATCH rows a rank (a global batch of n x
    DP_BATCH): each rank's fit graphed and then eager, against each other
    (`check_graphed_mesh`) and against one process at the global batch
    (`check_dp`), and the sharded compress (`check_sharded_compress`),
    with each run's step p50, images/s, busy share and reduction."""
    from mmnc_tpu_torch.parallel import launch

    batch = n * DP_BATCH
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cards_")
    try:
        cache, _ = dp_scenes(tmp, DP_STEPS * batch)
        out = os.path.join(tmp, "dp")
        single = dp_fit(None, cache, out, DP_STEPS, batch)
        t0 = time.perf_counter()
        ranks = launch(dp_fit_and_compress, n, "cuda", cache, out, DP_STEPS,
                       batch, timeout=600)
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check_sharded_compress(torch, [r["compress"] for r in ranks], batch,
                           card, f"{n} NCCL ranks, one a card")
    eager = [r["fit"]["eager"] for r in ranks]
    ranks = [r["fit"][1] for r in ranks]
    check_graphed_mesh(ranks, eager, f"{n} cards")
    worst = check_dp(single, ranks, DP_STEPS, f"{n} cards")
    print(f"cards: {DP_STEPS} fit steps at a global batch of {batch}, {n} "
          f"NCCL ranks, one a card ({DP_BATCH} rows each), vs one process "
          f"({card} each), deterministic cuDNN: calls {ranks[0]['calls']} "
          f"(graphs; every rank's bitwise its eager reference's, "
          f"validation included), losses {json.dumps(ranks[0]['trace'])} "
          f"vs {json.dumps(single['trace'])}, parameters max |diff| "
          f"{worst:.3e}, ranks bitwise equal; launch wall {seconds:.3f} s")
    print_dp_run("cards", "single", single, batch, card)
    for r, (run, ref) in enumerate(zip(ranks, eager)):
        print_dp_run("cards", f"rank {r}", run, batch, card)
        print_dp_run("cards", f"rank {r} eager", ref, batch, card)


def run_phase10(torch, card):
    """Phase 10: the sweep, the analysis on its checkpoints and data
    parallelism. Returns the launches and the calls of each of phase 3's
    shape groups they came from."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p10_")
    try:
        t0 = time.perf_counter()
        sweep = run_sweep(torch, tmp, card)
        analysis = run_analysis(torch, sweep["ckpts"][0], card)
        baseline = run_baseline(torch, sweep["ckpts"], card)
        dp = run_parallel(torch, tmp, card)
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    calls = {}
    for key, n in [(f"train{RD_BATCH}", sweep["n"]["train"]),
                   (f"encode{RD_BATCH}", sweep["n"]["eval"]),
                   (f"decode{RD_BATCH}", sweep["n"]["eval"]),
                   *((f"{part}{ANALYSIS_BATCH}", c.get(part, 0))
                     for c in ANALYSIS_CALLS.values()
                     for part in ("encode", "decode")),
                   *((f"{part}{RD_BATCH}", baseline["batches"] * n)
                     for part, n in baseline["per_batch"].items()),
                   *dp["calls"].items()]:
        calls[key] = calls.get(key, 0) + n
    launches = {k: sum(part["launches"][k] for part in
                       (sweep, analysis, baseline, dp))
                for k in KERNELS}
    for k, n in launches.items():
        if n == 0:
            raise RuntimeError(f"kernel {k} never launched in phase 10")
    print(f"p10 ({card}): {seconds:.3f} s; launches {launches}")
    return {"launches": launches, "calls": calls, "compress": dp["compress"]}


def p10_sums(p10, tot, kernel):
    """The kernels line's phase 10 entries of `kernel`: its launches, and
    phase 3's times summed over them (each shape group's sums times the
    calls of it); the two counts must agree."""
    fields = [f for f in ("ms", "plain_ms", "bound_ms", "library_ms")
              if f in next(iter(tot.values()))]
    out = {"p10_launches": p10["launches"][kernel],
           **{f"p10_{f}": 0.0 for f in fields}}
    reckoned = 0
    for key, n in p10["calls"].items():
        if key not in tot:  # deconv+IGDN: no train or encode launches;
            continue        # the backward: no encode or decode
        reckoned += n * tot[key]["launches"]
        for field in fields:
            out[f"p10_{field}"] += n * tot[key][field]
    if reckoned != p10["launches"][kernel]:
        raise RuntimeError(f"{kernel}: phase 3 reckoned {reckoned} launches "
                           f"in phase 10, it counted "
                           f"{p10['launches'][kernel]}")
    return out


def profile_round_trip(torch, model, batch, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    run = profiled(torch, lambda: model.decompress(model.compress(batch)[0]),
                   os.path.join(out_dir, "round_trip_trace.json"))
    wall = run["wall"]
    table = run["prof"].key_averages().table(sort_by="cuda_time_total",
                                             row_limit=40)
    # device work only, as in time_ms
    events = [e for e in run["events"] if e.get("cat") in DEVICE_WORK]
    busy_us = sum(e["dur"] for e in events)
    with open(os.path.join(out_dir, "round_trip_profile.txt"), "w") as f:
        f.write(f"wall {wall * 1e3:.3f} ms, device kernel time {busy_us / 1e3:.3f}"
                f" ms, {len(events)} device events (the table's \"Activity "
                f"Buffer Request\" row is the profiler's own)\n{table}\n")
    print(f"profile: wall {wall * 1e3:.3f} ms, device kernel time "
          f"{busy_us / 1e3:.3f} ms ({busy_us / 1e3 / (wall * 1e3):.3f} of wall)"
          f", {len(events)} device events -> {out_dir}")


def cli_sums(cli, tot, kernel, steps):
    """The kernels line's phase 9 entries of `kernel`: launches over the
    train CLI's run and a step's, phase 3's times at a step's shapes."""
    out = {"cli_launches": cli["launches"][kernel]}
    for step in steps:
        count = cli["per_step"]["train" if step == "train" else "eval"]
        key = f"cli_{step}"
        if tot[key]["launches"] != count[kernel]:
            raise RuntimeError(f"{kernel}: phase 3 reckoned "
                               f"{tot[key]['launches']} launches a {step} "
                               f"step, phase 9 counted {count[kernel]}")
        out.update({f"{key}_launches_per_step": count[kernel],
                    f"{key}_isolated_ms": tot[key]["ms"],
                    f"{key}_plain_ms": tot[key]["plain_ms"],
                    f"{key}_bound_ms": tot[key]["bound_ms"]})
        if "library_ms" in tot[key]:
            out[f"{key}_library_ms"] = tot[key]["library_ms"]
    return out


def new_path_sums(p5, cli, p10, imported, tot, kernel):
    """The kernels line's entries of `kernel` on this slice's paths: each
    path's launches and phase 3's device / plain / bound (and library)
    ms summed over them, the launches phase 3 reckoned checked against
    the counted ones."""
    fields = [f for f in ("ms", "plain_ms", "bound_ms", "library_ms")
              if f in next(iter(tot.values()))]
    out = {"import_launches": imported[kernel]}
    k = cli["k_calls"]["per_call"][kernel]
    compress = p10["compress"]
    for prefix, launches, key, n in (
            ("p5_shared4", p5[kernel], "shared4", BATCHES),
            ("cli_k4_call", k, "cli_train", CLI_K),
            ("p10_compress", compress["launches"][kernel], compress["key"],
             compress["calls"])):
        reckoned = n * tot[key]["launches"] if key in tot else 0
        if reckoned != launches:
            raise RuntimeError(f"{kernel} {prefix}: phase 3 reckoned "
                               f"{reckoned} launches, counted {launches}")
        out[f"{prefix}_launches"] = launches
        for f in fields:
            out[f"{prefix}_{f}"] = n * tot[key][f] if key in tot else 0.0
    out["cli_k4_launches"] = cli["k_calls"]["launches"][kernel]
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("--profile", default=None,
                        help="write a profiler summary of one round trip here")
    parser.add_argument("--dp-cards", type=int, default=None,
                        help="run only phase 10 (c) across this many cards "
                             "(one NCCL rank a card) against one process")
    parser.add_argument("--time-deconv", metavar="TREE", default=None,
                        help="run only phase 3's deconv+IGDN checks and "
                             "times at an rgb and a shared4 round trip's "
                             "shapes, on the mmnc_tpu_torch of the checkout "
                             "at TREE")
    parser.add_argument("--time-gdn-backward", metavar="TREE", default=None,
                        help="run only phase 3's GDN backward checks and "
                             "times, on the mmnc_tpu_torch of the checkout "
                             "at TREE")
    parser.add_argument("--profile-windows", metavar="N", type=int,
                        default=None,
                        help="run only N rounds of profiled train steps "
                             "in windows with and without the host wait, "
                             "counting the windows that lost records")
    args = parser.parse_args(argv)
    tree = args.time_deconv or args.time_gdn_backward
    if tree:
        sys.path.insert(0, os.path.abspath(tree))

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
    if args.time_deconv:
        libs = _build.build(["deconv_igdn"])
        print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
        time_deconv(torch, args.time_deconv, card)
        return 0
    if args.time_gdn_backward:
        libs = _build.build(["gdn_backward"])
        print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
        time_gdn_backward(torch, args.time_gdn_backward, card)
        return 0
    libs = _build.build_all()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    if args.profile_windows:
        profile_windows(torch, args.profile_windows, card)
        return 0
    if args.dp_cards:
        run_cards(torch, args.dp_cards, "; ".join(card.splitlines()))
        print_ok(torch)
        return 0

    phase_s = {}

    def timed(name, fn, *fn_args):
        t = time.perf_counter()
        out = fn(*fn_args)
        phase_s[name] = round(time.perf_counter() - t, 3)
        return out

    gen = torch.Generator().manual_seed(SEED)
    gdn_tot, gdn_err, gdn_tol = timed("3 gdn", check_gdn, torch, BATCH, gen)
    dec_tot, dec_err, dec_tol = timed("3 deconv_igdn", check_deconv, torch,
                                      BATCH, gen)
    bwd_tot, bwd_err, bwd_tol = timed("3 gdn_backward", check_gdn_backward,
                                      torch, gen)

    tally_graph_launches()
    launches, model, batches, trips = timed("4", run_model, torch,
                                            args.profile, card)
    for name in SERVING:
        if launches[name] == 0:
            raise RuntimeError(f"kernel {name} never launched on the rgb path")
    p5_rgb = timed("5", run_streaming, torch, model, batches, args.profile,
                   card)
    timed("stale", check_stale_parameters, torch, card)
    timed("6", run_widths, torch)
    train = timed("7 (a)-(d)", run_train, torch, args.profile)
    train["graph"] = timed("7 (e)", run_graph_train, torch, card)
    mt = timed("8", run_multitask, torch, args.profile, card)
    bf = timed("bf16", run_bf16, torch, model, batches, train, mt, trips,
               args.profile, card)
    for name in SERVING:
        if bf["launches"][name] == 0:
            raise RuntimeError(f"kernel {name} never launched on the bf16 "
                               f"rgb path")
    del model, batches
    p5, p5_s4 = timed("5 shared4", run_mt_streaming, torch, args.profile,
                      mt, card)
    imported = timed("import", run_import, torch)
    cli = timed("9", run_cli, torch, args.profile, card)
    p10 = timed("10", run_phase10, torch, card)
    print(f"phase seconds: {json.dumps(phase_s)}")
    for name in SERVING:
        n = mt["launches"][name]
        # phase 3 summed its times over the launches its shape lists give
        per_trip = dec_tot if name == "deconv_igdn" else gdn_tot
        if n == 0 or n != BATCHES * per_trip["shared4"]["launches"]:
            raise RuntimeError(f"kernel {name}: {n} launches on the shared4 "
                               f"path, phase 3 reckoned "
                               f"{per_trip['shared4']['launches']} a round "
                               f"trip")

    for name, n in cli["launches"].items():
        if n == 0:
            raise RuntimeError(f"kernel {name} never launched by the CLIs")
    for what, got in (("phase 5's shared4 stream", p5),
                      ("the imported model's round trip", imported)):
        for name in SERVING:
            if got[name] == 0:
                raise RuntimeError(f"kernel {name} never launched in {what}")

    def graphed_sums(runs, kernel, tot, key):
        g, e = runs["graphed"]["profile"], runs["eager"]["profile"]
        return {"graph_launches": g["graph"][kernel],
                "ms": g["by_kernel"].get(kernel, 0.0),
                "eager_ms": e["by_kernel"].get(kernel, 0.0),
                "bound_ms": tot[key]["bound_ms"],
                "library_ms": (tot[key]["library_ms"]
                               if kernel == "deconv_igdn" else None)}

    def graphed(kernel, tot):
        return {"rgb": graphed_sums(trips, kernel, tot, "trip"),
                "shared4": graphed_sums(mt["trips"], kernel, tot,
                                        "shared4")}

    def step_sums(tot, key):
        t = tot[key]
        return {"launches_per_step": t["launches"], "ms": t["ms"],
                "host_ms": t["host_ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": max(t["by"], key=t["by"].get),
                "library_ms": None, "cuda_core_ms": t["cuda_core_ms"],
                "tc_bound_ms": t["tc_bound_ms"],
                "mma_launches_per_step": round(t["mma_launches"])}

    backward_times = (
        f"launches: phase 7 (b)'s {TRAIN_STEPS} rgb train steps at batch "
        f"{TRAIN_BATCH}; ms, host_ms, plain_ms, bound_ms: phase 3, summed "
        f"over one such step's backward launches (device time, "
        f"torch.profiler; the kernel's rows kernel and its sum of the "
        f"blocks' partials) on the plan's path, cuda_core_ms the same on "
        f"the CUDA cores' path at every launch (timed in turns with the "
        f"tensor cores' where those have a plan), tc_bound_ms the bound "
        f"with the products on the tensor cores in 3xTF32 "
        f"(gdn_backward_tc_bound), mma_launches_per_step the launches the "
        f"plan gives the tensor cores; no library call computes the "
        f"closed form "
        f"(library_ms null); train_step_ms: the backward kernel's records in "
        f"phase 7's profiled step, train_step_nodes_ms every device record "
        f"launched in its 18 autograd nodes (the kernel and the gradients' "
        f"contiguous copies); shared4_train: phase 8's step at batch "
        f"{MT_TRAIN_BATCH}; bf16_train: phase \"bf16\"'s rgb step "
        f"(2 bytes an activation value; the profiled step's kernel and "
        f"node ms); cli_*, p10_*, p5_*, import_*, cli_k4_*, p10_compress_* "
        f"as the gdn entry's (cli_train_cuda_core_ms, cli_train_tc_bound_ms "
        f"as cuda_core_ms and tc_bound_ms at phase 9's step)")

    def sums(tot, key, library):
        t = tot[key]
        return {"launches_per_round_trip": t["launches"], "ms": t["ms"],
                "host_ms": t["host_ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": max(t["by"], key=t["by"].get),
                "library_ms": t["library_ms"] if library else None}

    times = (f"launches: phase 8's shared4 run ({BATCHES} round trips of a "
             f"batch of {BATCH}); ms, host_ms, plain_ms, bound_ms, "
             f"library_ms: phase 3, summed over one shared4 round trip's "
             f"launches (device time, torch.profiler; host_ms: CUDA events "
             f"over back-to-back calls); rgb: the same for phase 4's bench "
             f"config (launches over its {BATCHES} round trips); train_*: "
             f"phase 7, batch {TRAIN_BATCH}; train_graph_launches_per_call"
             f": a replayed call's kernel records launched by its graph "
             f"(phase 7 (e), torch.profiler); train_step_ms, "
             f"train_backward_ms: in one profiled step; train_isolated_ms, "
             f"train_plain_ms: phase 3 at the step's shapes; "
             f"shared4_train_*: phase 8's step at batch {MT_TRAIN_BATCH}; "
             f"cli_*: phase 9 (the train CLI at shared4, batch {CLI_BATCH}): "
             f"cli_launches over its run, the wrappers' counts and, for "
             f"each replayed train call, the launches its graph made (a "
             f"call's count, as the replays' graph records in the profiled "
             f"steps 5-10 show it), *_per_step a train and a "
             f"validation step, cli_*_isolated_ms and cli_*_plain_ms phase 3 "
             f"at those steps' shapes; p10_*: phase 10 (the sweep, the "
             f"analysis and data parallelism at shared4): p10_launches "
             f"over it, every process's, the replayed calls' graph launches "
             f"included (a call's count each, as a profiled replay's "
             f"records showed it), p10_ms, p10_plain_ms and "
             f"p10_bound_ms phase 3's sums over those launches; p5_shared4_*"
             f": phase 5's shared4 stream (v2, {BATCHES} batches of "
             f"{BATCH}), its launches and phase 3's sums over them; "
             f"cli_k4_*: phase 9's train CLI at --steps-per-call {CLI_K} "
             f"(its run's launches, its replays' graph launches included as "
             f"cli_launches', a call's, phase 3's sums at a call's "
             f"shapes); p10_compress_*: phase 10 (d)'s sharded compress, "
             f"the ranks' counted call; import_launches: the imported "
             f"model's round trip of {BATCH}; bf16: phase \"bf16\" (the "
             f"rgb codec in bf16, {BATCHES} round trips of {BATCH}: its "
             f"launches; ms, plain_ms, bound_ms (2 bytes an activation "
             f"value), library_ms summed over one rgb round trip's launches, "
             f"shared4 one shared4 round trip's, train one train step's at "
             f"batch {TRAIN_BATCH}); graphed_trip: phases 4 (rgb) and 8 "
             f"(shared4), one profiled round trip of a batch of {BATCH} "
             f"replayed from the serving graphs: the kernel's records "
             f"launched by the graphs (graph_launches) and their device ms "
             f"(ms), the same trip's device ms eager (eager_ms), phase 3's "
             f"bound and library sums over a trip's launches)")
    kernels = [
        {"name": "gdn", "route": "cuda", "source": "mmnc_tpu_torch/csrc/gdn.cu",
         "replaces": "mmnc_tpu/ops/gdn_pallas.py:52",
         "launches": mt["launches"]["gdn"], "max_abs_err": gdn_err,
         "tolerance": f"{gdn_tol} x max(1, |plain|max)",
         **sums(gdn_tot, "shared4", False), "times": times,
         "rgb": dict(sums(gdn_tot, "trip", False), launches=launches["gdn"]),
         "train_launches_per_step": {
             k: v["gdn"] for k, v in train["launches"].items()},
         "train_step_ms": train["gdn_ms"],
         "train_isolated_ms": gdn_tot["train"]["ms"],
         "train_plain_ms": gdn_tot["train"]["plain_ms"],
         "train_bound_ms": train["bound_ms"],
         "train_backward_ms": train["gdn_backward_ms"],
         "train_backward_bound_ms": train["backward_bound_ms"],
         "train_graph_launches_per_call": {
             f"K={k}": v["gdn"] for k, v in train["graph"].items()},
         "shared4_train_launches_per_step": mt["train_launches"]["gdn"],
         "shared4_train_isolated_ms": gdn_tot["shared4_train"]["ms"],
         "shared4_train_plain_ms": gdn_tot["shared4_train"]["plain_ms"],
         "shared4_train_bound_ms": gdn_tot["shared4_train"]["bound_ms"],
         **cli_sums(cli, gdn_tot, "gdn", ("train", "val")),
         **p10_sums(p10, gdn_tot, "gdn"),
         **new_path_sums(p5, cli, p10, imported, gdn_tot, "gdn"),
         "bf16": bf16_sums(bf, "gdn"), "graphed_trip": graphed("gdn",
                                                               gdn_tot)},
        {"name": "deconv_igdn", "route": "cuda",
         "source": "mmnc_tpu_torch/csrc/deconv_igdn.cu",
         "replaces": "mmnc_tpu/ops/deconv_igdn_pallas.py:66",
         "launches": mt["launches"]["deconv_igdn"], "max_abs_err": dec_err,
         "tolerance": f"{dec_tol} x max(1, |plain|max)",
         **sums(dec_tot, "shared4", True), "times": times,
         "rgb": dict(sums(dec_tot, "trip", True),
                     launches=launches["deconv_igdn"]),
         "train_launches_per_step": {
             k: v["deconv_igdn"] for k, v in train["launches"].items()},
         "shared4_train_launches_per_step":
             mt["train_launches"]["deconv_igdn"],
         **cli_sums(cli, dec_tot, "deconv_igdn", ("val",)),
         **p10_sums(p10, dec_tot, "deconv_igdn"),
         **new_path_sums(p5, cli, p10, imported, dec_tot, "deconv_igdn"),
         "bf16": bf16_sums(bf, "deconv_igdn"),
         "graphed_trip": graphed("deconv_igdn", dec_tot)},
        {"name": "gdn_backward", "route": "cuda",
         "source": "mmnc_tpu_torch/csrc/gdn_backward.cu",
         "replaces": "mmnc_tpu/ops/gdn_pallas.py:85",
         "launches": train["run_launches"]["gdn_backward"],
         "max_abs_err": max(bwd_err),
         "max_abs_err_dx_dgamma_dbeta": bwd_err,
         "tolerance": f"{bwd_tol} x max(1, |plain|max) for dx, dgamma and "
                      f"dbeta each; a bf16 dx {BF16_TOL} x max(1, "
                      f"|plain|max)",
         **step_sums(bwd_tot, "train"), "times": backward_times,
         "train_launches_per_step": {
             k: v["gdn_backward"] for k, v in train["launches"].items()},
         "train_step_ms": train["gdn_backward_kernel_ms"],
         "train_step_nodes_ms": train["gdn_backward_ms"],
         "train_graph_launches_per_call": {
             f"K={k}": v["gdn_backward"] for k, v in train["graph"].items()},
         "shared4_train": dict(step_sums(bwd_tot, "shared4_train"),
                               launches_per_step=mt["train_launches"][
                                   "gdn_backward"]),
         "bf16_train": dict(step_sums(bwd_tot, "bf16_train"),
                            launches_per_step=bf["train_launches"][
                                "gdn_backward"],
                            step_ms=bf["train_profile"][
                                "gdn_backward_kernel_ms"],
                            step_nodes_ms=bf["train_profile"][
                                "gdn_backward_ms"]),
         **cli_sums(cli, bwd_tot, "gdn_backward", ("train",)),
         "cli_train_cuda_core_ms": bwd_tot["cli_train"]["cuda_core_ms"],
         "cli_train_tc_bound_ms": bwd_tot["cli_train"]["tc_bound_ms"],
         **p10_sums(p10, bwd_tot, "gdn_backward"),
         **new_path_sums(p5, cli, p10, imported, bwd_tot, "gdn_backward")},
    ]
    print(json.dumps({"kernels": kernels}))
    print_ok(torch)
    return 0


def profile_windows(torch, rounds, card):
    """`--profile-windows N`: N rounds of two profiled train steps on
    phase 7's rgb model and batch (after 3 unprofiled steps), one in a
    window whose work starts at once and one in a window held open
    PROFILE_WAIT_S before it and after it, each taken once; then one JSON
    line: per wait, the windows that lost launches' records and the most
    launches one lost."""
    rng = np.random.default_rng(SEED + 1)
    batch = {"rgb": torch.from_numpy(rng.random(
        (TRAIN_BATCH, IMAGE, IMAGE, 3), dtype=np.float32)).cuda()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    state, step = train_setup(train_model("cuda"))
    for _ in range(3):
        step(state, batch, gen)
    lost = {0.0: [], PROFILE_WAIT_S: []}
    for _ in range(rounds):
        for wait, got in lost.items():
            got.append(profiled(torch, lambda: step(state, batch, gen),
                                tries=1, wait=wait)["lost"])
    print(json.dumps({"card": card, "rounds": rounds, "lost": {
        str(wait): {"windows": sum(n > 0 for n in got), "most": max(got)}
        for wait, got in lost.items()}}))


# bf16 shapes whose tensor-core plans have the n8 tiles a warp (kNT) that
# no launch of the other groups plans: 5 and 8 (the 32x32 stage of an rgb
# codec of conv 80 and 128), 6 in one N group (conv 96) and 1 (shared4's
# 32x32 stage in a decode of one image)
MMA_NT_SHAPES = [(BATCH, 32, 32, 40, 40, "igdn"),
                 (BATCH, 32, 32, 64, 64, "igdn"),
                 (BATCH, 32, 32, 48, 48, "igdn"), (1, 32, 32, 21, 21, "igdn")]


def time_deconv(torch, tree, card):
    """`--time-deconv TREE`: phase 3's deconv+IGDN checks and device times
    (the split shapes' forced tiled plans left out; where the plan is the
    tensor-core kernel, the CUDA-core tiled kernel checked and timed beside
    it in turns) at every launch shape of an rgb and a shared4 round trip
    of BATCH images, of the bench's rgb trip of BENCH_BATCH, of an rgb trip
    at conv 192 ("conv192") and of MMA_NT_SHAPES ("nt"), in float32 and in
    bf16, on the kernel of the checkout at TREE; then one JSON line: each
    shape's numbers and each group's sums of the kernel's, the CUDA-core
    path's and the library call's device ms."""
    from mmnc_tpu_torch.ops import deconv_igdn

    if not deconv_igdn.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {deconv_igdn.__file__}, not {tree}'s")
    gen = torch.Generator().manual_seed(SEED)
    groups = [(deconv_path_shapes(BATCH), "trip"),
              (mt_deconv_shapes(paper_layout(*PAPER["shared4"]), BATCH),
               "shared4"), (deconv_path_shapes(BENCH_BATCH), "bench"),
              (deconv_path_shapes(BATCH, 192), "conv192"),
              (MMA_NT_SHAPES, "nt")]
    rows, sums = [], {}
    for dtype, tag, tol in ((None, "f32", 1e-4),
                            (torch.bfloat16, "bf16", BF16_TOL)):
        tot, _ = check_deconv_cases(torch, gen, groups, tol, dtype,
                                    forced=False, rows=rows)
        for key, t in tot.items():
            sums[f"{tag}_{key}"] = {k: t.get(k) for k in (
                "launches", "ms", "library_ms", "plain_ms", "bound_ms",
                "cuda_core_ms", "mma_launches")}
    print(json.dumps({"tree": tree, "card": card, "sums": sums,
                      "shapes": rows}))


def print_ok(torch):
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
