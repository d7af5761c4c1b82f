"""The four codec variants (mmnc_tpu/models/codecs.py:44-728).

* SingleTaskCompressor              (model 1: mixed, one task, no weighting)
* MultiTaskMixedLatentCompressor    (model 2: one latent for all tasks)
* MultiTaskDisjointLatentCompressor (model 3: one y slice per task)
* MultiTaskSharedLatentCompressor   (model 4: per-task slices + a shared one)

Model-level calls take and return NHWC dicts ({task: (B, H, W, C)}), like
the JAX package; inside, activations are NCHW in channels_last memory
format. Parameters live in `nn.Module`s named after the reference's
state_dict (`model.input_heads.{t}.{seq}`, `model.compressor.{g_a,g_s,
h_a,h_s}.{seq}`, `model.compressor.entropy_bottleneck.*`,
`model.output_heads.{t}.{seq}`, `loss_balancer.log_vars`), so mmnc_tpu's
`import_reference_state_dict` reads any state_dict of this port.

Disjoint and shared build no g_s: their y_hat goes straight to per-task
output heads, each an upsample stack (indices 0-6) before a decoder head
(index 7), fed the task's y slice (shared: plus the last, shared block).
Their latent is cut to equal blocks (`_adjust_latent`), and each block
can be coded as its own stream (`compress_partial`), so a subset of the
tasks decodes from a subset of the code (`decompress_tasks`).

Each codec has the serving path (`init(seed)`, eval `forward`,
`update_bottleneck_values`, `compress`, `decompress` in both call forms),
partial coding, the analysis entry points (`encode_eval`,
`decode_from_latents`, `corrected_geometry_twin`), the device programs of
the streaming round trip (`models/streaming.py`) and the training side:
the noise-quantized training `forward`, `loss_and_logs` (loss = lmbda *
rec + rate, codecs.py:295-309) and `aux_loss`, which `train/step.py`
drives.

The device programs (the eval forward, `encode_eval`, the compress
programs, the index and synthesis programs, the partial decode's
`_synthesize_task`) are `graphs.program`s: on a card each runs as a CUDA
graph after a warm-up call and a capture, the counterpart of the JAX
class's jitted methods; host uploads, downloads, the rANS coder and the
guards between programs stay on the host.

`dtype=torch.bfloat16` builds the mixed-precision codec of the JAX
package's `dtype=jnp.bfloat16` (codecs.py:55-83, 171-204): parameters stay
float32, the layers' activations are bf16 (the encoder heads cast the
batch), the entropy models and the losses compute in float32, so the
likelihoods and the loss are float32 and the x_hats bf16. Rounded y and z
are coded as in float32. `hyper_parameters` does not record the dtype, as
the JAX class's does not: a codec rebuilt from a checkpoint is float32.
"""

import copy
from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn as nn

from .. import graphs
from ..data.task_configs import task_parameters
from ..device import resolve_device
from ..entropy import gaussian_conditional as gc
from ..entropy import rans
from ..entropy.tables import CdfTable, build_eb_table, build_gc_table
from ..ops.layers import Conv
from ..ops.quant import uniform_noise
from . import losses as L
from .backbone import ScaleHyperprior
from .heads import DecoderHead, EncoderHead, UpsampledDecoderHead

VARIANTS = ("mixed", "disjoint", "shared")


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _host(x) -> np.ndarray:
    return _nhwc(x).contiguous().cpu().numpy()


@dataclass
class CodecTables:
    """Host-side range-coding state built from the current params."""
    eb: CdfTable
    eb_medians: np.ndarray
    gc: CdfTable


class CodecNet(nn.Module):
    """Variant-switched multi-task graph: encoder heads -> ScaleHyperprior
    -> output heads (mmnc_tpu/models/codecs.py:44-141), NCHW inside."""

    def __init__(self, variant, input_channels, output_channels,
                 latent_channels, conv_channels, channels_per_task,
                 dtype=torch.float32):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"variant must be one of {VARIANTS}, got "
                             f"{variant!r}")
        n_tasks = len(input_channels)
        total = conv_channels * n_tasks
        self.variant = variant
        self.channels_per_task = channels_per_task
        self.input_heads = nn.ModuleList(
            [EncoderHead(ic, conv_channels, dtype) for ic in input_channels])
        self.compressor = ScaleHyperprior(total, latent_channels,
                                          use_gs=(variant == "mixed"),
                                          dtype=dtype)
        if variant == "mixed":
            heads = [DecoderHead(total, oc, dtype) for oc in output_channels]
        else:
            width = channels_per_task * (2 if variant == "shared" else 1)
            heads = [UpsampledDecoderHead(width, conv_channels, n_tasks, oc,
                                          dtype)
                     for oc in output_channels]
        self.output_heads = nn.ModuleList(heads)

    def encode_heads(self, xs):
        return torch.cat([head(x) for head, x in zip(self.input_heads, xs)],
                         dim=1)

    def analyze(self, xs):
        return self.compressor.analyze(self.encode_heads(xs))

    def decode_one_head(self, u, i: int):
        """Task i from the synthesized tensor (mixed) or y_hat: disjoint
        takes its slice, shared its slice and the last (shared) block."""
        if self.variant != "mixed":
            c = self.channels_per_task
            own = u[:, i * c:(i + 1) * c]
            u = own if self.variant == "disjoint" else torch.cat(
                [own, u[:, -c:]], dim=1)
        return self.output_heads[i](u)

    def decode_heads(self, u):
        return [self.decode_one_head(u, i)
                for i in range(len(self.output_heads))]

    def synthesize_one_task(self, y_hat, i: int):
        return self.decode_one_head(self.compressor.synthesize(y_hat), i)

    def synthesize_from_y(self, y_hat):
        return self.decode_heads(self.compressor.synthesize(y_hat))

    def forward(self, xs, training: bool = False, noise=None,
                legacy_broadcast: bool = True):
        out = self.compressor(self.encode_heads(xs), training, noise,
                              legacy_broadcast)
        return self.decode_heads(out["x_hat"]), out["likelihoods"]

    def aux_loss(self):
        return self.compressor.aux_loss()


class LossBalancer(nn.Module):
    """Uncertainty weighting's per-task log variances, zeros at init."""

    def __init__(self, n_tasks):
        super().__init__()
        self.log_vars = nn.Parameter(torch.zeros(n_tasks))

    @torch.no_grad()
    def init_parameters(self, generator):
        del generator  # deterministic init
        self.log_vars.zero_()


class MultiTaskCompressorBase(nn.Module):
    """What the four codecs share.

    Runs on `device` (CUDA unless given; raises with no card and no
    device). Weights are drawn from `seed` with a CPU torch.Generator, so
    the same seed gives the same model on any device. `lmbda` and the two
    learning rates default to the JAX class's (codecs.py:160-171);
    `train.create_train_state` trains at these rates unless given others.
    `dtype` is the activations' type, torch.float32 or torch.bfloat16
    (module docstring); parameters are float32 in either.
    """

    variant = "mixed"
    weighting = "uncertainty"  # or "none"

    def __init__(self, tasks: Sequence[str], input_channels: Sequence[int],
                 output_channels: Sequence[int], latent_channels: int,
                 conv_channels: int, lmbda: float = 1.0,
                 learning_rate_main: float = 1e-5,
                 learning_rate_aux: float = 1e-3,
                 legacy_broadcast: bool = True, device=None, seed: int = 0,
                 dtype=torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16,"
                             f" got {dtype}")
        tasks = tuple(tasks)
        if not len(tasks) == len(tuple(input_channels)) \
                == len(tuple(output_channels)):
            raise ValueError("one input and one output width per task")
        self.device = resolve_device(device)
        self.tasks = tasks
        self.n_tasks = len(tasks)
        self.input_channels = tuple(input_channels)
        self.output_channels = tuple(output_channels)
        self.conv_channels = conv_channels
        self.lmbda = lmbda
        self.learning_rate_main = learning_rate_main
        self.learning_rate_aux = learning_rate_aux
        self.legacy_broadcast = legacy_broadcast
        self.dtype = dtype
        latent_channels, channels_per_task = self._adjust_latent(
            latent_channels)
        self.latent_channels = latent_channels
        self.channels_per_task = channels_per_task
        self.loss_types = {t: task_parameters[t]["loss_function"]
                           for t in tasks}
        self.model = CodecNet(self.variant, self.input_channels,
                              self.output_channels, latent_channels,
                              conv_channels, channels_per_task, dtype)
        if self.weighting == "uncertainty":
            self.loss_balancer = LossBalancer(self.n_tasks)
        # self-describing containers (bitstream.py), as the JAX class
        self.hyper_parameters = dict(
            model_class=type(self).__name__,
            tasks=list(tasks),
            input_channels=list(self.input_channels),
            output_channels=list(self.output_channels),
            latent_channels=int(latent_channels),
            conv_channels=int(conv_channels),
            lmbda=float(lmbda),
            learning_rate_main=float(learning_rate_main),
            learning_rate_aux=float(learning_rate_aux),
            legacy_broadcast=bool(legacy_broadcast),
        )
        self.tables = None
        self.init(seed)
        # channels_last weights keep cuDNN on the NHWC layout the GDN rows
        # and the kernels read, so no layer output needs a copy
        self.to(self.device, memory_format=torch.channels_last)
        self.eval()

    # variant hooks -------------------------------------------------------

    def _adjust_latent(self, m: int):
        """-> (latent channels, channels per task); mixed: no split."""
        return m, m

    def _compression_loss(self, likelihoods, x_hats):
        return L.compression_loss_mixed(likelihoods, x_hats, self.tasks)

    # construction --------------------------------------------------------

    def get_model_name(self):
        return type(self).__name__

    @torch.no_grad()
    def init(self, seed: int):
        """Re-draw every parameter from `seed` (module order is fixed)."""
        generator = torch.Generator().manual_seed(seed)
        for module in self.modules():
            if hasattr(module, "init_parameters"):
                module.init_parameters(generator)
        self.tables = None

    def example_batch(self, batch_size=1, image_size=256, seed=0):
        """Random numpy batch with valid per-task ranges (semantic labels
        in 0..16), the same bytes as the JAX class's for a seed."""
        nprng = np.random.default_rng(seed)
        batch = {}
        for task, c in zip(self.tasks, self.input_channels):
            x = nprng.random(
                (batch_size, image_size, image_size, c)).astype(np.float32)
            if task == "semantic":
                x = np.floor(x * 16.99)
            batch[task] = x
        return batch

    def corrected_geometry_twin(self):
        """This codec with `legacy_broadcast=False`: the rate is estimated
        over y's own spatial support instead of the reference's broadcast
        (codecs.py:235-257). The twin shares this model's modules, and so
        every parameter tensor (an update to one shows in the other); only
        the likelihood geometry differs. Memoised."""
        if not self.legacy_broadcast:
            return self
        twin = self.__dict__.get("_corrected_twin")
        if twin is None:
            twin = copy.copy(self)  # the same submodules
            twin._modules = dict(self._modules)
            twin.legacy_broadcast = False
            twin.hyper_parameters = dict(self.hyper_parameters,
                                         legacy_broadcast=False)
            self.__dict__["_corrected_twin"] = twin  # not a submodule
        return twin

    # forward and losses --------------------------------------------------

    def to_device(self, batch):
        """{task: NHWC array or tensor} -> float32 tensors on the device
        (the losses' targets, in float32 at any dtype)."""
        return {t: torch.as_tensor(batch[t], dtype=torch.float32,
                                   device=self.device) for t in self.tasks}

    def _inputs(self, batch):
        """The encoder heads' inputs: NCHW in the codec's dtype
        (mmnc_tpu/models/codecs.py:83)."""
        return [_nchw(x).to(self.dtype)
                for x in self.to_device(batch).values()]

    def forward(self, batch, training: bool = False, noise=None):
        """{task: NHWC} -> (x_hats {task: NHWC}, likelihoods {"y", "z"}
        NHWC). Eval (the default) runs under no-grad, where decode's
        deconv->IGDN pairs fuse. Training runs with grad and quantizes by
        `noise`, {"y", "z"} NHWC in the shapes `latent_shapes` gives (drawn
        by `draw_noise`)."""
        if not training:
            return self._eval_forward(batch)
        if noise is None:
            raise ValueError("a training forward needs noise (draw_noise)")
        return self._forward(batch, True, {
            k: _nchw(torch.as_tensor(v, device=self.device))
            for k, v in noise.items()})

    @graphs.program
    @torch.no_grad()
    def _eval_forward(self, batch):
        """The eval forward's device program (mmnc_tpu/models/codecs.py:
        281-323)."""
        return self._forward(batch, False, None)

    def _forward(self, batch, training, noise):
        x_hats, liks = self.model(self._inputs(batch), training, noise,
                                  self.legacy_broadcast)
        return ({t: _nhwc(x) for t, x in zip(self.tasks, x_hats)},
                {k: _nhwc(v) for k, v in liks.items()})

    def latent_shapes(self, batch):
        """NHWC shapes {"y", "z"} of the latents of `batch`: every conv
        pads k // 2, so a stride-s conv takes an extent n to ceil(n / s)."""
        b, h, w, _ = batch[self.tasks[0]].shape

        def through(layers, h, w):
            for layer in layers:
                if isinstance(layer, Conv):
                    h, w = -(-h // layer.stride), -(-w // layer.stride)
            return h, w

        comp = self.model.compressor
        yh, yw = through(comp.g_a, *through(self.model.input_heads[0], h, w))
        zh, zw = through(comp.h_a, yh, yw)
        return {"y": (b, yh, yw, self.latent_channels),
                "z": (b, zh, zw, self.conv_channels * self.n_tasks)}

    def draw_noise(self, batch, generator: torch.Generator):
        """U(-1/2, 1/2) noise {"z", "y"} for a training forward of `batch`,
        drawn from `generator` (on the model's device) in the codec's
        dtype, z first."""
        shapes = self.latent_shapes(batch)
        return {k: uniform_noise(shapes[k], generator, self.device,
                                 self.dtype)
                for k in ("z", "y")}

    def loss_and_logs(self, batch, training: bool = True, noise=None):
        """-> (loss, (logs, x_hats, likelihoods)); loss = lmbda * rec +
        rate (codecs.py:295-309), rec uncertainty-weighted by
        `loss_balancer.log_vars` where the class weights, the rate by the
        variant's formula. The logs are 0-d tensors on the device."""
        batch = self.to_device(batch)
        x_hats, likelihoods = self.forward(batch, training, noise)
        log_vars = (self.loss_balancer.log_vars
                    if self.weighting == "uncertainty" else None)
        rec, rec_logs = L.multitask_reconstruction_loss(
            batch, x_hats, self.tasks, self.loss_types, log_vars)
        comp, comp_logs = self._compression_loss(likelihoods, x_hats)
        loss = self.lmbda * rec + comp
        logs = {"rec_loss": rec, "compression_loss": comp, "loss": loss,
                **rec_logs, **comp_logs}
        return loss, (logs, x_hats, likelihoods)

    def aux_loss(self):
        """The entropy bottleneck's quantile loss (trains `quantiles` only)."""
        return self.model.aux_loss()

    # analysis ------------------------------------------------------------

    def variant_slices(self):
        """[(name, lo, hi)] y-channel ownership per task, plus "shared"
        for the shared variant (None for mixed)."""
        if self.variant == "mixed":
            return None
        c = self.channels_per_task
        slices = [(t, i * c, (i + 1) * c) for i, t in enumerate(self.tasks)]
        if self.variant == "shared":
            slices.append(("shared", self.latent_channels - c,
                           self.latent_channels))
        return slices

    @graphs.program
    @torch.no_grad()
    def encode_eval(self, batch):
        """Deterministic quantized latents (y_hat, z_hat), NHWC: y rounded,
        z rounded around the entropy bottleneck's medians."""
        y, z = self.model.analyze(self._inputs(batch))
        med = self._medians()
        return _nhwc(torch.round(y)), _nhwc(torch.round(z - med) + med)

    def decode_from_latents(self, y_hat, z_hat=None):
        """Latents (NHWC) -> {task: NHWC}; z_hat only sets the rate, not
        the reconstruction. The device program is
        `_decompress_synthesize`'s (mmnc_tpu/models/codecs.py:336-350)."""
        del z_hat
        return self._decompress_synthesize(y_hat)

    # real coding ---------------------------------------------------------

    def update_bottleneck_values(self) -> CodecTables:
        """Build the coding tables from the current params (kept on the
        model for compress/decompress) and return them."""
        eb, medians = build_eb_table(self.model.compressor.entropy_bottleneck)
        self.tables = CodecTables(eb=eb, eb_medians=medians,
                                  gc=build_gc_table())
        return self.tables

    def _coding_tables(self) -> CodecTables:
        if self.tables is None:
            raise RuntimeError("call update_bottleneck_values() first")
        return self.tables

    def _medians(self):
        return self.model.compressor.entropy_bottleneck.medians().view(
            1, -1, 1, 1)

    @graphs.program
    @torch.no_grad()
    def _compress_device(self, batch):
        """-> (y_sym, z_sym, indexes) NHWC int32 on the device
        (mmnc_tpu/models/codecs.py:353-366)."""
        y, z = self.model.analyze(self._inputs(batch))
        z_sym = torch.round(z - self._medians())
        indexes = self._indexes(z_sym, y.shape[2:])  # coding geometry
        return (_nhwc(torch.round(y).to(torch.int32)),
                _nhwc(z_sym.to(torch.int32)), _nhwc(indexes))

    # device programs of the streaming round trip (models/streaming.py):
    # each returns tensors on the device and syncs nothing (graphs.py)

    def _symbols(self, batch):
        """-> (y_sym, z_sym) rounded f32 NCHW, max_abs int32 scalar."""
        y, z = self.model.analyze(self._inputs(batch))
        z_sym = torch.round(z - self._medians())
        y_sym = torch.round(y)
        max_abs = torch.maximum(y_sym.abs().max(),
                                z_sym.abs().max()).to(torch.int32)
        return y_sym, z_sym, max_abs

    @graphs.program
    @torch.no_grad()
    def _compress_device_lean(self, batch):
        """-> (y_sym, z_sym) NHWC int16 and max_abs (int32 scalar)
        (mmnc_tpu/models/codecs.py:368-386). The caller falls back to
        `_compress_device` where max_abs says int16 wrapped."""
        y_sym, z_sym, max_abs = self._symbols(batch)
        return (_nhwc(y_sym).to(torch.int16), _nhwc(z_sym).to(torch.int16),
                max_abs)

    @graphs.program
    @torch.no_grad()
    def _compress_device_fused(self, batch):
        """-> (y_sym i16, z_sym i16, indexes u8) NHWC and max_abs in one
        call (mmnc_tpu/models/codecs.py:388-421): the lean program plus
        h_s and build_indexes on the encoder's quantized z, which equals the
        decoder's decoded z because z's coding is lossless."""
        y_sym, z_sym, max_abs = self._symbols(batch)
        indexes = self._indexes(z_sym, y_sym.shape[2:])
        return (_nhwc(y_sym).to(torch.int16), _nhwc(z_sym).to(torch.int16),
                _nhwc(indexes).to(torch.uint8), max_abs)

    def _indexes(self, z_sym, y_shape):
        """Rounded z (NCHW f32) -> y's CDF-row indexes (NCHW int32)."""
        scales = self.model.compressor.hyper_synthesize(z_sym + self._medians())
        return gc.build_indexes(scales[:, :, :y_shape[0], :y_shape[1]])

    @graphs.program
    @torch.no_grad()
    def _decompress_indexes_u8(self, z_sym, y_shape):
        """z symbols (NHWC, any integer type, host or device) -> y's
        indexes as NHWC uint8 on the device (mmnc_tpu/models/codecs.py:
        423-428; the scale table has 64 rows)."""
        z = _nchw(torch.as_tensor(z_sym, device=self.device).float())
        return _nhwc(self._indexes(z, y_shape)).to(torch.uint8)

    @graphs.program
    @torch.no_grad()
    def _synthesize_from_symbols(self, y_sym):
        """int16 y symbols (NHWC, on the device) -> {task: NHWC}; the cast
        to the codec's dtype runs on the device
        (mmnc_tpu/models/codecs.py:430-435)."""
        return self._decompress_synthesize(y_sym.to(self.dtype))

    @graphs.program
    @torch.no_grad()
    def _decompress_synthesize(self, y_hat):
        """f32 y_hat (NHWC) -> {task: NHWC} (mmnc_tpu/models/codecs.py:
        496-499)."""
        y_hat = _nchw(torch.as_tensor(y_hat, device=self.device))
        x_hats = self.model.synthesize_from_y(y_hat)
        return {t: _nhwc(x) for t, x in zip(self.tasks, x_hats)}

    @graphs.program
    @torch.no_grad()
    def _synthesize_task(self, y_hat, task_index: int):
        """f32 y_hat (NHWC) -> task `task_index`'s reconstruction (NHWC),
        running only that task's output head."""
        y_hat = _nchw(torch.as_tensor(y_hat, device=self.device))
        return _nhwc(self.model.synthesize_one_task(y_hat, task_index))

    def _decompress_indexes(self, z_sym, y_shape):
        """z symbols (NHWC, host) -> Gaussian CDF-row indexes for y (host):
        the upload, the device program, the download."""
        return _host(self._decompress_indexes_device(z_sym, y_shape))

    @graphs.program
    @torch.no_grad()
    def _decompress_indexes_device(self, z_sym, y_shape):
        """z symbols (NHWC) -> y's indexes (NCHW int32) on the device
        (mmnc_tpu/models/codecs.py:483-494)."""
        z = _nchw(torch.as_tensor(z_sym, device=self.device).float())
        return self._indexes(z, y_shape)

    def _z_index(self, shape):
        zc = self.conv_channels * self.n_tasks
        return np.broadcast_to(np.arange(zc, dtype=np.int32), (*shape, zc))

    def _decode_z(self, z_strings, shape, b):
        """z strings (one packed stream for b > 1 items, or one per item)
        -> z symbols (b, zh, zw, zc)."""
        eb = self._coding_tables().eb
        zh, zw = shape
        if len(z_strings) == 1 and b > 1:
            return rans.decode_with_indexes(
                z_strings[0], self._z_index((b, zh, zw)), eb
            ).reshape(b, zh, zw, -1)
        z_idx = self._z_index((zh, zw))
        return np.stack([rans.decode_with_indexes(s, z_idx, eb
                                                  ).reshape(zh, zw, -1)
                         for s in z_strings])

    def _decode_y(self, strings, indexes):
        """y strings (one packed stream, or one per item) with their
        indexes (b, h, w, c) -> symbols of the same shape."""
        gc_table = self._coding_tables().gc
        b = len(indexes)
        if len(strings) == 1 and b > 1:
            return rans.decode_with_indexes(strings[0], indexes, gc_table
                                            ).reshape(indexes.shape)
        return np.stack([rans.decode_with_indexes(strings[i], indexes[i],
                                                  gc_table
                                                  ).reshape(indexes.shape[1:])
                         for i in range(b)])

    def compress(self, batch, packed: bool = True):
        """-> (ans dict(strings=[y_strings, z_strings], shape, y_shape,
        batch_size), n_bytes).

        packed=True codes the whole batch's y (and z) symbols as one rANS
        stream each; packed=False gives one string per image."""
        tables = self._coding_tables()
        y_sym, z_sym, indexes = (
            x.contiguous().cpu().numpy() for x in self._compress_device(batch))
        b, zh, zw, _ = z_sym.shape
        if packed:
            y_strings = [rans.encode_with_indexes(y_sym, indexes, tables.gc)]
            z_strings = [rans.encode_with_indexes(
                z_sym, self._z_index((b, zh, zw)), tables.eb)]
        else:
            z_idx = self._z_index((zh, zw))
            y_strings = [rans.encode_with_indexes(y_sym[i], indexes[i],
                                                  tables.gc)
                         for i in range(b)]
            z_strings = [rans.encode_with_indexes(z_sym[i], z_idx, tables.eb)
                         for i in range(b)]
        n_bytes = sum(map(len, y_strings)) + sum(map(len, z_strings))
        ans = {"strings": [y_strings, z_strings], "shape": (zh, zw),
               "y_shape": tuple(y_sym.shape[1:3]), "batch_size": b}
        return ans, n_bytes

    @torch.no_grad()
    def decompress(self, strings, shape=None, y_shape=None,
                   batch_size=None) -> Dict[str, torch.Tensor]:
        """A compress() ans dict, or the reference's form strings=[y_strings,
        z_strings] with shape (zh, zw) -> {task: NHWC reconstruction}
        (mmnc_tpu/models/codecs.py:501-557).

        In the reference's form `batch_size` defaults to the number of z
        strings (give it for a packed stream of several images) and
        `y_shape` to 4 x `shape`, as there: two stride-2 hyper convs. At
        256 px y and z are both 1x1, so that default does not fit; pass
        the ans dict or y_shape."""
        if isinstance(strings, dict):
            ans = strings
            strings, shape = ans["strings"], ans["shape"]
            y_shape = ans.get("y_shape", y_shape)
            batch_size = ans.get("batch_size", batch_size)
        if shape is None:
            raise ValueError("shape required (or pass the ans dict)")
        y_strings, z_strings = strings
        zh, zw = shape
        if y_shape is None:
            y_shape = (zh * 4, zw * 4)
        b = batch_size if batch_size is not None else len(z_strings)
        z_sym = self._decode_z(z_strings, shape, b)
        indexes = self._decompress_indexes(z_sym, tuple(y_shape))
        y_sym = self._decode_y(y_strings, indexes)
        return self._decompress_synthesize(
            torch.as_tensor(y_sym, device=self.device).float())

    # per-task partial coding (disjoint/shared) ---------------------------

    def _slices(self):
        slices = self.variant_slices()
        if slices is None:
            raise ValueError("partial coding needs a disjoint or shared "
                             "codec")
        return slices

    def compress_partial(self, batch):
        """-> (ans dict(task_streams={slice name: [stream]}, z_strings,
        shape, y_shape, batch_size), total bytes)
        (mmnc_tpu/models/codecs.py:567-595).

        Each y slice of `variant_slices` (and z) is one packed stream over
        the batch, so a subset of the tasks stays decodable on its own."""
        slices = self._slices()
        tables = self._coding_tables()
        y_sym, z_sym, indexes = (
            x.contiguous().cpu().numpy() for x in self._compress_device(batch))
        b, zh, zw, _ = z_sym.shape
        streams = {name: [rans.encode_with_indexes(
            y_sym[..., lo:hi], indexes[..., lo:hi], tables.gc)]
            for name, lo, hi in slices}
        z_strings = [rans.encode_with_indexes(
            z_sym, self._z_index((b, zh, zw)), tables.eb)]
        total = sum(len(s[0]) for s in streams.values()) + len(z_strings[0])
        ans = {"task_streams": streams, "z_strings": z_strings,
               "shape": (zh, zw), "y_shape": tuple(y_sym.shape[1:3]),
               "batch_size": b}
        return ans, total

    @torch.no_grad()
    def decompress_tasks(self, ans, tasks) -> Dict[str, torch.Tensor]:
        """Decode only `tasks` from their slice streams (plus the shared
        block and z) of a compress_partial() ans dict; packed or per-image
        slice streams (mmnc_tpu/models/codecs.py:603-653). The indexes
        come from the decoded z on the device, and only the requested
        tasks' output heads run."""
        slices = {name: (lo, hi) for name, lo, hi in self._slices()}
        needed = list(tasks)
        unknown = [t for t in needed if t not in self.tasks]
        if unknown:
            raise ValueError(f"unknown tasks {unknown}; the codec codes "
                             f"{list(self.tasks)}")
        names = needed + (["shared"] if self.variant == "shared" else [])
        y_shape = tuple(ans["y_shape"])
        b = ans.get("batch_size", len(ans["z_strings"]))
        z_sym = self._decode_z(ans["z_strings"], ans["shape"], b)
        indexes = self._decompress_indexes(z_sym, y_shape)
        y_hat = np.zeros((b, *y_shape, self.latent_channels), np.float32)
        for name in names:
            lo, hi = slices[name]
            y_hat[..., lo:hi] = self._decode_y(
                ans["task_streams"][name],
                np.ascontiguousarray(indexes[..., lo:hi]))
        y_hat = torch.as_tensor(y_hat, device=self.device)
        return {t: self._synthesize_task(y_hat, self.tasks.index(t))
                for t in needed}


class MultiTaskMixedLatentCompressor(MultiTaskCompressorBase):
    """Model 2: one mixed latent for all tasks."""
    variant = "mixed"
    weighting = "uncertainty"


class SingleTaskCompressor(MultiTaskMixedLatentCompressor):
    """Model 1: one task, mixed machinery, no loss balancing."""
    weighting = "none"

    def __init__(self, tasks: Sequence[str], *args, **kwargs):
        if len(tuple(tasks)) != 1:
            raise ValueError("SingleTaskCompressor takes exactly one task")
        super().__init__(tasks, *args, **kwargs)


class MultiTaskDisjointLatentCompressor(MultiTaskCompressorBase):
    """Model 3: the latent partitioned per task; any subset of tasks
    decodes from its channel slices."""
    variant = "disjoint"
    weighting = "uncertainty"

    def _adjust_latent(self, m):
        per_task = m // self.n_tasks
        adjusted = per_task * self.n_tasks
        if adjusted != m:
            print(f"!! latent_channels {m} is not a multiple of n_tasks "
                  f"{self.n_tasks}; auto-adjusted to {adjusted}")
        return adjusted, per_task

    def _compression_loss(self, likelihoods, x_hats):
        return L.compression_loss_disjoint(
            likelihoods, x_hats, self.tasks, self.channels_per_task)


class MultiTaskSharedLatentCompressor(MultiTaskDisjointLatentCompressor):
    """Model 4: per-task slices plus one shared slice stored once."""
    variant = "shared"

    def _adjust_latent(self, m):
        blocks = self.n_tasks + 1
        per_task = m // blocks
        adjusted = per_task * blocks
        if adjusted != m:
            print(f"!! latent_channels {m} adjusted to {adjusted} so each "
                  f"task and the shared part get equal channel blocks")
        return adjusted, per_task

    def _compression_loss(self, likelihoods, x_hats):
        return L.compression_loss_shared(
            likelihoods, x_hats, self.tasks, self.channels_per_task)


MODEL_NUMBER = {
    1: SingleTaskCompressor,
    2: MultiTaskMixedLatentCompressor,
    3: MultiTaskDisjointLatentCompressor,
    4: MultiTaskSharedLatentCompressor,
}
MODEL_NAME = {cls.__name__: cls for cls in MODEL_NUMBER.values()}


def build_model(model, tasks, latent_channels, conv_channels, **kwargs):
    """Construct a codec (model number 1-4 or class name) from the task
    registry (mmnc_tpu build_model); kwargs go to the constructor (lmbda,
    learning rates, legacy_broadcast, device, seed, dtype)."""
    cls = MODEL_NUMBER.get(model) if isinstance(model, int) \
        else MODEL_NAME.get(model)
    if cls is None:
        raise ValueError(f"unknown model {model!r}: a number in "
                         f"{sorted(MODEL_NUMBER)} or one of "
                         f"{sorted(MODEL_NAME)}")
    return cls(tasks=tuple(tasks),
               input_channels=[task_parameters[t]["in_channels"] for t in tasks],
               output_channels=[task_parameters[t]["out_channels"] for t in tasks],
               latent_channels=latent_channels, conv_channels=conv_channels,
               **kwargs)
