"""The single-task codec on the mixed-latent machinery
(mmnc_tpu/models/codecs.py:44-557, n_tasks = 1).

Model-level calls take and return NHWC dicts ({task: (B, H, W, C)}), like
the JAX package; inside, activations are NCHW in channels_last memory
format. Parameters live in `nn.Module`s named after the reference's
state_dict (`model.input_heads.{t}.{seq}`, `model.compressor.{g_a,g_s,
h_a,h_s}.{seq}`, `model.compressor.entropy_bottleneck.*`,
`model.output_heads.{t}.{seq}`), so mmnc_tpu's
`import_reference_state_dict` reads any state_dict of this port.

Ported so far: the serving path (`init(seed)`, eval `forward`,
`update_bottleneck_values`, `compress`, `decompress`), the device
programs of the streaming round trip (`models/streaming.py`) and the
training side: the noise-quantized training `forward`, `loss_and_logs`
(loss = lmbda * rec + rate, codecs.py:295-309) and `aux_loss`, which
`train/step.py` drives. The disjoint/shared variants come in a later slice.
"""

from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..data.task_configs import task_parameters
from ..device import resolve_device
from ..entropy import gaussian_conditional as gc
from ..entropy import rans
from ..entropy.tables import CdfTable, build_eb_table, build_gc_table
from ..ops.layers import Conv
from ..ops.quant import uniform_noise
from . import losses as L
from .backbone import ScaleHyperprior
from .heads import DecoderHead, EncoderHead


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
    """Mixed-latent multi-task graph: encoder heads -> ScaleHyperprior ->
    decoder heads (mmnc_tpu/models/codecs.py:44-141), NCHW inside."""

    def __init__(self, input_channels, output_channels, latent_channels,
                 conv_channels, legacy_broadcast=True):
        super().__init__()
        total = conv_channels * len(input_channels)
        self.input_heads = nn.ModuleList(
            [EncoderHead(ic, conv_channels) for ic in input_channels])
        self.compressor = ScaleHyperprior(total, latent_channels,
                                          legacy_broadcast)
        self.output_heads = nn.ModuleList(
            [DecoderHead(total, oc) for oc in output_channels])

    def encode_heads(self, xs):
        return torch.cat([head(x) for head, x in zip(self.input_heads, xs)],
                         dim=1)

    def analyze(self, xs):
        return self.compressor.analyze(self.encode_heads(xs))

    def decode_heads(self, u):
        return [head(u) for head in self.output_heads]

    def synthesize_from_y(self, y_hat):
        return self.decode_heads(self.compressor.synthesize(y_hat))

    def forward(self, xs, training: bool = False, noise=None):
        out = self.compressor(self.encode_heads(xs), training, noise)
        return self.decode_heads(out["x_hat"]), out["likelihoods"]

    def aux_loss(self):
        return self.compressor.aux_loss()


class SingleTaskCompressor(nn.Module):
    """Model 1: one task, mixed machinery, no loss balancing.

    Runs on `device` (CUDA unless given; raises with no card and no
    device). Weights are drawn from `seed` with a CPU torch.Generator, so
    the same seed gives the same model on any device. `lmbda` and the two
    learning rates default to the JAX class's (codecs.py:160-171);
    `train.create_train_state` trains at these rates unless given others.
    """

    def __init__(self, tasks: Sequence[str], input_channels: Sequence[int],
                 output_channels: Sequence[int], latent_channels: int,
                 conv_channels: int, lmbda: float = 1.0,
                 learning_rate_main: float = 1e-5,
                 learning_rate_aux: float = 1e-3,
                 legacy_broadcast: bool = True, device=None, seed: int = 0):
        super().__init__()
        tasks = tuple(tasks)
        if len(tasks) != 1:
            raise ValueError("SingleTaskCompressor takes exactly one task")
        if len(tuple(input_channels)) != 1 or len(tuple(output_channels)) != 1:
            raise ValueError("one input and one output width per task")
        self.device = resolve_device(device)
        self.tasks = tasks
        self.n_tasks = 1
        self.input_channels = tuple(input_channels)
        self.output_channels = tuple(output_channels)
        self.latent_channels = latent_channels
        self.conv_channels = conv_channels
        self.lmbda = lmbda
        self.learning_rate_main = learning_rate_main
        self.learning_rate_aux = learning_rate_aux
        self.loss_types = {t: task_parameters[t]["loss_function"]
                           for t in tasks}
        self.model = CodecNet(self.input_channels, self.output_channels,
                              latent_channels, conv_channels,
                              legacy_broadcast)
        self.tables = None
        self.init(seed)
        # channels_last weights keep cuDNN on the NHWC layout the GDN rows
        # and the kernels read, so no layer output needs a copy
        self.to(self.device, memory_format=torch.channels_last)
        self.eval()

    @torch.no_grad()
    def init(self, seed: int):
        """Re-draw every parameter from `seed` (module order is fixed)."""
        generator = torch.Generator().manual_seed(seed)
        for module in self.modules():
            if hasattr(module, "init_parameters"):
                module.init_parameters(generator)
        self.tables = None

    def to_device(self, batch):
        """{task: NHWC array or tensor} -> float32 tensors on the device."""
        return {t: torch.as_tensor(batch[t], dtype=torch.float32,
                                   device=self.device) for t in self.tasks}

    def _inputs(self, batch):
        return [_nchw(x) for x in self.to_device(batch).values()]

    def forward(self, batch, training: bool = False, noise=None):
        """{task: NHWC} -> (x_hats {task: NHWC}, likelihoods {"y", "z"}
        NHWC). Eval (the default) runs under no-grad, where decode's
        deconv->IGDN pairs fuse. Training runs with grad and quantizes by
        `noise`, {"y", "z"} NHWC in the shapes `latent_shapes` gives (drawn
        by `draw_noise`)."""
        if not training:
            with torch.no_grad():
                return self._forward(batch, False, None)
        if noise is None:
            raise ValueError("a training forward needs noise (draw_noise)")
        return self._forward(batch, True, {
            k: _nchw(torch.as_tensor(v, device=self.device))
            for k, v in noise.items()})

    def _forward(self, batch, training, noise):
        x_hats, liks = self.model(self._inputs(batch), training, noise)
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
        drawn from `generator` (on the model's device), z first."""
        shapes = self.latent_shapes(batch)
        return {k: uniform_noise(shapes[k], generator, self.device)
                for k in ("z", "y")}

    def loss_and_logs(self, batch, training: bool = True, noise=None):
        """-> (loss, (logs, x_hats, likelihoods)); loss = lmbda * rec +
        rate (codecs.py:295-309). The logs are 0-d tensors on the device."""
        batch = self.to_device(batch)
        x_hats, likelihoods = self.forward(batch, training, noise)
        rec, rec_logs = L.multitask_reconstruction_loss(
            batch, x_hats, self.tasks, self.loss_types)
        comp, comp_logs = L.compression_loss_mixed(likelihoods, x_hats,
                                                   self.tasks)
        loss = self.lmbda * rec + comp
        logs = {"rec_loss": rec, "compression_loss": comp, "loss": loss,
                **rec_logs, **comp_logs}
        return loss, (logs, x_hats, likelihoods)

    def aux_loss(self):
        """The entropy bottleneck's quantile loss (trains `quantiles` only)."""
        return self.model.aux_loss()

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
    # each returns tensors on the device and syncs nothing

    def _symbols(self, batch):
        """-> (y_sym, z_sym) rounded f32 NCHW, max_abs int32 scalar."""
        y, z = self.model.analyze(self._inputs(batch))
        z_sym = torch.round(z - self._medians())
        y_sym = torch.round(y)
        max_abs = torch.maximum(y_sym.abs().max(),
                                z_sym.abs().max()).to(torch.int32)
        return y_sym, z_sym, max_abs

    @torch.no_grad()
    def _compress_device_lean(self, batch):
        """-> (y_sym, z_sym) NHWC int16 and max_abs (int32 scalar)
        (mmnc_tpu/models/codecs.py:368-386). The caller falls back to
        `_compress_device` where max_abs says int16 wrapped."""
        y_sym, z_sym, max_abs = self._symbols(batch)
        return (_nhwc(y_sym).to(torch.int16), _nhwc(z_sym).to(torch.int16),
                max_abs)

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

    @torch.no_grad()
    def _decompress_indexes_u8(self, z_sym, y_shape):
        """z symbols (NHWC, any integer type, host or device) -> y's
        indexes as NHWC uint8 on the device (mmnc_tpu/models/codecs.py:
        423-428; the scale table has 64 rows)."""
        z = _nchw(torch.as_tensor(z_sym, device=self.device).float())
        return _nhwc(self._indexes(z, y_shape)).to(torch.uint8)

    @torch.no_grad()
    def _synthesize_from_symbols(self, y_sym):
        """int16 y symbols (NHWC, on the device) -> {task: NHWC}; the cast
        to f32 runs on the device (mmnc_tpu/models/codecs.py:430-435)."""
        return self._decompress_synthesize(y_sym.float())

    @torch.no_grad()
    def _decompress_synthesize(self, y_hat):
        """f32 y_hat (NHWC) -> {task: NHWC} (mmnc_tpu/models/codecs.py:
        496-499)."""
        y_hat = _nchw(torch.as_tensor(y_hat, device=self.device))
        x_hats = self.model.synthesize_from_y(y_hat)
        return {t: _nhwc(x) for t, x in zip(self.tasks, x_hats)}

    @torch.no_grad()
    def _decompress_indexes(self, z_sym, y_shape):
        """z symbols (NHWC, host) -> Gaussian CDF-row indexes for y (host)."""
        z = _nchw(torch.as_tensor(z_sym, device=self.device).float())
        return _host(self._indexes(z, y_shape))

    def compress(self, batch, packed: bool = True):
        """-> (ans dict(strings=[y_strings, z_strings], shape, y_shape,
        batch_size), n_bytes).

        packed=True codes the whole batch's y (and z) symbols as one rANS
        stream each; packed=False gives one string per image."""
        tables = self._coding_tables()
        y_sym, z_sym, indexes = (
            x.contiguous().cpu().numpy() for x in self._compress_device(batch))
        b, zh, zw, zc = z_sym.shape
        if packed:
            z_idx = np.broadcast_to(np.arange(zc, dtype=np.int32), z_sym.shape)
            y_strings = [rans.encode_with_indexes(y_sym, indexes, tables.gc)]
            z_strings = [rans.encode_with_indexes(z_sym, z_idx, tables.eb)]
        else:
            z_idx = np.broadcast_to(np.arange(zc, dtype=np.int32),
                                    z_sym.shape[1:])
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
    def decompress(self, ans) -> Dict[str, torch.Tensor]:
        """A compress() ans dict -> {task: NHWC reconstruction}
        (mmnc_tpu/models/codecs.py:501-557)."""
        tables = self._coding_tables()
        y_strings, z_strings = ans["strings"]
        zh, zw = ans["shape"]
        y_shape = tuple(ans["y_shape"])
        b = ans["batch_size"]
        zc = self.conv_channels * self.n_tasks
        m = self.latent_channels
        packed = len(z_strings) == 1 and b > 1

        if packed:
            z_idx = np.broadcast_to(np.arange(zc, dtype=np.int32),
                                    (b, zh, zw, zc))
            z_sym = rans.decode_with_indexes(z_strings[0], z_idx, tables.eb
                                             ).reshape(b, zh, zw, zc)
        else:
            z_idx = np.broadcast_to(np.arange(zc, dtype=np.int32),
                                    (zh, zw, zc))
            z_sym = np.stack([rans.decode_with_indexes(s, z_idx, tables.eb
                                                       ).reshape(zh, zw, zc)
                              for s in z_strings])

        indexes = self._decompress_indexes(z_sym, y_shape)
        if packed:
            y_sym = rans.decode_with_indexes(y_strings[0], indexes, tables.gc
                                             ).reshape(b, *y_shape, m)
        else:
            y_sym = np.stack([rans.decode_with_indexes(y_strings[i], indexes[i],
                                                       tables.gc
                                                       ).reshape(*y_shape, m)
                              for i in range(b)])
        return self._decompress_synthesize(
            torch.as_tensor(y_sym, device=self.device).float())


MODEL_NUMBER = {1: SingleTaskCompressor}
MODEL_NAME = {cls.__name__: cls for cls in MODEL_NUMBER.values()}


def build_model(model, tasks, latent_channels, conv_channels, **kwargs):
    """Construct a codec from the task registry (mmnc_tpu build_model).

    Only model 1 (SingleTaskCompressor) is ported so far; kwargs go to the
    constructor (lmbda, learning rates, device, seed, legacy_broadcast).
    """
    cls = MODEL_NUMBER.get(model) if isinstance(model, int) \
        else MODEL_NAME.get(model)
    if cls is None:
        raise NotImplementedError(f"model {model!r} is not ported yet")
    return cls(tasks=tuple(tasks),
               input_channels=[task_parameters[t]["in_channels"] for t in tasks],
               output_channels=[task_parameters[t]["out_channels"] for t in tasks],
               latent_channels=latent_channels, conv_channels=conv_channels,
               **kwargs)
