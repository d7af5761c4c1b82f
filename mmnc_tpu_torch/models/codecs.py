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
`update_bottleneck_values`, `compress`, `decompress`) and the device
programs of the streaming round trip (`models/streaming.py`). Training
forward, losses and the disjoint/shared variants come in later slices.
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

    def forward(self, xs):
        out = self.compressor(self.encode_heads(xs))
        return self.decode_heads(out["x_hat"]), out["likelihoods"]


class SingleTaskCompressor(nn.Module):
    """Model 1: one task, mixed machinery, no loss balancing.

    Runs on `device` (CUDA unless given; raises with no card and no
    device). Weights are drawn from `seed` with a CPU torch.Generator, so
    the same seed gives the same model on any device.
    """

    def __init__(self, tasks: Sequence[str], input_channels: Sequence[int],
                 output_channels: Sequence[int], latent_channels: int,
                 conv_channels: int, legacy_broadcast: bool = True,
                 device=None, seed: int = 0):
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

    def _inputs(self, batch):
        return [_nchw(torch.as_tensor(batch[t], dtype=torch.float32,
                                      device=self.device))
                for t in self.tasks]

    @torch.no_grad()
    def forward(self, batch):
        """Eval forward: {task: NHWC} -> (x_hats {task: NHWC},
        likelihoods {"y", "z"} NHWC)."""
        x_hats, liks = self.model(self._inputs(batch))
        return ({t: _nhwc(x) for t, x in zip(self.tasks, x_hats)},
                {k: _nhwc(v) for k, v in liks.items()})

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
    constructor (device, seed, legacy_broadcast).
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
