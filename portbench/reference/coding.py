"""The coding tables and the byte count of the range coder, in NumPy.

The published coder (CompressAI's rANS): 16-bit quantized CDFs, one row
per index; a row holds the pmf over its integer support and one escape
symbol carrying the tail mass; a symbol outside the support is coded as
the escape symbol followed by its value in 4-bit raw chunks (a unary
count of chunks, then the chunks). A batch's y and z symbols are coded in
NHWC order as one stream each: y with the Gaussian row of its scale
index, z with the row of its channel. `stream_bytes` counts the bytes of
such a stream without writing it: 64-bit state, 32-bit renormalisation
words, the state flushed as two words at the end.

Imports nothing of the program, of the JAX package or of JAX.
"""

import numpy as np
import torch

from . import codec

PRECISION = 16
RANS_L = 1 << 31
BYPASS_BITS = 4
BYPASS_MAX = (1 << BYPASS_BITS) - 1
# -Phi^-1(TAIL_MASS / 2): how many scales the Gaussian rows reach
_TAIL_SCALES = 6.1094102048693975


def quantized_cdf(pmf):
    """pmf (float64, with the tail mass last) -> its 16-bit CDF (n + 1
    entries from 0 to 2^16) in which every symbol keeps a nonzero
    frequency: rounded frequencies rescaled to 2^16, then each empty bin
    takes one count from the least frequent bin that has more than one."""
    total = 1 << PRECISION
    freq = np.round(np.asarray(pmf, np.float64) * total).astype(np.int64)
    cdf = np.concatenate([[0], np.cumsum(freq * total // freq.sum())])
    cdf[-1] = total
    for i in range(len(cdf) - 1):
        if cdf[i] == cdf[i + 1]:
            f = np.diff(cdf)
            cand = np.flatnonzero(f > 1)
            best = cand[np.argmin(f[cand])]
            if best < i:
                cdf[best + 1:i + 1] -= 1
            else:
                cdf[i + 1:best + 1] += 1
    return cdf


class Table:
    """CDF rows (zero padded), each row's support length + 2 and offset."""

    def __init__(self, rows, offsets):
        self.lengths = np.array([len(r) for r in rows], np.int64)
        self.cdfs = np.zeros((len(rows), self.lengths.max()), np.int64)
        for i, r in enumerate(rows):
            self.cdfs[i, :len(r)] = r
        self.offsets = np.asarray(offsets, np.int64)


def gaussian_table():
    """One row per table scale: the pmf of a zero-mean Gaussian of that
    scale over the integers within its tail bound."""
    scales = codec.scale_table().double().numpy()
    centers = np.ceil(scales * _TAIL_SCALES).astype(np.int64)
    rows = []
    for s, c in zip(scales, centers):
        k = np.abs(np.arange(2 * c + 1) - c).astype(np.float64)
        upper = 0.5 * torch.special.erfc(torch.from_numpy(
            -(2 ** -0.5) * (0.5 - k) / s)).numpy()
        lower = 0.5 * torch.special.erfc(torch.from_numpy(
            -(2 ** -0.5) * (-0.5 - k) / s)).numpy()
        tail = 2 * lower[0]
        rows.append(quantized_cdf(np.append(upper - lower, max(tail, 0.0))))
    return Table(rows, -centers)


@torch.no_grad()
def prior_table(params):
    """One row per channel of z: the factorized prior's pmf over the
    integers its quantiles span around the median (float32 on the CPU),
    and its two tails' mass. -> (Table, medians (C,) float32)."""
    cpu = {k: v.detach().float().cpu() for k, v in params.items()
           if "entropy_bottleneck" in k}
    q = cpu["model.compressor.entropy_bottleneck.quantiles"].double().numpy()
    med = q[:, 0, 1]
    lo = np.clip(np.ceil(med - q[:, 0, 0]), 0, None).astype(np.int64)
    hi = np.clip(np.ceil(q[:, 0, 2] - med), 0, None).astype(np.int64)
    length = lo + hi + 1
    width = int(length.max())
    start = torch.from_numpy(med.astype(np.float32)) - torch.from_numpy(
        lo).float()
    x = torch.arange(width, dtype=torch.float32)[None, None, :] \
        + start[:, None, None]
    lower = codec.eb_logits(cpu, x - 0.5)
    upper = codec.eb_logits(cpu, x + 0.5)
    pmf = codec._interval(lower, upper)[:, 0, :].double().numpy()
    tail = (torch.sigmoid(lower[:, 0, 0])
            + torch.sigmoid(-upper[:, 0, -1])).double().numpy()
    rows = [quantized_cdf(np.append(pmf[c, :length[c]], max(tail[c], 0.0)))
            for c in range(len(length))]
    return Table(rows, -lo), med.astype(np.float32)


def stream_bytes(symbols, indexes, table):
    """Bytes of the rANS stream of `symbols` (integers) coded with rows
    `indexes`, in the order given."""
    symbols = np.asarray(symbols).ravel().tolist()
    indexes = np.asarray(indexes).ravel().tolist()
    cdfs = table.cdfs.tolist()
    lengths = table.lengths.tolist()
    offsets = table.offsets.tolist()
    x, words = RANS_L, 0
    top = (RANS_L >> PRECISION) << 32
    bits_top = (RANS_L >> BYPASS_BITS) << 32
    for i in range(len(symbols) - 1, -1, -1):
        idx = indexes[i]
        cdf = cdfs[idx]
        top_value = lengths[idx] - 2
        value = symbols[i] - offsets[idx]
        raw = 0
        if value < 0:
            raw, value = -2 * value - 1, top_value
        elif value >= top_value:
            raw, value = 2 * (value - top_value), top_value
        if value == top_value:
            chunks = 0
            while raw >> (chunks * BYPASS_BITS):
                chunks += 1
            # emitted forward as: the count (BYPASS_MAX x full, then the
            # rest), then the chunks; a rANS coder puts them in reverse
            full = chunks // BYPASS_MAX
            puts = [(raw >> (j * BYPASS_BITS)) & BYPASS_MAX
                    for j in range(chunks - 1, -1, -1)]
            puts += [chunks - full * BYPASS_MAX] + [BYPASS_MAX] * full
            for val in puts:
                while x >= bits_top:
                    words += 1
                    x >>= 32
                x = (x << BYPASS_BITS) | val
        start, freq = cdf[value], cdf[value + 1] - cdf[value]
        x_max = top * freq
        while x >= x_max:
            words += 1
            x >>= 32
        x = ((x // freq) << PRECISION) + (x % freq) + start
    return 4 * (words + 2)


def batch_bytes(y_sym, z_sym, indexes, gauss, prior):
    """Bytes of a batch's two packed streams: y (NHWC, rows `indexes`) and
    z (NHWC, the row of each channel)."""
    y = y_sym.permute(0, 2, 3, 1).cpu().numpy().astype(np.int64)
    idx = indexes.permute(0, 2, 3, 1).cpu().numpy()
    z = z_sym.permute(0, 2, 3, 1).cpu().numpy().astype(np.int64)
    z_idx = np.broadcast_to(np.arange(z.shape[-1]), z.shape)
    return stream_bytes(y, idx, gauss) + stream_bytes(z, z_idx, prior)

