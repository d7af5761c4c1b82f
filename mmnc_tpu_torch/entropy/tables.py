"""Quantized-CDF tables for real range coding (mmnc_tpu/entropy/tables.py).

Host-side numpy, the port's own copy. Semantics must match the coder
(native/rans/rans.cpp) bit for bit:
* a cdf has pmf_len + 1 entries, cdf[0] = 0, cdf[-1] = 2^16;
* each pmf bin is rounded to freq = round(p * 2^16), then rescaled by the
  total so the CDF tops out at exactly 2^16;
* every symbol gets a nonzero frequency by stealing one count from the
  lowest-frequency symbol with freq > 1.
"""

import copy
from dataclasses import dataclass

import numpy as np
import torch

from .entropy_bottleneck import EntropyBottleneck, eb_pmf
from .gaussian_conditional import gc_pmf, get_scale_table

PRECISION = 16


def pmf_to_quantized_cdf_np(pmf: np.ndarray, precision: int = PRECISION) -> np.ndarray:
    pmf = np.asarray(pmf, np.float64)
    if np.any(pmf < 0) or not np.all(np.isfinite(pmf)):
        raise ValueError("invalid pmf (negative or non-finite entries)")
    freqs = np.round(pmf * (1 << precision)).astype(np.uint64)
    total = int(freqs.sum())
    if total == 0:
        raise ValueError("pmf is all-zero")
    cdf = np.zeros(len(pmf) + 1, np.int64)
    cdf[1:] = ((freqs * (1 << precision)) // total).astype(np.int64)
    cdf = np.cumsum(cdf)
    cdf[-1] = 1 << precision

    for i in range(len(cdf) - 1):
        if cdf[i] == cdf[i + 1]:
            freq = cdf[1:] - cdf[:-1]
            candidates = np.where(freq > 1)[0]
            if len(candidates) == 0:
                raise ValueError("cannot normalize cdf: no mass to steal")
            best = candidates[np.argmin(freq[candidates])]
            if best < i:
                cdf[best + 1:i + 1] -= 1
            else:
                cdf[i + 1:best + 1] += 1
    return cdf.astype(np.int32)


@dataclass
class CdfTable:
    """Everything the rANS coder needs: one CDF row per index bucket."""
    cdfs: np.ndarray         # (rows, max_cdf_len) int32, zero-padded
    cdf_lengths: np.ndarray  # (rows,) int32 — valid entries per row
    offsets: np.ndarray      # (rows,) int32 — symbol = value - offset

    @property
    def max_values(self) -> np.ndarray:
        """Per-row largest in-range symbol (the escape symbol)."""
        return self.cdf_lengths - 2


def _rows_to_table(pmf, tail_mass, pmf_length, offset) -> CdfTable:
    pmf = np.asarray(pmf, np.float64)
    tail_mass = np.asarray(tail_mass, np.float64)
    pmf_length = np.asarray(pmf_length, np.int64)
    rows = pmf.shape[0]
    max_len = int(pmf_length.max()) + 2
    cdfs = np.zeros((rows, max_len + 1), np.int32)
    for r in range(rows):
        n = int(pmf_length[r])
        prob = np.concatenate([pmf[r, :n], [max(tail_mass[r], 0.0)]])
        cdf = pmf_to_quantized_cdf_np(prob)
        cdfs[r, :len(cdf)] = cdf
    return CdfTable(
        cdfs=cdfs,
        cdf_lengths=(pmf_length + 2).astype(np.int32),
        offsets=np.asarray(offset, np.int32),
    )


@torch.no_grad()
def build_eb_table(eb: EntropyBottleneck):
    """The EntropyBottleneck coding table -> (CdfTable, medians (C,) f32).

    The pmf is evaluated on a CPU copy of the module, so a model gives the
    same table on any device.
    """
    eb = copy.deepcopy(eb).cpu()
    quantiles = eb.quantiles.double().numpy()
    medians = quantiles[:, 0, 1]
    minima = np.clip(np.ceil(medians - quantiles[:, 0, 0]), 0, None).astype(np.int64)
    maxima = np.clip(np.ceil(quantiles[:, 0, 2] - medians), 0, None).astype(np.int64)
    pmf_length = minima + maxima + 1
    max_length = int(pmf_length.max())

    pmf, tail = eb_pmf(eb, eb.quantiles.float(), max_length,
                       torch.from_numpy(minima))
    table = _rows_to_table(pmf.double().numpy(), tail.double().numpy(),
                           pmf_length, -minima)
    return table, medians.astype(np.float32)


def build_gc_table(scale_table=None) -> CdfTable:
    """The GaussianConditional coding table (one row per table scale)."""
    if scale_table is None:
        scale_table = get_scale_table()
    pmf, tail, pmf_length, offset = gc_pmf(np.asarray(scale_table))
    return _rows_to_table(pmf, tail, pmf_length, offset)
