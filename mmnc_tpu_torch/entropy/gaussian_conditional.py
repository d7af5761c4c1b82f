"""Conditional Gaussian entropy model over predicted scales
(mmnc_tpu/entropy/gaussian_conditional.py).

Stateless: scales come from the hyper-synthesis net. The 64-entry scale
table is kept as float32 literals: JAX builds it as exp(linspace(log)) in
float32, torch's exp/linspace give other float32 values in 44 of the 64
entries, and one ulp moves a `build_indexes` bucket and so the stream
bytes. tests/test_torch_entropy.py pins the literals against JAX.
"""

import numpy as np
import torch

from ..ops.bound import abs_, lower_bound
from ..ops.quant import quantize_noise, quantize_round

SCALE_BOUND = 0.11
SCALES_MIN = 0.11
SCALES_MAX = 256.0
SCALES_LEVELS = 64
LIKELIHOOD_BOUND = 1e-9
TAIL_MASS = 1e-9
# -scipy.stats.norm.ppf(TAIL_MASS / 2) in float64
_TAIL_MULTIPLIER = 6.1094102048693975

_SCALE_TABLE = (
    0.10999999940395355, 0.12440409511327744, 0.14069437980651855,
    0.15911778807640076, 0.1799536645412445, 0.20351797342300415,
    0.2301679253578186, 0.26030758023262024, 0.294393926858902,
    0.33294379711151123, 0.3765415549278259, 0.4258483052253723,
    0.48161160945892334, 0.5446769595146179, 0.6160003542900085,
    0.696663498878479, 0.7878890037536621, 0.8910602927207947,
    1.0077413320541382, 1.13970148563385, 1.2889411449432373,
    1.457723617553711, 1.6486070156097412, 1.8644863367080688,
    2.1086342334747314, 2.3847522735595703, 2.6970269680023193,
    3.0501928329467773, 3.4496047496795654, 3.901317834854126,
    4.412181377410889, 4.989940643310547, 5.643355846405029,
    6.3823323249816895, 7.218076229095459, 8.163256645202637,
    9.232205390930176, 10.441131591796875, 11.808359146118164,
    13.354620933532715, 15.10335922241211, 17.08108901977539,
    19.317798614501953, 21.847393035888672, 24.708229064941406,
    27.943689346313477, 31.602811813354492, 35.741085052490234,
    40.42125701904297, 45.714271545410156, 51.70038986206055,
    58.470367431640625, 66.12686157226562, 74.7859115600586,
    84.57887268066406, 95.65419006347656, 108.17973327636719,
    122.34549713134766, 138.36622619628906, 156.4847412109375,
    176.9758758544922, 200.15017700195312, 226.35916137695312,
    256.0,
)


def get_scale_table(device=None) -> torch.Tensor:
    """The 64 log-spaced float32 scales in [0.11, 256], equal bit for bit
    to mmnc_tpu's get_scale_table()."""
    return torch.tensor(_SCALE_TABLE, dtype=torch.float32, device=device)


def _std_cumulative(x):
    """Standard normal CDF as 0.5*erfc(-x/sqrt(2))."""
    return 0.5 * torch.special.erfc(-(2 ** -0.5) * x)


def likelihood(values, scales):
    """Elementwise likelihood of integer values under zero-mean Gaussians.

    values and scales broadcast numpy-style: the reference's as-built
    geometry broadcasts y (B,M,1,1) against scales (B,M,4,4) at 256 px
    (legacy_broadcast, mmnc_tpu/models/backbone.py:113-116).
    """
    scales = lower_bound(scales.float(), SCALE_BOUND)
    v = abs_(values.float())
    upper = _std_cumulative((0.5 - v) / scales)
    lower = _std_cumulative((-0.5 - v) / scales)
    return lower_bound(upper - lower, LIKELIHOOD_BOUND)


def quantize(values, noise=None, training: bool = False):
    """Training: values + noise (U(-1/2, 1/2), values' shape); eval: round."""
    if training:
        return quantize_noise(values, noise)
    return quantize_round(values)


def build_indexes(scales, scale_table=None):
    """Bucket of each sigma: the smallest table entry >= sigma (int32).

    `bucketize(s, table[:-1])` counts the entries strictly below s, which is
    the JAX package's 63-step comparison count (gaussian_conditional.py:78-86).
    """
    if scale_table is None:
        scale_table = get_scale_table(scales.device)
    scales = torch.clamp_min(scales, SCALE_BOUND)
    return torch.bucketize(scales, scale_table[:-1]).to(torch.int32)


def gc_pmf(scale_table):
    """Per-table-entry pmf over the centered integer support (float64).

    Returns (pmf (L, max_length), tail_mass (L,), pmf_length (L,),
    offset (L,)), as mmnc_tpu's gc_pmf does with scipy.
    """
    scale_table = np.asarray(scale_table, np.float64)
    pmf_center = np.ceil(scale_table * _TAIL_MULTIPLIER).astype(np.int64)
    pmf_length = 2 * pmf_center + 1
    max_length = int(pmf_length.max())
    samples = np.abs(np.arange(max_length, dtype=np.int64)[None, :]
                     - pmf_center[:, None]).astype(np.float64)
    s = scale_table[:, None]

    def phi(x):
        return 0.5 * torch.special.erfc(
            torch.from_numpy(-(2 ** -0.5) * x)).numpy()

    upper = phi((0.5 - samples) / s)
    lower = phi((-0.5 - samples) / s)
    pmf = upper - lower
    tail_mass = 2 * lower[:, 0]
    return pmf, tail_mass, pmf_length, -pmf_center
