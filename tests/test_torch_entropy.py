"""mmnc_tpu_torch entropy coding against mmnc_tpu on the CPU: the scale
table bit for bit, build_indexes, likelihoods, CDF tables and rANS bytes.
Integer results must be exactly equal."""

import hashlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmnc_tpu.entropy import rans as j_rans
from mmnc_tpu.entropy.entropy_bottleneck import EntropyBottleneck as JEB
from mmnc_tpu.entropy.gaussian_conditional import GaussianConditional as JGC
from mmnc_tpu.entropy.gaussian_conditional import \
    get_scale_table as j_scale_table
from mmnc_tpu.entropy.tables import CdfTable as JCdfTable
from mmnc_tpu.entropy.tables import build_eb_table as j_build_eb_table
from mmnc_tpu.entropy.tables import build_gc_table as j_build_gc_table
from mmnc_tpu.entropy.tables import \
    pmf_to_quantized_cdf_np as j_pmf_to_quantized_cdf

from mmnc_tpu_torch.entropy import gaussian_conditional as gc
from mmnc_tpu_torch.entropy import rans
from mmnc_tpu_torch.entropy.entropy_bottleneck import EntropyBottleneck
from mmnc_tpu_torch.entropy.tables import (CdfTable, build_eb_table,
                                           build_gc_table,
                                           pmf_to_quantized_cdf_np)


@pytest.fixture(scope="module")
def eb_pair():
    """A JAX EntropyBottleneck's params, perturbed by numpy noise so the
    medians and tails differ per channel, and the port module carrying
    the same values."""
    c = 6
    variables = JEB(channels=c).init(jax.random.PRNGKey(3),
                                     jnp.zeros((1, 2, 2, c)), training=False)
    rng = np.random.default_rng(0)
    params = {}
    for k, v in variables["params"].items():
        v = np.asarray(v)
        scale = 2.0 if k == "quantiles" else 0.05
        params[k] = (v + scale * rng.normal(size=v.shape)).astype(np.float32)
    eb = EntropyBottleneck(c)
    with torch.no_grad():
        for k, v in params.items():
            name = "quantiles" if k == "quantiles" else "_" + k.replace("_", "")
            getattr(eb, name).copy_(torch.from_numpy(v))
    return params, eb


def test_scale_table_bit_equal_to_jax():
    got = gc.get_scale_table().numpy()
    want = np.asarray(j_scale_table(), np.float32)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_build_indexes_equal_on_random_and_exact_table_scales():
    table = np.asarray(j_scale_table(), np.float32)
    rng = np.random.default_rng(1)
    random = np.exp(rng.uniform(np.log(0.01), np.log(500.0), 4000))
    edges = np.concatenate([table, np.nextafter(table, np.float32(0)),
                            np.nextafter(table, np.float32(1e9)),
                            [0.0, -1.0, 0.11, 1e6]])
    scales = np.concatenate([random, edges]).astype(np.float32)
    scales = scales[:len(scales) // 8 * 8].reshape(-1, 2, 2, 2)
    want = np.asarray(JGC.build_indexes(jnp.asarray(scales)))
    got = gc.build_indexes(torch.from_numpy(scales)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_gaussian_likelihood_matches_jax_with_legacy_broadcast():
    rng = np.random.default_rng(2)
    y = np.round(rng.normal(size=(2, 1, 1, 8)) * 3).astype(np.float32)
    scales = np.exp(rng.normal(size=(2, 4, 4, 8))).astype(np.float32)
    want = np.asarray(JGC.likelihood(jnp.asarray(y), jnp.asarray(scales)))
    got = gc.likelihood(torch.from_numpy(y), torch.from_numpy(scales)).numpy()
    assert got.shape == want.shape == (2, 4, 4, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_entropy_bottleneck_eval_matches_jax(eb_pair):
    params, eb = eb_pair
    rng = np.random.default_rng(3)
    z = (rng.normal(size=(2, 3, 3, 6)) * 4).astype(np.float32)
    z_hat_j, lik_j = JEB(channels=6).apply(
        {"params": {k: jnp.asarray(v) for k, v in params.items()}},
        jnp.asarray(z), training=False)
    with torch.no_grad():
        z_hat_t, lik_t = eb(torch.from_numpy(z).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(z_hat_t.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(z_hat_j))
    np.testing.assert_allclose(lik_t.permute(0, 2, 3, 1).numpy(),
                               np.asarray(lik_j), rtol=1e-4, atol=1e-7)


def _assert_tables_equal(a, b):
    np.testing.assert_array_equal(a.cdfs, b.cdfs)
    np.testing.assert_array_equal(a.cdf_lengths, b.cdf_lengths)
    np.testing.assert_array_equal(a.offsets, b.offsets)


def test_eb_cdf_table_matches_jax_up_to_float32_ties(eb_pair):
    """The EB pmf is float32 math through softplus/tanh/sigmoid, whose XLA
    CPU versions differ from torch's in the last ulp (XLA's tanh is its own
    rational approximation). A pmf one ulp apart quantizes to a frequency
    one count apart when p * 2^16 sits on a rounding tie, so the tables
    agree in layout and medians exactly and in every CDF entry to within
    one count of 2^16; real coding on JAX's table is byte-equal
    (test_rans_bytes_equal_on_the_jax_eb_table and test_torch_codec.py)."""
    params, eb = eb_pair
    want, want_med = j_build_eb_table(params, params["quantiles"])
    got, got_med = build_eb_table(eb)
    assert got.cdfs.shape == want.cdfs.shape
    np.testing.assert_array_equal(got.cdf_lengths, want.cdf_lengths)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    np.testing.assert_array_equal(got_med, want_med)
    assert np.abs(got.cdfs.astype(np.int64) - want.cdfs).max() <= 1


def test_rans_bytes_equal_on_the_jax_eb_table(eb_pair):
    params, _ = eb_pair
    j_table, _ = j_build_eb_table(params, params["quantiles"])
    table = CdfTable(cdfs=j_table.cdfs, cdf_lengths=j_table.cdf_lengths,
                     offsets=j_table.offsets)
    rng = np.random.default_rng(6)
    indexes = np.tile(np.arange(6, dtype=np.int32), 500)
    symbols = np.round(rng.normal(size=indexes.shape) * 3).astype(np.int32)
    got = rans.encode_with_indexes(symbols, indexes, table)
    assert got == j_rans.encode_with_indexes(symbols, indexes, j_table)
    np.testing.assert_array_equal(
        rans.decode_with_indexes(got, indexes, table), symbols)


def test_gc_cdf_table_equal_to_jax():
    _assert_tables_equal(build_gc_table(), j_build_gc_table())


def test_pmf_to_quantized_cdf_equal_to_jax():
    rng = np.random.default_rng(4)
    for _ in range(30):
        pmf = rng.random(int(rng.integers(2, 50)))
        pmf = pmf / pmf.sum() * (1 - 1e-6)
        row = np.concatenate([pmf, [1e-6]])
        np.testing.assert_array_equal(pmf_to_quantized_cdf_np(row),
                                      j_pmf_to_quantized_cdf(row))


def _random_table(rng, rows=5, support=20):
    cdfs, lengths = [], []
    for _ in range(rows):
        pmf = rng.random(int(rng.integers(4, support))) + 1e-4
        pmf = pmf / pmf.sum() * (1 - 1e-6)
        cdfs.append(pmf_to_quantized_cdf_np(np.concatenate([pmf, [1e-6]])))
        lengths.append(len(cdfs[-1]))
    mat = np.zeros((rows, max(lengths)), np.int32)
    for r, c in enumerate(cdfs):
        mat[r, :len(c)] = c
    offsets = rng.integers(-8, 8, rows).astype(np.int32)
    lengths = np.asarray(lengths, np.int32)
    return (CdfTable(cdfs=mat, cdf_lengths=lengths, offsets=offsets),
            JCdfTable(cdfs=mat, cdf_lengths=lengths, offsets=offsets))


@pytest.mark.parametrize("table_kind", ["gaussian", "random"])
def test_rans_bytes_equal_to_jax_and_round_trip(table_kind):
    rng = np.random.default_rng(5)
    n = 5000
    if table_kind == "gaussian":
        t_table, j_table = build_gc_table(), j_build_gc_table()
        indexes = rng.integers(0, 64, n).astype(np.int32)
        symbols = np.round(rng.normal(size=n) * 6).astype(np.int32)
    else:
        t_table, j_table = _random_table(rng)
        indexes = rng.integers(0, 5, n).astype(np.int32)
        symbols = (rng.integers(-30, 30, n)
                   + t_table.offsets[indexes]).astype(np.int32)
    symbols[::101] += 4000  # bypass escapes
    got = rans.encode_with_indexes(symbols, indexes, t_table)
    want = j_rans.encode_with_indexes(symbols, indexes, j_table)
    assert got == want
    np.testing.assert_array_equal(
        rans.decode_with_indexes(got, indexes, t_table), symbols)


def test_rans_golden_stream_of_the_jax_package():
    """The input and digest of tests/test_rans.py::test_golden_stream_pinned."""
    rng = np.random.default_rng(1234)
    cdfs, lengths = [], []
    for n in (6, 18, 40):
        pmf = rng.random(n) + 1e-4
        pmf = pmf / pmf.sum() * (1 - 1e-6)
        cdf = pmf_to_quantized_cdf_np(np.concatenate([pmf, [1e-6]]))
        cdfs.append(cdf)
        lengths.append(len(cdf))
    mat = np.zeros((3, max(lengths)), np.int32)
    for r, c in enumerate(cdfs):
        mat[r, :len(c)] = c
    table = CdfTable(cdfs=mat, cdf_lengths=np.asarray(lengths, np.int32),
                     offsets=np.asarray([-3, 0, 5], np.int32))
    n = 10_000
    idx = rng.integers(0, 3, n).astype(np.int32)
    sym = rng.integers(-10, 50, n).astype(np.int32)
    out_pos = np.arange(0, n, 97)
    sym[out_pos] = (np.arange(len(out_pos)) * 7919) % 60001 - 30000
    data = rans.encode_with_indexes(sym, idx, table)
    np.testing.assert_array_equal(rans.decode_with_indexes(data, idx, table),
                                  sym)
    assert len(data) == 23184
    assert (hashlib.sha256(data).hexdigest()
            == "6b97949d2e92d3c8862866115a8f02c6e60f463b69bfe726105bd99ce8d4d925")


def test_rans_rejects_out_of_table_indexes():
    table = build_gc_table()
    with pytest.raises(ValueError):
        rans.encode_with_indexes(np.zeros(3, np.int32),
                                 np.array([0, 64, 1], np.int32), table)
    with pytest.raises(ValueError):
        rans.encode_with_indexes(np.zeros(3, np.int32), np.zeros(2, np.int32),
                                 table)


# --- typed entry points and fast decode ------------------------------------

def _gaussian_stream_case(n=4000, seed=7):
    rng = np.random.default_rng(seed)
    indexes = rng.integers(0, 64, n).astype(np.int32)
    symbols = np.round(rng.normal(size=n) * 6).astype(np.int32)
    symbols[::97] += 300  # bypass escapes, still within int16
    return symbols, indexes


@pytest.mark.parametrize("idx_dtype", [np.uint8, np.int32])
def test_typed_encode_bytes_equal_to_int32_path_and_to_jax(idx_dtype):
    """int16 symbols with uint8 / int32 indexes take the typed entry
    points and give the int32 path's stream, and the JAX package's."""
    table, j_table = build_gc_table(), j_build_gc_table()
    symbols, indexes = _gaussian_stream_case()
    want = rans.encode_with_indexes(symbols, indexes, table)
    got = rans.encode_with_indexes(symbols.astype(np.int16),
                                   indexes.astype(idx_dtype), table)
    assert got == want
    assert got == j_rans.encode_with_indexes(symbols.astype(np.int16),
                                             indexes.astype(idx_dtype),
                                             j_table)


@pytest.mark.parametrize("idx_dtype,out_dtype", [
    (np.int32, np.int32), (np.uint8, np.int16), (np.int32, np.int16),
    (np.uint8, np.int32)])
def test_fast_decode_equals_classic_decode(idx_dtype, out_dtype):
    table = build_gc_table()
    symbols, indexes = _gaussian_stream_case(seed=8)
    data = rans.encode_with_indexes(symbols, indexes, table)
    indexes = indexes.astype(idx_dtype)
    fast = rans.decode_with_indexes(data, indexes, table, out_dtype=out_dtype)
    classic = rans.decode_with_indexes(data, indexes, table,
                                       out_dtype=out_dtype, fast=False)
    assert fast.dtype == classic.dtype == out_dtype
    np.testing.assert_array_equal(fast, classic)
    np.testing.assert_array_equal(fast, symbols)
    out = np.empty(len(symbols), out_dtype)
    assert rans.decode_with_indexes(data, indexes, table, out_dtype=out_dtype,
                                    out=out) is not None
    np.testing.assert_array_equal(out, symbols)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("idx_dtype", [np.uint8, np.int32])
def test_int16_decode_raises_overflow_on_an_outlier(fast, idx_dtype):
    table = build_gc_table()
    symbols, indexes = _gaussian_stream_case(n=500, seed=9)
    symbols[123] = 40000  # escapes; does not fit int16
    data = rans.encode_with_indexes(symbols, indexes, table)
    with pytest.raises(OverflowError):
        rans.decode_with_indexes(data, indexes.astype(idx_dtype), table,
                                 out_dtype=np.int16, fast=fast)
    np.testing.assert_array_equal(
        rans.decode_with_indexes(data, indexes, table, fast=fast), symbols)


def test_fast_decode_tables_are_built_once_per_table():
    table = build_gc_table()
    symbols, indexes = _gaussian_stream_case(n=100)
    data = rans.encode_with_indexes(symbols, indexes, table)
    rans.decode_with_indexes(data, indexes, table)
    cached = table._mmnc_fast
    rans.decode_with_indexes(data, indexes, table)
    assert table._mmnc_fast is cached
    with pytest.raises(ValueError):
        rans.decode_with_indexes(data, indexes, table, out_dtype=np.int16,
                                 out=np.empty(len(indexes), np.int32))
