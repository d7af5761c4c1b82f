"""ctypes bridge to the native rANS coder, the port's own loader.

Compiles `native/rans/rans.cpp` (shared with the JAX package, same C ABI
as mmnc_tpu/entropy/rans.py) into the port's build directory through
`ops/_build.py`; it never loads the JAX package's library. Symbols and
indexes cross as contiguous int32 numpy arrays.
"""

import ctypes
import functools

import numpy as np

from ..ops import _build


@functools.cache
def _lib():
    lib = _build.load("mmncrans")
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.mmnc_rans_encode_with_indexes.restype = ctypes.c_int64
    lib.mmnc_rans_encode_with_indexes.argtypes = [
        i32p, i32p, ctypes.c_int64, i32p, ctypes.c_int64, i32p, i32p, u8p,
        ctypes.c_int64]
    lib.mmnc_rans_decode_with_indexes.restype = ctypes.c_int32
    lib.mmnc_rans_decode_with_indexes.argtypes = [
        u8p, ctypes.c_int64, i32p, ctypes.c_int64, i32p, ctypes.c_int64,
        i32p, i32p, i32p]
    return lib


def _i32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _table_arrays(table):
    return (np.ascontiguousarray(table.cdfs, np.int32),
            np.ascontiguousarray(table.cdf_lengths, np.int32),
            np.ascontiguousarray(table.offsets, np.int32))


def encode_with_indexes(symbols, indexes, table) -> bytes:
    """Encode integer symbols with per-symbol CDF-row indexes -> bytes."""
    symbols = np.ascontiguousarray(symbols, np.int32).ravel()
    indexes = np.ascontiguousarray(indexes, np.int32).ravel()
    if symbols.shape != indexes.shape:
        raise ValueError(f"symbols/indexes length mismatch: "
                         f"{symbols.shape} vs {indexes.shape}")
    if len(indexes) and (indexes.min() < 0
                         or indexes.max() >= len(table.cdf_lengths)):
        raise ValueError("index outside the CDF table")
    cdfs, lengths, offsets = _table_arrays(table)
    capacity = 16 * len(symbols) + 64  # every symbol escaping, ~64 bits
    out = np.empty(capacity, np.uint8)
    n = _lib().mmnc_rans_encode_with_indexes(
        _i32(symbols), _i32(indexes), len(symbols), _i32(cdfs),
        cdfs.shape[1], _i32(lengths), _i32(offsets), _u8(out), capacity)
    if n < 0:
        raise RuntimeError(f"rANS encode failed with code {n}")
    return out[:n].tobytes()


def decode_with_indexes(data: bytes, indexes, table) -> np.ndarray:
    """Decode a bytestring back to int32 symbols (len == len(indexes))."""
    indexes = np.ascontiguousarray(indexes, np.int32).ravel()
    if len(indexes) and (indexes.min() < 0
                         or indexes.max() >= len(table.cdf_lengths)):
        raise ValueError("index outside the CDF table")
    buf = np.frombuffer(data, np.uint8).copy()
    cdfs, lengths, offsets = _table_arrays(table)
    out = np.zeros(len(indexes), np.int32)
    rc = _lib().mmnc_rans_decode_with_indexes(
        _u8(buf), len(buf), _i32(indexes), len(indexes), _i32(cdfs),
        cdfs.shape[1], _i32(lengths), _i32(offsets), _i32(out))
    if rc != 0:
        raise RuntimeError(f"rANS decode failed with code {rc}")
    return out
