"""ctypes bridge to the native rANS coder, the port's own loader.

Compiles `native/rans/rans.cpp` (shared with the JAX package, same C ABI
as mmnc_tpu/entropy/rans.py:53-99) into the port's build directory
through `ops/_build.py`; it never loads the JAX package's library.

Typed entry points (mmnc_tpu/entropy/rans.py:169-253): int16 symbols with
uint8 or int32 indexes are coded without widening on the host, into
streams byte-equal to the int32 path's, and a decode can write int16
symbols directly (it raises OverflowError where a symbol does not fit).
Decoding takes the fast path by default: a per-table bucket index (built
once per table and kept on it) brackets each symbol's search; `fast=False`
takes the classic search. Both give the same symbols. ctypes releases the
GIL during every native call, so coder threads overlap.
"""

import ctypes
import functools

import numpy as np

from ..ops import _build

_N_BUCKETS = 256  # bucket entries per CDF row (rans.cpp: 1 << (16 - 8))

_I32, _I16 = ctypes.c_int32, ctypes.c_int16
_U8, _U16 = ctypes.c_uint8, ctypes.c_uint16


def _p(t):
    return ctypes.POINTER(t)


@functools.cache
def _lib():
    lib = _build.load("mmncrans")
    table = [_p(_I32), ctypes.c_int64, _p(_I32), _p(_I32)]  # cdfs .. offsets
    for name, sym_t, idx_t in (("mmnc_rans_encode_with_indexes", _I32, _I32),
                               ("mmnc_rans_encode_i16u8", _I16, _U8),
                               ("mmnc_rans_encode_i16i32", _I16, _I32)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = ([_p(sym_t), _p(idx_t), ctypes.c_int64] + table
                       + [_p(_U8), ctypes.c_int64])
    for name, idx_t, out_t, fast in (
            ("mmnc_rans_decode_with_indexes", _I32, _I32, False),
            ("mmnc_rans_decode_u8i16", _U8, _I16, False),
            ("mmnc_rans_decode_i32i16", _I32, _I16, False),
            ("mmnc_rans_decode_fast_i32i32", _I32, _I32, True),
            ("mmnc_rans_decode_fast_u8i16", _U8, _I16, True),
            ("mmnc_rans_decode_fast_i32i16", _I32, _I16, True)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int32
        fn.argtypes = ([_p(_U8), ctypes.c_int64, _p(idx_t), ctypes.c_int64]
                       + table + ([_p(_U16)] if fast else []) + [_p(out_t)])
    lib.mmnc_rans_decbuckets_build.restype = ctypes.c_int32
    lib.mmnc_rans_decbuckets_build.argtypes = [
        _p(_I32), ctypes.c_int64, _p(_I32), ctypes.c_int32, _p(_U16)]
    return lib


def _ptr(a, ctype):
    return a.ctypes.data_as(_p(ctype))


def _table_arrays(table):
    return (np.ascontiguousarray(table.cdfs, np.int32),
            np.ascontiguousarray(table.cdf_lengths, np.int32),
            np.ascontiguousarray(table.offsets, np.int32))


def _fast_tables(table):
    """(buckets, cdfs, lengths, offsets) of a table, built on first use and
    kept on the table object (mmnc_tpu/entropy/rans.py:140-158)."""
    cached = getattr(table, "_mmnc_fast", None)
    if cached is not None:
        return cached
    cdfs, lengths, offsets = _table_arrays(table)
    buckets = np.empty(len(lengths) * _N_BUCKETS, np.uint16)
    rc = _lib().mmnc_rans_decbuckets_build(
        _ptr(cdfs, _I32), cdfs.shape[1], _ptr(lengths, _I32), len(lengths),
        _ptr(buckets, _U16))
    if rc != 0:
        raise ValueError(f"rANS decode buckets failed with code {rc}")
    cached = (buckets, cdfs, lengths, offsets)
    table._mmnc_fast = cached
    return cached


def _check_indexes(indexes, table):
    if len(indexes) and (indexes.min() < 0
                         or indexes.max() >= len(table.cdf_lengths)):
        raise ValueError("index outside the CDF table")


def encode_with_indexes(symbols, indexes, table) -> bytes:
    """Encode integer symbols with per-symbol CDF-row indexes -> bytes.

    int16 symbols with uint8 or int32 indexes take the typed entry points
    as they are; anything else is widened to int32. The stream is the same
    either way."""
    symbols = np.ascontiguousarray(symbols).ravel()
    indexes = np.ascontiguousarray(indexes).ravel()
    if symbols.shape != indexes.shape:
        raise ValueError(f"symbols/indexes length mismatch: "
                         f"{symbols.shape} vs {indexes.shape}")
    _check_indexes(indexes, table)
    lib = _lib()
    if symbols.dtype == np.int16 and indexes.dtype == np.uint8:
        fn, sym_t, idx_t = lib.mmnc_rans_encode_i16u8, _I16, _U8
    elif symbols.dtype == np.int16 and indexes.dtype == np.int32:
        fn, sym_t, idx_t = lib.mmnc_rans_encode_i16i32, _I16, _I32
    else:
        symbols = symbols.astype(np.int32, copy=False)
        indexes = indexes.astype(np.int32, copy=False)
        fn, sym_t, idx_t = lib.mmnc_rans_encode_with_indexes, _I32, _I32
    cdfs, lengths, offsets = _table_arrays(table)
    capacity = 16 * len(symbols) + 64  # every symbol escaping, ~64 bits
    out = np.empty(capacity, np.uint8)
    n = fn(_ptr(symbols, sym_t), _ptr(indexes, idx_t), len(symbols),
           _ptr(cdfs, _I32), cdfs.shape[1], _ptr(lengths, _I32),
           _ptr(offsets, _I32), _ptr(out, _U8), capacity)
    if n < 0:
        raise RuntimeError(f"rANS encode failed with code {n}")
    return out[:n].tobytes()


def decode_with_indexes(data: bytes, indexes, table, out_dtype=np.int32,
                        fast: bool = True, out=None) -> np.ndarray:
    """Decode a bytestring back to symbols (len == len(indexes)).

    out_dtype np.int16 writes narrow symbols directly and raises
    OverflowError where the stream holds one that does not fit. `out`, a
    contiguous array of that dtype and length, receives the symbols (a
    pinned host buffer, say); else a new array does."""
    out_dtype = np.dtype(out_dtype)
    if out_dtype not in (np.int16, np.int32):
        raise ValueError(f"out_dtype must be int16 or int32, got {out_dtype}")
    indexes = np.ascontiguousarray(indexes).ravel()
    if indexes.dtype != np.uint8 and indexes.dtype != np.int32:
        indexes = indexes.astype(np.int32)
    if out_dtype == np.int32 and indexes.dtype == np.uint8:
        indexes = indexes.astype(np.int32)  # no u8 -> i32 entry point
    _check_indexes(indexes, table)
    if out is None:
        out = np.zeros(len(indexes), out_dtype)
    elif (out.dtype != out_dtype or out.size != len(indexes)
          or not out.flags.c_contiguous):
        raise ValueError("out does not match the decode's dtype and length")
    lib = _lib()
    idx_t = _U8 if indexes.dtype == np.uint8 else _I32
    out_t = _I16 if out_dtype == np.int16 else _I32
    name = {(_I32, _I32): "with_indexes", (_U8, _I16): "u8i16",
            (_I32, _I16): "i32i16"}[(idx_t, out_t)]
    if fast:
        name = "fast_i32i32" if name == "with_indexes" else "fast_" + name
        buckets, cdfs, lengths, offsets = _fast_tables(table)
        extra = [_ptr(buckets, _U16)]
    else:
        cdfs, lengths, offsets = _table_arrays(table)
        extra = []
    buf = np.frombuffer(data, np.uint8)
    rc = getattr(lib, f"mmnc_rans_decode_{name}")(
        _ptr(buf, _U8), len(buf), _ptr(indexes, idx_t), len(indexes),
        _ptr(cdfs, _I32), cdfs.shape[1], _ptr(lengths, _I32),
        _ptr(offsets, _I32), *extra, _ptr(out.reshape(-1), out_t))
    if rc == -3:
        raise OverflowError("rANS decode: a stream symbol does not fit the "
                            "requested int16 output")
    if rc != 0:
        raise RuntimeError(f"rANS decode failed with code {rc}")
    return out.reshape(-1)
