"""Bitstream container: a compress()/compress_partial() result in one
file, the layout of mmnc_tpu/bitstream.py (copied: the port imports
nothing of the JAX package), so either package reads the other's files:

    magic | version | header JSON (model class, tasks, shapes, counts)
    | per-stream u32 lengths | stream bytes

`decompress_file` rebuilds every task, or a subset of the tasks of a
partial-coded disjoint/shared container, with a port codec, which holds
its own coding tables.
"""

import json
import struct
from typing import Dict, List, Optional

_MAGIC = b"MMNC"
_VERSION = 1


def _write_streams(f, streams: List[bytes]):
    f.write(struct.pack("<I", len(streams)))
    for s in streams:
        f.write(struct.pack("<I", len(s)))
    for s in streams:
        f.write(s)


def _read_streams(f) -> List[bytes]:
    (n,) = struct.unpack("<I", f.read(4))
    lengths = struct.unpack(f"<{n}I", f.read(4 * n))
    return [f.read(length) for length in lengths]


def save_bitstream(path: str, ans: Dict, hyper_parameters: Dict,
                   partial: bool = False):
    """Write a compress()/compress_partial() result to one file."""
    header = {
        "hyper_parameters": hyper_parameters,
        "shape": list(ans["shape"]),
        "y_shape": list(ans["y_shape"]),
        "partial": partial,
        # packed containers carry one stream per batch; the item count
        # lives here (absent in containers written before stream packing,
        # where it equals the per-item stream count)
        "batch_size": ans.get("batch_size"),
    }
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", _VERSION))
        if partial:
            header["stream_names"] = list(ans["task_streams"].keys())
            hdr = json.dumps(header).encode()
            f.write(struct.pack("<I", len(hdr)))
            f.write(hdr)
            for name in header["stream_names"]:
                _write_streams(f, ans["task_streams"][name])
            _write_streams(f, ans["z_strings"])
        else:
            hdr = json.dumps(header).encode()
            f.write(struct.pack("<I", len(hdr)))
            f.write(hdr)
            _write_streams(f, ans["strings"][0])
            _write_streams(f, ans["strings"][1])


def load_bitstream(path: str):
    """-> (ans dict as produced by compress/compress_partial, header)."""
    with open(path, "rb") as f:
        if f.read(4) != _MAGIC:
            raise ValueError(f"{path}: not an MMNC bitstream")
        (version,) = struct.unpack("<I", f.read(4))
        if version != _VERSION:
            raise ValueError(f"{path}: unsupported version {version}")
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen))
        if header["partial"]:
            task_streams = {name: _read_streams(f)
                            for name in header["stream_names"]}
            z_strings = _read_streams(f)
            ans = {"task_streams": task_streams, "z_strings": z_strings,
                   "shape": tuple(header["shape"]),
                   "y_shape": tuple(header["y_shape"])}
        else:
            y_strings = _read_streams(f)
            z_strings = _read_streams(f)
            ans = {"strings": [y_strings, z_strings],
                   "shape": tuple(header["shape"]),
                   "y_shape": tuple(header["y_shape"])}
        bsz = header.get("batch_size")
        ans["batch_size"] = bsz if bsz is not None else len(z_strings)
    return ans, header


def decompress_file(path: str, model, tasks: Optional[List[str]] = None):
    """Load a container and decode it with `model` (its tables built by
    update_bottleneck_values): every task, or `tasks` of a partial one."""
    ans, header = load_bitstream(path)
    if header["partial"]:
        return model.decompress_tasks(ans, tasks or list(model.tasks))
    if tasks is not None:
        raise ValueError("task-subset decode needs a partial container")
    return model.decompress(ans["strings"], ans["shape"], ans["y_shape"],
                            batch_size=ans["batch_size"])
