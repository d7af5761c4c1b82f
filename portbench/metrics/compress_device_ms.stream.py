"""Device ms a batch of the compress program (the encoder and the
hyper-networks: `_compress_device_fused`, or `_compress_device_lean` in
layout v1), from the port's device spans around each replay (a pair of
CUDA events on the compute stream: the input copies, the graph and the
clones) recorded in the traced slice, over the batches whose
`stream.compress` span the slice holds (their tags). None where the port
keeps no spans or dropped some (`profiling.dropped()`)."""

LAYER = "Device programs (models/codecs.py)"
UNIT = "ms"
MOVES = "stream_mps"
SOURCE = "program_span"
PROGRAMS = ("_compress_device_fused", "_compress_device_lean")


def read(r):
    from mmnc_tpu_torch.utils import profiling
    if r.slice is None or not hasattr(profiling, "device_spans") \
            or profiling.dropped():
        return None
    t0, t1 = r.slice.t0, r.slice.t0 + r.slice.wall_s
    batches = {s.tag for s in profiling.spans()
               if s.name == "stream.compress" and s.tag is not None
               and t0 <= s.start < t1}
    ms = [d.ms for d in profiling.device_spans()
          if d.name in PROGRAMS and t0 <= d.start < t1]
    if not batches or not ms:
        return None
    return sum(ms) / len(batches)
