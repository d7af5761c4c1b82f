"""Host ms a batch the stream's threads waited for its dispatch lock (the
port's `stream.lock_wait` spans, every thread) in the traced slice, over
the batches whose `stream.compress` span the slice holds (their tags).
None where the port keeps no spans or dropped some
(`profiling.dropped()`)."""

LAYER = "Stream (models/streaming.py)"
UNIT = "ms"
MOVES = "stream_mps"
SOURCE = "program_span"


def read(r):
    from mmnc_tpu_torch.utils import profiling
    if r.slice is None or not hasattr(profiling, "spans") \
            or profiling.dropped():
        return None
    t0, t1 = r.slice.t0, r.slice.t0 + r.slice.wall_s
    spans = [s for s in profiling.spans() if t0 <= s.start < t1]
    batches = {s.tag for s in spans
               if s.name == "stream.compress" and s.tag is not None}
    waits = [s.end - s.start for s in spans if s.name == "stream.lock_wait"]
    if not batches or not waits:
        return None
    return 1e3 * sum(waits) / len(batches)
