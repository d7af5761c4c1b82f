"""Host ms a batch in the device programs' signatures (the port's
`graphs.signature` spans: the shapes, the flags and every parameter's and
buffer's storage, read on each call) in the traced slice, over the
batches whose `stream.compress` span the slice holds (their tags). None
where the port keeps no spans or dropped some (`profiling.dropped()`)."""

LAYER = "Graphs (graphs.py, train/step.py)"
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
    t = [s.end - s.start - s.cost for s in spans
         if s.name == "graphs.signature"]
    if not batches or not t:
        return None
    return 1e3 * sum(t) / len(batches)
