"""Host ms a batch waited in the coder queue, from its submission on the
main thread to the coder thread's start on it (the port's `stream.queued`
spans) in the traced slice, over the batches whose `stream.compress` span
the slice holds (their tags). The loop is closed at `depth` batches with
one coder, so wherever the main thread waits on results (the card or the
coder sets the pace) this reads about depth x the batch period; it falls
towards 0 only where the main thread's dispatch sets the pace and the
coder waits for work. It does not tell the card from the coder. None
where the port keeps no spans or dropped some (`profiling.dropped()`)."""

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
    waits = [s.end - s.start for s in spans if s.name == "stream.queued"]
    if not batches or not waits:
        return None
    return 1e3 * sum(waits) / len(batches)
