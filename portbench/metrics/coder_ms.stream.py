"""Host ms a batch in the rANS coder (the stream's `stream.rans_encode`
and `stream.rans_decode` stages, every thread), over the window."""

LAYER = "Host coder (entropy/rans.py)"
UNIT = "ms"
MOVES = "stream_mps"
SOURCE = "program_span"


def read(r):
    if r.spans is None or not r.units:
        return None
    t = r.spans.totals.get("stream.rans_encode", 0.0) \
        + r.spans.totals.get("stream.rans_decode", 0.0)
    return 1e3 * t / r.units if t else None
