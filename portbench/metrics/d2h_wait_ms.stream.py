"""Host ms a batch the stream waited for its device-to-host copies (the
`stream.d2h_wait` stage), over the window."""

LAYER = "Stream (models/streaming.py)"
UNIT = "ms"
MOVES = "stream_mps"
SOURCE = "program_span"


def read(r):
    if r.spans is None or not r.units:
        return None
    t = r.spans.totals.get("stream.d2h_wait")
    return 1e3 * t / r.units if t else None
