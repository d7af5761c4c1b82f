"""Device ms a batch: the durations of the slice's kernel, copy and
memset records, over the batches they cover (the slice's GDN records over
a trip's GDN launches)."""

LAYER = "Device programs (models/codecs.py)"
UNIT = "ms"
MOVES = "stream_mps"
SOURCE = "device_trace"


def read(r):
    t = r.device_s_per_unit()
    return None if t is None else 1e3 * t
