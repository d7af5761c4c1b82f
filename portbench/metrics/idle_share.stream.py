"""The card's idle share in the traced slice: 1 - the union of its device
records over the slice's wall."""

LAYER = "Device"
UNIT = "%"
MOVES = "stream_mps"
SOURCE = "device_trace"


def read(r):
    return r.idle_share()
