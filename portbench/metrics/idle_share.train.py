"""The card's idle share in the traced slice of train steps: 1 - the
union of its device records over the slice's wall."""

LAYER = "Device"
UNIT = "%"
MOVES = "train_img_per_s"
SOURCE = "device_trace"


def read(r):
    return r.idle_share()
