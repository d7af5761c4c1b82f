"""The whole trip's share of the card's peak: the product FLOPs of every
conv, deconv and (I)GDN of the window's trips at the cell's shapes
(`costs.py`, taps that reach the image only) over the window's wall times
the peak at the cell's precision (3xTF32's 165 TFLOP/s for float32,
989 TFLOP/s for bf16; 700 W)."""

LAYER = "Whole trip (models/codecs.py, models/streaming.py)"
UNIT = "%"
MOVES = "stream_mps"
SOURCE = "host_clock"


def read(r):
    return r.mfu()
