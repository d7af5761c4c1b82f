"""deconv+IGDN's share of its roofline in a serving trip: the mean bound
of the trip's deconv5x5/2 + (I)GDN pairs (`costs.py`) over the mean
device time of the fused kernel's records."""

LAYER = "Kernel deconv+IGDN (ops/deconv_igdn.py, csrc/deconv_igdn.cu)"
UNIT = "%"
MOVES = "stream_mps"
SOURCE = "device_trace"
PATTERNS = ("deconv_igdn",)


def read(r):
    return r.roofline("deconv_igdn", PATTERNS)
