"""GDN's share of its roofline in a serving trip: the mean bound of the
trip's (I)GDN launches that no deconv fuses (work from the cell's shapes,
`costs.py`) over the mean device time of the GDN kernel's records."""

LAYER = "Kernel GDN (ops/gdn.py, csrc/gdn.cu)"
UNIT = "%"
MOVES = "stream_mps"
SOURCE = "device_trace"
PATTERNS = ("gdn_kernel",)
EXCLUDE = ("gdn_backward", "deconv_igdn")


def read(r):
    return r.roofline("gdn", PATTERNS, EXCLUDE)
