"""GDN's share of its roofline in a train step: the mean bound of the
forward's (I)GDN launches (`costs.py`) over the mean device time of the
GDN kernel's records."""

LAYER = "Kernel GDN (ops/gdn.py, csrc/gdn.cu)"
UNIT = "%"
MOVES = "train_img_per_s"
SOURCE = "device_trace"
PATTERNS = ("gdn_kernel",)
EXCLUDE = ("gdn_backward", "deconv_igdn")


def read(r):
    return r.roofline("gdn", PATTERNS, EXCLUDE)
