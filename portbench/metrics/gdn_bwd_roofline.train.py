"""GDN's backward's share of its roofline in a train step: the mean bound
of its launches (the lesser of the CUDA-core and the 3xTF32 bound,
`costs.py`) over the mean device time of a launch, its row kernel's and
its helpers' records (the padding and the fixed-order sum) together."""

LAYER = "Kernel GDN backward (ops/gdn.py, csrc/gdn_backward.cu)"
UNIT = "%"
MOVES = "train_img_per_s"
SOURCE = "device_trace"
PATTERNS = ("gdn_backward_kernel", "gdn_backward_mma_kernel")
TIME_PATTERNS = ("gdn_backward",)


def read(r):
    return r.roofline("gdn_backward", PATTERNS,
                      time_patterns=TIME_PATTERNS)
