"""Device ms a batch outside the port's kernels and the copies: cuDNN's
convolutions and the torch ops of the transforms."""

LAYER = "Transforms (models/heads.py, models/backbone.py)"
UNIT = "ms"
MOVES = "stream_mps"
SOURCE = "device_trace"
PATTERNS = ("gdn_kernel", "deconv_igdn", "gdn_backward")


def read(r):
    def library(name):
        return not any(p in name for p in PATTERNS) \
            and not name.startswith(("Memcpy", "Memset", "memcpy", "memset"))
    t = r.device_s_per_unit(library)
    return None if t is None else 1e3 * t
