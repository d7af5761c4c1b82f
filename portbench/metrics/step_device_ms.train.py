"""Device ms a train step: the durations of the slice's kernel, copy and
memset records over the steps they cover (its GDN records over a step's
GDN launches)."""

LAYER = "Train step (train/step.py, train/state.py)"
UNIT = "ms"
MOVES = "train_img_per_s"
SOURCE = "device_trace"


def read(r):
    t = r.device_s_per_unit()
    return None if t is None else 1e3 * t
