"""The whole train step's share of the card's peak: 3 x the forward's
product FLOPs at the cell's shapes (`costs.py`) x the window's steps,
over the window's wall times 3xTF32's 165 TFLOP/s (700 W)."""

LAYER = "Whole step (train/step.py)"
UNIT = "%"
MOVES = "train_img_per_s"
SOURCE = "host_clock"


def read(r):
    return r.mfu()
