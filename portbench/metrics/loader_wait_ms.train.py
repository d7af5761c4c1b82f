"""Host ms a step the trainer waited for its prefetched batch
(`prefetch_to_device(stats=...)`'s "wait_s" over the window)."""

LAYER = "Data (data/loader.py)"
UNIT = "ms"
MOVES = "train_img_per_s"
SOURCE = "program_counter"


def read(r):
    if r.loader_wait_s is None or not r.units:
        return None
    return 1e3 * r.loader_wait_s / r.units
