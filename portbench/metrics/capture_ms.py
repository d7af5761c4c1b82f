"""Host ms the cell's CUDA graphs took to capture (`graphs.all_stats`'s
"capture_s" of every device program, and the train call's captures),
summed: part of set-up."""

LAYER = "Graphs (graphs.py, train/step.py)"
UNIT = "ms"
MOVES = "setup_s"
SOURCE = "program_counter"


def read(r):
    return 1e3 * r.capture_s
