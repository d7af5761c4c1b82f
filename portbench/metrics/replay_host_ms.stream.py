"""Host ms a batch in the device programs' replayed calls outside the
launch itself: the port's `graphs.run` spans less their `graphs.launch`
children (`graph.replay()`, where a card-paced stream waits on a full
launch queue), so the inputs' flattening and copies, the signature, the
cache and the clones, in the traced slice, over the batches whose
`stream.compress` span the slice holds (their tags). The spans' own
bookkeeping inside each (`Record.cost`: the children's records, the
device span's events) is taken out. None where the port keeps no spans
or dropped some (`profiling.dropped()`)."""

LAYER = "Graphs (graphs.py, train/step.py)"
UNIT = "ms"
MOVES = "stream_mps"
SOURCE = "program_span"


def read(r):
    from mmnc_tpu_torch.utils import profiling
    if r.slice is None or not hasattr(profiling, "spans") \
            or profiling.dropped():
        return None
    t0, t1 = r.slice.t0, r.slice.t0 + r.slice.wall_s
    every = profiling.spans()
    launch = {}
    for s in every:
        if s.name == "graphs.launch":
            launch[s.parent] = launch.get(s.parent, 0.0) \
                + s.end - s.start - s.cost
    spans = [s for s in every if t0 <= s.start < t1]
    batches = {s.tag for s in spans
               if s.name == "stream.compress" and s.tag is not None}
    runs = [s.end - s.start - s.cost - launch.get(s.id, 0.0)
            for s in spans if s.name == "graphs.run"]
    if not batches or not runs:
        return None
    return 1e3 * sum(runs) / len(batches)
