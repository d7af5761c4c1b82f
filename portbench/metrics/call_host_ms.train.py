"""Host ms a train step in the train call outside the graph's launch:
the port's `train.call` spans less their `train.replay` children
(`graph.replay()`), so the noise draws, the inputs' copies, the
signature, the version bumps and the logs' clones, in the traced slice,
over the steps of the calls the slice holds (each call's "steps"). The
spans' own bookkeeping inside each (`Record.cost`: the children's
records) is taken out. None where the port keeps no spans or dropped
some (`profiling.dropped()`)."""

LAYER = "Train step (train/step.py, train/state.py)"
UNIT = "ms"
MOVES = "train_img_per_s"
SOURCE = "program_span"


def read(r):
    from mmnc_tpu_torch.utils import profiling
    if r.slice is None or not hasattr(profiling, "spans") \
            or profiling.dropped():
        return None
    t0, t1 = r.slice.t0, r.slice.t0 + r.slice.wall_s
    every = profiling.spans()
    replay = {}
    for s in every:
        if s.name == "train.replay":
            replay[s.parent] = replay.get(s.parent, 0.0) \
                + s.end - s.start - s.cost
    calls = [s for s in every if s.name == "train.call" and t0 <= s.start < t1]
    if not calls:
        return None
    host = sum(s.end - s.start - s.cost - replay.get(s.id, 0.0)
               for s in calls)
    return 1e3 * host / sum(s.args["steps"] for s in calls)
