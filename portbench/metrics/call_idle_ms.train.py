"""The card's idle ms a train step that the train call's host work
explains. Of the traced slice's device records (by start), the gaps
between two records of different launches (`args.correlation`: a graph
replay's records share their launch's, so gaps inside a replay are left
out) are where the card ran dry; each is mapped onto the host clock by
the slice's offset and counted where, of the main thread's parts of the
train call (the port's `train.noise`, `train.inputs`, `train.replay` and
`train.outputs` spans), `train.noise`, `train.inputs` or `train.outputs`
covers most of it: more than any other part, and more than the host
spent outside the parts. Over the steps of the calls the slice holds.
None where the port keeps no spans or dropped some
(`profiling.dropped()`), or the slice has no host offset."""

LAYER = "Train step (train/step.py, train/state.py)"
UNIT = "ms"
MOVES = "train_img_per_s"
SOURCE = "program_span"
PARTS = ("train.noise", "train.inputs", "train.replay", "train.outputs")
HOST = ("train.noise", "train.inputs", "train.outputs")


def dry_gaps(s):
    """The slice's gaps between records of different launches, as
    (start, end) host seconds clipped to the slice."""
    t0, t1 = s.t0, s.t0 + s.wall_s
    out, end, last = [], None, None
    for e in sorted(s.events, key=lambda e: e["ts"]):
        corr = e.get("args", {}).get("correlation")
        if end is not None and e["ts"] > end and corr != last:
            a = max(t0, (end - s.offset_us) / 1e6)
            b = min(t1, (e["ts"] - s.offset_us) / 1e6)
            if b > a:
                out.append((a, b))
        if end is None or e["ts"] + e["dur"] > end:
            end, last = e["ts"] + e["dur"], corr
    return out


def split(r):
    """({part: idle ms a step that it covers most}, steps), or None."""
    from mmnc_tpu_torch.utils import profiling
    s = r.slice
    if s is None or s.offset_us is None or not hasattr(profiling, "spans") \
            or profiling.dropped():
        return None
    t0, t1 = s.t0, s.t0 + s.wall_s
    every = profiling.spans()
    calls = [c for c in every if c.name == "train.call" and t0 <= c.start < t1]
    if not calls:
        return None
    ids = {c.id for c in every if c.name == "train.call"}
    parts = [p for p in every if p.name in PARTS and p.parent in ids]
    by = {}
    for a, b in dry_gaps(s):
        cover = {}
        for p in parts:
            o = min(b, p.end) - max(a, p.start)
            if o > 0:
                cover[p.name] = cover.get(p.name, 0.0) + o
        if cover:
            name = max(cover, key=cover.get)
            if cover[name] > b - a - sum(cover.values()):
                by[name] = by.get(name, 0.0) + b - a
    steps = sum(c.args["steps"] for c in calls)
    return {k: 1e3 * v / steps for k, v in by.items()}, steps


def read(r):
    got = split(r)
    if got is None:
        return None
    return sum(got[0].get(k, 0.0) for k in HOST)
