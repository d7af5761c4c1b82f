"""The control of a cell's comparison: the plain reference put in the
program's place, computed in the next precision below the configuration's
(TF32 operands for float32, fp8 for bf16), or a fault planted in it, and
judged as a run judges the program. The benchmark's own runs never run
this; its readings set the upper end of each limit (PERF.md).

    python3 -m portbench.control --workload <cell> --seeds <n> ...
                  [--fault control|half_batch|last_head_frozen|wide]

Stream cells: the first `judge_batches` batches of the pool, their x_hats
and stream bytes from the control's symbols, scale indexes and synthesis.
The train cell: the checked steps by the control ("control"), on the
first half of each batch ("half_batch", the mean over the rest), or with
the last task's output head given no gradient ("last_head_frozen": the
semantic head of shared4). "wide" is no control: the float32 reference
judged against the float64 one, with the rounding it shows: each leaf's
float32 gradient against its float64 one, over its own norm (the worst
leaf's: a leaf nought to rounding reads about 1), and the smallest
leaf's gradient norm over the median leaf's. Prints one JSON line a
seed: the numbers compared and their limits.
"""

import statistics

import argparse
import json
import sys

from .drivers import common
from .registry import Cell
from .weights import make_weights


def control_numerics(torch, dtype_name):
    from .reference.codec import Numerics
    act = getattr(torch, dtype_name)
    return Numerics(act, "tf32" if act == torch.float32 else "fp8")


def stream_control(torch, cell, seed, device):
    from .drivers import stream
    from .reference import codec, coding
    cfg, tr = cell.config, cell.traffic
    pool = common.make_inputs(torch, cfg, tr["pool"], tr["batch"], seed,
                              device)
    params = make_weights(cfg, seed, device)
    ctrl = codec.Codec(cfg, params, control_numerics(torch, tr["dtype"]))
    gauss = coding.gaussian_table()
    prior, _ = coding.prior_table(params)
    items = []
    for k in range(tr["judge_batches"]):
        with torch.no_grad():
            y, z = ctrl.analyze(pool[k % len(pool)])
            y_sym, z_sym, idx = ctrl.symbols(y, z)
            x_hats = {t: v.to(ctrl.num.act) for t, v in
                      ctrl.synthesize(y_sym).items()}
        items.append((k, (x_hats, coding.batch_bytes(y_sym, z_sym, idx,
                                                     gauss, prior))))
    return stream.judge(torch, cell, seed, device, pool, items)


def train_control(torch, cell, seed, device, fault):
    from .drivers import train
    cfg, tr = cell.config, cell.traffic
    pool = [{t: x.cpu().numpy() for t, x in b.items()} for b in
            common.make_inputs(torch, cfg, tr["pool"], tr["batch"], seed,
                               device)]
    if fault == "wide":
        return wide_readings(torch, cell, seed, device, pool)
    want = train.reference_steps(torch, cell, seed, device, pool)
    if fault == "half_batch":
        half = [{t: x[:len(x) // 2] for t, x in b.items()} for b in pool]
        got = train.reference_steps(torch, cell, seed, device, half)
    elif fault == "last_head_frozen":
        head = f"model.output_heads.{len(cfg['tasks']) - 1}."

        def freeze(grads):
            for k, g in grads.items():
                if k.startswith(head):
                    g.zero_()
        got = train.reference_steps(torch, cell, seed, device, pool,
                                    alter=freeze)
    else:
        got = train.reference_steps(torch, cell, seed, device, pool,
                                    control_numerics(torch, "float32"))
    return train.compare(cell.limits, got, want)


def wide_readings(torch, cell, seed, device, pool):
    """The float32 reference against the float64 one over the checked
    steps: its checks, and the rounding they show ({name: (value,
    None)})."""
    from .drivers import train
    from .reference import train as ref_train
    from .reference.codec import Numerics
    cfg, tr = cell.config, cell.traffic
    runs = {}
    for dtype in (torch.float32, torch.float64):
        params = {k: v.to(dtype) for k, v in
                  make_weights(cfg, seed, device).items()}
        batches = [{t: torch.as_tensor(x, device=device).to(dtype)
                    for t, x in pool[i % len(pool)].items()}
                   for i in range(tr["checked_steps"])]
        runs[dtype] = ref_train.run_steps(cfg, params, batches,
                                          seed % 2 ** 31, tr["total_steps"],
                                          Numerics(dtype))
    (l32, g32, c32), (l64, g64, c64) = runs[torch.float32], runs[
        torch.float64]

    def norm(t):
        return float(t.double().norm())

    n32 = {k: norm(v) for k, v in g32.items()}
    n64 = {k: norm(v) for k, v in g64.items()}
    med = statistics.median(n64.values())
    own = {k: norm(g32[k].double() - g64[k]) / max(n64[k], 1e-300)
           for k in g64}
    smallest = min(n64, key=n64.get)
    worst = max(own, key=own.get)
    out = train.compare(cell.limits, (l32, n32, {k: norm(v) for k, v in
                                                 c32.items()}),
                        (l64, n64, {k: norm(v) for k, v in c64.items()}))
    out.update({"own_rounding_worst": (own[worst], None),
                "smallest_leaf": (n64[smallest] / med, None)})
    print(f"smallest leaf {smallest}; the most rounding for its size "
          f"{worst}; median leaf's gradient {med:.6e}", file=sys.stderr)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default="control",
                   choices=("control", "half_batch", "last_head_frozen",
                            "wide"))
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = Cell(args.workload)
    for seed in args.seeds:
        if cell.traffic["driver"] == "train":
            checks = train_control(torch, cell, seed, device, args.fault)
        else:
            checks = stream_control(torch, cell, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault,
                          "checks": {k: {"value": v, "limit": lim}
                                     for k, (v, lim) in checks.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
