"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Needs the cards the cell asks for (CUDA), else exits 2 and prints no
result. Sets up the cell (its driver, `portbench/drivers/`), measures for
`--seconds`, judges the answers against the plain reference, and prints
as the last line of standard output one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
`--trace 0`, its per-layer metrics with `--trace 1`), `device` (with
`--trace 1` also the traced slice's `busy_s` and `window_s`),
`breakdown` (with `--trace 1`) and, last, `checks`: each number compared
with its limit, which also end standard error. Exits 1 and prints no
result if the process holds JAX or the JAX package once the window has
closed.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the caches of anything the run builds stay at fixed paths inside the
# checkout (the program's own kernels build into mmnc_tpu_torch/_build/)
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ.setdefault(_var, os.path.join(ROOT, ".portbench_cache", _sub))

import argparse  # noqa: E402
import json  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mmnc_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (`mmnc_tpu_torch` is not `mmnc_tpu`)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def measure(args, device, cell=None, t_start=T_START):
    """Run the cell on `device` -> the result line (a dict), its checks
    last. `cell` defaults to the workload's in BENCHMARK.json."""
    import torch

    from .registry import Cell
    cell = cell or Cell(args.workload)
    traced = bool(args.trace)
    out = cell.driver().run(cell, args.seed, args.seconds, traced, device,
                            t_start)
    units = {m["name"]: m["unit"] for m in cell.bench["end_to_end"]
             + cell.bench["per_layer"]}
    metrics = {}
    if traced:
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(out.reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]],
                                  "unit": units[m["name"]]}
    correct = all(v <= lim for v, lim in out.checks.values())
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    s = out.reading.slice
    if traced and s is not None:
        dev["busy_s"] = s.busy_s()
        dev["window_s"] = s.wall_s
        result["breakdown"] = s.breakdown(out.reading.spans)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in out.checks.items()}
    return result


def main(argv=None):
    args = parse(argv if argv is not None else sys.argv[1:])
    import torch
    from .registry import Cell
    cell = Cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); {have} "
              f"available", file=sys.stderr)
        return 2
    result = measure(args, torch.device("cuda", 0), cell)
    found = forbidden_modules()
    if found:
        print(f"the process holds {found}: the benchmark runs without JAX "
              f"and the JAX package", file=sys.stderr)
        return 1
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
