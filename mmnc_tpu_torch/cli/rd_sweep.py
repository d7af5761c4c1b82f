"""Rate-distortion sweep (mmnc_tpu/cli/rd_sweep.py): train one model per
lambda, collect the RD points, plot the curves.

    python -m mmnc_tpu_torch.cli.rd_sweep -d synthetic -t rgb -m 1 -l 128 \
        -c 48 --lmbdas 0.1 0.01 0.001 --epochs 20 --batch-size 16 -w sweep1

Writes <out-dir>/<run>/rd_points.json and rd_<task>.png per task. Runs on
the CUDA device unless --device names another; `-g N` trains each lambda
data-parallel on N ranks (`parallel.launch`). `sweep` trains and writes
the points; `plot` draws them (it needs matplotlib, which `sweep` does
not).
"""

import argparse
import json
import os
import sys

from .. import analysis
from ..models import build_model
from ..parallel import launch
from ..train.loop import fit
from .train import get_loaders


def parse_args(argv):
    p = argparse.ArgumentParser(description="RD sweep over lambda values")
    p.add_argument("-d", "--dataset", required=True,
                   choices=("synthetic", "mnist", "fashion-mnist", "clevr"))
    p.add_argument("-t", "--tasks", required=True, nargs="+")
    p.add_argument("-m", "--model", required=True, type=int,
                   choices=range(1, 5))
    p.add_argument("-l", "--latent-channels", required=True, type=int)
    p.add_argument("-c", "--conv-channels", default=100, type=int)
    p.add_argument("-w", "--run-name", required=True)
    p.add_argument("--lmbdas", nargs="+", type=float,
                   default=[0.1, 0.01, 0.001])
    p.add_argument("-e", "--epochs", default=10, type=int)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("-lrm", "--learning-rate-main", default=1e-4, type=float)
    p.add_argument("-lra", "--learning-rate-aux", default=1e-3, type=float)
    p.add_argument("--image-size", default=256, type=int)
    p.add_argument("--train-size", default=1024, type=int)
    p.add_argument("--data-style", default="legacy",
                   choices=("legacy", "clevr"),
                   help="synthetic render style (see cli/train.py)")
    p.add_argument("--val-size", default=64, type=int)
    p.add_argument("--max-steps", default=None, type=int)
    p.add_argument("--out-dir", default="runs")
    p.add_argument("--devices", "-g", default=1, type=int,
                   help="devices in the data-parallel mesh: one process "
                        "per device")
    p.add_argument("--device", default=None,
                   help="torch device to train on (default: the CUDA "
                        "device; 'cpu' to run on the CPU)")
    return p.parse_args(argv)


def _fit_one(args, lmbda, run_name, device=None, n_devices=None):
    """Train the sweep's model at `lmbda` as run `run_name`."""
    model = build_model(
        args.model, args.tasks,
        latent_channels=args.latent_channels,
        conv_channels=args.conv_channels, lmbda=lmbda,
        learning_rate_main=args.learning_rate_main,
        learning_rate_aux=args.learning_rate_aux,
        device=device if device is not None else args.device)
    train_loader, val_loader = get_loaders(args)
    fit(model, train_loader, val_loader, epochs=args.epochs,
        run_name=run_name, out_dir=args.out_dir,
        compute_metrics=True, log_images=False,
        max_steps=args.max_steps, n_devices=n_devices)


def _fit_rank(mesh, args, lmbda, run_name):
    _fit_one(args, lmbda, run_name, mesh.device, mesh.world_size)


def sweep(args) -> list:
    """Train one model per lambda, read each run's last validation record
    as its RD point, write <out-dir>/<run>/rd_points.json; returns the
    points."""
    sweep_dir = os.path.join(args.out_dir, args.run_name)
    os.makedirs(sweep_dir, exist_ok=True)
    points = []
    for lmbda in args.lmbdas:
        sub_run = f"{args.run_name}-l{lmbda:g}"
        print(f"=== lambda {lmbda:g} -> run {sub_run}")
        if args.devices > 1:
            launch(_fit_rank, args.devices, args.device, args, lmbda,
                   sub_run)
        else:
            _fit_one(args, lmbda, sub_run)
        metrics_path = os.path.join(args.out_dir, sub_run,
                                    f"{sub_run}.metrics.jsonl")
        pt = analysis.final_rd_point(metrics_path, args.tasks)
        pt["lmbda"] = lmbda
        points.append(pt)
        print(f"  rd point: {pt}")

    with open(os.path.join(sweep_dir, "rd_points.json"), "w") as f:
        json.dump(points, f, indent=2)
    return points


def plot(args, points):
    """rd_<task>.png per task under <out-dir>/<run>."""
    sweep_dir = os.path.join(args.out_dir, args.run_name)
    label = f"model{args.model}"
    for task in args.tasks:
        out = os.path.join(sweep_dir, f"rd_{task}.png")
        analysis.plot_rd_curves({label: points}, task, out_path=out)
        print(f"wrote {out}")


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    points = sweep(args)
    plot(args, points)
    return points


if __name__ == "__main__":
    main()
