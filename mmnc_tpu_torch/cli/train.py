"""Training CLI with mmnc_tpu's flag surface (mmnc_tpu/cli/train.py),
plus --device.

    python -m mmnc_tpu_torch.cli.train -d synthetic -t rgb depth_euclidean \
        -m 2 -l 300 -c 32 -w myrun --lmbda 1e-2 --epochs 10 --batch-size 16

Runs on the CUDA device unless --device names another (--device cpu);
with no card and no --device it raises. `-g N` trains data-parallel on N
ranks, one process each (`parallel.launch`): rank r on card r, or N CPU
ranks with --device cpu; --batch-size is the global batch, which the
ranks split. `--steps-per-call K` runs K train steps per call of the
step (`make_multi_train_step`), with `-g N` too; on a card (one process)
a call replays one CUDA graph of its K steps.
"""

import argparse
import os
import sys

from ..data import (SyntheticMultiTaskDataset, CLEVRDataset, BatchLoader,
                    task_parameters)
from ..data.mnist import MNISTMonoDataset
from ..models import build_model
from ..parallel import launch
from ..train.loop import fit

DATASET_ROOTS = {
    "mnist": os.environ.get("MMNC_MNIST_ROOT", "data/mnist"),
    "fashion-mnist": os.environ.get("MMNC_FMNIST_ROOT", "data/fashion-mnist"),
    "clevr": os.environ.get("MMNC_CLEVR_ROOT", "data/clevr"),
}


def parse_args(argv):
    p = argparse.ArgumentParser(description="Train a multi-task codec (CUDA)")
    p.add_argument("-d", "--dataset", required=True,
                   choices=("synthetic", "mnist", "fashion-mnist", "clevr"))
    p.add_argument("-t", "--tasks", required=True, nargs="+",
                   choices=sorted(task_parameters.keys()))
    p.add_argument("-m", "--model", required=True, type=int,
                   choices=range(1, 5),
                   help="1 SingleTask, 2 MixedLatent, 3 DisjointLatent, "
                        "4 SharedLatent")
    p.add_argument("-l", "--latent-channels", required=True, type=int)
    p.add_argument("-c", "--conv-channels", default=100, type=int)
    p.add_argument("-w", "--run-name", required=True)
    p.add_argument("-e", "--epochs", default=100, type=int)
    p.add_argument("-lrm", "--learning-rate-main", default=1e-4, type=float)
    p.add_argument("-lra", "--learning-rate-aux", default=1e-3, type=float)
    p.add_argument("--lmbda", type=float, default=1e-2)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("-g", "--devices", default=1, type=int,
                   help="devices in the data-parallel mesh: one process "
                        "per device")
    p.add_argument("--device", default=None,
                   help="torch device to train on (default: the CUDA "
                        "device; 'cpu' to run on the CPU)")
    p.add_argument("--image-size", default=256, type=int)
    p.add_argument("--train-size", default=1024, type=int,
                   help="synthetic dataset size")
    p.add_argument("--data-style", default="legacy",
                   choices=("legacy", "clevr"),
                   help="synthetic render style; 'clevr' matches the "
                        "reference data's statistics")
    p.add_argument("--val-size", default=64, type=int)
    p.add_argument("--max-steps", default=None, type=int)
    p.add_argument("--out-dir", default="runs")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--continue-run-id", default=None,
                   help="alias: any non-'none' value implies --resume")
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--no-metrics", action="store_true")
    p.add_argument("--log-every", default=10, type=int)
    p.add_argument("--steps-per-call", default=1, type=int,
                   help="optimizer steps per call of the train step, "
                        "on a card one CUDA graph replay (clamped to the "
                        "batches of an epoch)")
    p.add_argument("--profile-dir", default=None)
    p.add_argument("-n", "--num-workers", default=4, type=int,
                   help="thread workers for sample fetch (reference "
                        "DataLoader num_workers analog); ignored for "
                        "prerendered data, which is vectorized")
    p.add_argument("--prerender", action="store_true", default=True,
                   help="materialize the dataset once to cached .npy and "
                        "serve batches as array slices (default)")
    p.add_argument("--no-prerender", dest="prerender", action="store_false")
    p.add_argument("--force-prerender", action="store_true",
                   help="prerender even a split larger than the RAM-safety "
                        "gate would allow (the gate auto-skips big splits "
                        "because --prerender is on by default)")
    p.add_argument("--data-cache-dir",
                   default=os.environ.get("MMNC_DATA_CACHE",
                                          "data/prerendered"))
    p.add_argument("--legacy-broadcast", action="store_true", default=True)
    p.add_argument("--corrected-geometry", dest="legacy_broadcast",
                   action="store_false")
    return p.parse_args(argv)


def get_loaders(args):
    if args.dataset == "synthetic":
        train = SyntheticMultiTaskDataset(args.tasks, size=args.train_size,
                                          image_size=args.image_size, seed=0,
                                          style=args.data_style)
        val = SyntheticMultiTaskDataset(args.tasks, size=args.val_size,
                                        image_size=args.image_size,
                                        seed=10 ** 6, style=args.data_style)
    elif args.dataset in ("mnist", "fashion-mnist"):
        assert args.tasks == ["mono"], "MNIST datasets provide only 'mono'"
        root = DATASET_ROOTS[args.dataset]
        train = MNISTMonoDataset(root, train=True, image_size=args.image_size,
                                 fashion=args.dataset == "fashion-mnist")
        val = MNISTMonoDataset(root, train=False, image_size=args.image_size,
                               fashion=args.dataset == "fashion-mnist")
    else:
        root = DATASET_ROOTS["clevr"]
        train = CLEVRDataset(root, args.tasks, "train", args.image_size)
        val = CLEVRDataset(root, args.tasks, "val", args.image_size)
    if getattr(args, "prerender", False):
        # materializing a split needs ~size * H*W*C*4 bytes of RAM + disk;
        # at CLEVR scale (50k x 256px) that is tens of GB — stream instead
        # unless the user insists via --force-prerender
        n_px = len(train) * args.image_size * args.image_size
        if n_px > 20_000 * 256 * 256 and not getattr(
                args, "force_prerender", False):
            print(f"prerender skipped: split of {len(train)} samples is too "
                  f"large to materialize in RAM; streaming instead "
                  f"(pass --force-prerender to materialize it anyway)")
        else:
            from ..data.prerender import prerender
            cache = getattr(args, "data_cache_dir", None)
            train = prerender(train, cache)
            val = prerender(val, cache)
    workers = getattr(args, "num_workers", 0)
    return (BatchLoader(train, args.batch_size, shuffle=True,
                        num_workers=workers),
            BatchLoader(val, args.batch_size, shuffle=False,
                        num_workers=workers))


def train(args, device=None, n_devices=None, stats=None):
    """Build the model and the loaders from `args` and train; returns
    (state, val_logs)."""
    resume = args.resume or (
        args.continue_run_id not in (None, "", "none", "None"))
    model = build_model(
        args.model, args.tasks,
        latent_channels=args.latent_channels,
        conv_channels=args.conv_channels,
        lmbda=args.lmbda,
        learning_rate_main=args.learning_rate_main,
        learning_rate_aux=args.learning_rate_aux,
        legacy_broadcast=args.legacy_broadcast,
        device=device if device is not None else args.device,
    )
    print(f"model: {model.get_model_name()} tasks={model.tasks} "
          f"M={model.latent_channels} C={model.conv_channels} "
          f"device={model.device}")

    train_loader, val_loader = get_loaders(args)
    return fit(
        model, train_loader, val_loader,
        epochs=args.epochs, run_name=args.run_name, out_dir=args.out_dir,
        resume=resume, use_wandb=args.wandb,
        compute_metrics=not args.no_metrics,
        n_devices=n_devices,
        profile_dir=args.profile_dir, max_steps=args.max_steps,
        log_every=args.log_every,
        steps_per_call=args.steps_per_call,
        stats=stats,
    )


def _train_rank(mesh, args):
    """One rank of `-g N`: its own model and loaders on its device."""
    stats = {}
    state, val_logs = train(args, mesh.device, mesh.world_size, stats)
    return {"step": state.step, "val_logs": val_logs, "stats": stats}


def main(argv=None, stats=None):
    """Parse argv, build the model and the loaders, and train. `stats` is
    handed to `fit` (the run's timings). Returns the train state; with
    `-g N > 1`, each rank's {"step", "val_logs", "stats"} in rank order."""
    args = parse_args(argv if argv is not None else sys.argv[1:])
    if args.devices > 1:
        if args.prerender:
            get_loaders(args)  # render the cache once, before the ranks read it
        return launch(_train_rank, args.devices, args.device, args)
    state, val_logs = train(args, stats=stats)
    for k in sorted(val_logs):
        print(f"  {k}: {val_logs[k]:.5g}")
    return state


if __name__ == "__main__":
    main()
