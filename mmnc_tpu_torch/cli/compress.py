"""Offline compression CLI over a checkpoint (mmnc_tpu/cli/compress.py).

    python -m mmnc_tpu_torch.cli.compress \
        -p runs/myrun/checkpoints/step_100 -d synthetic --batch-size 8 \
        --num-batches 4

Rebuilds the model from the checkpoint's hyper_parameters alone, loads
its weights, builds the entropy coding tables (update_bottleneck_values),
compresses batches with the real rANS coder and reports the bitstream's
bpp next to the likelihood-estimated bpp, in the training geometry and
in the corrected one. Runs on the CUDA device unless --device names
another; with no card and no --device it raises.
"""

import argparse
import sys

from ..data import SyntheticMultiTaskDataset, CLEVRDataset, BatchLoader
from ..utils.checkpoint import restore_checkpoint, rebuild_model_from_checkpoint
from .train import DATASET_ROOTS


def parse_args(argv):
    p = argparse.ArgumentParser(description="Compress a dataset with a "
                                "trained checkpoint")
    p.add_argument("-p", "--model-path", required=True,
                   help="checkpoint dir (runs/<run>/checkpoints/step_<N>)")
    p.add_argument("-d", "--dataset", required=True,
                   choices=("synthetic", "clevr"))
    p.add_argument("--split", default="train", choices=("train", "val", "test"))
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--num-batches", type=int, default=None)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--out", default=None,
                   help="optional path to write the raw bitstream of the "
                        "first batch")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; 'cpu' to "
                        "run on the CPU)")
    return p.parse_args(argv)


def main(argv=None):
    """-> (actual bpp of the rANS bitstream, estimated bpp in the
    corrected geometry)."""
    args = parse_args(argv if argv is not None else sys.argv[1:])

    model, hp = rebuild_model_from_checkpoint(args.model_path, args.device)
    print(f"restored {hp['model_class']} tasks={hp['tasks']} "
          f"device={model.device}")
    payload, _ = restore_checkpoint(args.model_path, model.device)
    model.load_state_dict(payload["model"])

    model.update_bottleneck_values()

    # corrected-geometry twin: the same params, scales cropped to y's support
    model_corrected = model.corrected_geometry_twin()

    if args.dataset == "synthetic":
        ds = SyntheticMultiTaskDataset(model.tasks, size=1024,
                                       image_size=args.image_size)
    else:
        ds = CLEVRDataset(DATASET_ROOTS["clevr"], list(model.tasks),
                          args.split, args.image_size)
    loader = BatchLoader(ds, args.batch_size, shuffle=False)

    total_bytes = 0
    total_pixels = 0
    est_bpp_sum = 0.0
    est_corrected_sum = 0.0
    n_batches = 0
    for i, batch in enumerate(loader):
        if args.num_batches is not None and i >= args.num_batches:
            break
        tbatch = model.to_device(batch)
        ans, n_bytes = model.compress(tbatch)
        if args.out and i == 0:
            with open(args.out, "wb") as f:
                for group in ans["strings"]:
                    for s in group:
                        f.write(len(s).to_bytes(8, "little"))
                        f.write(s)
            print(f"wrote first-batch bitstream to {args.out}")
        b, h, w, _ = batch[model.tasks[0]].shape
        total_bytes += n_bytes
        total_pixels += b * h * w * model.n_tasks

        # the variant's compression loss is bits / (B*H*W*n_tasks), so it
        # compares with the bitstream's bpp; under the default
        # legacy_broadcast geometry the training-time estimate counts each
        # saturated-latent y value 16x, the corrected one is what the coder
        # should match
        _, lik = model(tbatch)  # eval forwards run under no-grad
        est, _ = model._compression_loss(lik, tbatch)
        est_bpp_sum += float(est)
        _, lik_c = model_corrected(tbatch)
        est_c, _ = model_corrected._compression_loss(lik_c, tbatch)
        est_corrected_sum += float(est_c)
        n_batches += 1

    actual_bpp = total_bytes * 8 / total_pixels
    est_bpp = est_bpp_sum / max(n_batches, 1)
    est_corrected = est_corrected_sum / max(n_batches, 1)
    print(f"batches: {n_batches}  bytes: {total_bytes}")
    print(f"actual BPP (rANS bitstream):            {actual_bpp:.4f}")
    print(f"estimated BPP (training geometry):      {est_bpp:.4f}")
    print(f"estimated BPP (corrected geometry):     {est_corrected:.4f}")
    return actual_bpp, est_corrected


if __name__ == "__main__":
    main()
