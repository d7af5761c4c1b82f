"""Command-line entry points: `python -m mmnc_tpu_torch.cli.train` and
`python -m mmnc_tpu_torch.cli.compress` (mmnc_tpu/cli)."""
