"""Framework-wide constants: a copy of mmnc_tpu/constants.py (the
reference's src/constants.py), kept here so the port imports nothing of
the JAX package."""

MNIST = "mnist"
FASHION_MNIST = "fashion-mnist"
CLEVR = "clevr"
SYNTHETIC = "synthetic"

DATASETS = (SYNTHETIC, MNIST, FASHION_MNIST, CLEVR)

WANDB_PROJECT_NAME = "mmnc-tpu"
