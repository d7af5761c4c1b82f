"""Per-task channel registry: the entries of mmnc_tpu/data/task_configs.py
that the ported slice uses (the single-task rgb codec)."""

task_parameters = {
    "rgb": {
        "in_channels": 3,
        "out_channels": 3,
        "loss_function": "mse",
    },
}
