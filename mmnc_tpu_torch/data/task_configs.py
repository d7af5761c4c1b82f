"""Per-task channel/loss registry: a copy of mmnc_tpu/data/task_configs.py
(every task, its head widths, loss, depth's clamp and normal's mask
value, and the CLEVR semantic class ids), kept here so the port imports
nothing of the JAX package."""

task_parameters = {
    "depth_euclidean": {
        "in_channels": 1,
        "out_channels": 1,
        # 16-bit depth is pre-scaled by 1/(2^15-1); clamp rescales to [0, 1]
        "clamp_to": (0.0, 8000.0 / (2 ** 15 - 1)),
        "loss_function": "mse",
    },
    "rgb": {
        "in_channels": 3,
        "out_channels": 3,
        "loss_function": "mse",
    },
    "semantic": {
        "in_channels": 1,
        "out_channels": 17,  # dense labels in -> 17-class logits out
        "loss_function": "cross-entropy",
    },
    "normal": {
        "in_channels": 3,
        "out_channels": 3,
        "mask_val": 0.502,
        "loss_function": "mse",
    },
    "mono": {
        "in_channels": 1,
        "out_channels": 1,
        "loss_function": "mse",
    },
}

# CLEVR semantic G-channel class ids -> dense class indices
SEM_CLASSES = (0, 1, 2, 3, 4, 5, 6, 7, 10, 11, 12, 13, 14, 15, 16, 17, 255)
