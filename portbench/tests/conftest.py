"""Fixtures of the benchmark's CPU tests: a data directory holding the
benchmark's files at a size the CPU runs in seconds (the configurations'
widths cut, their 256 px kept: the codec's geometry wants it)."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {"rgb": {"latent_channels": 16, "conv_channels": 8},
        "shared4": {"latent_channels": 10, "conv_channels": 8}}
TINY_TRAFFIC = {"batch": 2, "pool": 3, "judge_batches": 2}


def tiny_data(tmp, widths=True):
    """A copy of portbench's data files at CPU size, under `tmp`: batches
    of 2 and, where `widths`, the configurations' widths cut."""
    package = os.path.join(ROOT, "portbench")
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(package, d), os.path.join(tmp, d))
    for name, sizes in TINY.items() if widths else ():
        path = os.path.join(tmp, "configs", f"{name}.json")
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(sizes)
        with open(path, "w") as f:
            json.dump(cfg, f)
    for name in os.listdir(os.path.join(tmp, "traffic")):
        path = os.path.join(tmp, "traffic", name)
        with open(path) as f:
            tr = json.load(f)
        tr.update(TINY_TRAFFIC)
        with open(path, "w") as f:
            json.dump(tr, f)
    return str(tmp)


@pytest.fixture
def tiny(tmp_path):
    import torch
    torch.set_num_threads(2)
    return tiny_data(tmp_path)


@pytest.fixture
def small(tmp_path):
    """The data files at the configurations' own widths, batches of 2."""
    import torch
    torch.set_num_threads(2)
    return tiny_data(tmp_path, widths=False)


@pytest.fixture
def run_tiny(tiny):
    """run_tiny(workload, seed=..., seconds=..., trace=...) -> the result
    line of one run on the CPU at the tiny size (the look for a card
    skipped)."""
    import argparse
    import time

    import torch

    from portbench import registry, run

    def go(workload, seed=2 ** 31 + 11, seconds=0.5, trace=0):
        cell = registry.Cell(workload, data_dir=tiny)
        args = argparse.Namespace(workload=workload, seed=seed,
                                  seconds=seconds, trace=trace)
        return run.measure(args, torch.device("cpu"), cell,
                           time.perf_counter())
    return go
