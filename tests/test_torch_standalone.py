"""mmnc_tpu_torch stands alone: it imports neither JAX/flax nor anything
of mmnc_tpu, and importing it builds nothing."""

import ast
import os
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_ROOT, "mmnc_tpu_torch")
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mmnc_tpu")


def _port_sources():
    for dirpath, _, files in os.walk(_PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(_ROOT, "chip_smoke.py")


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, _ROOT))
def test_source_imports_no_jax_and_no_mmnc_tpu(path):
    bad = sorted(set(_imported_roots(path)) & set(_FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_import_pulls_in_no_jax_and_builds_nothing():
    code = r"""
import pkgutil, subprocess, sys
def refuse(*a, **k):
    raise AssertionError("importing the port started a process")
subprocess.Popen = refuse
subprocess.run = refuse
import mmnc_tpu_torch
for info in pkgutil.walk_packages(mmnc_tpu_torch.__path__, "mmnc_tpu_torch."):
    __import__(info.name)
roots = {m.split(".")[0] for m in sys.modules}
print(sorted(roots & {"jax", "jaxlib", "flax", "optax", "mmnc_tpu"}))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
