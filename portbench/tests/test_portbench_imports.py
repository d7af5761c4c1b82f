"""Nothing of the benchmark imports JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the program; a
run's process holds neither; and the run refuses to measure without a
card."""

import ast
import os
import subprocess
import sys

from portbench import registry, run

PACKAGE = os.path.join(registry.ROOT, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mmnc_tpu"}


def imported_top_levels(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(top):
    for base, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in sources(PACKAGE):
        assert not imported_top_levels(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in sources(os.path.join(PACKAGE, "reference")):
        names = imported_top_levels(path)
        assert not names & (FORBIDDEN | {"mmnc_tpu_torch", "portbench"}), path


def test_whole_names_tell_the_port_from_the_jax_package():
    before = dict(sys.modules)
    try:
        sys.modules["mmnc_tpu_torch_like"] = sys
        assert "mmnc_tpu" not in run.forbidden_modules()
        sys.modules["mmnc_tpu.models"] = sys
        assert run.forbidden_modules() == ["mmnc_tpu"]
    finally:
        for k in set(sys.modules) - set(before):
            del sys.modules[k]


def test_a_run_holds_no_jax(tmp_path):
    """A whole tiny run on the CPU in a fresh process, then its modules."""
    code = (
        "import sys, json, time, argparse, torch\n"
        f"sys.path.insert(0, {os.path.join(PACKAGE, 'tests')!r})\n"
        "from conftest import tiny_data\n"
        "from portbench import registry, run\n"
        "torch.set_num_threads(2)\n"
        f"d = tiny_data({str(tmp_path)!r})\n"
        "cell = registry.Cell('rgb.stream64', data_dir=d)\n"
        "a = argparse.Namespace(workload='rgb.stream64', seed=5, "
        "seconds=0.3, trace=0)\n"
        "r = run.measure(a, torch.device('cpu'), cell, time.perf_counter())\n"
        "print(json.dumps([r['correct'], run.forbidden_modules()]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=registry.ROOT,
                         env={**os.environ, "PYTHONPATH": registry.ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[true, []]"


def test_no_card_no_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "rgb.stream64", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
