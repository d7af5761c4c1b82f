"""The cells of `BENCHMARK.json` and the files they name.

A cell names a configuration and a traffic mix; each lives in a file of
its own under the data directory (`portbench/` by default):
`configs/<config>.json`, `traffic/<traffic>.json` (its "driver" names the
module in `portbench/drivers/` that runs it), `limits/<cell>.json` (the
comparison's limits), and `metrics/<metric>.py` for each per-layer
metric (its reader). Adding a cell, a configuration, a mix or a metric
adds files and entries; nothing here changes.
"""

import importlib
import importlib.util
import json
import os

PACKAGE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PACKAGE)


def _load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of `BENCHMARK.json` with its files read."""

    def __init__(self, name, bench_path=None, data_dir=None):
        bench_path = bench_path or os.path.join(ROOT, "BENCHMARK.json")
        self.data_dir = data_dir or PACKAGE
        self.bench = _load_json(bench_path)
        found = [w for w in self.bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in {bench_path}")
        self.workload = found[0]
        self.name = name
        self.chips = self.workload["chips"]
        self.config = self._data("configs", self.workload["config"])
        self.traffic = self._data("traffic", self.workload["traffic"])
        self.limits = self._data("limits", name)

    def _data(self, kind, name):
        return _load_json(os.path.join(self.data_dir, kind, f"{name}.json"))

    def _applies(self, metric, reported=None):
        cells = metric.get("workloads")
        if cells is not None:
            return self.name in cells
        return reported is None or metric["moves"] in reported

    @property
    def end_to_end(self):
        """The cell's end-to-end metric entries."""
        return [m for m in self.bench["end_to_end"] if self._applies(m)]

    @property
    def per_layer(self):
        """The cell's per-layer metric entries."""
        reported = {m["name"] for m in self.end_to_end}
        return [m for m in self.bench["per_layer"]
                if self._applies(m, reported)]

    def reader(self, metric_name):
        """The module `metrics/<metric>.py`."""
        path = os.path.join(self.data_dir, "metrics", f"{metric_name}.py")
        spec = importlib.util.spec_from_file_location(
            f"portbench.metrics.{metric_name.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def driver(self):
        return importlib.import_module(
            f"portbench.drivers.{self.traffic['driver']}")
