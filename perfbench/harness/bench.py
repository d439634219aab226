"""Finding a cell's pieces by name.

Everything that belongs to one configuration, cell, traffic driver or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- a configuration: the ``file`` of its entry under ``configs``;
- a cell: ``perfbench/workloads/<cell>.json``, naming its traffic driver,
  that driver's parameters and the limits of its check;
- a traffic driver: ``perfbench/traffic/<driver>.py`` with ``run(ctx)``;
- a per-layer metric: ``perfbench/metrics/<metric>.py`` with ``read(run)``.

A later change adds any of them by adding files and entries, without an edit
to a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files of ``perfbench`` under it."""

    def __init__(self, root):
        self.root = root
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))
        self.dir = os.path.join(root, "perfbench")

    def cell(self, name):
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for c in self.spec["configs"]:
            if c["name"] == name:
                return load_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def workload(self, name):
        return load_json(os.path.join(self.dir, "workloads", f"{name}.json"))

    def traffic(self, driver):
        return load_module(os.path.join(self.dir, "traffic", f"{driver}.py"),
                           f"perfbench_traffic_{driver}")

    def end_to_end(self, cell):
        return [m for m in self.spec["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell):
        """The per-layer metrics this cell reports: those that list it, and
        those without a list whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    def metric(self, name):
        return load_module(os.path.join(self.dir, "metrics", f"{name}.py"),
                           "perfbench_metric_" + name.replace(".", "_").replace("-", "_"))
