"""The benchmark's data, found by name: `BENCHMARK.json` at the root of
the checkout, a cell's configuration file and traffic mix, and each
metric's reader `metrics/<name>.py`. A new configuration, mix or metric
is new files and new `BENCHMARK.json` entries; nothing here changes."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    """`BENCHMARK.json` of the checkout at `root`."""
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    """The workload entry `name`; KeyError when there is none."""
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, cell: dict, root: Path = ROOT) -> dict:
    """The configuration file of a cell's configuration, as run."""
    for c in bench["configs"]:
        if c["name"] == cell["config"]:
            return json.loads((Path(root) / c["file"]).read_text())
    raise KeyError(f"no config {cell['config']!r} in BENCHMARK.json")


def metrics(bench: dict, cell_name: str, trace: bool) -> list:
    """The (name, unit) of the metrics a run of the cell reports: the
    end-to-end ones without tracing, the per-layer ones with it; a metric
    that lists `workloads` only in those."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [(m["name"], m["unit"]) for m in group
            if cell_name in m.get("workloads", [cell_name])]


def reader(name: str, root: Path = HERE / "metrics"):
    """The `read(run)` of `metrics/<name>.py`."""
    path = Path(root) / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"cosine_bench.metrics.{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
