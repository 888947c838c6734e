"""Find a cell's pieces by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own, found by name:

    configs/<config>.json       the deployment as it is run
    traffic/<traffic>.json      the mix's parameters, read by traffic.py
    metrics/<metric>.py         ``read(run) -> float | None``

So a cell, a configuration, a mix or a metric is added by adding files
and entries, never by editing the harness.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]  # the benchmark's folder
ROOT = HERE.parent  # the checkout


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the cell's metric entries, in BENCHMARK.json order
    per_layer: list

    @property
    def config_name(self) -> str:
        return self.config["name"]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    """A metric without a ``workloads`` list is read in every cell."""
    return cell in metric.get("workloads", [cell])


def resolve(bench: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` with its configuration, mix and metrics
    read from their files; raises ``KeyError`` for an unknown name."""
    here = root / "perfbench"
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / entry["file"]).read_text())
    config["name"] = entry["name"]
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json").read_text())
    traffic["name"] = w["traffic"]
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    layer = [m for m in bench["per_layer"] if _applies(m, workload)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, layer)


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = root / "perfbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
