"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file
``BENCHMARK.json`` gives, and a traffic mix, ``loopsbench/traffic/
<traffic>.json``. The traffic file names its driver, ``loopsbench/
drivers/<driver>.py``, and holds the cell's correctness limits. Every
metric is read by ``loopsbench/metrics/<metric name>.py``. A new cell,
configuration or metric is new files and new entries here; no file that
is there changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict         # the configuration file's contents
    traffic: dict        # the traffic file's contents
    end_to_end: list     # the BENCHMARK.json metric entries of this cell
    per_layer: list

    @property
    def driver(self):
        return importlib.import_module(
            f"loopsbench.drivers.{self.traffic['driver']}")


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def read_json(path: str, root: str = ROOT) -> dict:
    with open(os.path.join(root, path)) as f:
        return json.load(f)


def traffic_path(traffic: str) -> str:
    return os.path.join("loopsbench", "traffic", f"{traffic}.json")


def metric_path(metric: str) -> str:
    return os.path.join("loopsbench", "metrics", f"{metric}.py")


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def resolve(workload: str, bench: dict | None = None,
            root: str = ROOT) -> Cell:
    """The cell named ``workload``; ``KeyError`` for an unknown name."""
    bench = bench or load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=read_json(configs[w["config"]]["file"], root),
        traffic=read_json(traffic_path(w["traffic"]), root),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def reader(metric: str, root: str = ROOT):
    """``read(run) -> float | None`` of ``loopsbench/metrics/<metric>.py``
    (loaded by path: a metric's name may hold dots)."""
    path = os.path.join(root, metric_path(metric))
    spec = importlib.util.spec_from_file_location(
        f"loopsbench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
