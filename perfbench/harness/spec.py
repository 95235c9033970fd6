"""The benchmark's registry: `BENCHMARK.json` and the files it names.

A cell (`workloads` entry) names a configuration and a traffic mix. Every
piece is found by its name, so that a new cell, configuration, traffic mix
or per-layer metric is a new file and a new entry, never an edit:

  configs/<config>.json      the configuration as it is run (`file` in
                             BENCHMARK.json names it)
  traffic/<traffic>.json     the traffic mix: the entry it drives and its
                             parameters
  entries/<entry>.py         the program's side of an entry: how the port
                             is built and driven for it, what a unit keeps
                             for the reference, a unit's FLOPs
  reference/entries/<entry>.py
                             the reference's side of an entry: how the plain
                             reference follows the same units, the numbers
                             compared, the control and the faults it plants
  limits/<workload>.json     the limits of the cell's correctness numbers
  metrics/<metric>.py        the reader of one per-layer metric
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))   # perfbench/
ROOT = os.path.dirname(HERE)                                         # the checkout


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    workloads: Optional[List[str]]      # None: every cell (end-to-end only)

    def reported_in(self, workload: str) -> bool:
        return self.workloads is None or workload in self.workloads


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    here: str                      # the perfbench/ directory it was read from
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _read_json(os.path.join(root, "BENCHMARK.json"))


def _metric(entry: dict, per_layer: bool) -> Metric:
    if per_layer and "workloads" not in entry:
        raise ValueError(f"the per-layer metric {entry['name']!r} lists no workloads")
    return Metric(name=entry["name"], unit=entry["unit"], workloads=entry.get("workloads"))


def traffic_path(name: str, here: str = HERE) -> str:
    return os.path.join(here, "traffic", name + ".json")


def limits_path(workload: str, here: str = HERE) -> str:
    return os.path.join(here, "limits", workload + ".json")


def metric_path(name: str, here: str = HERE) -> str:
    return os.path.join(here, "metrics", name + ".py")


def entry_path(name: str, here: str = HERE) -> str:
    return os.path.join(here, "entries", name + ".py")


def load(path: str, module_name: str):
    """The module in the file `path`, loaded under `module_name`."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(workload: str, root: str = ROOT) -> Cell:
    """The cell `workload` of `root`'s BENCHMARK.json with its files."""
    b = benchmark(root)
    here = os.path.join(root, "perfbench")
    cells = {w["name"]: w for w in b["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in b["configs"]}
    config = _read_json(os.path.join(root, configs[w["config"]]["file"]))
    e2e = [m for m in (_metric(e, False) for e in b["end_to_end"]) if m.reported_in(workload)]
    layer = [m for m in (_metric(e, True) for e in b["per_layer"]) if m.reported_in(workload)]
    return Cell(name=workload, config_name=w["config"], traffic_name=w["traffic"],
                chips=int(w["chips"]), here=here, config=config,
                traffic=_read_json(traffic_path(w["traffic"], here)),
                limits=_read_json(limits_path(workload, here)),
                end_to_end=e2e, per_layer=layer)


def reader(name: str, here: str = HERE) -> Callable:
    """The `read(ctx)` function of metrics/<name>.py."""
    return load(metric_path(name, here), f"perfbench_metric_{name}").read


def entry(name: str, here: str = HERE):
    """The program's side of the entry `name`: entries/<name>.py."""
    return load(entry_path(name, here), f"perfbench_entry_{name}")


def readers(cell_: Cell) -> Dict[str, Callable]:
    return {m.name: reader(m.name, cell_.here) for m in cell_.per_layer}
