"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration and a traffic mix; each is a data file of its
own (`configs/<name>.json`, `traffic/<name>.json`), and so are the limits
of the cell's output check (`limits/<cell>.json`). The traffic's `kind`
names the module that drives it, checks it and plants its faults
(`kinds/<kind>.py`), and the configuration's `task` the reference task
(`reference/tasks/<task>.py`). A per-layer metric is a reader module
`metrics/<metric>.py` with `read(ctx)` (and optionally `install(ctx)`,
called before the window). Adding a cell, a configuration, a traffic mix,
a traffic kind, a reference task or a metric adds files and entries and
edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


_MODULES: Dict[str, Any] = {}


def load_json(path: str) -> Dict[str, Any]:
  with open(path) as f:
    return json.load(f)


def load_module(root: str, folder: str, name: str):
  """The module `<root>/<folder>/<name>.py`, loaded once by its path."""
  path = os.path.join(root, folder, name + ".py")
  if path not in _MODULES:
    if not os.path.exists(path):
      raise KeyError(f"no {folder} module {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + folder.replace("/", "_") + "_"
        + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _MODULES[path] = mod
  return _MODULES[path]


@dataclasses.dataclass
class Metric:
  name: str
  unit: str
  end_to_end: bool
  entry: Dict[str, Any]
  root: str = HERE

  def reader(self):
    """The per-layer metric's reader module, `metrics/<name>.py`."""
    return load_module(self.root, "metrics", self.name)


@dataclasses.dataclass
class Cell:
  name: str
  chips: int
  config: Dict[str, Any]
  traffic: Dict[str, Any]
  limits: Dict[str, float]
  end_to_end: List[Metric]
  per_layer: List[Metric]
  root: str = HERE

  @property
  def kind(self):
    """The module of the traffic's kind, `kinds/<kind>.py`."""
    return load_module(self.root, "kinds", self.traffic["kind"])


def _reports(metric: Dict[str, Any], cell: str,
             end_to_end_names: List[str]) -> bool:
  if "workloads" in metric:
    return cell in metric["workloads"]
  # a per-layer metric without a list is reported wherever its end-to-end
  # metric is
  return metric.get("moves") in end_to_end_names if "moves" in metric \
      else True


def load_cell(name: str, bench: Optional[Dict[str, Any]] = None,
              root: str = HERE) -> Cell:
  """The cell `name` of BENCHMARK.json with every file it names."""
  bench = bench or load_json(os.path.join(REPO, "BENCHMARK.json"))
  cells = {w["name"]: w for w in bench["workloads"]}
  if name not in cells:
    raise KeyError(f"no workload {name!r}; there are {sorted(cells)}")
  w = cells[name]
  config = load_json(os.path.join(root, "configs", w["config"] + ".json"))
  traffic = load_json(os.path.join(root, "traffic", w["traffic"] + ".json"))
  limits = load_json(os.path.join(root, "limits", name + ".json"))
  e2e = [Metric(m["name"], m["unit"], True, m, root)
         for m in bench["end_to_end"] if _reports(m, name, [])]
  e2e_names = [m.name for m in e2e]
  layer = [Metric(m["name"], m["unit"], False, m, root)
           for m in bench["per_layer"] if _reports(m, name, e2e_names)]
  return Cell(name=name, chips=int(w["chips"]), config=config,
              traffic=traffic, limits=limits, end_to_end=e2e,
              per_layer=layer, root=root)
