"""The benchmark's description, and the files each of its names resolves to.

``BENCHMARK.json`` at the checkout's root names the cells, configurations
and metrics.  Everything that belongs to one of them sits in a file of its
own, found by name:

* a configuration: ``portbench/configs/<config>.json`` (its ``file`` entry);
* a traffic mix: ``portbench/traffic/<traffic>.json``;
* a per-layer metric: ``portbench/metrics/<metric>.py``, a reader with
  ``read(ctx) -> float | None``;
* a cell's correctness limits: ``portbench/limits/<cell>.json``;
* a family's plain reference: ``portbench/reference/<family>.py``;
* a kernel's roofline formula: ``portbench/roofline/<kernel>.py``, which
  the readers of its metrics import.

So a later change adds a cell, a mix, a configuration or a metric by
adding files and entries, and edits none.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: tuple          # cells that report it (every cell if empty)
    moves: str = ""           # per-layer: the end-to-end metric it moves
    layer: str = ""


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    traffic: str
    chips: int
    config: Dict[str, Any]    # the configuration file's contents
    mix: Dict[str, Any]       # the traffic file's contents
    limits: Dict[str, Any]    # the cell's correctness limits
    end_to_end: tuple         # Metric entries this cell reports, trace 0
    per_layer: tuple          # Metric entries this cell reports, trace 1


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """Import the Python file ``path`` as a module called ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot import {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _metrics(entries: List[Dict[str, Any]]) -> List[Metric]:
    return [Metric(name=e["name"], unit=e["unit"], better=e["better"],
                   source=e["source"],
                   workloads=tuple(e.get("workloads", ())),
                   moves=e.get("moves", ""), layer=e.get("layer", ""))
            for e in entries]


def _reports(metric: Metric, cell: str) -> bool:
    return not metric.workloads or cell in metric.workloads


def load_spec(root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


def cell_names(spec: Dict[str, Any]) -> List[str]:
    return [w["name"] for w in spec["workloads"]]


def resolve_cell(spec: Dict[str, Any], name: str, root: Path = ROOT
                 ) -> Cell:
    """The cell ``name`` of ``spec`` with every file it names read."""
    by_name = {w["name"]: w for w in spec["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r}; the benchmark has "
                       f"{sorted(by_name)}")
    w = by_name[name]
    configs = {c["name"]: c for c in spec["configs"]}
    conf = configs[w["config"]]
    e2e = [m for m in _metrics(spec["end_to_end"]) if _reports(m, name)]
    layer = [m for m in _metrics(spec["per_layer"]) if _reports(m, name)]
    return Cell(name=name, config_name=w["config"], traffic=w["traffic"],
                chips=int(w["chips"]),
                config=load_json(root / conf["file"]),
                mix=load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(BENCH_DIR / "limits" / f"{name}.json"),
                end_to_end=tuple(e2e), per_layer=tuple(layer))


def metric_reader(name: str) -> ModuleType:
    """The reader of the per-layer metric ``name``."""
    return load_module(BENCH_DIR / "metrics" / f"{name}.py",
                       f"portbench_metric_{name.replace('.', '_')}")


def reference_module(family: str) -> ModuleType:
    """The plain reference of a model family."""
    return importlib.import_module(f"portbench.reference.{family}")
