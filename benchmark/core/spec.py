"""Everything a cell is made of, found by name.

`BENCHMARK.json` at the checkout's root names the cells and metrics; each
cell's parts sit in files of their own under `benchmark/`:
  workloads/<cell>.json        configuration, traffic, entry, rate
  configs/<config>.json        the published YAML and what was assumed
  traffic/mixes/<traffic>.json the mix's parameters
  drivers/<entry>.py           the loop that drives one program entry
  metrics/<metric>.py          one reader per metric
so that a later change adds a cell or a metric by adding files.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List, Mapping, Optional

HERE = pathlib.Path(__file__).resolve().parents[1]  # benchmark/
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


class SpecError(ValueError):
    pass


def check_name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise SpecError(f"bad {kind} name {name!r}: 1-64 of letters, digits, '_', '.', '-'")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT.fullmatch(unit):
        raise SpecError(f"bad unit {unit!r}: 1-16 of letters, digits, '_', '/', '%', '.', '-'")
    return unit


def _json(path: pathlib.Path, kind: str, name: str) -> dict:
    if not path.is_file():
        raise SpecError(f"no {kind} {name!r}: {path} is missing")
    with open(path) as f:
        return json.load(f)


def _module(path: pathlib.Path, kind: str, name: str) -> ModuleType:
    if not path.is_file():
        raise SpecError(f"no {kind} {name!r}: {path} is missing")
    mod_name = f"benchmark.{kind}s." + re.sub(r"[^A-Za-z0-9_]", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    end_to_end: bool
    workloads: Optional[List[str]]
    reader: ModuleType

    def applies_to(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict
    driver: ModuleType
    metrics: List[Metric]  # the cell's end-to-end and per-layer metrics


def benchmark_json(root: pathlib.Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json", "benchmark", "BENCHMARK.json")


def load_metric(entry: Mapping, end_to_end: bool, base: pathlib.Path = HERE) -> Metric:
    name = check_name("metric", entry["name"])
    better = entry["better"]
    if better not in ("lower", "higher"):
        raise SpecError(f"metric {name}: better is {better!r}, not 'lower' or 'higher'")
    return Metric(name, check_unit(entry["unit"]), better, entry["source"], end_to_end,
                  entry.get("workloads"), _module(base / "metrics" / f"{name}.py", "metric", name))


def load_cell(name: str, bench: Optional[Mapping] = None, base: pathlib.Path = HERE) -> Cell:
    """The cell `name` of BENCHMARK.json with its files and metrics, the
    files under `base` (this folder)."""
    check_name("workload", name)
    bench = benchmark_json(base.parent) if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(entries)}")
    w = _json(base / "workloads" / f"{name}.json", "workload", name)
    for key in ("config", "traffic"):
        if w[key] != entries[name][key]:
            raise SpecError(f"workload {name}: {key} {w[key]!r} in its file, "
                            f"{entries[name][key]!r} in BENCHMARK.json")
    config = _json(base / "configs" / f"{check_name('config', w['config'])}.json", "config",
                   w["config"])
    mix = _json(base / "traffic" / "mixes" / f"{check_name('traffic', w['traffic'])}.json",
                "traffic", w["traffic"])
    driver = _module(base / "drivers" / f"{check_name('entry', w['entry'])}.py", "driver",
                     w["entry"])
    metrics = [load_metric(m, True, base) for m in bench["end_to_end"]]
    metrics += [load_metric(m, False, base) for m in bench["per_layer"]]
    return Cell(name, w, config, mix, driver, [m for m in metrics if m.applies_to(name)])


def read_metrics(cell: Cell, run, end_to_end: bool) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of the cell's metrics of one kind; a
    reader that finds nothing to read returns None and its metric is
    left out."""
    out = {}
    for m in cell.metrics:
        if m.end_to_end != end_to_end:
            continue
        value = m.reader.read(run)
        if value is not None:
            out[m.name] = {"value": float(value), "unit": m.unit}
    return out
