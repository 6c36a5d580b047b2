"""BENCHMARK.json against the benchmark's contract, and cells, configs and
metrics found by name: a new one is added by files alone."""

import json
import math
import re
import shutil

import pytest

from benchmark.core import spec
from benchmark.core.compare import NUMBERS

ROOT = spec.ROOT
BENCH = spec.benchmark_json()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.fullmatch(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        kinds = [(m.end_to_end, m.name) for m in cell.metrics]
        assert (True, "setup_s") in kinds and sum(e for e, _ in kinds) >= 2
        assert any(not e for e, _ in kinds)


def test_every_cell_loads_with_its_files_and_metrics():
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert callable(cell.driver.run)
        assert all(callable(m.reader.read) for m in cell.metrics)
        assert cell.workload["limits"] and set(cell.workload["limits"]) <= set(NUMBERS)


@pytest.mark.parametrize("bad", ["", "a b", "a/b", "a,b", "x" * 65, "µs", ".x"])
def test_bad_names_are_refused(bad):
    with pytest.raises(spec.SpecError):
        spec.check_name("workload", bad)


@pytest.mark.parametrize("bad", ["", "tokens per second", "x" * 17, "µs"])
def test_bad_units_are_refused(bad):
    with pytest.raises(spec.SpecError):
        spec.check_unit(bad)


def test_unknown_cell_is_refused():
    with pytest.raises(spec.SpecError, match="no workload"):
        spec.load_cell("no_such.cell")


def test_a_cell_config_and_metric_are_added_by_files_alone(tmp_path):
    base = tmp_path / "benchmark"
    shutil.copytree(spec.HERE, base, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((base / "configs" / "shelf_jln64.json").read_text())
    cfg["name"] = "shelf_wide"
    (base / "configs" / "shelf_wide.json").write_text(json.dumps(cfg))
    (base / "traffic" / "mixes" / "heatmaps.crowd.json").write_text(json.dumps(
        dict(json.loads((base / "traffic" / "mixes" / "heatmaps.live.json").read_text()),
             scenes={"people": [10, 10], "noise_px": 2.0})))
    w = json.loads((base / "workloads" / "shelf_jln64.heatmaps.live.json").read_text())
    w.update(config="shelf_wide", traffic="heatmaps.crowd")
    (base / "workloads" / "shelf_wide.heatmaps.crowd.json").write_text(json.dumps(w))
    (base / "metrics" / "people.served_mean.py").write_text(
        "def read(run):\n    return None\n")
    bench["configs"].append({"name": "shelf_wide", "source": "x", "file": "x",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "shelf_wide.heatmaps.crowd", "config": "shelf_wide",
                               "traffic": "heatmaps.crowd", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "people.served_mean", "unit": "people",
                               "better": "higher", "source": "host_clock", "layer": "Service",
                               "moves": "latency_p50_ms",
                               "workloads": ["shelf_wide.heatmaps.crowd"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("shelf_wide.heatmaps.crowd", base=base)
    assert cell.mix["scenes"]["people"] == [10, 10]
    assert "people.served_mean" in [m.name for m in cell.metrics]
    old = spec.load_cell("shelf_jln64.heatmaps.live", base=base)
    assert "people.served_mean" not in [m.name for m in old.metrics]


def test_full_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_bounds_are_never_under_one_percent():
    assert all(m["bound"] >= 0.01 and not math.isnan(m["bound"]) for m in BENCH["end_to_end"])
