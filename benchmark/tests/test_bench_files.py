"""Every configuration, cell and metric of BENCHMARK.json sits in a file of
its own that the harness finds by its name."""

import json
from pathlib import Path

import pytest

from benchmark import build, check, harness, run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_and_its_config_load_by_name(name):
    w = next(w for w in BENCH["workloads"] if w["name"] == name)
    cell = harness.load_cell(name)
    assert cell.spec["config"] == w["config"]
    assert cell.cfg == build.load_json("configs", w["config"])
    assert cell.cfg["n_dt"] % cell.call_steps == 0
    limits = cell.spec["check"]["limits"]
    assert limits and set(limits) <= set(check.NUMBERS)
    assert run.cell_metrics(BENCH, name, False) and run.cell_metrics(BENCH, name, True)


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_file_is_the_one_named(name):
    c = next(c for c in BENCH["configs"] if c["name"] == name)
    assert (ROOT / c["file"]) == build.HERE / "configs" / f"{name}.json"
    cfg = build.load_json("configs", name)
    assert cfg["source"] == c["source"]
    assert set(c["reduced"]) <= set(cfg)


@pytest.mark.parametrize("name", [m["name"] for m in METRICS])
def test_metric_has_a_reader(name):
    assert callable(run.load_reader(name))


def test_unknown_cell_is_refused():
    with pytest.raises(FileNotFoundError):
        harness.load_cell("no_such.cell")
