"""BENCHMARK.json and the files its names resolve to."""
from __future__ import annotations

import json
import re

import pytest

from portbench.harness import spec as S
from portbench.harness import traffic
from portbench.harness.check import NUMBERS

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = S.load_spec()
CELLS = S.cell_names(SPEC)


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((S.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_units_and_keys(section):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}[section]
    names = [e["name"] for e in SPEC[section]]
    assert len(set(names)) == len(names)
    for e in SPEC[section]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                              "higher")
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]
                assert "\t" not in e[text]


def test_every_cell_reports_setup_another_metric_and_a_layer():
    moves = {}
    for cell in CELLS:
        c = S.resolve_cell(SPEC, cell)
        e2e = {m.name for m in c.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert c.per_layer, cell
        assert c.chips == 1
        moves[cell] = e2e
    for m in SPEC["per_layer"]:
        for cell in m["workloads"]:
            assert m["moves"] in moves[cell], (m["name"], cell)


def test_kernel_shares_are_named_as_rooflines():
    for m in SPEC["per_layer"]:
        if m["unit"] == "%" and m["source"] == "device_trace" \
                and "idle" not in m["name"]:
            assert m["name"].endswith("_roofline"), m["name"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = S.resolve_cell(SPEC, cell)
    traffic.check_mix(c.mix)
    assert c.config["family"] in ("dense", "moe")
    assert S.reference_module(c.config["family"]).run
    assert set(NUMBERS) & set(c.limits)
    for m in c.per_layer:
        assert callable(S.metric_reader(m.name).read), m.name


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_cut(conf):
    assert conf["file"].startswith("portbench/configs/")
    body = json.loads((S.ROOT / conf["file"]).read_text())
    assert body["name"] == conf["name"]
    assert body["source"] == conf["source"]
    assert sorted(body["reduced"]) == sorted(conf["reduced"])
    assert set(body["published"]) == set(conf["reduced"])
    for key in conf["reduced"]:
        assert key == "n_layers", "only depth is cut"
        assert body[key] < body["published"][key]
    assert body["deployment"]
