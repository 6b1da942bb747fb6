"""BENCHMARK.json against the rules its readers hold it to."""
import json
import re
from pathlib import Path

import pytest

from gpubench.harness.cell import Manifest
from gpubench.harness.check import load_kind

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ALL_METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["gpubench"]


@pytest.mark.parametrize("name", [m["name"] for m in ALL_METRICS]
                         + [c["name"] for c in BENCH["configs"]]
                         + [w["name"] for w in BENCH["workloads"]]
                         + [w["traffic"] for w in BENCH["workloads"]]
                         + [k for c in BENCH["configs"] for k in c["reduced"]])
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", ALL_METRICS, ids=lambda m: m["name"])
def test_units_and_sources(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")


def test_names_are_unique():
    for group in (ALL_METRICS, BENCH["configs"], BENCH["workloads"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


def test_end_to_end_bounds():
    names = {m["name"]: m for m in BENCH["end_to_end"]}
    assert names["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_cells_report_what_it_moves(metric):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    moved = e2e[metric["moves"]]
    cells = [w["name"] for w in BENCH["workloads"]]
    for cell in metric.get("workloads", cells):
        assert cell in cells
        assert cell in moved.get("workloads", cells)
    assert (REPO / "gpubench" / "layer_metrics"
            / f"{metric['name']}.py").is_file()


def test_every_config_keeps_a_cell():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    man = Manifest(REPO)
    cfg = man.config(cell["config"])
    mix = man.mix(cell["traffic"])
    limits = man.limits(cell["name"])
    (entry,) = [c for c in BENCH["configs"] if c["name"] == cell["config"]]
    assert cfg["reduced"] == entry["reduced"]
    assert set(mix["reads"]) <= {p["name"] for p in cfg["properties"]}
    assert limits["pagerank_l1"] > 0
    assert cell["chips"] == 1 and len(cell["why"]) <= 200


def test_command_names_no_file_outside_paths():
    cmd = BENCH["command"]
    assert cmd[0] == "python3" and cmd[1].startswith("gpubench/")
    assert (REPO / cmd[1]).is_file()


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_mix_client_and_property_kinds_have_files(cell):
    man = Manifest(REPO)
    mix = man.mix(cell["traffic"])
    client = man.client(mix)
    assert callable(client.open_client) and callable(client.window_metrics)
    for p in man.config(cell["config"])["properties"]:
        kind = load_kind(REPO, p["kind"])
        assert callable(kind.spec) and callable(kind.check)
        assert isinstance(kind.NUMBERS, dict)
        assert set(kind.NUMBERS) <= set(man.limits(cell["name"]))


@pytest.mark.parametrize("change", [{"clients": 16}, {"loop": "open"}],
                         ids=["clients", "loop"])
def test_client_refuses_a_mix_it_does_not_drive(change):
    man = Manifest(REPO)
    mix = {**man.mix("fresh"), **change}
    with pytest.raises(ValueError, match="closed-loop client"):
        man.client(mix).open_client(None, mix, 1)


def test_unknown_property_kind_is_refused():
    with pytest.raises(ValueError, match="no property kind"):
        load_kind(REPO, "sssp_not_here")
