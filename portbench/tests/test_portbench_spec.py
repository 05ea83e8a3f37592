"""``BENCHMARK.json`` against the benchmark's contract: every name
resolves to its file, names and units use the allowed characters, and
every cell reports what its metrics need; the parked cells
(``parked.json``) resolve alike."""
import json
import re

import pytest

from portbench.harness import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
#: the benchmark with the parked cells
ALL = spec.with_parked(BENCH)
ALL_CELLS = [w["name"] for w in ALL["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_command_and_paths():
    assert 1 <= len(BENCH["paths"]) <= 16
    for path in BENCH["paths"]:
        assert PATH.match(path) and not path.startswith("/") and ".." not in path.split("/")
        assert (spec.ROOT / path).is_dir()
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
            assert (spec.ROOT / word).is_file()


def test_the_full_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("entry", ALL["configs"] + ALL["workloads"] + ALL["end_to_end"]
                         + ALL["per_layer"], ids=lambda e: e["name"])
def test_names_and_one_line_texts(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")


def test_names_are_unique():
    for group in (ALL["configs"], ALL["workloads"], ALL["end_to_end"] + ALL["per_layer"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("entry", ALL["configs"], ids=lambda e: e["name"])
def test_a_configuration_resolves_to_its_own_file(entry):
    assert entry["file"].startswith(BENCH["paths"][0] + "/")
    doc = json.loads((spec.ROOT / entry["file"]).read_text())
    assert doc["reduced"] == entry["reduced"] == []
    assert (spec.ROOT / doc["reference"]).is_file()
    assert entry["name"] in {w["config"] for w in ALL["workloads"]}
    assert len({c["file"] for c in ALL["configs"]}) == len(ALL["configs"])


def test_every_configuration_of_the_benchmark_is_used_by_one_of_its_cells():
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}


def test_a_parked_cell_says_why_it_was_left_out():
    parked = json.loads((spec.HOME / "parked.json").read_text())
    assert set(parked["left_out"]) == {w["name"] for w in parked["workloads"]}
    assert not set(parked["left_out"]) & set(CELLS)
    assert all(0 < len(why) <= 200 for why in parked["left_out"].values())


@pytest.mark.parametrize("cell", ALL["workloads"], ids=lambda e: e["name"])
def test_a_cell_resolves_its_traffic_driver_and_limits(cell):
    assert cell["chips"] == 1
    assert NAME.match(cell["traffic"]) and NAME.match(cell["config"])
    cfg = spec.config(ALL, cell["config"])
    trf = spec.traffic(cell["traffic"])
    assert callable(spec.driver(trf).run)
    assert trf["driver"] in cfg["limits"]
    assert sum(c["config"] == cell["config"] and c["traffic"] == cell["traffic"]
               for c in ALL["workloads"]) == 1


@pytest.mark.parametrize("metric", ALL["per_layer"], ids=lambda m: m["name"])
def test_a_per_layer_metric_resolves_to_its_reader(metric):
    assert callable(spec.reader(metric["name"]).read)
    assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                "host_clock")


@pytest.mark.parametrize("metric", ALL["per_layer"], ids=lambda m: m["name"])
def test_what_a_per_layer_metric_moves_is_reported_in_each_of_its_cells(metric):
    moves = next(m for m in ALL["end_to_end"] if m["name"] == metric["moves"])
    for cell in metric.get("workloads", ALL_CELLS):
        assert cell in ALL_CELLS and spec.applies(moves, cell)


def test_layers_are_named_alike():
    for metric in BENCH["per_layer"]:
        assert len(metric["layer"]) <= 200 and metric["layer"] == metric["layer"].strip()


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    e2e = [m["name"] for m in spec.cell_metrics(ALL, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.cell_metrics(ALL, cell, "per_layer")


def test_bounds():
    for metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25


def test_shares_of_a_peak_are_named_so():
    for metric in BENCH["per_layer"]:
        if "roofline" in metric["name"] or "mfu" in metric["name"]:
            assert metric["unit"] == "%"
