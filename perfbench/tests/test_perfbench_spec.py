"""BENCHMARK.json holds to the benchmark's contract, and every cell,
configuration, traffic mix, limit and metric resolves by name from data."""

import json
import re
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert (ROOT / BENCH["command"][1]).is_file()
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 runs a cell, each allowed
    # run_seconds + 60, 2 x 90 s of compile a cell, 1200 s spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_fields():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [
        c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])


def test_configs_resolve_and_keep_their_widths():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert (ROOT / cfg["reference"]).is_file()
        assert cfg["dtype"] == "float32" and cfg["tf32"] is False
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    entry, config, traffic, e2e, per_layer = harness.load_cell(cell)
    assert entry["name"] == cell
    assert (ROOT / "perfbench" / "drivers" / f"{traffic['kind']}.py").is_file()
    limits = json.loads((ROOT / "perfbench" / "limits"
                         / f"{cell}.json").read_text())
    assert limits and all(v >= 0 for v in limits.values())
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert per_layer
    for m in per_layer:
        assert m["moves"] in names
        reader = harness._reader(m["name"])
        assert reader({}) is None  # nothing to read: nothing reported


def test_shelved_entries_fit_the_contract(root):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    names = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", names)) <= names
        assert (root / "perfbench" / "metrics" / f"{m['name']}.py"
                ).is_file() or m in bench["end_to_end"]
    for cell in names:
        harness.load_cell(cell, root)


def test_every_metric_has_its_reader():
    files = {p.stem for p in (ROOT / "perfbench" / "metrics").glob("*.py")}
    assert {m["name"] for m in BENCH["per_layer"]} <= files


@pytest.mark.parametrize("mix", sorted(
    p.stem for p in (ROOT / "perfbench" / "traffic").glob("*.json")))
def test_every_mix_names_its_generator(mix):
    kind = json.loads((ROOT / "perfbench" / "traffic"
                       / f"{mix}.json").read_text())["kind"]
    assert (ROOT / "perfbench" / "drivers" / f"{kind}.py").is_file()
