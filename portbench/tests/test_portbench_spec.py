"""BENCHMARK.json and the files it names: every cell resolves to its
configuration, mix, limits and metric readers, and every name, unit and
entry keeps to the benchmark's contract."""

import json
import re

import pytest

from portbench.harness import PKG_DIR, ROOT, metric_reader, resolve

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def reports(cell, metric):
    return cell in metric.get("workloads", [cell])


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1] == "portbench/run.py" and len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = resolve(cell)
    assert c.config["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    assert c.traffic["kind"] == "closed_loop"
    assert set(c.limits) == {"bad_answers", "scan_gap", "score_err"}
    assert c.limits["bad_answers"] == 0
    assert c.chips == 1
    for m in c.end_to_end + c.per_layer:
        assert callable(metric_reader(m["name"]))
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_units_and_text(entry):
    assert NAME.fullmatch(entry["name"])
    texts = [entry[key] for key in ("why", "layer") if key in entry]
    if "file" in entry:  # a configuration's source; a metric's is a kind of source
        texts.append(entry["source"])
    for text in texts:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    if "unit" in entry:
        assert UNIT.fullmatch(entry["unit"])
        assert entry["better"] in ("lower", "higher")


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configs_are_whole_and_used(config):
    assert config["reduced"] == []
    assert config["file"] == f"portbench/configs/{config['name']}.json"
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"] and data["reduced"] == []
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_its_cells_report(metric):
    moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
    assert metric["workloads"] and set(metric["workloads"]) <= set(CELLS)
    assert all(reports(cell, moved) for cell in metric["workloads"])
    if metric["name"].split(".")[0].endswith("_roofline"):
        assert metric["unit"] == "%"


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "bound" not in m


def test_every_data_file_is_named_by_the_benchmark():
    """A file under configs/, traffic/, workloads/ or metrics/ that no entry
    names would be dead weight for every later check."""
    named = {f"configs/{c['name']}.json" for c in BENCH["configs"]}
    named |= {f"traffic/{w['traffic']}.json" for w in BENCH["workloads"]}
    named |= {f"workloads/{w['name']}.json" for w in BENCH["workloads"]}
    named |= {f"metrics/{m['name']}.py" for m in METRICS}
    on_disk = {str(p.relative_to(PKG_DIR)) for d in ("configs", "traffic", "workloads", "metrics")
               for p in (PKG_DIR / d).iterdir() if p.is_file()}
    assert on_disk == named
